"""Standalone kernel times on a cell's own rays, after its window.

``cuda_ms`` and the ray helpers are frozen copies of the port's smoke script's: CUDA
events over many launches after a warm-up, with a spin kernel holding the stream while
the host enqueues them, so that a short kernel's time is the device's and not the
host's. The rays are the cell's camera rays for the run's seed and the first-bounce
rays that follow their hits, cosine-sampled about the hit's normal by a generator
seeded from the run's seed. These are times of the kernel alone, not of its launches
inside the program's graphs.
"""

from __future__ import annotations

import math

import numpy as np

SPIN_CYCLES = 20_000_000  # ~10 ms of the card: longer than the host needs to enqueue a round


def cuda_ms(fn, reps=20, rounds=7):
    """Median over `rounds` of the mean device time of `reps` calls, in ms."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def camera_rays(camera, dev, seed):
    """One ray a pixel (sample 0) of `camera` at `seed` -> (o, d, time), contiguous."""
    import torch
    from tpupt_torch.render.camera import generate_rays

    w, h = camera.image_width, camera.image_height
    pix = torch.arange(w * h, dtype=torch.int32, device=dev)
    o, d, t = generate_rays(camera.init(dev), pix // w, pix % w, pix, torch.zeros_like(pix), seed)
    return o.contiguous(), d.contiguous(), t.contiguous()


def bounce_rays(o, d, t, normal, seed):
    """The batch after a batch of hits: origin o + t d, direction cosine-sampled about the
    normal (turned against the incoming ray). Missed lanes keep their ray, dead (t_in 0)."""
    import torch

    hit = t < 3e38
    n = normal / normal.norm(dim=1, keepdim=True).clamp_min(1e-20)
    n = torch.where((n * d).sum(dim=1, keepdim=True) > 0, -n, n)
    gen = torch.Generator(device=o.device)
    gen.manual_seed(seed)
    u = torch.rand((o.shape[0], 2), generator=gen, device=o.device)
    r, phi = u[:, 0:1].sqrt(), 2.0 * math.pi * u[:, 1:2]
    axis = torch.where(n[:, 0:1].abs() > 0.9, n.new_tensor([0.0, 1.0, 0.0]), n.new_tensor([1.0, 0.0, 0.0]))
    tx = torch.linalg.cross(axis, n)
    tx = tx / tx.norm(dim=1, keepdim=True).clamp_min(1e-20)
    ty = torch.linalg.cross(n, tx)
    nd = tx * (r * phi.cos()) + ty * (r * phi.sin()) + n * (1.0 - u[:, 0:1]).sqrt()
    nd = nd / nd.norm(dim=1, keepdim=True).clamp_min(1e-20)
    no = torch.where(hit[:, None], o + t[:, None] * d, o)
    nd = torch.where(hit[:, None], nd, d)
    t_in = torch.where(hit, 3e38, 0.0).to(torch.float32)
    return no.contiguous(), nd.contiguous(), t_in.contiguous()
