"""Tests of the port that need a CUDA card (the kernel has no CPU mode).

They skip without a GPU. This file imports neither jax nor the reference package,
so it runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py -q

Tolerances: the kernel is bit-equal to its plain version (both round every
operation on its own); a small render on the card matches the same render on the
CPU on at least 95% of pixels within rtol 1e-3 / atol 1e-4, with image means
within 1% (the card's transcendentals differ from the CPU's by an ulp, which
flips a rare branch).
"""

import numpy as np
import pytest
import torch

from tpupt_torch.ops import hit_kernel
from tpupt_torch.render.renderer import render_image
from tpupt_torch.scenes import balls_scene, cornell_box_scene


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _rays(b, seed, lo, hi, dev):
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, size=(b, 3)).astype(np.float32)
    d = rng.normal(size=(b, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t = rng.uniform(size=b).astype(np.float32)
    return tuple(torch.from_numpy(a).to(dev) for a in (o, d, t))


@pytest.mark.parametrize("b", [1, 255, 257, 100_003])
@pytest.mark.parametrize("which", ["cornell", "balls"])
def test_kernel_bit_equal_to_plain(cuda, which, b):
    build, lo, hi = {"cornell": (cornell_box_scene, 0.0, 555.0), "balls": (balls_scene, -12.0, 12.0)}[which]
    sd = build(16, 4)[0].compile(device=cuda).data
    sph, quad = hit_kernel.tables(sd)
    o, d, tm = _rays(b, 11, lo, hi, cuda)
    before = hit_kernel.launches
    got = hit_kernel.closest_sphere_quad(o, d, tm, sph, quad)
    want = hit_kernel.closest_sphere_quad_plain(o, d, tm, sph, quad)
    torch.cuda.synchronize()
    assert hit_kernel.launches == before + 1
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])


def test_kernel_rejects_mixed_devices(cuda):
    sd = cornell_box_scene(16, 4)[0].compile(device=cuda).data
    sph, quad = hit_kernel.tables(sd)
    o, d, tm = _rays(64, 1, 0.0, 555.0, cuda)
    with pytest.raises(ValueError, match="is on"):
        hit_kernel.closest_sphere_quad(o, d.cpu(), tm, sph, quad)


def test_small_render_matches_cpu(cuda):
    scene, cam = cornell_box_scene(32, 4)
    _, m_cpu, _ = render_image(scene.compile(device="cpu"), cam, progress=False)
    before = hit_kernel.launches
    _, m_gpu, stats = render_image(scene.compile(device=cuda), cam, progress=False)
    assert hit_kernel.launches - before == stats.iterations > 0
    close = np.isclose(m_gpu, m_cpu, rtol=1e-3, atol=1e-4, equal_nan=True).all(-1).mean()
    assert close >= 0.95
    np.testing.assert_allclose(np.nanmean(m_gpu), np.nanmean(m_cpu), rtol=1e-2)
