"""Smoke test of the PyTorch/CUDA port on one GPU: builds the kernels, holds each
against its plain PyTorch version, drives the main path (the Cornell-box forward
render at 600x600, max_depth 50) and prints the numbers PERF.md quotes.

    python3 chip_smoke.py                 # default: one card, 32 spp
    python3 chip_smoke.py --spp 64        # longer render
    python3 chip_smoke.py --profile DIR   # add a torch.profiler pass, tables in DIR

Exits non-zero, printing no result, without a CUDA device or outside a checkout
of the repository. The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": <card>, "count": <cards>}}.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

# K1's float operations per ray and table slot, counted from csrc/hit_kernel.cu
# (adds, multiplies, one divide or sqrt; compares not counted)
K1_FLOPS_SPHERE = 28
K1_FLOPS_QUAD = 49
K1_RAY_BYTES = 7 * 4 + 3 * 4  # o, d, time in; t, kind, idx out


def log(msg=""):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=20, rounds=7):
    """Median over `rounds` of the mean time of `reps` calls, by CUDA events (after warm-up)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def random_rays(b, seed, lo, hi, dev):
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, size=(b, 3)).astype(np.float32)
    d = rng.normal(size=(b, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t = rng.uniform(size=b).astype(np.float32)
    return tuple(torch.from_numpy(a).to(dev) for a in (o, d, t))


def camera_rays(camera, dev, seed=0):
    from tpupt_torch.render.camera import generate_rays

    w, h = camera.image_width, camera.image_height
    pix = torch.arange(w * h, dtype=torch.int32, device=dev)
    o, d, t = generate_rays(camera.init(dev), pix // w, pix % w, pix, torch.zeros_like(pix), seed)
    return o.contiguous(), d.contiguous(), t.contiguous()


def check_k1(hit_kernel, sph, quad, rays, label):
    """Kernel vs plain on the card -> (mismatching lanes, max |t| error on hits)."""
    o, d, tm = rays
    kt, kk, ki = hit_kernel.closest_sphere_quad(o, d, tm, sph, quad)
    pt, pk, pi = hit_kernel.closest_sphere_quad_plain(o, d, tm, sph, quad)
    torch.cuda.synchronize()
    bad = (kt.view(torch.int32) != pt.view(torch.int32)) | (kk != pk) | (ki != pi)
    n_bad = int(bad.sum())
    hits = pt < hit_kernel.BIG
    err = float((kt - pt).abs()[hits].max()) if bool(hits.any()) else 0.0
    log(f"K1 vs plain [{label}]: {o.shape[0]} rays, S={sph.shape[1]} Q={quad.shape[1]}, "
        f"hit share {float(hits.float().mean()):.4f}, mismatching lanes {n_bad}, max |dt| {err}")
    return n_bad, err


def image_stats(mean):
    """(finite share, mean radiance over finite pixels, its standard error)."""
    px = mean.reshape(-1, 3)
    fin = np.isfinite(px).all(axis=1)
    vals = px[fin].mean(axis=1)
    return float(fin.mean()), float(vals.mean()), float(vals.std() / math.sqrt(max(len(vals), 1)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--spp", type=int, default=32, help="samples per pixel of the 600 px render")
    ap.add_argument("--profile", type=str, default=None, metavar="DIR")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    try:
        from tpupt_torch import build
        from tpupt_torch.ops import hit_kernel
        from tpupt_torch.render.renderer import render_image
        from tpupt_torch.scenes import balls_scene, cornell_box_scene
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})", file=sys.stderr)
        return 1

    dev = torch.device("cuda")
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    # ---- build every kernel of the port, one nvcc per source, all at once ----
    t0 = time.perf_counter()
    reports = build.build_all(["hit_kernel"])
    log(f"kernel build: {time.perf_counter() - t0:.2f} s")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "smem" in line:
                log(f"  {name}: {line.strip()}")

    # ---- K1 against its plain version on the card ----
    cscene, ccam = cornell_box_scene(600, args.spp)
    csd = cscene.compile(device=dev).data
    c_sph, c_quad = hit_kernel.tables(csd)
    bscene, bcam = balls_scene(600, args.spp)
    bsd = bscene.compile(device=dev).data
    b_sph, b_quad = hit_kernel.tables(bsd)
    mismatches, max_err = 0, 0.0
    for label, sph, quad, rays in (
        ("cornell, random", c_sph, c_quad, random_rays(1 << 20, 1, 0.0, 555.0, dev)),
        ("cornell, camera", c_sph, c_quad, camera_rays(ccam, dev)),
        ("balls, random", b_sph, b_quad, random_rays(1 << 20, 2, -12.0, 12.0, dev)),
        ("balls, camera", b_sph, b_quad, camera_rays(bcam, dev)),
    ):
        n_bad, err = check_k1(hit_kernel, sph, quad, rays, label)
        mismatches += n_bad
        max_err = max(max_err, err)
    if mismatches:
        raise SystemExit(f"chip_smoke: K1 disagrees with its plain version on {mismatches} lanes")

    # ---- K1 timing at the main path's shapes (B = 600*600 Cornell lanes) ----
    o, d, tm = camera_rays(ccam, dev)
    b = o.shape[0]
    k1_ms = cuda_ms(lambda: hit_kernel.closest_sphere_quad(o, d, tm, c_sph, c_quad))
    plain_ms = cuda_ms(lambda: hit_kernel.closest_sphere_quad_plain(o, d, tm, c_sph, c_quad), reps=5)
    flops = b * (c_sph.shape[1] * K1_FLOPS_SPHERE + c_quad.shape[1] * K1_FLOPS_QUAD)
    nbytes = b * K1_RAY_BYTES + 4 * (c_sph.numel() + c_quad.numel())
    bound_ms = 1e3 * max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS)
    bound_by = "operations" if flops / PEAK_F32_FLOPS >= nbytes / PEAK_BYTES_PER_S else "bytes"
    log(f"K1 at B={b}, S={c_sph.shape[1]}, Q={c_quad.shape[1]}: kernel {k1_ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: {flops:.3e} flop, "
        f"{nbytes:.3e} B); no single PyTorch call computes it")

    # ---- the main path: Cornell 600x600, max_depth 50, through render_image ----
    hit_kernel.launches = 0
    torch.cuda.synchronize()
    _, m_gpu, st = render_image(cscene.compile(device=dev), ccam, seed=0, progress=False)
    torch.cuda.synchronize()
    k1_launches = hit_kernel.launches
    log(f"render cornell 600x600 {args.spp} spp max_depth {ccam.max_depth} on cuda: "
        f"{st.wall_s:.3f} s, {st.paths} paths, {st.paths_per_s:.4e} paths/s, {st.rays} rays, "
        f"{st.rays_per_s:.4e} rays/s, {st.launches} launches, {st.iterations} wavefront "
        f"iterations ({1e3 * st.wall_s / max(st.iterations, 1):.3f} ms each), "
        f"K1 launches {k1_launches} (~{100 * k1_launches * k1_ms / 1e3 / st.wall_s:.2f}% of wall)")
    if k1_launches == 0:
        raise SystemExit("chip_smoke: the render never launched K1")
    if m_gpu.shape != (600, 600, 3):
        raise SystemExit(f"chip_smoke: render shape {m_gpu.shape}")

    # ---- the render against the port's CPU render ----
    sscene, scam = cornell_box_scene(32, 4)
    _, m_cpu, _ = render_image(sscene.compile(device="cpu"), scam, seed=0, progress=False)
    _, m_small, _ = render_image(sscene.compile(device=dev), scam, seed=0, progress=False)
    close = float(np.isclose(m_small, m_cpu, rtol=1e-3, atol=1e-4, equal_nan=True).all(-1).mean())
    fin_g, mean_g, se_g = image_stats(m_gpu)
    fin_c, mean_c, se_c = image_stats(m_cpu)
    fin_s, mean_s, _ = image_stats(m_small)
    tol = 5.0 * math.sqrt(se_g * se_g + se_c * se_c)
    log(f"32 px / 4 spp, cuda vs cpu: {close:.4f} of pixels within rtol 1e-3 / atol 1e-4, "
        f"means {mean_s:.6f} vs {mean_c:.6f}")
    log(f"600 px cuda vs 32 px cpu: finite share {fin_g:.6f} vs {fin_c:.6f}, mean radiance "
        f"{mean_g:.6f} vs {mean_c:.6f} (|diff| {abs(mean_g - mean_c):.6f}, 5-sigma tol {tol:.6f})")
    if close < 0.95 or abs(mean_s - mean_c) > 0.01 * abs(mean_c):
        raise SystemExit("chip_smoke: the small cuda render disagrees with the cpu render")
    if fin_g < 0.99 or abs(fin_g - fin_c) > 0.01:
        raise SystemExit("chip_smoke: finite share of the film differs from the cpu render")
    if not (mean_g > 0.0) or abs(mean_g - mean_c) > tol:
        raise SystemExit("chip_smoke: mean radiance differs from the cpu render")

    if args.profile:
        profile_render(args.profile, render_image, cornell_box_scene, dev)

    kernels = [dict(
        name="K1 closest_sphere_quad",
        route="cuda",
        source="tpupt_torch/csrc/hit_kernel.cu",
        replaces="tpupt/ops/pallas_hit.py:35",
        launches=k1_launches,
        max_abs_err=max_err,
        ms=k1_ms,
        plain_ms=plain_ms,
        bound_ms=bound_ms,
        bound_by=bound_by,
        library_ms=None,
        status=f"ported, launches {k1_launches}, mismatches {mismatches}",
    )]
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


def profile_render(out_dir, render_image, cornell_box_scene, dev):
    """torch.profiler over a 600 px / 2 spp render: kernel time by name, device busy share."""
    import os

    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    scene, cam = cornell_box_scene(600, 2)
    compiled = scene.compile(device=dev)
    render_image(compiled, cam, progress=False)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, _, st = render_image(compiled, cam, progress=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    table = events.table(sort_by="cuda_time_total", row_limit=40)
    with open(os.path.join(out_dir, "render_profile.txt"), "w") as f:
        f.write(table)
    # device-side entries only: an operator's own row repeats its kernels' time
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kernels)
    n_kernels = sum(e.count for e in kernels)
    log(f"profile (600 px, 2 spp, under the profiler): wall {wall:.3f} s, {st.iterations} iterations, "
        f"device kernel time {dev_us / 1e3:.3f} ms ({100 * dev_us / 1e6 / wall:.2f}% busy), "
        f"{n_kernels} device kernels; table in {out_dir}/render_profile.txt")


if __name__ == "__main__":
    raise SystemExit(main())
