"""k1_roofline: K1's share of its bytes roofline, in %: the least time its bytes need at
3.35e12 B/s (counts/k1.py) over its measured device time, summed over the cell's camera
rays and first-bounce rays for the run's seed. The kernel is timed alone after the window
(core/kernels.py), not inside the program's graphs."""

from ptbench.core import kernels
from ptbench.counts import k1


def read(run):
    prog = run.program
    if prog is None or "compiled" not in prog:
        return None
    import torch
    from tpupt_torch.ops import hit_kernel

    sd = prog["compiled"].data
    dev = sd.device
    sph, quad = hit_kernel.tables(sd)
    o, d, tm = kernels.camera_rays(prog["camera"], dev, run.seed_for("k1"))
    t, kind, idx = hit_kernel.closest_sphere_quad(o, d, tm, sph, quad)
    i_s = idx.long().clamp_max(sd.sph_r.shape[0] - 1)
    i_q = idx.long().clamp_max(sd.quad_d.shape[0] - 1)
    center = sd.sph_c1[i_s] + (sd.sph_c2[i_s] - sd.sph_c1[i_s]) * tm[:, None]
    p = o + torch.where(t < 3e38, t, 0.0)[:, None] * d
    normal = torch.where((kind == 0)[:, None], p - center, sd.quad_n[i_q])
    no, nd, _ = kernels.bounce_rays(o, d, t, normal, run.seed_for("k1.bounce"))
    least = ms = 0.0
    for ro, rd in ((o, d), (no, nd)):
        ms += kernels.cuda_ms(lambda: hit_kernel.closest_sphere_quad(ro, rd, tm, sph, quad))
        least += k1.least_ms(ro.shape[0], sph.shape[1], quad.shape[1])
    return 100.0 * least / ms
