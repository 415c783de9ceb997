"""k2_roofline: K2's share of its bytes roofline, in %: the least time its bytes need at
3.35e12 B/s (counts/k2.py) over its measured device time, summed over the cell's camera
rays and first-bounce rays for the run's seed. The kernel is timed alone after the window
(core/kernels.py), not inside the program's graphs. None where the scene's triangles do
not take the flat cluster kernel."""

import torch

from ptbench.core import kernels
from ptbench.counts import k2


def read(run):
    prog = run.program
    if prog is None or "compiled" not in prog or not prog["compiled"].data.has_tri_clusters:
        return None
    from tpupt_torch.ops import tri_kernel

    sd = prog["compiled"].data
    tables = (sd.tri_scl, sd.tri_cl, sd.tri_geo, sd.tri_attr)
    o, d, _ = kernels.camera_rays(prog["camera"], sd.device, run.seed_for("k2"))
    t_in = torch.full((o.shape[0],), 3e38, dtype=torch.float32, device=o.device)
    t, _, aux = tri_kernel.closest_tri_flat(o, d, t_in, 1e-3, *tables)
    no, nd, nt = kernels.bounce_rays(o, d, t, aux["ns_raw"], run.seed_for("k2.bounce"))
    least = ms = 0.0
    for ro, rd, rt in ((o, d, t_in), (no, nd, nt)):
        ms += kernels.cuda_ms(lambda: tri_kernel.closest_tri_flat(ro, rd, rt, 1e-3, *tables))
        least += k2.least_ms(ro.shape[0], sd.tri_scl.shape[0], sd.tri_cl.shape[0])
    return 100.0 * least / ms
