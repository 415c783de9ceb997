"""How many of a warp's 32 rays share a supercluster or a cluster.

From the box test of the cluster kernels (csrc/tri_kernel.cu) in eager PyTorch, for
the camera rays and the two bounce batches that follow them, on the scene-6 stand-in
and the bigmesh stand-in of chip_smoke.py: superclusters, top groups and clusters visited by the
union of each 32-ray warp and each 128-ray block, the mean and histogram of the
lanes per visited cluster and supercluster, and an instruction-count model of the
leaf (ray-parallel: 64 x 60 per visited cluster; triangle-parallel: 145 per lane
+ 40) at several thresholds of lanes between the two. Run from the root of a
checkout:

    python tools/torch_warp_occupancy.py [--out FILE.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch

BIG_IDF = float(1 << 24)  # id of pad slots in tri_geo
BUCKETS = ((1, 1), (2, 2), (3, 4), (5, 8), (9, 12), (13, 16), (17, 20), (21, 24), (25, 32))
TOP = 16  # superclusters per top group counted here


def lane_hits(sd, o, d, t_in, sc_size, tmin=1e-3):
    """Per-lane hit tables sc [B,S] and cl [B,C] (a cluster needs its supercluster)."""
    n_sc = sd.tri_cl.shape[0] // sc_size
    inv = 1.0 / torch.where(d.abs() < 1e-20, torch.where(d < 0, -1e-20, 1e-20), d)

    def slab(box):  # box [K,8] -> [B,K]
        t1 = (box[None, :, 0:3] - o[:, None, :]) * inv[:, None, :]
        t2 = (box[None, :, 3:6] - o[:, None, :]) * inv[:, None, :]
        tn = torch.minimum(t1, t2).amax(dim=2).clamp_min(tmin)
        tf = torch.minimum(torch.maximum(t1, t2).amin(dim=2), t_in[:, None])
        return tn <= tf

    sc = slab(sd.tri_scl[:n_sc])
    return sc, slab(sd.tri_cl) & sc.repeat_interleave(sc_size, dim=1)


def stats(name, sd, o, d, t_in, sc_size):
    dev = o.device
    b = o.shape[0]
    pad = (-b) % 128  # whole blocks; the pad lanes are dead
    if pad:
        o, d = torch.cat([o, o[:pad]]), torch.cat([d, d[:pad]])
        t_in = torch.cat([t_in, torch.zeros(pad, device=dev)])
    real = (sd.tri_geo[:, 9, :] < BIG_IDF).sum(1)
    acc = {}

    def add(key, value):
        acc[key] = acc.get(key, 0) + value

    hist_cl = torch.zeros(33, dtype=torch.int64, device=dev)
    hist_sc = torch.zeros(33, dtype=torch.int64, device=dev)
    chunk = 128 * 256
    for lo in range(0, o.shape[0], chunk):
        sc, cl = lane_hits(sd, o[lo : lo + chunk], d[lo : lo + chunk], t_in[lo : lo + chunk], sc_size)
        n = sc.shape[0]
        add("lane_sc", int(sc.sum()))
        add("lane_cl", int(cl.sum()))
        add("lane_tri", int((cl * real[None]).sum()))
        for g, tag in ((32, "warp"), (128, "block")):
            scg, clg = sc.view(n // g, g, -1).sum(1), cl.view(n // g, g, -1).sum(1)
            add(f"{tag}_groups", n // g)
            add(f"{tag}_sc_visits", int((scg > 0).sum()))
            add(f"{tag}_cl_visits", int((clg > 0).sum()))
            if g == 32:
                hist_cl += torch.bincount(clg.flatten(), minlength=33)
                hist_sc += torch.bincount(scg.flatten(), minlength=33)
                top = torch.nn.functional.pad(scg, (0, (-scg.shape[1]) % TOP))
                add("warp_top_visits", int((top.view(n // g, -1, TOP).sum(2) > 0).sum()))
                add("warps_with_a_cluster", int(((clg > 0).sum(1) > 0).sum()))
    warps = acc["warp_groups"]
    hc, hs = (h.cpu().numpy().astype(float) for h in (hist_cl, hist_sc))
    hc[0] = hs[0] = 0.0
    k = np.arange(33)
    out = dict(
        name=name, rays=b, alive=float((t_in[:b] > 0).float().mean()),
        clusters=int(sd.tri_cl.shape[0]), sc_size=sc_size,
        real_triangles_per_cluster=float(real[real > 0].float().mean()),
        clusters_of_at_most_32=float((real[real > 0] <= 32).float().mean()),
        lane_superclusters_per_ray=acc["lane_sc"] / b, lane_clusters_per_ray=acc["lane_cl"] / b,
        lane_triangle_tests=acc["lane_tri"],
        warp_top_groups=acc["warp_top_visits"] / warps, warp_superclusters=acc["warp_sc_visits"] / warps,
        warp_clusters=acc["warp_cl_visits"] / warps,
        warps_with_a_cluster=acc["warps_with_a_cluster"] / warps,
        block_superclusters=acc["block_sc_visits"] / acc["block_groups"],
        block_clusters=acc["block_cl_visits"] / acc["block_groups"],
        lanes_per_visited_cluster=float((hc * k).sum() / hc.sum()),
        lanes_per_visited_supercluster=float((hs * k).sum() / hs.sum()),
        buckets=[f"{a}-{z}" for a, z in BUCKETS],
        cluster_lanes_histogram=[round(float(hc[a : z + 1].sum() / hc.sum()), 4) for a, z in BUCKETS],
        supercluster_lanes_histogram=[round(float(hs[a : z + 1].sum() / hs.sum()), 4) for a, z in BUCKETS],
        leaf_model_ray_parallel=float(hc.sum() * 64 * 60 / warps),
    )
    for thr in (8, 12, 16, 20, 24, 32):
        out[f"leaf_model_threshold_{thr}"] = float((hc * np.where(k <= thr, 145 * k + 40, 64 * 60)).sum() / warps)
    print(json.dumps(out), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("warp_occupancy: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    import chip_smoke as CS
    from tpupt_torch.scenes import everything_scene

    dev = torch.device("cuda")
    print(f"card: {CS.card_line()}", flush=True)
    asset_dir = tempfile.mkdtemp(prefix="tpupt_assets_")
    os.environ["TPUPT_ASSETS"] = asset_dir
    CS.write_stand_in_assets(asset_dir)
    results = []
    for name, (scene, cam) in (("scene 6 stand-in", everything_scene(600, 32)),
                               ("bigmesh stand-in", CS.bigmesh_scene(600, 25))):
        sd = scene.compile(device=dev).data
        kernel, _ = CS.tri_args(sd)
        o, d, t = CS.camera_rays(cam, dev)
        batch = (o, d, torch.full_like(t, 3e38))
        for depth, kind in enumerate(("camera", "bounce 1", "bounce 2")):
            results.append(stats(f"{name}, {kind}", sd, *batch, sd.tri_sc_size))
            kt, _, ka = kernel(*batch)
            batch = CS.bounce_rays(batch[0], batch[1], kt, ka["ns_raw"], seed=18 + depth)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
