"""The roughness gradient of the detached estimator against a central finite difference of
the rendered image, in the port, on the CPU.

    python tools/torch_roughness_fd.py [--spp 256 1024] [--seeds 0 1 2]

The scene of tests/test_torch_grad_roughness.py (a rough metal floor under a quad light, a
dim sky, 6x6 pixels, max_depth 3), and the same with a principled floor (metallic 1, 0.5,
0) whose roughness is mat_params[:, P_ROUGHNESS]. For each, the gradient of the image sum
in the roughness by render_grads, and (sum(+h) - sum(-h)) / 2h at h = 0.05 with the same
seed. Prints one line a case. (tests/test_torch_grad_roughness.py holds the port's
gradients to the reference's.)
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from tpupt_torch.render import diff as TD  # noqa: E402
from tpupt_torch.render.camera import Camera  # noqa: E402
from tpupt_torch.scene.builder import Light, Metal, Principled, Scene  # noqa: E402
from tpupt_torch.scene.compile import CompiledScene  # noqa: E402
from tpupt_torch.scene.data import MAT_LIGHT, P_ROUGHNESS  # noqa: E402

H = 0.05  # the reference's step


def scene(floor):
    s = Scene()
    s.add_quad((-4.0, 0.0, -4.0), (8.0, 0.0, 0.0), (0.0, 0.0, 8.0), floor)
    s.add_quad((-1.0, 3.0, -1.0), (2.0, 0.0, 0.0), (0.0, 0.0, 2.0), Light((5.0, 5.0, 5.0)), light=True)
    s.environment = (0.1, 0.1, 0.1)
    return s.compile(device="cpu")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--spp", type=int, nargs="+", default=[256, 1024])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    args = ap.parse_args()
    torch.set_num_threads(1)
    torch.sqrt(torch.ones(4))  # the process's first vector-math call, on one thread (tests/torch_cpu_warmup.py)
    torch.set_num_threads(os.cpu_count() or 1)
    ids = np.arange(36, dtype=np.int32)
    cam = Camera(aspect_ratio=1.0, image_width=6, samples_per_pixel=4, max_depth=3, vfov=40.0,
                 look_from=(0.0, 1.0, 3.0), look_at=(0.0, 1.0, 0.0), blur_strength=0.5, focal_length=3.0,
                 defocus_angle=0.0)
    cases = {"metal, roughness texture": Metal((0.9, 0.9, 0.9), 0.4)}
    cases.update({f"principled metallic {m}, mat_params roughness": Principled((0.9, 0.9, 0.9), metallic=m,
                                                                              roughness=0.4)
                  for m in (1.0, 0.5, 0.0)})
    for label, floor in cases.items():
        tc = scene(floor)
        m = int(np.nonzero(tc.data.mat_type.numpy() != MAT_LIGHT)[0][0])
        field, idx = (("tex_rgb", (int(tc.data.mat_rough_tex[m]), 0)) if "texture" in label
                      else ("mat_params", (m, P_ROUGHNESS)))

        def run(v, spp, seed):
            x = getattr(tc.data, field).clone()
            x[idx] = v
            sd = TD.apply_params(tc.data, {field: x})
            rad, g = TD.render_grads(CompiledScene(sd, tc.has_lights), cam, ids, spp=spp, seed=seed)
            return float(rad.double().sum()), float(g[field][idx])

        v0 = float(getattr(tc.data, field)[idx])
        for spp in args.spp:
            for seed in args.seeds:
                _, g = run(v0, spp, seed)
                fd = (run(v0 + H, spp, seed)[0] - run(v0 - H, spp, seed)[0]) / (2.0 * H)
                print(f"{label}: spp {spp} seed {seed}: gradient {g:.6f}, finite difference {fd:.6f}, "
                      f"finite difference / gradient {fd / g:.3f}", flush=True)


if __name__ == "__main__":
    main()
