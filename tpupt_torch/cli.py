"""CLI mirroring the reference binary (main.rs:620-645).

Usage: python -m tpupt_torch.cli -s 3                  # 600 px, 100 spp on cuda
       python -m tpupt_torch.cli -s 3 --width 300 --spp 16 -o out/cornell.png
       python -m tpupt_torch.cli -s 3 --width 32 --spp 4 --device cpu
       TPUPT_ASSETS=/path/to/assets python -m tpupt_torch.cli -s 6   # OBJ meshes, .hdr env
       TPUPT_ASSETS=/path/to/assets python -m tpupt_torch.cli -s 4 --hdr-env
"""

from __future__ import annotations

import argparse
import inspect
import os


def main(argv=None):
    ap = argparse.ArgumentParser(description="tpupt_torch: PyTorch/CUDA path tracer")
    ap.add_argument("-q", "--quality", action="store_true", help="1920 px / 4000 spp preset")
    ap.add_argument(
        "-s", "--scene", type=int, default=1,
        help="scene number (1 and 3 need no assets; the others read $TPUPT_ASSETS)",
    )
    ap.add_argument("--width", type=int, default=None, help="override image width")
    ap.add_argument("--spp", type=int, default=None, help="override samples per pixel")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("-o", "--output", type=str, default=None)
    ap.add_argument("--rays-per-launch", type=int, default=1 << 20)
    ap.add_argument(
        "--checkpoint",
        type=str,
        default=None,
        help="film checkpoint file: saved after every launch, resumed if present "
        "(bit-identical to an uninterrupted render)",
    )
    ap.add_argument(
        "--debug-checks",
        action="store_true",
        help="validate every launch's film for NaN/Inf and fail loudly",
    )
    ap.add_argument(
        "--hdr-env",
        action="store_true",
        help="keep the scene's .hdr environment in float32 and importance-sample it "
        "(scenes 4, 6 and 7; the reference quantizes it to u8)",
    )
    ap.add_argument("--device", type=str, default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)

    width, spp = (1920, 4000) if args.quality else (600, 100)  # main.rs:633
    if args.width is not None:
        width = args.width
    if args.spp is not None:
        spp = args.spp

    from .io.image import save_png
    from .render.renderer import render_image
    from .scenes import SCENES

    if args.scene not in SCENES:
        print(f"unknown scene {args.scene}; choose from {sorted(SCENES)}")
        return 1

    name, build = SCENES[args.scene]
    out_path = args.output or os.path.join("out", f"{name}.png")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)

    print(f"scene {args.scene} ({name}): {width}px, {spp} spp on {args.device}")
    kwargs = {}
    if args.hdr_env:
        if "hdr_env" not in inspect.signature(build).parameters:
            print(f"--hdr-env: scene {args.scene} has no environment map; ignoring")
        else:
            kwargs["hdr_env"] = True
    scene, camera = build(width, spp, **kwargs)
    compiled = scene.compile(device=args.device)
    img, _, stats = render_image(
        compiled,
        camera,
        seed=args.seed,
        rays_per_launch=args.rays_per_launch,
        checkpoint_path=args.checkpoint,
        debug_checks=args.debug_checks,
    )
    save_png(out_path, img)
    print(
        f"rendered {stats.paths} paths in {stats.wall_s:.2f}s "
        f"({stats.paths_per_s / 1e6:.2f} Mpaths/s, {stats.rays_per_s / 1e6:.2f} Mrays/s, "
        f"{stats.iterations} wavefront iterations) -> {out_path}"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
