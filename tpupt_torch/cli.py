"""CLI mirroring the reference binary (main.rs:620-645).

Usage: python -m tpupt_torch.cli -s 3                  # 600 px, 100 spp on cuda
       python -m tpupt_torch.cli -s 3 --width 300 --spp 16 -o out/cornell.png
       python -m tpupt_torch.cli -s 3 --width 32 --spp 4 --device cpu
       TPUPT_ASSETS=/path/to/assets python -m tpupt_torch.cli -s 6   # OBJ meshes, .hdr env
       TPUPT_ASSETS=/path/to/assets python -m tpupt_torch.cli -s 4 --hdr-env
       torchrun --nproc-per-node 8 python -m tpupt_torch.cli -s 3 --mesh 8   # 8 GPUs
"""

from __future__ import annotations

import argparse
import contextlib
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
        "--profile",
        type=str,
        default=None,
        metavar="DIR",
        help="write a Chrome trace of the render to DIR (one a rank): torch.profiler's events, "
        "the program's spans from the scene's build on, and the card's intervals in its graphs",
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
    ap.add_argument(
        "--mesh",
        type=int,
        default=None,
        metavar="N",
        help="shard the samples over N processes, one a device (film all-reduced once a "
        "launch); launch with torchrun --nproc-per-node N",
    )
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

    device, mesh = args.device, None
    if args.mesh is not None:
        from .parallel.multihost import initialize_distributed
        from .parallel.sharding import make_mesh

        if args.mesh > 1 and int(os.environ.get("WORLD_SIZE", "1")) == 1:
            ap.error(f"--mesh {args.mesh} runs one process a device: torchrun --nproc-per-node "
                     f"{args.mesh} python -m tpupt_torch.cli --mesh {args.mesh} ...")
        if device == "cuda":
            device = f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"
        initialize_distributed(device=device)
        mesh = make_mesh(args.mesh, device=device)
    lead = mesh is None or mesh.index == 0  # only rank 0 writes and reports

    name, build = SCENES[args.scene]
    out_path = args.output or os.path.join("out", f"{name}.png")
    if lead:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        print(f"scene {args.scene} ({name}): {width}px, {spp} spp on {device}"
              + ("" if mesh is None else f", sharded over {mesh.size} processes"))
    kwargs = {}
    if args.hdr_env:
        if "hdr_env" not in inspect.signature(build).parameters:
            if lead:
                print(f"--hdr-env: scene {args.scene} has no environment map; ignoring")
        else:
            kwargs["hdr_env"] = True
    with contextlib.ExitStack() as stack:
        if args.profile is not None:  # the trace shows set-up too: builds, the scene's compile
            from .trace import recording

            stack.enter_context(recording())
        scene, camera = build(width, spp, **kwargs)
        compiled = scene.compile(device=device)
        img, _, stats = render_image(
            compiled,
            camera,
            seed=args.seed,
            rays_per_launch=args.rays_per_launch,
            checkpoint_path=args.checkpoint,
            profile_dir=args.profile,
            debug_checks=args.debug_checks,
            mesh=mesh,
            progress=lead,
        )
    if not lead:
        return 0
    save_png(out_path, img)
    print(
        f"rendered {stats.paths} paths in {stats.wall_s:.2f}s "
        f"({stats.paths_per_s / 1e6:.2f} Mpaths/s, {stats.rays_per_s / 1e6:.2f} Mrays/s, "
        f"{stats.iterations} wavefront iterations) -> {out_path}"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
