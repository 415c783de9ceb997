"""The plain reference of the benchmark: the forward render worked out again from a
configuration file, in eager PyTorch, with no code of the program under test.

It follows the Rust reference renderer's estimator with the counter-based sampler that
the port shares with it, so the same seed, pixel and sample give the same path; the
shading code is a frozen copy of the port's plain route, the scene tables, the camera
and the intersection are this package's own. ``render_means`` gives the mean radiance
that ``render_image`` returns for chosen pixels of chosen frames.
"""

from __future__ import annotations

from . import scene, trace


def render_means(cfg, asset_dir, device, jobs, state_dtype=None):
    """jobs: [(seed, camera fields to override, pixel ids)] -> [float32 [P,3]]."""
    sd, has_lights = scene.build_tables(cfg, asset_dir, device)
    cams = [scene.camera(cfg, **over) for _, over, _ in jobs]
    cam = cams[0]
    bases = [c.basis(device) for c in cams]
    return trace.pixel_means(
        sd, has_lights, [(s, b, ids) for (s, _, ids), b in zip(jobs, bases)],
        cam.image_width, cam.image_height, cam.samples_per_pixel, cam.max_depth, state_dtype,
    )


def follow_steps(cfg, asset_dir, device, plan, steps, state_dtype=None):
    """The reference's first `steps` inverse-rendering steps of `plan` (train.py)."""
    from . import train

    return train.follow(cfg, asset_dir, device, plan, steps, state_dtype)


def one_step(cfg, asset_dir, device, spp, handed, state_dtype=None):
    """One inverse-rendering step's film and gradients from the parameters and cotangent it
    was handed (train.py)."""
    from . import train

    return train.one_step(cfg, asset_dir, device, spp, handed, state_dtype)
