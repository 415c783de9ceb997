"""Faults planted in the program under test, to see the output check come out as not
correct. Used by the CPU tests and, for the readings on the card that set a training
cell's limits, by control.py --fault. ``plant(name)`` patches the program's modules and
returns the function that takes the patch away.

- state_unchanged: a call returns its state unchanged. render_image gives every call the
  first call's image; render_film_grads gives zero gradients, so an Adam step moves no
  parameter.
- half_batch: half of the samples left out, the mean taken over the rest (spp halved).
- answer_altered: answers altered where they are produced. In a render, the radiance of
  the paths of every seventh pixel is raised by 1% and 1e-3; in a gradient pass, the
  texture colours' gradient is scaled by 1.05.
(The cells run on one card: there is no exchange between cards to leave out.)
"""

from __future__ import annotations

import dataclasses

NAMES = ("state_unchanged", "half_batch", "answer_altered")


def plant(name):
    import torch
    from tpupt_torch.render import diff, integrator, renderer

    saved = [(renderer, "render_image", renderer.render_image), (diff, "render_film_grads", diff.render_film_grads),
             (integrator, "bounce_step", integrator.bounce_step)]
    real_render, real_grads, real_bounce = (s[2] for s in saved)

    if name == "state_unchanged":
        first = {}

        def render_image(compiled, camera, seed=0, **kw):
            if "out" not in first:
                first["out"] = real_render(compiled, camera, seed=seed, **kw)
            return first["out"]

        def render_film_grads(*a, **kw):
            out = real_grads(*a, **kw)
            return (out[0], {n: torch.zeros_like(g) for n, g in out[1].items()}, *out[2:])

        renderer.render_image, diff.render_film_grads = render_image, render_film_grads
    elif name == "half_batch":
        def render_image(compiled, camera, seed=0, **kw):
            half = dataclasses.replace(camera, samples_per_pixel=max(1, camera.samples_per_pixel // 2))
            return real_render(compiled, half, seed=seed, **kw)

        def render_film_grads(compiled, camera, spp=None, **kw):
            spp = camera.samples_per_pixel if spp is None else spp
            return real_grads(compiled, camera, spp=max(1, spp // 2), **kw)

        renderer.render_image, diff.render_film_grads = render_image, render_film_grads
    elif name == "answer_altered":
        def bounce_step(sd, o, d, time, T, L, alive, bounce, pixel_ids, *rest, **kw):
            out = real_bounce(sd, o, d, time, T, L, alive, bounce, pixel_ids, *rest, **kw)
            if kw.get("detach"):
                return out
            L2 = torch.where((pixel_ids % 7 == 0)[:, None], out[3] * 1.01 + 1e-3, out[3])
            return (*out[:3], L2, out[4])

        def render_film_grads(*a, **kw):
            out = real_grads(*a, **kw)
            grads = dict(out[1], tex_rgb=out[1]["tex_rgb"] * 1.05)
            return (out[0], grads, *out[2:])

        integrator.bounce_step, diff.render_film_grads = bounce_step, render_film_grads
    else:
        raise ValueError(f"unknown fault {name!r}; known: {NAMES}")

    def undo():
        for mod, attr, value in saved:
            setattr(mod, attr, value)

    return undo
