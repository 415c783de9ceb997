"""The demo scenes, transcribed constant-for-constant from main.rs.

Counterpart of ``tpupt/scenes.py``. The port carries the scenes that need no asset
files: 1 (balls) and 3 (Cornell box). Scenes 2 and 4-7 read images or OBJ meshes
and raise until the port's io modules and the large-mesh path arrive (ROADMAP).
As in the reference package, balls_scene's small spheres come from a fixed-seed
numpy generator so renders are reproducible.
"""

from __future__ import annotations

import numpy as np

from .render.camera import Camera
from .scene.builder import (
    CheckerTexture,
    Diffuse,
    Glass,
    Light,
    Metal,
    Principled,
    Scene,
    SolidTexture,
    Transform,
)


def balls_scene(width: int, spp: int):
    """main.rs:14-82 — bouncing balls, motion blur, checker ground, DoF."""
    s = Scene()
    checker = CheckerTexture(0.32, SolidTexture((0.2, 0.3, 0.1)), SolidTexture((0.9, 0.9, 0.9)))
    s.add_sphere(1000.0, (0.0, -1000.0, 0.0), Diffuse(checker))
    s.add_sphere(1.0, (0.0, 1.0, 0.0), Glass.basic(1.5))
    s.add_sphere(1.0, (-4.0, 1.0, 0.0), Diffuse((0.4, 0.2, 0.1)))
    s.add_sphere(1.0, (4.0, 1.0, 0.0), Metal((0.7, 0.6, 0.5), 0.0))

    rng = np.random.default_rng(20241224)  # deterministic stand-in for thread_rng
    for a in range(-11, 11):
        for b in range(-11, 11):
            choose = rng.random()
            center = np.array([a + 0.9 * rng.random(), 0.2, b + 0.9 * rng.random()])
            if np.linalg.norm(center - np.array([4.0, 0.2, 0.0])) > 0.9:
                if choose < 0.8:
                    albedo = rng.random(3) * rng.random(3)
                    pos2 = center + np.array([0.0, rng.random() * 0.5, 0.0])
                    s.add_sphere(0.2, center, Diffuse(tuple(albedo)), center2=pos2)
                elif choose < 0.95:
                    albedo = 0.5 + 0.5 * rng.random(3)
                    s.add_sphere(0.2, center, Metal(tuple(albedo), 0.0))
                else:
                    s.add_sphere(0.2, center, Glass.basic(1.5))

    s.environment = (0.7, 0.8, 1.0)
    cam = Camera(
        aspect_ratio=16.0 / 9.0,
        image_width=width,
        samples_per_pixel=spp,
        max_depth=50,
        vfov=20.0,
        look_from=(13.0, 2.0, 3.0),
        look_at=(0.0, 0.0, 0.0),
        vup=(0.0, 1.0, 0.0),
        blur_strength=0.5,
        focal_length=10.0,
        defocus_angle=0.6,
    )
    return s, cam


def cornell_box_scene(width: int, spp: int):
    """main.rs:134-236 — Cornell box with principled sphere, metal + white boxes."""
    s = Scene()
    red = Diffuse((0.65, 0.05, 0.05))
    white = Diffuse((0.73, 0.73, 0.73))
    green = Diffuse((0.12, 0.45, 0.15))
    s.add_quad((555.0, 0.0, 0.0), (0.0, 555.0, 0.0), (0.0, 0.0, 555.0), green)
    s.add_quad((0.0, 0.0, 0.0), (0.0, 555.0, 0.0), (0.0, 0.0, 555.0), red)
    s.add_quad((0.0, 0.0, 0.0), (555.0, 0.0, 0.0), (0.0, 0.0, 555.0), white)
    s.add_quad((555.0, 555.0, 555.0), (-555.0, 0.0, 0.0), (0.0, 0.0, -555.0), white)
    s.add_quad((0.0, 0.0, 555.0), (555.0, 0.0, 0.0), (0.0, 555.0, 0.0), white)

    s.add_quad(
        (343.0, 554.0, 332.0),
        (-130.0, 0.0, 0.0),
        (0.0, 0.0, -105.0),
        Light((25.0, 25.0, 25.0)),
        light=True,
    )

    s.add_sphere(
        135.0,
        (113.0, 170.0, 372.0),
        Principled(
            (1.0, 1.0, 1.0),
            metallic=0.01,
            roughness=0.01,
            subsurface=0.01,
            specular=0.91,
            specular_tint=0.91,
            ior=1.5,
            spec_trans=0.91,
            sheen=0.91,
            sheen_tint=0.91,
            clearcoat=0.91,
            clearcoat_gloss=0.01,
        ),
    )

    s.add_cuboid(
        (0.0, 0.0, 0.0),
        (165.0, 330.0, 165.0),
        Metal((1.0, 1.0, 1.0), 0.1),
        transform=Transform((0.0, 1.0, 0.0), 0.261799, (265.0, 0.0, 295.0)),
    )
    s.add_cuboid(
        (0.0, 0.0, 0.0),
        (165.0, 165.0, 165.0),
        white,
        transform=Transform((0.0, 1.0, 0.0), -0.29, (130.0, 0.0, 65.0)),
    )

    s.environment = (0.0, 0.0, 0.0)
    cam = Camera(
        aspect_ratio=1.0,
        image_width=width,
        samples_per_pixel=spp,
        max_depth=50,
        vfov=40.0,
        look_from=(278.0, 278.0, -800.0),
        look_at=(278.0, 278.0, 0.0),
        vup=(0.0, 1.0, 0.0),
        blur_strength=0.5,
        focal_length=10.0,
        defocus_angle=0.0,
    )
    return s, cam


def _needs_assets(name: str):
    def build(width: int, spp: int, **kwargs):
        raise NotImplementedError(
            f"scene {name!r} reads image or OBJ assets; the port's io modules are not "
            "ported yet (ROADMAP Queue 1 item 2). Scenes 1 and 3 need no assets."
        )

    return build


SCENES = {
    1: ("balls", balls_scene),
    2: ("earth", _needs_assets("earth")),
    3: ("cornell", cornell_box_scene),
    4: ("lights", _needs_assets("lights")),
    5: ("bsdf", _needs_assets("bsdf")),
    6: ("scene6", _needs_assets("scene6")),
    7: ("normals", _needs_assets("normals")),
}
