"""The seven demo scenes, transcribed constant-for-constant from main.rs.

Counterpart of ``tpupt/scenes.py``. Scenes 1 (balls) and 3 (Cornell box) need no
asset files. The others read OBJ meshes and images from the directory named by
the ``TPUPT_ASSETS`` environment variable, read when a scene is built (default:
``assets/`` beside the package); a missing file raises FileNotFoundError. Scenes
4 and 6 need only ``.obj`` and ``.hdr`` files; scenes 2, 5 and 7 read PNG/JPEG
textures through the port's own readers (``io/png.py``, ``io/jpeg.py``). As in the reference package, balls_scene's small
spheres come from a fixed-seed numpy generator so renders are reproducible.
"""

from __future__ import annotations

import os

import numpy as np

from .io.obj import load_obj
from .render.camera import Camera
from .scene.builder import (
    CheckerTexture,
    Diffuse,
    Glass,
    ImageTexture,
    Light,
    Metal,
    Principled,
    Scene,
    SolidTexture,
    Transform,
)

_DEFAULT_ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets")


def _asset(name: str) -> str:
    return os.path.join(os.environ.get("TPUPT_ASSETS", _DEFAULT_ASSETS), name)


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


def earth_scene(width: int, spp: int):
    """main.rs:84-132."""
    s = Scene()
    s.add_sphere(1.0, (4.9, 1.0, 3.0), Diffuse(ImageTexture(_asset("earthmap.jpg"))))
    s.add_sphere(1.0, (0.0, 1.0, 0.0), Diffuse((0.4, 0.2, 0.1)))
    s.add_sphere(1.0, (4.0, 1.0, 0.0), Metal((0.7, 0.6, 0.5), 0.1))
    checker = CheckerTexture(0.62, SolidTexture((0.9, 0.0, 0.1)), SolidTexture((0.9, 0.9, 0.9)))
    s.add_sphere(1000.0, (0.0, -1000.0, 0.0), Diffuse(checker))
    s.environment = (0.85, 0.85, 1.0)
    cam = Camera(
        aspect_ratio=16.0 / 9.0,
        image_width=width,
        samples_per_pixel=spp,
        max_depth=50,
        vfov=28.0,
        look_from=(8.8, 2.0, 3.0),
        look_at=(0.0, 0.0, 0.0),
        vup=(0.0, 1.0, 0.0),
        blur_strength=0.5,
        focal_length=2.869817807,
        defocus_angle=2.5,
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


def environment_map_scene(width: int, spp: int, hdr_env: bool = False):
    """main.rs:238-274 — big mirror sphere + quad light under an HDR envmap.

    NOTE: the light quad is added via add_object (main.rs:245), so the lights list is
    empty and MIS degenerates to BSDF-only sampling, exactly as in the reference.
    hdr_env=True keeps the map in f32 and importance-samples it: the environment
    joins the MIS light mixture (so MIS engages although the lights list is empty).
    """
    s = Scene()
    s.add_sphere(9.0, (4.0, 2.0, 0.0), Metal((1.0, 1.0, 1.0), 0.001))
    s.add_quad(
        (-2.0, 6.5, 0.0), (4.0, 0.0, 0.0), (0.0, 0.0, 2.0), Light((10.0, 10.0, 10.0))
    )
    s.environment = ImageTexture(_asset("grace_probe_latlong.hdr"), hdr=hdr_env)
    cam = Camera(
        aspect_ratio=16.0 / 9.0,
        image_width=width,
        samples_per_pixel=spp,
        max_depth=50,
        vfov=90.0,
        look_from=(0.0, 3.0, 17.0),
        look_at=(0.0, 2.0, 0.0),
        vup=(0.0, 1.0, 0.0),
        blur_strength=0.5,
        focal_length=17.0,
        defocus_angle=1.5,
    )
    return s, cam


def bsdf_demo_scene(width: int, spp: int):
    """main.rs:276-369 — 3 rows of principled spheres sweeping roughness."""
    s = Scene()
    for i in range(5):  # diffuse row
        s.add_sphere(
            0.5,
            (-4.0 + i, 1.0, -5.0),
            Principled(
                (0.65, 0.05, 0.05),
                metallic=0.00,
                roughness=0.1 + 0.2 * i,
                subsurface=0.01,
                specular=0.01,
                specular_tint=0.01,
                ior=1.5,
                spec_trans=0.01,
                sheen=0.01,
                sheen_tint=0.01,
                clearcoat=0.01,
                clearcoat_gloss=0.01,
            ),
        )
    for i in range(5):  # metal row
        s.add_sphere(
            0.5,
            (-4.0 + i, 2.0, -5.0),
            Principled(
                (0.05, 0.65, 0.05),
                metallic=0.99,
                roughness=0.1 + 0.2 * i,
                subsurface=0.01,
                specular=0.01,
                specular_tint=0.01,
                ior=1.5,
                spec_trans=0.01,
                sheen=0.01,
                sheen_tint=0.01,
                clearcoat=0.01,
                clearcoat_gloss=0.01,
            ),
        )
    for i in range(5):  # glass row
        s.add_sphere(
            0.5,
            (-4.0 + i, 3.0, -5.0),
            Principled(
                (0.25, 0.05, 0.65),
                metallic=0.01,
                roughness=(0.1 + 0.2 * i) * 0.3,
                subsurface=0.01,
                specular=0.01,
                specular_tint=0.01,
                ior=1.5,
                spec_trans=0.99,
                sheen=0.01,
                sheen_tint=0.01,
                clearcoat=0.01,
                clearcoat_gloss=0.01,
            ),
        )
    s.environment = ImageTexture(_asset("envmap.jpg"))
    cam = Camera(
        aspect_ratio=16.0 / 9.0,
        image_width=width,
        samples_per_pixel=spp,
        max_depth=50,
        vfov=60.0,
        look_from=(-2.0, 2.0, -1.0),
        look_at=(-2.0, 2.0, -1001.0),  # look_from + (0,0,-1000), main.rs:358
        vup=(0.0, 1.0, 0.0),
        blur_strength=0.5,
        focal_length=5.0,
        defocus_angle=0.0,
    )
    return s, cam


def everything_scene(width: int, spp: int, hdr_env: bool = False):
    """main.rs:371-532 — OBJ meshes, caustics, HDR envmap, DoF."""
    s = Scene()
    checker = CheckerTexture(0.92, SolidTexture((0.2, 0.3, 0.1)), SolidTexture((0.9, 0.9, 0.9)))
    s.add_quad(
        (-1000.0, 0.0, -1000.0), (0.0, 0.0, 5000.0), (5000.0, 0.0, 0.0), Diffuse(checker)
    )
    s.add_sphere(2.0, (-4.0, 2.0, 9.8), Metal((1.0, 1.0, 1.0), 0.001))
    s.add_sphere(1.0, (4.0, 1.0, 6.0), Glass.basic(1.5))
    s.add_cuboid(
        (0.0, 0.0, 0.0),
        (1.0, 2.0, 1.0),
        Diffuse((0.0, 0.5, 1.0)),
        transform=Transform((0.0, 1.0, 0.0), 0.5, (1.2, 0.0, 6.0)),
    )

    bunny_mat = Principled(
        (1.0, 1.0, 1.0),
        metallic=0.91,
        roughness=0.01,
        subsurface=0.01,
        specular=0.01,
        specular_tint=0.91,
        ior=1.5,
        spec_trans=0.01,
        sheen=0.91,
        sheen_tint=0.91,
        clearcoat=0.91,
        clearcoat_gloss=0.01,
    )
    s.add_mesh(
        load_obj(_asset("bunny.obj")),
        bunny_mat,
        scale=10.0,
        transform=Transform((0.0, 1.0, 0.0), 3.14, (0.1, -0.327, 5.0)),
    )

    spot_mat = Principled(
        (0.65, 0.05, 0.05),
        metallic=0.01,
        roughness=0.01,
        subsurface=0.91,
        specular=0.01,
        specular_tint=0.01,
        ior=1.5,
        spec_trans=0.01,
        sheen=0.91,
        sheen_tint=0.91,
        clearcoat=0.91,
        clearcoat_gloss=0.01,
    )
    s.add_mesh(
        load_obj(_asset("spot.obj")),
        spot_mat,
        scale=0.65,
        transform=Transform((0.0, 1.0, 0.0), 0.87, (-1.5, 2.8, 4.3)),
    )

    cow_mat = Principled(
        (0.05, 0.65, 0.05),
        metallic=0.91,
        roughness=0.21,
        subsurface=0.91,
        specular=0.01,
        specular_tint=0.01,
        ior=1.5,
        spec_trans=0.01,
        sheen=0.91,
        sheen_tint=0.91,
        clearcoat=0.91,
        clearcoat_gloss=0.01,
    )
    s.add_mesh(
        load_obj(_asset("cow.obj")),
        cow_mat,
        scale=0.75,
        transform=Transform((0.0, 1.0, 0.0), 0.93, (2.5, 3.8, 12.0)),
    )

    # emissive sphere added to *objects* (main.rs:483-488): lights list stays empty
    s.add_sphere(0.1, (1.0, 0.1, 3.0), Light((20.0, 20.0, 10.0)))
    s.add_sphere(0.2, (0.0, 0.2, 3.0), Metal((0.6, 0.05, 0.05), 0.1))
    s.add_sphere(0.3, (1.2, 0.3, 3.4), Glass((0.7, 0.3, 0.3), 0.3, 1.5))

    s.environment = ImageTexture(_asset("grace_probe_latlong.hdr"), hdr=hdr_env)
    cam = Camera(
        aspect_ratio=16.0 / 9.0,
        image_width=width,
        samples_per_pixel=spp,
        max_depth=50,
        vfov=60.0,
        look_from=(0.0, 1.5, 0.0),
        look_at=(0.0, 1.5, 100000.0),
        vup=(0.0, 1.0, 0.0),
        blur_strength=0.5,
        focal_length=6.0,
        defocus_angle=1.0,
    )
    return s, cam


def normal_demo_scene(width: int, spp: int, hdr_env: bool = False):
    """main.rs:534-618 — Cornell-style box with brick normal mapping + glass sphere."""
    s = Scene()
    bricks_albedo = ImageTexture(_asset("bricks/color.png"))
    bricks_normal = ImageTexture(_asset("bricks/normal.png"))
    with_normal = Diffuse(bricks_albedo, normal_map=bricks_normal)
    without_normal = Diffuse(bricks_albedo)
    white = Diffuse((0.73, 0.73, 0.73))
    s.add_quad((555.0, 0.0, 0.0), (0.0, 555.0, 0.0), (0.0, 0.0, 555.0), without_normal)
    s.add_quad((0.0, 0.0, 0.0), (0.0, 555.0, 0.0), (0.0, 0.0, 555.0), with_normal)
    s.add_quad((0.0, 0.0, 0.0), (555.0, 0.0, 0.0), (0.0, 0.0, 555.0), white)
    s.add_quad((555.0, 555.0, 555.0), (-555.0, 0.0, 0.0), (0.0, 0.0, -555.0), white)
    s.add_quad((0.0, 0.0, 555.0), (555.0, 0.0, 0.0), (0.0, 555.0, 0.0), white)

    s.add_quad(
        (343.0, 554.0, 332.0),
        (-130.0, 0.0, 0.0),
        (0.0, 0.0, -105.0),
        Light((27.0, 28.0, 20.0)),
        light=True,
    )

    s.add_cuboid(
        (0.0, 0.0, 0.0),
        (165.0, 330.0, 165.0),
        Metal((0.94, 0.94, 0.94), 0.1),
        transform=Transform((0.0, 1.0, 0.0), 0.261799, (265.0, 0.0, 295.0)),
    )
    s.add_sphere(100.0, (130.0, 100.0, 65.0), Glass.basic(1.5))

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


SCENES = {
    1: ("balls", balls_scene),
    2: ("earth", earth_scene),
    3: ("cornell", cornell_box_scene),
    4: ("lights", environment_map_scene),
    5: ("bsdf", bsdf_demo_scene),
    6: ("scene6", everything_scene),
    7: ("normals", normal_demo_scene),
}
