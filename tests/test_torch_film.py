"""The render's film on its device (ops/film_kernel.py, render/renderer.py) on the CPU.

- The plain versions of the film's add and resolve equal numpy's formulas bit for bit:
  ``film[ids] += out.astype(np.float64)`` over several launches with a padded last block,
  and ``tonemap_quantize(film / spp)``, ``(film / spp).astype(np.float32)`` over NaN, +-inf,
  -0.0, negative values and the quantisation's edges.
- render_image's image and mean equal those formulas over the float64 film that a
  checkpointed render writes, over several pixel blocks and sample chunks.
- A repeated call takes every launch's inputs from the kept buffers
  (``RenderStats.host_free_launches``) and returns arrays of its own.
- The kept Morton order and the benchmark's reader of host_free.frame.
"""

import types

import torch_cpu_warmup  # noqa: F401  (MKL's first vector-math call, on one thread)
import numpy as np
import pytest
import torch

import tpupt_torch.render.renderer as R
from ptbench.core import spec
from tpupt_torch import trace
from tpupt_torch.ops import film_kernel
from tpupt_torch.render.camera import Camera
from tpupt_torch.render.film import tonemap_quantize
from tpupt_torch.scene.builder import Diffuse, Light, Scene
from tpupt_torch.trace import Recording, Span

MS = 1_000_000  # ns


def _small():
    s = Scene()
    s.add_sphere(1.0, (0.0, 0.0, -3.0), Diffuse((0.6, 0.5, 0.4)))
    s.add_quad((-1.0, 2.5, -4.0), (2.0, 0.0, 0.0), (0.0, 0.0, 2.0), Light((6.0, 6.0, 6.0)), light=True)
    s.environment = (0.2, 0.3, 0.4)
    cam = Camera(
        aspect_ratio=1.5, image_width=12, samples_per_pixel=16, max_depth=6,
        vfov=30.0, look_from=(0, 0, 0), look_at=(0, 0, -1),
        blur_strength=0.5, focal_length=3.0, defocus_angle=0.0,
    )
    return s.compile(device="cpu"), cam


KW = dict(rays_per_launch=64, samples_per_launch=4, progress=False)  # 2 pixel blocks (96 px), 4 chunks


def edge_film(spp, seed):
    """[n, 3] float64 film values whose means over spp hit the tonemap's cases: NaN, +-inf,
    -0.0, negatives, 0, g*256 at and beside integers, g at and beside 0.999, huge values,
    and random ones."""
    rng = np.random.default_rng(seed)
    m = np.arange(257, dtype=np.float64)
    at_int = (m / 256.0) ** 2  # sqrt gives m/256 exactly: g*256 = m
    beside = np.concatenate([np.nextafter(at_int, -np.inf), np.nextafter(at_int, np.inf)])
    edge = np.array([0.999 ** 2, np.nextafter(0.999 ** 2, 0), np.nextafter(0.999 ** 2, 2), 0.998001, 1.0, 4.0,
                     np.nan, -np.nan, np.inf, -np.inf, -0.0, 0.0, -1.0, -1e-300, 1e-300, 5e-324, 1e300,
                     np.finfo(np.float64).max])
    mean = np.concatenate([at_int, beside, edge, rng.uniform(-0.2, 1.5, 600), rng.exponential(0.3, 600)])
    mean = mean[: len(mean) // 3 * 3]
    with np.errstate(over="ignore"):  # the largest values reach inf
        return (mean * spp).reshape(-1, 3)


@pytest.mark.parametrize("spp", [1, 7, 100])
def test_resolve_plain_is_the_numpy_formula_bit_for_bit(spp):
    film = edge_film(spp, spp)
    img, mean = film_kernel.resolve_plain(torch.from_numpy(film.copy()), spp)
    assert img.dtype == torch.uint8 and mean.dtype == torch.float32
    want = film / spp
    assert img.numpy().tobytes() == tonemap_quantize(want).tobytes()
    assert mean.numpy().tobytes() == want.astype(np.float32).tobytes()
    img2, mean2 = film_kernel.resolve(torch.from_numpy(film.copy()), spp)  # the CPU's route is the plain one
    assert torch.equal(img2, img) and mean2.numpy().tobytes() == mean.numpy().tobytes()


def test_add_plain_is_numpy_scatter_bit_for_bit_over_launches():
    """Four launches over 100 pixels in blocks of 32 (a padded last block of 4 pixels whose
    padded lanes, id 0, hold NaN and inf that must add nothing), two sample chunks each."""
    rng = np.random.default_rng(3)
    npix, pb = 100, 32
    order = rng.permutation(npix).astype(np.int32)
    want = np.zeros((npix, 3))
    got = torch.zeros((npix, 3), dtype=torch.float64)
    for chunk in range(2):
        for lo in range(0, npix, pb):
            n_valid = min(pb, npix - lo)
            ids = np.zeros(pb, np.int32)
            ids[:n_valid] = order[lo : lo + n_valid]
            out = rng.normal(size=(pb, 3)).astype(np.float32) * np.float32(10.0 ** rng.integers(-3, 4))
            out[n_valid:] = np.array([np.nan, np.inf, -7.0], dtype=np.float32)
            out[0, 1] = -0.0
            want[ids[:n_valid]] += out[:n_valid].astype(np.float64)
            film_kernel.add(got, torch.from_numpy(out), torch.from_numpy(ids), n_valid)
    assert got.numpy().tobytes() == want.tobytes()


def test_render_image_resolves_the_checkpointed_film(tmp_path):
    compiled, cam = _small()
    ck = str(tmp_path / "film.npz")
    img, mean, stats = R.render_image(compiled, cam, checkpoint_path=ck, **KW)
    assert stats.launches == 8 and stats.host_free_launches == 0  # the film crossed to the host
    film = np.load(ck)["film"]
    h, w = cam.image_height, cam.image_width
    want = (film / cam.samples_per_pixel).reshape(h, w, 3)
    assert img.tobytes() == tonemap_quantize(want).tobytes() and img.shape == (h, w, 3)
    assert mean.tobytes() == want.astype(np.float32).tobytes() and mean.dtype == np.float32
    _, plain, _ = R.render_image(compiled, cam, **KW)
    assert plain.tobytes() == mean.tobytes()


def test_on_launch_gets_the_film_so_far():
    compiled, cam = _small()
    seen = []
    _, mean, stats = R.render_image(compiled, cam, on_launch=lambda m, f: seen.append((m.copy(), f)), **KW)
    assert len(seen) == stats.launches == 8 and stats.host_free_launches == 0
    assert seen[-1][1] == 1.0 and seen[-1][0].tobytes() == mean.tobytes()
    assert all(m.dtype == np.float32 and m.shape == mean.shape for m, _ in seen)


def test_a_second_call_is_host_free_and_returns_arrays_of_its_own():
    compiled, cam = _small()
    img1, mean1, st1 = R.render_image(compiled, cam, seed=4, **KW)
    keep_img, keep_mean = img1.copy(), mean1.copy()
    img2, mean2, st2 = R.render_image(compiled, cam, seed=4, **KW)
    assert st1.launches == st2.launches == 8
    assert st1.host_free_launches == 0 and st2.host_free_launches == st2.launches
    for a in (img1, mean1):
        for b in (img2, mean2):
            assert not np.shares_memory(a, b)
    assert img1.tobytes() == keep_img.tobytes() == img2.tobytes()
    assert mean1.tobytes() == keep_mean.tobytes() == mean2.tobytes()
    img2[...] = 0  # the caller owns its arrays: a third call is not moved by an edit of them
    img3, _, st3 = R.render_image(compiled, cam, seed=4, **KW)
    assert img3.tobytes() == keep_img.tobytes() and st3.host_free_launches == 8


@pytest.mark.parametrize("w,h", [(1, 1), (12, 8), (7, 13), (64, 36), (600, 337)])
def test_the_kept_order_is_the_morton_order(w, h):
    order = R._pixel_order(w, h)
    assert np.array_equal(order, R._morton_pixel_order(w, h)) and not order.flags.writeable
    assert R._pixel_order(w, h) is order
    pb = max(1, (w * h) // 3 + 1)
    sched = R._Schedule(order, torch.device("cpu"), pb, 2, 4, 16, 8, 0, w)
    blocks = [sched.launch(b, 0) for b in range(-(-w * h // pb))]
    assert np.array_equal(np.concatenate([ids[:n].numpy() for ids, n, _, _ in blocks]), order)
    assert all(not ids[n:].any() for ids, n, _, _ in blocks)  # padding takes id 0
    ids, n, (pix, rows, cols, sample0, n_work0), kept = sched.launch(0, 1)
    assert kept is False and sched.launch(0, 1)[3] is True
    assert torch.equal(pix, ids.repeat(2)) and torch.equal(rows * w + cols, pix)
    want = R.lane_first_samples(pb, n, 2, 4, 8, 16)
    assert np.array_equal(sample0.numpy(), want) and n_work0 == int((want < 16).sum())


def test_a_scene_keeps_its_last_schedules():
    """At most KEPT_SCHEDULES launch schedules stay on a compiled scene; a schedule used again
    is the kept one and moves to the back, and the least recently used goes first."""
    compiled = types.SimpleNamespace(data=types.SimpleNamespace(device=torch.device("cpu")))
    n = R.KEPT_SCHEDULES

    def sched(spp):
        return R._schedule(compiled, 12, 8, 32, 1, spp, spp, spp, 1, 0)

    first = [sched(spp) for spp in range(1, n + 1)]
    assert sched(1) is first[0]  # spp 1 is now the most recently used
    sched(n + 1)
    kept = compiled._render_schedules
    assert len(kept) == n and [key[5] for key in kept] == [*range(3, n + 1), 1, n + 1]
    assert sched(2) is not first[1] and len(kept) == n


def _run(traffic, rec):
    return types.SimpleNamespace(workload={"traffic": traffic}, program={}, program_trace=rec)


def _read(run):
    return spec.module("metrics", "host_free.frame").read(run)


def _recording(attrs):
    rec = Recording()
    for i, a in enumerate(attrs):
        rec.spans.append(Span(2 * i, None, 2 * i, "render", 100 * i * MS, (100 * i + 90) * MS, a))
        rec.spans.append(Span(2 * i + 1, 2 * i, 2 * i, "render.wait", 100 * i * MS, (100 * i + 80) * MS, {}))
    return rec


def test_host_free_reads_the_share_of_host_free_launches():
    rec = _recording([{"launches": 4, "host_free_launches": 1}, {"launches": 4, "host_free_launches": 4}])
    assert _read(_run("frames", rec)) == pytest.approx(100.0 * 5 / 8)
    assert _read(_run("grad_steps", rec)) is None  # the metric reads frames alone


@pytest.mark.parametrize("rec", [None, Recording(), _recording([{"launches": 1}]),
                                 _recording([{"launches": 0, "host_free_launches": 0}])])
def test_host_free_is_silent_without_spans_or_the_counter(rec):
    """No recording, no render span, render spans without host_free_launches (a program
    whose film lives on the host, as before this counter), or no launch: nothing to read."""
    assert _read(_run("frames", rec)) is None


def test_host_free_reads_100_on_a_repeated_cpu_render():
    compiled, cam = _small()
    R.render_image(compiled, cam, **KW)
    with trace.recording() as rec:
        R.render_image(compiled, cam, **KW)
    (span,) = rec.named("render")
    assert span.attrs["host_free_launches"] == span.attrs["launches"] == 8
    assert _read(_run("frames", rec)) == 100.0
