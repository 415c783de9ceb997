"""The stage runner of the graph route (render/integrator.py ``StreamStages``) on the CPU.

On the card, render/graph.py captures the stage runner's parts into CUDA graphs whose
loops run on the device (tests/test_torch_cuda.py and chip_smoke.py hold that route
against the eager loop there). Here the same parts run from the host:
- the stage runner against today's eager loop (``trace_film_streamed``): film bit for bit,
  rays and iterations equal, on the Cornell box (two stages) and on a seeded
  random-triangle mesh on the cluster route (the sqrt(2) ladder, three stages);
- its condition and iteration counter, kept in tensors, against the eager loop's host
  count of lanes with work, at every read;
- the stage runner's film against the reference's jitted ``_chunk_film``
  (``use_pallas_hit=False``) on the Cornell box, at tests/test_torch_render.py's
  tolerance: the film's mean within 0.5%, at least 98% of pixels within rtol 1e-3 /
  atol 1e-4 (the two packages' float32 transcendentals differ by an ulp, which flips a
  rare branch);
- the condition's plain version, its argument checks, and the host's first-sample
  schedule against the reference's formula.
"""

import functools

import torch_cpu_warmup  # noqa: F401  (MKL's first vector-math call, on one thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpupt.render.renderer import _chunk_film as j_chunk_film
from tpupt.scenes import SCENES as JSCENES
from tpupt_torch.ops import loop_cond
from tpupt_torch.render import renderer as R
from tpupt_torch.render.camera import Camera
from tpupt_torch.render.integrator import StreamStages, compaction_thresholds, trace_film_streamed
from tpupt_torch.scene.builder import Diffuse, Light, Scene
from tpupt_torch.scenes import SCENES as TSCENES

CPU = torch.device("cpu")


def _random_mesh(width, spp):
    """1500 seeded random triangles in a blob under a quad light (tests/test_pallas_tri.py's
    recipe), max_depth 6: the flat cluster route."""
    rng = np.random.default_rng(7)
    n = 1500
    pos = (rng.normal(size=(n, 1, 3)) * 1.5 + rng.normal(size=(n, 3, 3)) * 0.3).reshape(-1, 3)
    s = Scene()
    s.add_mesh(dict(positions=pos, normals=None, uvs=None, indices=np.arange(3 * n).reshape(n, 3)),
               Diffuse((0.6, 0.5, 0.4)))
    s.add_quad((-2.0, 5.0, -2.0), (4.0, 0.0, 0.0), (0.0, 0.0, 4.0), Light((6.0, 6.0, 6.0)), light=True)
    s.environment = (0.2, 0.25, 0.3)
    cam = Camera(aspect_ratio=1.0, image_width=width, samples_per_pixel=spp, max_depth=6, vfov=50.0,
                 look_from=(0.0, 1.0, 8.0), look_at=(0.0, 0.0, 0.0), blur_strength=0.5,
                 focal_length=8.0, defocus_angle=0.0)
    return s, cam


# (scene, width, lanes a pixel, samples a lane, max_depth): 8192 and 4608 lanes
CASES = {"cornell": (lambda w, spp: TSCENES[3][1](w, spp), 64, 2, 2, 10),
         "mesh": (_random_mesh, 48, 2, 2, 6)}


@functools.lru_cache(maxsize=None)
def _runs(case):
    """Both runners on one launch of `case` -> (eager (film, rays, iterations, log), stages
    (film, rays, iterations, log), thresholds)."""
    build, width, r, k, depth = CASES[case]
    scene, cam = build(width, r * k)
    compiled = scene.compile(device=CPU)
    sd, c = compiled.data, cam.init(CPU)
    npix = width * cam.image_height
    pix = torch.arange(npix, dtype=torch.int32).repeat(r)
    rows, cols = pix // width, pix % width
    sample0 = torch.from_numpy(R.lane_first_samples(npix, npix, r, k, 0, r * k))
    args = (sd, c, pix, rows, cols, sample0, r * k, 0, k, depth, compiled.has_lights)
    log_e, log_s = [], []
    eager = trace_film_streamed(*args, log=log_e)
    st = StreamStages(sd, c, pix.shape[0], r * k, k, depth, compiled.has_lights, CPU)
    st.set_inputs(pix, rows, cols, sample0, 0)
    stages = st.run(log=log_s)
    return (*eager, log_e), (stages[0].clone(), *stages[1:], log_s), st.thresholds


@pytest.mark.parametrize("case", sorted(CASES))
def test_stage_runner_bit_equal_to_eager_loop(case):
    (film_e, rays_e, it_e, _), (film_s, rays_s, it_s, _), thresholds = _runs(case)
    assert len(thresholds) >= 2  # the launch compacts at least once
    assert torch.equal(film_s.view(torch.int32), film_e.view(torch.int32))
    assert (rays_s, it_s) == (rays_e, it_e) and it_e > 0


@pytest.mark.parametrize("case", sorted(CASES))
def test_stage_condition_and_counter_at_every_read(case):
    """The device-side count of lanes with work equals the host's int(work_mask(s).sum())
    at every read, in the same stages; the decision is count > threshold; the counter
    holds the iterations run before each read."""
    (_, _, it_e, log_e), (_, _, _, log_s), thresholds = _runs(case)
    assert [(i, n) for i, n, _, _ in log_s] == log_e
    done = 0
    for i, n, go, iters in log_s:
        assert go == int(n > thresholds[i])
        assert iters == done
        done += go
    assert done == it_e
    assert {i for i, _, _, _ in log_s} == set(range(len(thresholds)))


def test_stage_runner_matches_reference_chunk_film():
    """The stage runner's film of a Cornell launch against the reference's jitted
    _chunk_film with the sphere/quad sweep (use_pallas_hit=False)."""
    width, r, k, depth = 24, 2, 4, 50
    _, jbuild = JSCENES[3]
    js, jcam = jbuild(width, r * k)
    jc = js.compile()
    assert not jc.data.use_pallas_hit
    npix = width * jcam.image_height
    ids = np.arange(npix, dtype=np.int32)
    film_j, rays_j = j_chunk_film(jc.data, jcam.init(), jnp.asarray(ids), npix, 0, r * k, jnp.uint32(0), k=k,
                                  r=r, max_depth=depth, has_lights=jc.has_lights, width=width)
    ts, tcam = TSCENES[3][1](width, r * k)
    tc = ts.compile(device=CPU)
    pix = torch.from_numpy(ids).repeat(r)
    st = StreamStages(tc.data, tcam.init(CPU), pix.shape[0], r * k, k, depth, tc.has_lights, CPU)
    st.set_inputs(pix, pix // width, pix % width, torch.from_numpy(R.lane_first_samples(npix, npix, r, k, 0, r * k)),
                  0)
    bank, rays, iters = st.run()
    film_t = bank.reshape(r, npix, 3).sum(dim=0).numpy()
    film_j = np.asarray(jax.device_get(film_j))
    assert iters > 0 and rays > 0 and int(rays_j) > 0
    np.testing.assert_allclose(film_t.mean(), film_j.mean(), rtol=5e-3)
    close = np.isclose(film_t / (r * k), film_j / (r * k), rtol=1e-3, atol=1e-4, equal_nan=True).all(-1).mean()
    assert close >= 0.98, close


@pytest.mark.parametrize("pb,n_valid,r,k,sample0,spp_limit", [
    (16, 16, 1, 4, 0, 4), (16, 11, 3, 2, 0, 6), (10, 7, 4, 3, 5, 12), (8, 8, 2, 5, 9, 12), (5, 0, 2, 1, 0, 2),
])
def test_lane_first_samples_is_the_reference_formula(pb, n_valid, r, k, sample0, spp_limit):
    """The host's first samples equal the reference's device formula (_chunk_film_body);
    their count below spp_limit is the lanes that start with work."""
    got = R.lane_first_samples(pb, n_valid, r, k, sample0, spp_limit)
    lane = sample0 + jnp.repeat(jnp.arange(r, dtype=jnp.int32) * k, pb)
    ref = np.asarray(jnp.where(jnp.tile(jnp.arange(pb, dtype=jnp.int32) < n_valid, r), lane, spp_limit))
    assert got.dtype == np.int32 and np.array_equal(got, ref)
    work = loop_cond.work_mask(torch.zeros(r * pb, dtype=torch.bool), torch.zeros(r * pb, dtype=torch.int32),
                               torch.from_numpy(got), k, spp_limit)
    assert int(work.sum()) == int((got < spp_limit).sum())


@pytest.mark.parametrize("thr_offset", [-1, 0, 1])
def test_stage_cond_plain(thr_offset):
    """The count of lanes with work, go = count > thr, and the counter's bump."""
    rng = np.random.default_rng(3)
    n = 1000
    alive = torch.from_numpy(rng.uniform(size=n) < 0.2)
    sample = torch.from_numpy(rng.integers(0, 6, n).astype(np.int32))
    sample0 = torch.from_numpy(rng.integers(0, 20, n).astype(np.int32))
    want = int((alive.numpy() | ((sample.numpy() < 4) & (sample0.numpy() + sample.numpy() < 16))).sum())
    thr = max(want + thr_offset, 0)
    iters = torch.zeros(1, dtype=torch.int64)
    out = loop_cond.stage_cond(alive, sample, sample0, 4, 16, thr, iters, bump=True)
    assert out.tolist() == [want, int(want > thr)] and int(iters) == 1
    assert loop_cond.stage_cond(alive, sample, sample0, 4, 16, thr).tolist() == [want, int(want > thr)]


def test_stage_cond_argument_checks():
    b = torch.zeros(8, dtype=torch.bool)
    i = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match=r"need alive, sample, sample0 \[n\]"):
        loop_cond.stage_cond(b, i[:4], i, 2, 4, 0)
    with pytest.raises(TypeError, match="sample must be"):
        loop_cond.stage_cond(b, i.to(torch.int64), i, 2, 4, 0)
    with pytest.raises(ValueError, match="must fit int32"):
        loop_cond.stage_cond(b, i, i, 0, 4, 0)
    with pytest.raises(ValueError, match="bump needs iters"):
        loop_cond.stage_cond(b, i, i, 2, 4, 0, bump=True)


def test_stage_runner_thresholds_and_reset():
    """Stage i holds n_i lanes (the launch's, then each threshold); a second run of the same
    inputs gives the same bits (reset restores stage 0, the bank and the counters)."""
    (film_e, rays_e, it_e, _), _, _ = _runs("cornell")
    build, width, r, k, depth = CASES["cornell"]
    scene, cam = build(width, r * k)
    compiled = scene.compile(device=CPU)
    npix = width * cam.image_height
    pix = torch.arange(npix, dtype=torch.int32).repeat(r)
    st = StreamStages(compiled.data, cam.init(CPU), pix.shape[0], r * k, k, depth, compiled.has_lights, CPU)
    assert st.thresholds == compaction_thresholds(pix.shape[0])
    assert [s["alive"].shape[0] for s in st.states] == [pix.shape[0]] + st.thresholds[:-1]
    st.set_inputs(pix, pix // width, pix % width, torch.from_numpy(R.lane_first_samples(npix, npix, r, k, 0, r * k)),
                  0)
    for _ in range(2):
        film, rays, iters = st.run()
        assert torch.equal(film.view(torch.int32), film_e.view(torch.int32)) and (rays, iters) == (rays_e, it_e)


def test_one_stage_runner_at_two_seeds():
    """One StreamStages run at two seeds and two cameras (seed and camera are inputs, as the
    kept graphs take them): each run bit-equal to trace_film_streamed at its seed and camera."""
    build, width, r, k, depth = CASES["cornell"]
    scene, cam = build(width, r * k)
    compiled = scene.compile(device=CPU)
    sd = compiled.data
    npix = width * cam.image_height
    pix = torch.arange(npix, dtype=torch.int32).repeat(r)
    sample0 = torch.from_numpy(R.lane_first_samples(npix, npix, r, k, 0, r * k))
    st = StreamStages(sd, cam.init(CPU), pix.shape[0], r * k, k, depth, compiled.has_lights, CPU)
    for seed, vfov in ((7, cam.vfov), (0, cam.vfov + 5.0)):
        cam.vfov = vfov
        c = cam.init(CPU)
        film_e, rays_e, it_e = trace_film_streamed(sd, c, pix, pix // width, pix % width, sample0, r * k, seed, k,
                                                   depth, compiled.has_lights)
        st.set_inputs(pix, pix // width, pix % width, sample0, seed, c)
        film, rays, iters = st.run()
        assert torch.equal(film.view(torch.int32), film_e.view(torch.int32)) and (rays, iters) == (rays_e, it_e)


def test_cpu_renders_take_the_eager_loop():
    """On the CPU render_image builds no graph (no capture time) and plain_launches changes
    nothing there."""
    scene, cam = TSCENES[3][1](16, 4)
    compiled = scene.compile(device=CPU)
    _, m_a, st_a = R.render_image(compiled, cam, progress=False)
    with R.plain_launches():
        _, m_b, st_b = R.render_image(compiled, cam, progress=False)
    assert st_a.capture_s == 0.0 and np.array_equal(m_a, m_b, equal_nan=True)
    assert (st_a.rays, st_a.iterations) == (st_b.rays, st_b.iterations) and not R._plain
