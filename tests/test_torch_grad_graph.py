"""The gradient pass's stage runner (render/diff.py ``FilmScanStages``) on the CPU.

On the card, render/graph.py captures the runner's parts into CUDA graphs whose forward
and backward loops run on the device (tests/test_torch_cuda.py and chip_smoke.py hold that
route against the eager route there). Here the same parts run from the host:
- the runner against the eager ``render_film_grads`` (checkpointed trips, autograd) on the
  box, the Cornell box, an HDR-map scene (principled, metal), a mesh on the flat clusters (K2's plain version), 60000 triangles
  on the two-level clusters (K3's) and the mesh on the BVH (K4's): film bit for bit, trips
  and rays equal; each gradient field within relative L1 1e-6 of the eager one, since the
  runner sums a trip's gradient before adding it to the total and autograd adds each
  contribution to the total as it comes (a field the eager route leaves at zero stays zero);
- runs cut into chunks of one and two segments against one chunk, bit for bit;
- a tensor seed against an int seed through generate_rays and bounce_step, bit for bit;
- parameters edited in place between two calls: the second call reads the new values;
- the gate and the countdown (K5's new modes) by their plain versions at every trip, every
  segment boundary, the trip cap and a chunk's end; the stamp that tells the graphs that a
  scene moved; the chunk's size under the staging budget.
The runner against the reference's render_film_grads is in test_torch_film_grads_ref.py.
"""

import functools

import torch_cpu_warmup  # noqa: F401  (MKL's first vector-math call, on one thread)
import numpy as np
import pytest
import torch

from tpupt_torch.ops import loop_cond
from tpupt_torch.render import diff as D
from tpupt_torch.render import graph as G
from tpupt_torch.render.camera import generate_rays
from tpupt_torch.render.integrator import _mis_probs, bounce_step
from tpupt_torch.scenes import cornell_box_scene

from chip_smoke import grad_box_scene, grad_hdr_scene, random_mesh_scene
from test_torch_cuda import _mesh_scene

CPU = torch.device("cpu")
CASES = ["box", "cornell", "hdr", "mesh", "two_level", "bvh"]


def _case(name):
    """(compiled scene on the CPU, camera) of a small gradient case, 8x8 at 4 spp."""
    if name == "box":
        scene, cam = grad_box_scene(8, 4)
    elif name == "hdr":
        scene, cam = grad_hdr_scene(8, 4)
    elif name == "cornell":
        scene, cam = cornell_box_scene(8, 4)
        cam.max_depth = 12
    elif name == "two_level":
        scene, cam = random_mesh_scene(8, 4)
    else:
        scene, cam = _mesh_scene(8, 4)
    compiled = scene.compile(device="cpu", bvh=True if name == "bvh" else None)
    route = {"mesh": compiled.data.has_tri_clusters, "two_level": compiled.data.has_tri_clusters_hbm,
             "bvh": compiled.data.has_tri_bvh}.get(name, True)
    assert route, name
    return compiled, cam


def stage_run(compiled, cam, spp=4, replicas=2, seed=0, chunk=None, stages=None):
    """render_film_grads' pass by FilmScanStages.run() -> (mean [H,W,3], grads, rays, trips,
    stages). stages, if given, is reused (its inputs copied in anew)."""
    pix, rows, cols, s0, cot, r, k = D.film_lanes(cam, spp, replicas, None, CPU)
    if stages is None:
        stages = D.FilmScanStages(compiled.data, cam.init(CPU), pix.shape[0], spp, k, cam.max_depth,
                                  compiled.has_lights, CPU, chunk=chunk)
    stages.set_inputs(pix, rows, cols, s0, D.init_params(compiled.data), cot, seed)
    film, grads, rays, trips = stages.run()
    mean = (film.reshape(r, -1, 3).sum(0) / spp).reshape(cam.image_height, cam.image_width, 3)
    return mean, {n: g.clone() for n, g in grads.items()}, rays, trips, stages


@functools.lru_cache(maxsize=None)
def _runs(name):
    """(eager (mean, grads, GradStats), runner (mean, grads, rays, trips), camera) of a case."""
    compiled, cam = _case(name)
    eager = D.render_film_grads(compiled, cam, spp=4, seed=0, replicas=2, return_stats=True)
    return eager, stage_run(compiled, cam)[:4], cam


def assert_grads_match(got, ref, rel_l1=1e-6):
    """Each field within relative L1 rel_l1 of ref; a field that is zero in ref is zero."""
    assert set(got) == set(ref)
    for n, g in ref.items():
        assert got[n].shape == g.shape and bool(torch.isfinite(got[n]).all()), n
        total = float(g.abs().sum())
        err = float((got[n] - g).abs().sum())
        assert (err == 0.0) if total == 0.0 else err <= rel_l1 * total, (n, err, total)


@pytest.mark.parametrize("name", CASES)
def test_stage_runner_matches_eager_route(name):
    (mean_e, g_e, st), (mean, g, rays, trips), cam = _runs(name)
    assert torch.equal(mean.view(torch.int32), mean_e.view(torch.int32))
    assert (rays, trips) == (st.rays, st.trips) and trips > 0
    assert_grads_match(g, g_e)
    assert float(g["tex_rgb"].abs().sum()) > 0.0
    # the eager route reads the device once a segment it gates, and the rays once
    cap = D.trip_cap(2, cam.max_depth, D.SEGMENT)
    assert st.host_reads == trips // D.SEGMENT + (trips < cap) + 1 and st.chunks == 0 and st.capture_s == 0.0


@pytest.mark.parametrize("segments", [1, 2])
def test_chunked_runs_equal_one_chunk(segments, monkeypatch):
    """Chunks of one and two segments (their rows stashed in stores and brought back newest
    first) give one chunk's film, rays, trips and gradients bit for bit."""
    compiled, cam = _case("box")
    one = stage_run(compiled, cam)
    assert one[4].chunk_trips >= one[3]  # the default budget holds the whole pass here
    stashed = []
    stash = D.FilmScanStages.stash
    monkeypatch.setattr(D.FilmScanStages, "stash", lambda self, n: stashed.append(n) or stash(self, n))
    cut = stage_run(compiled, cam, chunk=segments * D.SEGMENT)
    c = segments * D.SEGMENT
    assert stashed == [c] * ((one[3] - 1) // c)  # every chunk but the newest
    assert torch.equal(cut[0].view(torch.int32), one[0].view(torch.int32))
    assert cut[2:4] == one[2:4]
    for n, g in one[1].items():
        assert torch.equal(cut[1][n].view(torch.int32), g.view(torch.int32)), n


def test_tensor_seed_equals_int_seed():
    """The graphs read the seed from a 0-d int64 tensor: generate_rays and bounce_step give
    an int seed's bits with it."""
    compiled, cam = _case("cornell")
    sd, c = compiled.data, cam.init(CPU)
    pix, rows, cols, s0, _, _, _ = D.film_lanes(cam, 4, 2, None, CPU)
    seed = 0x9E3779B9  # above 2^31: the uint32 wrap of the reference's cast
    a = generate_rays(c, rows, cols, pix, s0, seed)
    b = generate_rays(c, rows, cols, pix, s0, torch.tensor(seed, dtype=torch.int64))
    for x, y in zip(a, b):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))
    o, d, time = a
    n = o.shape[0]
    T, L, alive = torch.ones((n, 3)), torch.zeros((n, 3)), torch.ones(n, dtype=torch.bool)
    p_light, p_bsdf = _mis_probs(compiled.has_lights)
    outs = [bounce_step(sd, o, d, time, T, L, alive, 6, pix, s0, s, p_light, p_bsdf, compiled.has_lights,
                        detach=True) for s in (seed, torch.tensor(seed, dtype=torch.int64))]
    for x, y in zip(*outs):
        assert torch.equal(x.view(torch.int32) if x.is_floating_point() else x,
                          y.view(torch.int32) if y.is_floating_point() else y)


def test_parameters_edited_in_place_are_read():
    """Two calls of one FilmScanStages: the caller's parameters are copied in at each call
    (the leaves never alias them), so an edit in place between the calls is what the second
    call reads; its film and gradients are the eager route's on the edited scene."""
    compiled, cam = _case("box")
    sd = compiled.data
    first = stage_run(compiled, cam)
    stages = first[4]
    assert all(stages.leaves[n].data_ptr() != getattr(sd, n).data_ptr() for n in D.DIFF_FIELDS)
    with torch.no_grad():
        sd.tex_rgb.mul_(0.5)
        sd.env_color.add_(0.25)
    second = stage_run(compiled, cam, stages=stages)
    mean_e, g_e, st = D.render_film_grads(compiled, cam, spp=4, seed=0, replicas=2, return_stats=True)
    assert not torch.equal(second[0], first[0])
    assert torch.equal(second[0].view(torch.int32), mean_e.view(torch.int32)) and second[3] == st.trips
    assert_grads_match(second[1], g_e)


def _gate(trips, n_work, cap, end, segment):
    """The reference's schedule: trips go on inside a segment, at a segment boundary while
    a lane has work, never past the cap or the chunk's end."""
    return trips < cap and trips < end and (trips % segment != 0 or n_work > 0)


@pytest.mark.parametrize("segment", [1, 3, 8])
def test_gate_plain_at_every_trip(segment):
    rng = np.random.default_rng(segment)
    n, k, spp = 500, 4, 16
    sample0 = torch.from_numpy(rng.integers(0, spp, n).astype(np.int32))
    cap = D.trip_cap(k, 5, segment)
    chunk_len = 2 * segment
    for work in (True, False):
        alive = torch.from_numpy(rng.uniform(size=n) < (0.2 if work else 0.0))
        sample = torch.full((n,), k if not work else 1, dtype=torch.int32)
        n_work = int(loop_cond.work_mask(alive, sample, sample0, k, spp).sum())
        assert (n_work > 0) == work
        for c0 in range(0, cap + 1, chunk_len):
            chunk = torch.tensor([c0, c0 + chunk_len])
            for t in range(c0, min(c0 + chunk_len, cap) + 1):
                for bump in (False, True):
                    trips = torch.tensor([t - bump])
                    out = loop_cond.grad_gate(alive, sample, sample0, k, spp, segment, cap, trips, chunk, bump)
                    assert int(trips) == t
                    assert out.tolist() == [n_work, int(_gate(t, n_work, cap, c0 + chunk_len, segment))], (t, bump)


def test_countdown_plain_to_the_chunks_first_trip():
    chunk = torch.tensor([16, 24])
    index, replays = torch.tensor([23]), torch.tensor([0])
    seen = [loop_cond.grad_countdown(index, chunk, replays).tolist()]
    while seen[-1][1]:
        seen.append(loop_cond.grad_countdown(index, chunk, replays, bump=True).tolist())
    assert seen == [[j, int(j >= 16)] for j in range(23, 14, -1)]
    assert int(replays) == 8 and int(index) == 15


def test_gate_and_countdown_check_their_arguments():
    alive, sample = torch.zeros(4, dtype=torch.bool), torch.zeros(4, dtype=torch.int32)
    chunk, trips = torch.tensor([0, 8]), torch.tensor([0])
    with pytest.raises(ValueError, match="trips"):
        loop_cond.grad_gate(alive, sample, sample, 1, 1, 8, 8, torch.tensor([0], dtype=torch.int32), chunk)
    with pytest.raises(ValueError, match="segment"):
        loop_cond.grad_gate(alive, sample, sample, 1, 1, 0, 8, trips, chunk)
    with pytest.raises(TypeError, match="sample"):
        loop_cond.grad_gate(alive, sample.float(), sample, 1, 1, 8, 8, trips, chunk)
    with pytest.raises(ValueError, match="chunk"):
        loop_cond.grad_countdown(trips, torch.tensor([0]), torch.tensor([0]))


def test_stamp_follows_the_geometry_not_the_parameters():
    """The graphs are kept while the stamp holds: an edit in place of a parameter leaves it,
    one of the geometry, a replaced tensor or another static field moves it."""
    compiled, _ = _case("box")
    sd = compiled.data
    stamp = G._stamp(sd)
    with torch.no_grad():
        sd.mat_params.mul_(1.0)
        sd.tex_rgb.add_(0.0)
    assert G._stamp(sd) == stamp
    sd.quad_q.add_(0.0)
    assert G._stamp(sd) != stamp
    stamp = G._stamp(sd)
    sd.sph_r = sd.sph_r.clone()
    assert G._stamp(sd) != stamp
    stamp = G._stamp(sd)
    sd.has_checker = not sd.has_checker
    assert G._stamp(sd) != stamp


def test_chunk_size_under_the_staging_budget():
    lanes = 65536
    row = D._row_bytes(lanes)
    assert row == -(-77 * lanes // 16) * 16
    assert D.chunk_trips(lanes, 8, 50, 8, budget=10 * row) == 8  # whole segments under the budget
    assert D.chunk_trips(lanes, 8, 50, 8, budget=row) == 8  # at least one segment
    assert D.chunk_trips(lanes, 8, 50, 8, budget=1000 * row) == D.trip_cap(8, 50, 8) == 400  # at most the cap
    with pytest.raises(ValueError, match="whole segments"):
        D.FilmScanStages(_case("box")[0].data, None, 4, 4, 2, 12, True, CPU, chunk=12)
