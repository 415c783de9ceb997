"""The masked scan's stage runner (render/diff.py ``RadianceScanStages``) on the CPU.

On the card, render/graph.py captures the runner's parts into CUDA graphs whose forward
and backward loops run on the device, the route of ``render_grads`` and
``segmented_film_vjp`` there (tests/test_torch_cuda.py and chip_smoke.py hold it against
the eager route). Here the same parts run from the host:
- the runner against the eager ``render_grads`` (autograd of the checkpointed masked scan)
  and the eager ``segmented_film_vjp`` (a segment's replay at a time): radiance bit for
  bit, rays equal; each gradient field within relative L1 1e-6 of the eager one (a trip's
  gradient is summed before it joins the total; a field the eager route leaves at zero
  stays zero). Cases: segments of 8 and 0 (no gate), a max_depth that is not a multiple
  of the segment (12), the flat clusters (K2's plain version), lanes all dead after the
  first segment, chunks of one segment;
- a mesh of 2 gloo ranks (tests/torch_sharding_worker.py): one collective a segment on
  each rank, gated or not, as the eager route issues; the chunks summed in its order;
- the runner against the reference's ``render_grads`` on the box scene with a cotangent
  from a numpy seed, at tests/test_torch_grad_ref.py's relative L1 2e-2;
- the gate with k = 1 and spp_limit = 0 counts the live lanes; the stamps of the two
  kinds of graphs; the kept graphs' cache is its owner's alone.
"""

import functools
import os

import torch_cpu_warmup  # noqa: F401  (MKL's first vector-math call, on one thread)
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_sharding_worker as W
from tpupt.render import diff as JD
from tpupt_torch.ops import loop_cond
from tpupt_torch.render import diff as D
from tpupt_torch.render import graph as G

from chip_smoke import grad_box_scene
from test_torch_grad_graph import _case, assert_grads_match
from test_torch_grad_ref import assert_grads_close, configs

CPU = torch.device("cpu")
JOIN_S = 120  # a spawned rank's own timeout
# (case of test_torch_grad_graph, segment_size, max_depth or None: the case's)
CASES = {"box": ("box", 8, None), "box, no gate": ("box", 0, None), "cornell, depth 12": ("cornell", 8, 12),
         "mesh": ("mesh", 8, 6), "cornell, depth 20, no gate": ("cornell", 0, 20)}


def lanes(cam, ids, spp, cotangent=None):
    """render_grads' lanes: (pixel, row, col, sample id [npix*spp], cotangent [npix*spp, 3])."""
    ids = torch.as_tensor(ids, dtype=torch.int32)
    pix = torch.repeat_interleave(ids, spp)
    samp = torch.arange(spp, dtype=torch.int32).repeat(ids.shape[0])
    c = torch.ones((ids.shape[0], 3)) if cotangent is None else torch.as_tensor(cotangent, dtype=torch.float32)
    cot = c[:, None, :].expand(ids.shape[0], spp, 3).reshape(-1, 3) / spp
    return pix, pix // cam.image_width, pix % cam.image_width, samp, cot


def runner(compiled, cam, ids, spp, seed=0, cotangent=None, segment_size=D.SEGMENT, chunk=None, log=None):
    """render_grads by RadianceScanStages.run() -> (radiance [npix,3], grads, rays, trips, stages)."""
    pix, rows, cols, samp, cot = lanes(cam, ids, spp, cotangent)
    st = D.RadianceScanStages(compiled.data, cam.init(CPU), pix.shape[0], cam.max_depth, compiled.has_lights,
                              CPU, segment_size=segment_size, chunk=chunk)
    st.set_inputs(pix, rows, cols, samp, D.init_params(compiled.data), cot, seed)
    out, grads, rays, trips = st.run(log=log)
    radiance = out.reshape(-1, spp, 3).mean(dim=1)
    return radiance, {n: g.clone() for n, g in grads.items()}, rays, trips, st


@functools.lru_cache(maxsize=None)
def _setup(name):
    case, segment, depth = CASES[name]
    compiled, cam = _case(case)
    if depth is not None:
        cam.max_depth = depth
    return compiled, cam, np.arange(cam.image_width * cam.image_height, dtype=np.int32), segment


@pytest.mark.parametrize("name", sorted(CASES))
def test_runner_matches_eager_render_grads(name):
    compiled, cam, ids, segment = _setup(name)
    rad_e, g_e, rays_e = D.render_grads(compiled, cam, ids, 4, seed=0, segment_size=segment, return_stats=True)
    log = []
    rad, g, rays, trips, st = runner(compiled, cam, ids, 4, segment_size=segment, log=log)
    assert torch.equal(rad.view(torch.int32), rad_e.view(torch.int32))
    assert rays == rays_e and 0 < trips <= cam.max_depth
    assert_grads_match(g, g_e)
    assert float(g["tex_rgb"].abs().sum()) > 0.0
    # the gate: trips go on inside a segment, stop at a boundary with no lane alive or at max_depth
    fwd = [(t, n, go) for phase, t, n, go in log if phase == "forward"]
    assert fwd[-1][2] == 0 and fwd[-1][0] == trips
    assert trips == cam.max_depth or (trips % st.segment == 0 and fwd[-1][1] == 0)
    assert [t for phase, t, _, _ in log if phase == "backward"] == list(range(trips - 1, -2, -1))


@pytest.mark.parametrize("name", ["box", "cornell, depth 12"])
def test_runner_matches_eager_segmented_vjp(name):
    """Against the eager segmented_film_vjp (no mesh): a segment's replay at a time."""
    compiled, cam, ids, segment = _setup(name)
    sd = compiled.data
    pix, rows, cols, samp, cot = lanes(cam, ids, 4)
    rad_e, g_e = D.segmented_film_vjp(D.init_params(sd), sd, cam.init(CPU), pix, rows, cols, samp, 0,
                                      cam.max_depth, compiled.has_lights, cot, segment_size=segment)
    rad, g, _, _, _ = runner(compiled, cam, ids, 4, segment_size=segment)
    assert torch.equal(rad.view(torch.int32), rad_e.reshape(-1, 4, 3).mean(1).view(torch.int32))
    assert_grads_match(g, g_e)


def test_lanes_all_dead_after_the_first_segment():
    """dead_rank_lanes' rank 0: every path misses at bounce 0, so the gate stops at the first
    segment boundary (8 trips of 24), as the eager route skips the later segments."""
    scene, cam, pix, samples = W.dead_rank_lanes(0)
    compiled = scene.compile(device="cpu")
    ids = pix.reshape(-1, 8)[:, 0].numpy()
    rad_e, g_e, rays_e = D.render_grads(compiled, cam, ids, 8, seed=0, return_stats=True)
    log = []
    rad, g, rays, trips, _ = runner(compiled, cam, ids, 8, log=log)
    assert trips == D.SEGMENT < cam.max_depth and rays == rays_e == pix.shape[0]
    assert [(t, n, go) for phase, t, n, go in log if phase == "forward"][-1] == (D.SEGMENT, 0, 0)
    assert torch.equal(rad.view(torch.int32), rad_e.view(torch.int32))
    assert_grads_match(g, g_e)


@pytest.mark.parametrize("chunk", [D.SEGMENT, 2 * D.SEGMENT])
def test_chunked_runs_equal_one_chunk(chunk, monkeypatch):
    """Chunks of one and two segments (their rows stashed and brought back newest first)
    give one chunk's radiance, rays, trips and gradients bit for bit."""
    compiled, cam, ids, _ = _setup("cornell, depth 12")
    one = runner(compiled, cam, ids, 4)
    assert one[4].chunk_trips >= one[3] > D.SEGMENT
    stashed = []
    stash = D.RadianceScanStages.stash
    monkeypatch.setattr(D.RadianceScanStages, "stash", lambda self, n: stashed.append(n) or stash(self, n))
    cut = runner(compiled, cam, ids, 4, chunk=chunk)
    assert stashed == [chunk] * ((one[3] - 1) // chunk)
    assert torch.equal(cut[0].view(torch.int32), one[0].view(torch.int32)) and cut[2:4] == one[2:4]
    for n, g in one[1].items():
        assert torch.equal(cut[1][n].view(torch.int32), g.view(torch.int32)), n


def test_runner_at_two_seeds():
    """One runner, two calls at two seeds: each equals the eager route at its seed."""
    compiled, cam, ids, _ = _setup("box")
    st = None
    for seed in (3, 0):
        pix, rows, cols, samp, cot = lanes(cam, ids, 4)
        if st is None:
            st = D.RadianceScanStages(compiled.data, cam.init(CPU), pix.shape[0], cam.max_depth,
                                      compiled.has_lights, CPU)
        st.set_inputs(pix, rows, cols, samp, D.init_params(compiled.data), cot, seed, cam.init(CPU))
        out, g, rays, _ = st.run()
        rad_e, g_e, rays_e = D.render_grads(compiled, cam, ids, 4, seed=seed, return_stats=True)
        assert torch.equal(out.reshape(-1, 4, 3).mean(1).view(torch.int32), rad_e.view(torch.int32))
        assert rays == rays_e
        assert_grads_match(g, g_e)


def test_mesh_of_two_gloo_ranks(tmp_path):
    """Two ranks on dead_rank_lanes (rank 0's lanes die at bounce 0, rank 1's live past
    bounce 8), chunks of one segment: each rank's runner issues one all-reduce a
    segment (3), as the eager segmented_film_vjp does, the gated ones with zeros; its
    radiance is the eager route's bit for bit and its summed gradients within relative L1
    1e-6 of the eager route's, and within rtol 1e-5 of the sum of each rank's own."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=W.radiance_runner_worker, args=(r, 2, str(tmp_path / "store"), str(tmp_path)))
             for r in range(2)]
    for p in procs:
        p.start()
    for r, p in enumerate(procs):
        p.join(JOIN_S)
        if p.is_alive():
            p.kill()
            p.join(10)
        assert p.exitcode == 0, f"rank {r} exited with {p.exitcode}"
    ranks = [torch.load(os.path.join(tmp_path, f"radiance_rank{r}.pt"), weights_only=False) for r in range(2)]
    want = {}
    for rank in (0, 1):
        scene, cam, pix, samples = W.dead_rank_lanes(rank)
        _, g = W.dead_rank_vjp(scene.compile(device="cpu"), cam, pix, samples)
        want = {k: want.get(k, 0) + v for k, v in g.items()}
    n_seg = -(-24 // D.SEGMENT)
    for rank, res in enumerate(ranks):
        rad_e, g_e, calls_e = res["eager"]
        out, g, calls, rays, trips, log = res["runner"]
        assert calls == calls_e == n_seg
        assert (trips == D.SEGMENT) if rank == 0 else (trips > D.SEGMENT)
        assert torch.equal(out.view(torch.int32), rad_e.view(torch.int32))
        assert_grads_match(g, g_e)
        for k, ref in want.items():
            np.testing.assert_allclose(g[k].numpy(), ref.numpy(), rtol=1e-5, atol=1e-7, err_msg=k)
        # one countdown a segment run: each stops at its segment's first trip
        stops = [t for phase, t, _, go in log if phase == "backward" and not go]
        assert stops == [t0 - 1 for t0 in range(0, trips, D.SEGMENT)][::-1]
    assert float(ranks[0]["runner"][1]["mat_params"].abs().sum()) > 0.0


def test_runner_matches_reference_render_grads():
    """The runner against the reference's jitted render_grads on the box scene, a per-pixel
    cotangent from a numpy seed: tests/test_torch_grad_ref.py's tolerances. The weights are
    positive, as that file's ones are: its relative L1 bound is a share of paths that branch
    differently under the reference's contracted multiply-adds, which holds for sums whose
    terms do not cancel."""
    jc, jcam, tc, tcam = configs("box")
    ids = np.arange(jcam.image_width * jcam.image_height, dtype=np.int32)
    cot = np.random.default_rng(5).uniform(0.25, 1.0, size=(len(ids), 3)).astype(np.float32)
    jr, jg = JD.render_grads(jc, jcam, ids, spp=4, seed=0, cotangent=cot)
    tr, tg, _, _, _ = runner(tc, tcam, ids, 4, cotangent=cot)
    close = np.isclose(tr.numpy(), np.asarray(jr), rtol=1e-3, atol=1e-4).all(-1)
    assert close.mean() >= 0.95, close.mean()
    assert_grads_close(tg, jg)
    assert float(np.abs(np.asarray(jg["tex_rgb"])).sum()) > 0.0


def test_gate_counts_live_lanes_with_no_samples():
    """With k = 1, spp_limit = 0 and no sample counts, K5's gate predicate is `alive`: the
    masked scan's gate reads its lanes' alive flags, and decides as the eager route's host
    read does at a segment boundary, and by the cap and the chunk's end inside one."""
    rng = np.random.default_rng(1)
    for p in (0.0, 0.3, 1.0):
        alive = torch.from_numpy(rng.uniform(size=777) < p)
        zeros = torch.zeros(777, dtype=torch.int32)
        for t in (0, 3, 8, 12):
            trips, chunk = torch.tensor([t]), torch.tensor([0, 16])
            out = loop_cond.grad_gate(alive, zeros, zeros, 1, 0, 8, 12, trips, chunk)
            n = int(alive.sum())
            assert out.tolist() == [n, int(t < 12 and (t % 8 != 0 or n > 0))]


def test_render_stamp_follows_the_parameters_too():
    """The gradient graphs take the parameters as inputs (their stamp holds their shapes);
    the render's graphs read them where they lie, so a replaced or edited parameter tensor
    moves their stamp, as the geometry does."""
    compiled, _ = _case("box")
    sd = compiled.data
    grad, render = G._stamp(sd), G._stamp(sd, inputs=())
    with torch.no_grad():
        sd.tex_rgb.add_(0.0)
    assert G._stamp(sd) == grad and G._stamp(sd, inputs=()) != render
    render = G._stamp(sd, inputs=())
    sd.mat_params = sd.mat_params.clone()
    assert G._stamp(sd) == grad and G._stamp(sd, inputs=()) != render


def test_kept_graphs_belong_to_their_owner():
    """_kept makes a configuration's graphs once and returns them while the stamp holds; a
    shallow copy of the owner (apply_params copies a SceneData) keeps a cache of its own."""

    class Fake:
        def __init__(self, stamp):
            self.stamp, self.closed = stamp, False

        def close(self):
            self.closed = True

    scene, _ = grad_box_scene(4, 1)
    sd = scene.compile(device="cpu").data
    made = []
    make = lambda: made.append(Fake("a")) or made[-1]  # noqa: E731
    first = G._kept(sd, "_test_graphs", ("k",), "a", make)
    assert G._kept(sd, "_test_graphs", ("k",), "a", make) is first and len(made) == 1
    copy = D.apply_params(sd, {})
    assert G._kept(copy, "_test_graphs", ("k",), "a", make) is not first and len(made) == 2
    assert G._kept(sd, "_test_graphs", ("k",), "a", make) is first
    moved = G._kept(sd, "_test_graphs", ("k",), "b", lambda: Fake("b"))
    assert moved is not first and first.closed
