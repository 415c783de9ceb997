"""The port's sphere+quad closest hit (ops/hit_kernel.py) and closest_hit against
the reference package.

On the CPU the wrapper runs the kernel's plain version; the CUDA kernel itself is
checked against that plain version on the card (tests/test_torch_cuda.py and
chip_smoke.py).

Tolerances: hit kind, index and material must be equal on every lane. t agrees
to rtol 2e-5 / atol 1e-3 (scene units of 1-1000): XLA's CPU compiler contracts
multiply-adds into fused ones and its float32 sqrt can differ from PyTorch's by
an ulp, and both differences are amplified by the cancellations in a sphere's
s - q and a quad's d - n.o. Normals and uvs follow from t and agree to 2e-3
(a 0.2-radius sphere turns a 2e-4 t difference into 1e-3 of normal).
"""

import torch_cpu_warmup  # noqa: F401  (MKL's first vector-math call, on one thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpupt.ops.intersect import closest_hit as j_closest_hit
from tpupt.ops.pallas_hit import pallas_closest_sphere_quad
from tpupt.scene import builder as JB
from tpupt.scenes import balls_scene as j_balls
from tpupt.scenes import cornell_box_scene as j_cornell
from tpupt_torch.ops import hit_kernel
from tpupt_torch.ops.intersect import closest_hit as t_closest_hit
from tpupt_torch.scene import builder as TB
from tpupt_torch.scenes import balls_scene as t_balls
from tpupt_torch.scenes import cornell_box_scene as t_cornell

BIG = 3.0e38


def _rays(b, seed, lo, hi):
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, size=(b, 3)).astype(np.float32)
    d = rng.normal(size=(b, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t = rng.uniform(size=b).astype(np.float32)
    return o, d, t


def _moving(B):
    s = B.Scene()
    for i in range(6):
        c = (float(i) - 3.0, 0.2, 0.0)
        s.add_sphere(0.2, c, B.Diffuse((0.5, 0.4, 0.3)), center2=(c[0], 0.7, 0.0))
    s.add_quad((-10.0, 0.0, -10.0), (20.0, 0.0, 0.0), (0.0, 0.0, 20.0), B.Diffuse((0.5, 0.5, 0.5)))
    s.add_quad((-1.0, 5.0, -1.0), (2.0, 0.0, 0.0), (0.0, 0.0, 2.0), B.Light((5.0, 5.0, 5.0)), light=True)
    return s


SCENES = {
    "cornell": (lambda: j_cornell(16, 4)[0], lambda: t_cornell(16, 4)[0], 0.0, 555.0),
    "moving": (lambda: _moving(JB), lambda: _moving(TB), -8.0, 8.0),
    "balls": (lambda: j_balls(16, 4)[0], lambda: t_balls(16, 4)[0], -12.0, 12.0),
}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_closest_hit_matches_reference(name):
    jbuild, tbuild, lo, hi = SCENES[name]
    jsd = jbuild().compile().data
    tsd = tbuild().compile(device="cpu").data
    o, d, tm = _rays(2000 + 37, 3, lo, hi)
    jh = jax.jit(lambda sd, o, d, t: j_closest_hit(sd, o, d, t, jnp.float32(1e-3), jnp.float32(BIG)))(
        jsd, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm)
    )
    th = t_closest_hit(tsd, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(tm), 1e-3, BIG)
    valid = np.asarray(jh.valid)
    assert valid.mean() > 0.2  # the batch really hits things
    np.testing.assert_array_equal(th.valid.numpy(), valid)
    np.testing.assert_array_equal(th.mat_id.numpy()[valid], np.asarray(jh.mat_id)[valid])
    np.testing.assert_array_equal(th.front.numpy()[valid], np.asarray(jh.front)[valid])
    np.testing.assert_allclose(th.t.numpy()[valid], np.asarray(jh.t)[valid], rtol=2e-5, atol=1e-3)
    np.testing.assert_allclose(th.ng.numpy()[valid], np.asarray(jh.ng)[valid], atol=2e-3)
    np.testing.assert_allclose(th.u.numpy()[valid], np.asarray(jh.u)[valid], atol=2e-3)


def test_plain_matches_pallas_interpret():
    """One small batch against the Pallas kernel itself (interpret mode on the CPU)."""
    jsd = j_cornell(16, 4)[0].compile().data
    tsd = t_cornell(16, 4)[0].compile(device="cpu").data
    o, d, tm = _rays(300, 4, 0.0, 555.0)
    jt, jk, ji = pallas_closest_sphere_quad(
        jsd, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm), interpret=True
    )
    sph, quad = hit_kernel.tables(tsd)
    tt, tk, ti = hit_kernel.closest_sphere_quad(
        torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(tm), sph, quad
    )
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=2e-5, atol=1e-3)


def test_plain_tie_rules_and_misses():
    """Equal t: the lower index wins, and a sphere beats a quad; misses are (BIG, 0, 0)."""
    s = TB.Scene()
    # two identical quads and a sphere whose near point lies on their plane
    s.add_quad((-1.0, -1.0, 5.0), (2.0, 0.0, 0.0), (0.0, 2.0, 0.0), TB.Diffuse((0.5, 0.5, 0.5)))
    s.add_quad((-1.0, -1.0, 5.0), (2.0, 0.0, 0.0), (0.0, 2.0, 0.0), TB.Diffuse((0.5, 0.5, 0.5)))
    s.add_sphere(1.0, (0.0, 0.0, 6.0), TB.Diffuse((0.5, 0.5, 0.5)))
    sd = s.compile(device="cpu").data
    sph, quad = hit_kernel.tables(sd)
    o = torch.tensor([[0.0, 0.0, 0.0], [0.5, 0.5, 0.0], [0.0, 0.0, 0.0]])
    d = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0], [0.0, 0.0, -1.0]])
    t, kind, idx = hit_kernel.closest_sphere_quad(o, d, torch.zeros(3), sph, quad)
    assert t[0].item() == 5.0 and kind[0].item() == 0 and idx[0].item() == 0
    assert t[1].item() == 5.0 and kind[1].item() == 1 and idx[1].item() == 0
    assert t[2].item() == np.float32(BIG) and kind[2].item() == 0 and idx[2].item() == 0


def test_plain_large_table_many_blocks():
    """Balls' 512-row sphere table spans several sweep blocks; a per-primitive
    loop with the kernel's strict-< rule must agree exactly."""
    tsd = t_balls(16, 4)[0].compile(device="cpu").data
    sph, quad = hit_kernel.tables(tsd)
    assert sph.shape[1] > 2 * hit_kernel.PLAIN_BLOCK
    o, d, tm = (torch.from_numpy(a) for a in _rays(256, 9, -12.0, 12.0))
    t, kind, idx = hit_kernel.closest_sphere_quad_plain(o, d, tm, sph, quad)
    best = torch.full((256,), np.float32(BIG))
    bk = torch.zeros(256, dtype=torch.int32)
    bi = torch.zeros(256, dtype=torch.int32)
    for k, table in ((0, sph), (1, quad)):
        for j in range(table.shape[1]):
            tj, kj, _ = hit_kernel.closest_sphere_quad_plain(
                o, d, tm, table[:, j : j + 1] if k == 0 else sph[:, :0],
                table[:, j : j + 1] if k == 1 else quad[:, :0],
            )
            hit = (tj < best) & (tj < np.float32(BIG))
            best = torch.where(hit, tj, best)
            bk = torch.where(hit, k, bk)
            bi = torch.where(hit, j, bi)
    np.testing.assert_array_equal(t.numpy(), best.numpy())
    np.testing.assert_array_equal(kind.numpy(), bk.numpy())
    np.testing.assert_array_equal(idx.numpy(), bi.numpy())


def test_wrapper_argument_checks():
    tsd = t_cornell(16, 4)[0].compile(device="cpu").data
    sph, quad = hit_kernel.tables(tsd)
    o = torch.zeros(8, 3)
    d = torch.ones(8, 3)
    tm = torch.zeros(8)
    with pytest.raises(ValueError, match="o \\[B,3\\]"):
        hit_kernel.closest_sphere_quad(o[:, :2].contiguous(), d, tm, sph, quad)
    with pytest.raises(ValueError, match="time"):
        hit_kernel.closest_sphere_quad(o, d, tm[:4], sph, quad)
    with pytest.raises(TypeError, match="float32"):
        hit_kernel.closest_sphere_quad(o.double(), d, tm, sph, quad)
    with pytest.raises(ValueError, match="contiguous"):
        hit_kernel.closest_sphere_quad(o, torch.ones(3, 8).T, tm, sph, quad)
    with pytest.raises(ValueError, match="sph \\[7,S\\]"):
        hit_kernel.closest_sphere_quad(o, d, tm, quad, sph)
    before = hit_kernel.launches
    hit_kernel.closest_sphere_quad(o, d, tm, sph, quad)
    assert hit_kernel.launches == before  # the plain version is not a launch


def _bits(x):
    return x.contiguous().view(torch.int32)


def _assert_same_hits(got, want):
    for g, w in zip(got, want):
        assert torch.equal(_bits(g), _bits(w))


@pytest.mark.parametrize("name,real", [("cornell", (1, 18)), ("balls", (486, 0))])
def test_packed_tables_hold_reference_tables(name, real):
    """The kernel's primitive-major tables hold the numbers of the reference's _tables,
    row for row up to the last real one."""
    from tpupt.ops.pallas_hit import _tables as j_tables

    jbuild, tbuild, _, _ = SCENES[name]
    jsph, jquad = (np.asarray(a) for a in j_tables(jbuild().compile().data))
    sph, quad = hit_kernel.tables(tbuild().compile(device="cpu").data)
    np.testing.assert_array_equal(sph.numpy(), jsph)
    np.testing.assert_array_equal(quad.numpy(), jquad)
    assert hit_kernel.real_rows(sph, quad) == real
    sp, qp = (a.numpy() for a in hit_kernel.pack_tables(sph, quad))
    n_s, n_q = real
    assert sp.shape == (n_s, hit_kernel.SPH_PACKED) and qp.shape == (n_q, hit_kernel.QUAD_PACKED)
    np.testing.assert_array_equal(sp[:, 0:3], jsph[0:3, :n_s].T)  # c1
    np.testing.assert_array_equal(sp[:, 3], jsph[6, :n_s])  # r
    np.testing.assert_array_equal(qp[:, 0:3], jquad[0:3, :n_q].T)  # n
    np.testing.assert_array_equal(qp[:, 3], jquad[15, :n_q])  # d
    np.testing.assert_array_equal(qp[:, 4:16], jquad[3:15, :n_q].T)  # q, u, v, w


def test_hoisted_terms_bit_identical_to_inline():
    """c2 - c1 and r * r in the packed table are the sweep's own float32 operations."""
    sph, quad = hit_kernel.tables(_crowd().compile(device="cpu").data)
    sp, _ = hit_kernel.pack_tables(sph, quad)
    n = sp.shape[0]
    assert n == 6
    c1, c2, r = sph[0:3, :n].numpy(), sph[3:6, :n].numpy(), sph[6, :n].numpy()
    assert (c2 != c1).any()  # the spheres really move
    np.testing.assert_array_equal(sp[:, 4:7].numpy().view(np.int32), (c2 - c1).T.copy().view(np.int32))
    np.testing.assert_array_equal(sp[:, 7].numpy().view(np.int32), (r * r).view(np.int32))
    # the sphere sweep written with the hoisted terms gives the plain version's bits
    o, d, tm = (torch.from_numpy(a) for a in _rays(500, 21, -8.0, 8.0))
    want = hit_kernel.closest_sphere_quad_plain(o, d, tm, sph, quad[:, :0])
    e, r2 = sp[:, 4:7].T[:, None, :], sp[:, 7][None, :]
    l = sp[:, 0:3].T[:, None, :] + e * tm[None, :, None] - o.T[:, :, None]
    s = l[0] * d[:, 0:1] + l[1] * d[:, 1:2] + l[2] * d[:, 2:3]
    l2 = l[0] * l[0] + l[1] * l[1] + l[2] * l[2]
    d2 = l2 - s * s
    q = torch.sqrt(torch.clamp(r2 - d2, min=1e-20))
    t = torch.where(l2 > r2, s - q, s + q)
    ok = ~(((s < 0.0) & (l2 > r2)) | (d2 > r2)) & (t > 1e-3)
    got_t, got_i = torch.where(ok, t, BIG).min(dim=1)
    assert (got_t < BIG).float().mean() > 0.05
    assert torch.equal(_bits(got_t), _bits(want[0]))
    assert torch.equal(got_i[got_t < BIG].to(torch.int32), want[2][got_t < BIG])


def _crowd():
    """Six large moving spheres over a ground quad, under a light quad, before a wall quad."""
    s = TB.Scene()
    for i in range(6):
        c = (2.5 * i - 6.0, 1.5, 0.0)
        s.add_sphere(1.4, c, TB.Diffuse((0.5, 0.4, 0.3)), center2=(c[0], 2.5, 0.5))
    s.add_quad((-10.0, 0.0, -10.0), (20.0, 0.0, 0.0), (0.0, 0.0, 20.0), TB.Diffuse((0.5, 0.5, 0.5)))
    s.add_quad((-1.0, 7.0, -1.0), (2.0, 0.0, 0.0), (0.0, 0.0, 2.0), TB.Light((5.0, 5.0, 5.0)), light=True)
    s.add_quad((-10.0, 0.0, -6.0), (20.0, 0.0, 0.0), (0.0, 9.0, 0.0), TB.Diffuse((0.5, 0.5, 0.5)))
    return s


def _trim_case(name):
    """(sph, quad, expected real_rows) of a table with pads at the tail and elsewhere."""
    if name in ("cornell", "balls"):
        sph, quad = hit_kernel.tables(SCENES[name][1]().compile(device="cpu").data)
        return sph, quad, {"cornell": (1, 18), "balls": (486, 0)}[name]
    sph, quad = (x.clone() for x in hit_kernel.tables(_crowd().compile(device="cpu").data))
    if name == "pad_in_the_middle":
        sph[6, 2] = -1.0  # a pad sphere between real ones
        quad[:, 1] = 0.0  # a pad quad before the last real one
        return sph, quad, (6, 3)
    if name == "no_real_spheres":
        sph[6, :] = -1.0
        return sph, quad, (0, 3)
    assert name == "no_real_quads"
    quad[:] = 0.0
    return sph, quad, (6, 0)


@pytest.mark.parametrize(
    "name", ["cornell", "balls", "pad_in_the_middle", "no_real_spheres", "no_real_quads"]
)
def test_plain_on_trimmed_tables_bit_equal(name):
    """Cutting the tables after the last real row changes no hit: t, kind and idx of the
    plain version are the same bits, so the kernel may skip the pads at the tail."""
    sph, quad, real = _trim_case(name)
    n_s, n_q = hit_kernel.real_rows(sph, quad)
    assert (n_s, n_q) == real and (n_s < sph.shape[1] or n_q < quad.shape[1])
    lo, hi = {"cornell": (0.0, 555.0), "balls": (-12.0, 12.0)}.get(name, (-8.0, 8.0))
    o, d, tm = (torch.from_numpy(a) for a in _rays(3000, 22, lo, hi))
    want = hit_kernel.closest_sphere_quad_plain(o, d, tm, sph, quad)
    got = hit_kernel.closest_sphere_quad_plain(
        o, d, tm, sph[:, :n_s].contiguous(), quad[:, :n_q].contiguous()
    )
    assert (want[0] < BIG).float().mean() > 0.04
    _assert_same_hits(got, want)
    if name == "pad_in_the_middle":  # the pads hit nothing, the rows after them keep their index
        assert not ((want[1] == 0) & (want[2] == 2) & (want[0] < BIG)).any()
        assert not ((want[1] == 1) & (want[2] == 1)).any()
        assert ((want[1] == 0) & (want[2] == 5)).any() and ((want[1] == 1) & (want[2] == 2)).any()
    sp, qp = hit_kernel.pack_tables(sph, quad)
    assert sp.shape == (n_s, 8) and qp.shape == (n_q, 16)


def test_packed_tables_follow_an_edit_in_place():
    """The packed pair kept with a table is made anew after the table changes in place."""
    sph, quad = (x.clone() for x in hit_kernel.tables(_crowd().compile(device="cpu").data))
    first = hit_kernel._packed(sph, quad)
    assert hit_kernel._packed(sph, quad) is first
    sph[6, 5] = -1.0
    second = hit_kernel._packed(sph, quad)
    assert second is not first and second[0].shape[0] == 5


@pytest.mark.parametrize("edit", ["in place", "replaced"])
def test_scene_tables_follow_an_edit(edit):
    """The tables kept on a SceneData are made anew after a field they come from is
    edited in place or replaced: closest_hit then gives the edited scene's hits, bit for
    bit those of a scene compiled with the edit before its first call."""
    o, d, tm = (torch.from_numpy(a) for a in _rays(4096, 11, 0.0, 555.0))
    sd, fresh = (t_cornell(16, 4)[0].compile(device="cpu").data for _ in range(2))
    before = t_closest_hit(sd, o, d, tm, 1e-3, BIG)
    for x in (sd, fresh):
        if edit == "in place":
            x.sph_r.mul_(0.5)
            x.quad_d.add_(7.0)
        else:
            x.sph_r, x.quad_d = x.sph_r * 0.5, x.quad_d + 7.0
    after, want = (t_closest_hit(x, o, d, tm, 1e-3, BIG) for x in (sd, fresh))
    assert not torch.equal(after.t, before.t)
    for k in ("t", "valid", "mat_id"):
        assert torch.equal(getattr(after, k), getattr(want, k)), k


def test_plain_version_repeats_its_bits_on_every_thread():
    """Two calls of the plain version on the same rays, spread over every intra-op thread,
    give the same bits, and every thread rounds to nearest and keeps denormals (no
    flush-to-zero, no denormals-are-zero), the state the plain version's bits assume
    (ROADMAP Queue 3)."""
    n = 1 << 22  # elementwise ops of this size run on every intra-op thread
    one, q = torch.ones(n), torch.full((n,), 2.0**-25)
    state = {
        "rounds up": int(((one + q) != 1.0).sum()),
        "rounds down": int(((-one - q) != -1.0).sum()),
        "rounds toward zero": int(((one + 3 * q) == 1.0).sum()),
        "denormals are zero": int((torch.full((n,), 1e-39) * 1.0 == 0.0).sum()),
        "flushes to zero": int((torch.full((n,), 1e-20) * 1e-20 == 0.0).sum()),
    }
    assert not any(state.values()), f"elements computed in a non-default float state: {state}"
    sph, quad = hit_kernel.tables(t_balls(16, 4)[0].compile(device="cpu").data)
    o, d, tm = (torch.from_numpy(a) for a in _rays(1 << 16, 12, -12.0, 12.0))
    first = hit_kernel.closest_sphere_quad_plain(o, d, tm, sph, quad)
    second = hit_kernel.closest_sphere_quad_plain(o, d, tm, sph, quad)
    assert float((first[0] < BIG).float().mean()) > 0.05
    _assert_same_hits(second, first)


def test_every_port_test_module_warms_the_vector_math_first():
    """Each tests/test_torch_*.py imports tests/torch_cpu_warmup.py, whose one call into
    MKL's vector math on one thread keeps the first multi-threaded call of the process
    from running a less accurate sqrt on one intra-op chunk (ROADMAP Queue 3)."""
    import ast
    import pathlib

    files = sorted(pathlib.Path(__file__).resolve().parent.glob("test_torch_*.py"))
    assert len(files) > 20
    for f in files:
        names = {a.name for node in ast.parse(f.read_text()).body if isinstance(node, ast.Import)
                 for a in node.names}
        assert "torch_cpu_warmup" in names, f"{f.name} does not import torch_cpu_warmup"


@pytest.mark.parametrize("name", ["balls", "moving", "crowd"])
def test_tile_boxes_contain_their_spheres(name):
    """A tile's box holds each of its real spheres at every time in [0,1]: the centre as
    the sweep computes it, c1 + (c2-c1)*time, plus and minus r."""
    build = {"balls": SCENES["balls"][1], "moving": lambda: _moving(TB), "crowd": _crowd}[name]
    sph, quad = hit_kernel.tables(build().compile(device="cpu").data)
    boxes = hit_kernel.sphere_tile_boxes(sph)
    tile = hit_kernel.CULL_TILE
    assert boxes.shape == (-(-sph.shape[1] // tile), hit_kernel.BOX_FLOATS)
    c1, e, r = sph[0:3], sph[3:6] - sph[0:3], sph[6]
    times = torch.cat([torch.tensor([0.0, 1.0]), torch.from_numpy(_rays(200, 5, 0, 1)[2])])
    for j in range(sph.shape[1]):
        lo, hi = boxes[j // tile, 0:3], boxes[j // tile, 4:7]
        if r[j] < 0:
            continue
        c = c1[:, j, None] + e[:, j, None] * times[None, :]
        assert (c - r[j] >= lo[:, None]).all() and (c + r[j] <= hi[:, None]).all(), j
    # a tile of pad rows only has a box no ray of the scene reaches
    n_s, _ = hit_kernel.real_rows(sph, quad)
    for k in range(-(-n_s // tile), boxes.shape[0]):
        assert (boxes[k, 0:3] == hit_kernel.PAD_BOX).all() and (boxes[k, 4:7] == hit_kernel.PAD_BOX).all()
    # centre and half diagonal describe the same box
    real = boxes[:, 0] < hit_kernel.PAD_BOX
    np.testing.assert_allclose(boxes[real, 8:11], 0.5 * (boxes[real, 0:3] + boxes[real, 4:7]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(boxes[real, 11], 0.5 * (boxes[real, 4:7] - boxes[real, 0:3]).norm(dim=1), rtol=1e-5)


def _aimed_rays(sph, b, seed):
    """Rays from around the scene toward points near its real spheres, many of them
    grazing: a miss distance of 0.9 to 1.1 radii from the centre at a random time."""
    rng = np.random.default_rng(seed)
    s = sph.numpy()
    real = np.nonzero(s[6] >= 0)[0]
    real = real[s[6, real] < 500.0]  # not the ground sphere
    j = rng.choice(real, size=b)
    tm = rng.uniform(size=b).astype(np.float32)
    c = s[0:3, j].T + (s[3:6, j] - s[0:3, j]).T * tm[:, None]
    o = (c + rng.normal(size=(b, 3)) * rng.choice([2.0, 15.0, 300.0], size=(b, 1))).astype(np.float32)
    o[:, 1] = np.abs(o[:, 1])
    to_c = c - o
    side = np.cross(to_c, rng.normal(size=(b, 3)))
    side /= np.linalg.norm(side, axis=1, keepdims=True)
    target = c + side * (s[6, j] * rng.uniform(0.9, 1.1, size=b))[:, None]
    d = target - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in (o, d, tm))


@pytest.mark.parametrize("name", ["balls", "cornell", "moving", "crowd"])
def test_plain_cull_bit_equal_to_no_cull(name):
    """Skipping the tiles whose widened box a ray misses drops no hit: with and without
    the cull the plain version gives the same bits, on random rays, on rays that graze
    spheres from near and far, and on rays that may not cull (time outside [0,1], a
    direction that is not unit, NaN and infinite components)."""
    build = {"balls": SCENES["balls"][1], "cornell": SCENES["cornell"][1],
             "moving": lambda: _moving(TB), "crowd": _crowd}[name]
    lo, hi = {"balls": (-12.0, 12.0), "cornell": (0.0, 555.0)}.get(name, (-8.0, 8.0))
    sph, quad = hit_kernel.tables(build().compile(device="cpu").data)
    o, d, tm = (torch.cat(p) for p in zip(
        (torch.from_numpy(a) for a in _rays(6000, 31, lo, hi)), _aimed_rays(sph, 6000, 32)))
    tm[0:40] = torch.linspace(-2.0, 3.0, 40)  # times outside [0,1]: these rays may not cull
    d[40:80] *= torch.linspace(0.5, 2.0, 40)[:, None]  # directions that are not unit
    d[80, 0], o[81, 1], tm[82] = float("nan"), float("nan"), float("nan")
    o[83, 2], d[84, 1], tm[85] = float("inf"), float("-inf"), float("inf")
    d[86] = torch.tensor([0.0, -1.0, 0.0])  # axis-aligned: two flushed reciprocals
    o[87] = torch.tensor([1e30, 0.0, 0.0])
    counts, counts_all = {}, {}
    got = hit_kernel.closest_sphere_quad_plain(o, d, tm, sph, quad, counts=counts)
    want = hit_kernel.closest_sphere_quad_plain(o, d, tm, sph, quad, counts=counts_all, cull=False)
    assert ((want[0] < BIG) & (want[1] == 0)).float().mean() > 0.05  # spheres are hit
    _assert_same_hits(got, want)
    n_s, n_q = hit_kernel.real_rows(sph, quad)
    b = o.shape[0]
    assert counts_all == dict(box_tests=0, sphere_tests=b * n_s, quad_tests=b * n_q,
                              warp_sphere_tests=-(-b // 32) * 32 * n_s)
    assert counts["sphere_tests"] <= counts["warp_sphere_tests"] <= counts_all["warp_sphere_tests"]
    tiles = -(-n_s // hit_kernel.CULL_TILE)
    assert counts["box_tests"] == (b * tiles if tiles > 1 else 0)  # one tile is swept whole
    assert counts["quad_tests"] == b * n_q and 0 < counts["sphere_tests"] <= b * n_s
    if name == "balls":  # the cull pays: most (ray, sphere) pairs are skipped
        assert counts["sphere_tests"] < 0.3 * b * n_s
