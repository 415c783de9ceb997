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
