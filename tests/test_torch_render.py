"""End-to-end checks of the port's forward render on the CPU.

- Renders of scenes 3 and 1 against the reference's committed goldens (24 px,
  8 spp, seed 0). The counter-based RNG makes both packages trace the same
  paths, so most pixels agree closely; a path diverges only where XLA's and
  PyTorch's float32 transcendentals or fused multiply-adds differ by an ulp and
  flip a branch. Tolerance: image mean within 0.5%, and at least 98% (scene 3)
  or 95% (scene 1, moving spheres and glass) of pixels within rtol 1e-3 /
  atol 1e-4. Measured: 99.3% / 96.8% of pixels, means within 0.2%.
- Per-(pixel, sample) radiance replay against the reference's trace_radiance on
  a lane subset: at least 99% of paths within rtol 1e-3 / atol 1e-4.
- Checkpoint resume and fault retry are bit-identical within the port.
- The CLI writes a non-black PNG; the port imports neither jax nor tpupt.
"""

import ast
import json
import os
import pathlib
import struct
import zlib

import torch_cpu_warmup  # noqa: F401  (MKL's first vector-math call, on one thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpupt_torch.render.renderer as R
from tpupt.render.integrator import trace_radiance as j_trace
from tpupt.scenes import SCENES as JSCENES
from tpupt_torch import cli
from tpupt_torch.render.camera import Camera
from tpupt_torch.render.integrator import trace_radiance as t_trace
from tpupt_torch.scene.builder import Diffuse, Light, Scene
from tpupt_torch.scenes import SCENES as TSCENES

ROOT = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = ROOT / "tests" / "golden"


@pytest.mark.parametrize("sid,min_close", [(3, 0.98), (1, 0.95)])
def test_render_matches_golden(sid, min_close):
    name, build = TSCENES[sid]
    golden = np.load(GOLDEN / f"scene{sid}_{name}_24px_8spp.npy")
    scene, cam = build(24, 8)
    _, mean, stats = R.render_image(
        scene.compile(device="cpu"), cam, seed=0, rays_per_launch=1 << 14, progress=False
    )
    assert mean.shape == golden.shape and mean.dtype == np.float32
    assert stats.paths == 24 * cam.image_height * 8 and stats.rays > stats.paths
    assert stats.iterations > 0
    np.testing.assert_allclose(np.nanmean(mean), np.nanmean(golden), rtol=5e-3)
    close = np.isclose(mean, golden, rtol=1e-3, atol=1e-4, equal_nan=True).all(-1).mean()
    assert close >= min_close, close


@pytest.mark.parametrize("sid", [3, 1])
def test_radiance_replay_matches_reference(sid):
    name, jbuild = JSCENES[sid]
    _, tbuild = TSCENES[sid]
    js, jcam = jbuild(24, 8)
    ts, tcam = tbuild(24, 8)
    jc = js.compile()
    tc = ts.compile(device="cpu")
    rng = np.random.default_rng(sid)
    npix = 24 * jcam.image_height
    pix = rng.integers(0, npix, 1536).astype(np.int32)
    smp = rng.integers(0, 64, 1536).astype(np.int32)
    rows, cols = pix // 24, pix % 24
    lj, _ = jax.jit(j_trace, static_argnums=(7, 8))(
        jc.data, jcam.init(), *(jnp.asarray(a) for a in (pix, rows, cols, smp)),
        jnp.uint32(0), 50, jc.has_lights,
    )
    lt, rays = t_trace(
        tc.data, tcam.init("cpu"), *(torch.from_numpy(a) for a in (pix, rows, cols, smp)),
        0, 50, tc.has_lights,
    )
    assert rays >= len(pix)
    ok = np.isclose(lt.numpy(), np.asarray(lj), rtol=1e-3, atol=1e-4, equal_nan=True).all(-1)
    assert ok.mean() >= 0.99, ok.mean()


def _small():
    s = Scene()
    s.add_sphere(1.0, (0.0, 0.0, -3.0), Diffuse((0.6, 0.5, 0.4)))
    s.add_quad((-1.0, 2.5, -4.0), (2.0, 0.0, 0.0), (0.0, 0.0, 2.0), Light((6.0, 6.0, 6.0)), light=True)
    s.environment = (0.2, 0.3, 0.4)
    cam = Camera(
        aspect_ratio=1.0, image_width=10, samples_per_pixel=16, max_depth=6,
        vfov=30.0, look_from=(0, 0, 0), look_at=(0, 0, -1),
        blur_strength=0.5, focal_length=3.0, defocus_angle=0.0,
    )
    return s.compile(device="cpu"), cam


KW = dict(rays_per_launch=100, samples_per_launch=4, progress=False)


def test_checkpoint_resume_bit_identical(tmp_path):
    compiled, cam = _small()
    _, ref, _ = R.render_image(compiled, cam, **KW)
    ck = str(tmp_path / "film.npz")
    seen = []

    def interrupt(mean, frac):
        seen.append(frac)
        if len(seen) == 2:  # the process dies after launch 2
            raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        R.render_image(compiled, cam, checkpoint_path=ck, on_launch=interrupt, **KW)
    assert int(np.load(ck)["next_it"]) == 2
    _, resumed, stats = R.render_image(compiled, cam, checkpoint_path=ck, **KW)
    np.testing.assert_array_equal(resumed, ref)
    assert stats.launches == 4

    with pytest.raises(ValueError, match="different render"):
        R.render_image(compiled, cam, checkpoint_path=ck, seed=1, **KW)


def test_transient_fault_retried_and_other_errors_propagate():
    compiled, cam = _small()
    _, clean, _ = R.render_image(compiled, cam, **KW)
    calls = {"n": 0}

    def transient(it):
        calls["n"] += 1
        if it == 1 and calls["n"] == 2:
            raise R.TransientLaunchError("injected")

    R._fault_hook = transient
    try:
        _, faulted, st = R.render_image(compiled, cam, **KW)
        assert calls["n"] == st.launches + 1
        np.testing.assert_array_equal(faulted, clean)

        def broken(it):  # e.g. a kernel build or launch failure: never retried
            raise RuntimeError("kernel launch failed")

        R._fault_hook = broken
        with pytest.raises(RuntimeError, match="kernel launch failed"):
            R.render_image(compiled, cam, **KW)
    finally:
        R._fault_hook = None


def test_debug_checks_and_mesh():
    compiled, cam = _small()
    R.render_image(compiled, cam, debug_checks=True, **KW)
    with pytest.raises(TypeError, match="parallel.sharding.Mesh"):
        R.render_image(compiled, cam, mesh=object(), **KW)


def test_profile_dir_writes_a_trace(tmp_path):
    compiled, cam = _small()
    _, mean, _ = R.render_image(compiled, cam, profile_dir=str(tmp_path / "prof"), **KW)
    _, plain, _ = R.render_image(compiled, cam, **KW)
    np.testing.assert_array_equal(mean, plain)
    trace = json.loads((tmp_path / "prof" / "render_rank0.json").read_text())
    ops = [e["name"] for e in trace["traceEvents"] if e.get("name", "").startswith("aten::")]
    assert len(ops) > 100 and "aten::index_add_" in ops  # the film's scatter among them


def _read_png(path):
    data = pathlib.Path(path).read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos : pos + 4])
        tag, body = data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + n]
        if tag == b"IHDR":
            w, h = struct.unpack(">II", body[:8])
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    assert (raw[:, 0] == 0).all()
    return raw[:, 1:].reshape(h, w, 3)


def test_cli_writes_png(tmp_path):
    out = tmp_path / "cornell.png"
    assert cli.main(["-s", "3", "--width", "16", "--spp", "4", "--device", "cpu", "-o", str(out)]) == 0
    img = _read_png(out)
    assert img.shape == (16, 16, 3) and img.max() > 0


def test_cli_profile_and_mesh(tmp_path, capsys):
    out, prof = tmp_path / "cornell.png", tmp_path / "prof"
    args = ["-s", "3", "--width", "16", "--spp", "4", "--device", "cpu", "-o", str(out)]
    assert cli.main(args + ["--profile", str(prof), "--mesh", "1"]) == 0
    plain = tmp_path / "plain.png"
    assert cli.main(args[:-1] + [str(plain)]) == 0
    np.testing.assert_array_equal(_read_png(out), _read_png(plain))
    assert (prof / "render_rank0.json").exists()
    with pytest.raises(SystemExit):  # a mesh of 2 needs 2 processes
        cli.main(args + ["--mesh", "2"])
    assert "torchrun --nproc-per-node 2 python -m tpupt_torch.cli --mesh 2" in capsys.readouterr().err


def _imports(path):
    tree = ast.parse(pathlib.Path(path).read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_tpupt():
    """Nor PIL: the port reads PNG and JPEG itself (the card's machine has no PIL), and
    the card's tests run without it. The port's tools import neither jax nor tpupt (PIL
    writes and checks their images here)."""
    files = sorted((ROOT / "tpupt_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10 and os.path.exists(files[-1]) and ROOT / "tpupt_torch" / "entry.py" in files
    tools = sorted((ROOT / "tools").glob("torch_*.py")) + [ROOT / "tools" / "make_torch_image_fixtures.py"]
    card_tests = [ROOT / "tests" / "test_torch_cuda.py", ROOT / "tests" / "torch_sharding_worker.py"]
    assert len(tools) >= 5 and all(os.path.exists(f) for f in tools + card_tests)
    for f in files + tools + card_tests:
        banned = ("jax", "jaxlib", "tpupt") + (() if f in tools else ("PIL",))
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in banned, f"{f} imports {mod}"
