"""The port's render_film_grads (the production gradient entry, the reference's
`grads` bench configuration) against the reference's on the CPU, on the box scene
and a small Cornell box; and the stage runner of its CUDA route
(``FilmScanStages.run()``, test_torch_grad_graph.py) against the same. Tolerances and
their grounds are in test_torch_grad_ref.py: per field a relative L1 error of at most
2e-2, and at least 95% of pixels within rtol 1e-3 / atol 1e-4.
"""

import functools

import numpy as np
import pytest

import torch_cpu_warmup  # noqa: F401  (MKL's first vector-math call, on one thread)
from tpupt.render import diff as JD
from tpupt_torch.render import diff as TD
from test_torch_grad_graph import stage_run
from test_torch_grad_ref import assert_grads_close, configs


@functools.lru_cache(maxsize=None)
def _reference(name):
    """(reference's mean, grads, rays, port's compiled scene, port's camera) of a case."""
    jc, jcam, tc, tcam = configs(name)
    return (*JD.render_film_grads(jc, jcam, spp=4, seed=0, replicas=2, return_stats=True), tc, tcam)


@pytest.mark.parametrize("name", ["box", "cornell"])
def test_film_grads_match_reference(name):
    jm, jg, jrays, tc, tcam = _reference(name)
    tm, tg, st = TD.render_film_grads(tc, tcam, spp=4, seed=0, replicas=2, return_stats=True)
    assert tm.shape == (tcam.image_height, tcam.image_width, 3)
    close = np.isclose(tm.numpy(), np.asarray(jm), rtol=1e-3, atol=1e-4).all(-1)
    assert close.mean() >= 0.95, close.mean()
    assert abs(st.rays - int(jrays)) <= 0.02 * int(jrays) and st.trips > 0
    assert_grads_close(tg, jg)


@pytest.mark.parametrize("name", ["box", "cornell"])
def test_stage_runner_matches_reference(name):
    jm, jg, jrays, tc, tcam = _reference(name)
    tm, tg, rays, trips, _ = stage_run(tc, tcam)
    close = np.isclose(tm.numpy(), np.asarray(jm), rtol=1e-3, atol=1e-4).all(-1)
    assert close.mean() >= 0.95, close.mean()
    assert abs(rays - int(jrays)) <= 0.02 * int(jrays) and trips > 0
    assert_grads_close(tg, jg)
