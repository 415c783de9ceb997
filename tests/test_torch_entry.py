"""The port's entry points (tpupt_torch/entry.py) against __graft_entry__.py's.

- dryrun_multichip over 2 and 4 gloo ranks on the CPU (spawned processes): its four
  checks run in every rank with the JAX version's tolerances (render_image with a mesh
  against one device: rays equal, rtol 1e-4 / atol 1e-6; the pod mesh against the flat
  one: rtol 1e-4 / atol 1e-5; sharded gradients against one device's: rtol 2e-4 /
  atol 1e-5), and a failed check in a rank makes the call raise.
- Without a card, the default device raises: no CPU fallback, no smaller mesh.
- entry(device="cpu")'s radiance against __graft_entry__.entry() run through jax.jit on
  the CPU, at tests/test_torch_render.py's tolerance for the port's radiance against the
  jitted reference's: at least 99% of the 4096 lanes within rtol 1e-3 / atol 1e-4 (the
  counter RNG traces the same paths; XLA's contracted multiply-adds and transcendentals
  flip a branch on a few).
"""

import torch_cpu_warmup  # noqa: F401  (MKL's first vector-math call, on one thread)
import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as G
import torch_sharding_worker as W
from tpupt_torch import entry as E


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_on_gloo_ranks(n):
    ranks = E.dryrun_multichip(n, device="cpu")
    assert [r["rank"] for r in ranks] == list(range(n))
    for r in ranks:
        assert r["world"] == n and r["device"] == "cpu"
        assert r["render_image"]["rays"] == r["render_block_sharded"]["rays"] > 0
        assert r["render_image"]["max_abs_diff"] <= 1e-4
        assert ("render_block_pod" in r) == (n % 2 == 0)
        assert r["render_grads_sharded"]["grad_abs_sum"] > 0
        assert r["K1_launches"] == 0  # the CPU runs K1's plain version, which counts nothing


def test_a_failed_check_in_a_rank_raises():
    """Rank 1 fails its check while rank 0 waits for it in a collective: the call raises,
    naming the rank and the failure, and rank 0 is killed."""
    with pytest.raises(RuntimeError, match=r"rank 1 exited with 1: AssertionError: planted in rank 1"):
        E.run_ranks(2, "cpu", W.failing_checks, timeout_s=120)


def test_dryrun_multichip_needs_the_cards():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        E.dryrun_multichip(1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        E.entry()


def test_entry_matches_the_jitted_reference():
    jfn, jargs = G.entry()
    want = np.asarray(jax.jit(jfn)(*jargs))
    fn, args = E.entry(device="cpu")
    assert args[2].shape == (4096,) and args[2].device.type == "cpu"
    got = fn(*args).numpy()
    assert got.shape == want.shape == (4096, 3) and np.isfinite(got).all()
    ok = np.isclose(got, want, rtol=1e-3, atol=1e-4).all(-1)
    assert ok.mean() >= 0.99, ok.mean()
    assert float(got.mean()) > 0.0
