"""The port's counter-based RNG against the reference: bit-equal uniforms.

Tolerance: none. Both sides compute the same uint32 hash and the same exact
24-bit-to-float conversion, so every output must be identical.
"""

import torch_cpu_warmup  # noqa: F401  (MKL's first vector-math call, on one thread)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpupt.core import rng as jrng
from tpupt_torch.core import rng as trng


def _both(seed, pixel, sample, ctr):
    j = jrng.uniform4(
        jnp.uint32(seed), jnp.asarray(pixel, jnp.uint32), jnp.asarray(sample, jnp.uint32),
        jnp.asarray(ctr, jnp.uint32),
    )
    t = trng.uniform4(
        seed, torch.from_numpy(pixel.astype(np.int64)), torch.from_numpy(sample.astype(np.int64)),
        torch.from_numpy(np.asarray(ctr, np.int64)),
    )
    return [np.asarray(a) for a in j], [b.numpy() for b in t]


@pytest.mark.parametrize("seed", [0, 7, 0xFFFFFFFF])
def test_uniform4_bit_equal_on_grid(seed):
    pix, smp, ctr = np.meshgrid(np.arange(64), np.arange(16), np.arange(0, 40, 3), indexing="ij")
    j, t = _both(seed, pix.ravel(), smp.ravel(), ctr.ravel())
    for a, b in zip(j, t):
        assert b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_uniform4_bit_equal_near_2_32():
    rng = np.random.default_rng(1)
    top = np.uint64(1 << 32)
    pix = (top - rng.integers(1, 1 << 20, 4096, dtype=np.uint64)).astype(np.uint64)
    smp = rng.integers(0, 1 << 32, 4096, dtype=np.uint64)
    ctr = (top - rng.integers(1, 64, 4096, dtype=np.uint64)).astype(np.uint64)
    j, t = _both(123456789, pix, smp, ctr)
    for a, b in zip(j, t):
        np.testing.assert_array_equal(a, b)
        assert (b >= 0).all() and (b < 1).all()


def test_uniform4_scalar_counter_and_bounce_ctr():
    pix = np.arange(1000)
    smp = np.arange(1000) % 7
    for bounce in (0, 5, 49):
        c = jrng.bounce_ctr(bounce) + jrng.SLOT_BSDF
        assert c == trng.bounce_ctr(bounce) + trng.SLOT_BSDF
        j = jrng.uniform4(jnp.uint32(3), jnp.asarray(pix), jnp.asarray(smp), c)
        t = trng.uniform4(3, torch.from_numpy(pix), torch.from_numpy(smp), c)
        for a, b in zip(j, t):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
