"""Port parity: ``repro_torch.random`` against ``jax.random``, bitwise.

The installed jax runs threefry2x32 with ``jax_threefry_partitionable``
on; the port emulates that generator in int64 torch arithmetic. Keys,
splits, fold-ins, uniform floats and random integers must be the same
bits, which is what lets scheduler decisions and minibatches of the two
packages be compared bitwise. ``normal`` shares the uniform bits but
uses torch's ``erfinv``, which differs from XLA's by up to a few tens
of ulps in the tails, so it is held to f32 ``rtol=1e-5``. A draw is
computed over slices of its flat index (``DRAW_SLICE`` elements at a
time); the slices give the bits of one draw.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (a worker's share of the cores)

from repro.core import energy as jenergy
from repro_torch import random as trandom
from repro_torch.core import energy as tenergy

SEEDS = [0, 1, 2, 3, 7, 42, 99, 123, 1000, 2 ** 16 + 1, 31337, 65535,
         2 ** 20, 123456789, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1, 2 ** 32 + 5,
         -1, -12345]
SHAPES = [(), (5,), (3, 4)]


def _np(t):
    return t.cpu().numpy()


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_fold_in_bitwise(seed):
    jk = jax.random.PRNGKey(seed)
    tk = trandom.PRNGKey(seed, device="cpu")
    np.testing.assert_array_equal(_np(tk), np.asarray(jk))
    for num in (2, 3, 4, 7):
        np.testing.assert_array_equal(_np(trandom.split(tk, num)),
                                      np.asarray(jax.random.split(jk, num)))
    for data in (0, 1, 5, 2 ** 31 + 3):
        np.testing.assert_array_equal(
            _np(trandom.fold_in(tk, data)),
            np.asarray(jax.random.fold_in(jk, np.uint32(data))))
    # Batched fold_in is jax.vmap over the index.
    idx = np.arange(6)
    np.testing.assert_array_equal(
        _np(trandom.fold_in(tk, torch.from_numpy(idx))),
        np.asarray(jax.vmap(lambda i: jax.random.fold_in(jk, i))(idx)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_uniform_randint_bitwise(seed, shape):
    jk = jax.random.split(jax.random.PRNGKey(seed))[1]
    tk = trandom.split(trandom.PRNGKey(seed, device="cpu"))[1]
    ju = np.asarray(jax.random.uniform(jk, shape))
    tu = _np(trandom.uniform(tk, shape))
    assert tu.dtype == np.float32 and tu.shape == shape
    assert tu.tobytes() == ju.tobytes()
    ju2 = np.asarray(jax.random.uniform(jk, shape, minval=-2.0, maxval=3.0))
    assert _np(trandom.uniform(tk, shape, -2.0, 3.0)).tobytes() == ju2.tobytes()
    for lo, hi in ((0, 10), (0, 7), (-5, 1000), (3, 3), (0, 2 ** 31 - 1)):
        ji = np.asarray(jax.random.randint(jk, shape, lo, hi))
        ti = _np(trandom.randint(tk, shape, lo, hi))
        assert ti.dtype == np.int32
        np.testing.assert_array_equal(ti, ji)


@pytest.mark.parametrize("seed", SEEDS[:5])
def test_normal_close(seed):
    jk = jax.random.PRNGKey(seed)
    tk = trandom.PRNGKey(seed, device="cpu")
    jn = np.asarray(jax.random.normal(jk, (64, 33)))
    tn = _np(trandom.normal(tk, (64, 33)))
    np.testing.assert_allclose(tn, jn, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("seed", SEEDS[:6])
def test_client_draws_bitwise_per_row(seed):
    """client_keys / client_uniform / client_randint: one fold_in per
    client row, independent of the population width."""
    jk = jax.random.PRNGKey(seed)
    tk = trandom.PRNGKey(seed, device="cpu")
    for n in (1, 8, 13):
        np.testing.assert_array_equal(_np(tenergy.client_keys(tk, n)),
                                      np.asarray(jenergy.client_keys(jk, n)))
        ju = np.asarray(jenergy.client_uniform(jk, n))
        assert _np(tenergy.client_uniform(tk, n)).tobytes() == ju.tobytes()
        maxval = np.arange(1, n + 1).astype(np.float32)
        np.testing.assert_array_equal(
            _np(tenergy.client_randint(tk, n, torch.from_numpy(maxval))),
            np.asarray(jenergy.client_randint(jk, n, jnp.asarray(maxval))))
    wide = _np(tenergy.client_uniform(tk, 13))
    assert wide[:8].tobytes() == _np(tenergy.client_uniform(tk, 8)).tobytes()


@pytest.mark.parametrize("slice_", [7, 1000, 4096])
def test_draws_in_slices_are_one_draw(monkeypatch, slice_):
    """``random_bits``, ``uniform`` and ``normal`` drawn in slices (a
    shape a multiple of none of the slices: 407 elements in 59 slices of
    7, 37,037 in slices of 1,000 and 4,096) give the unsliced draw's
    bits, JAX's for the bits and uniform; a batched key likewise."""
    jk = jax.random.split(jax.random.PRNGKey(5), 3)[1]
    tk = trandom.split(trandom.PRNGKey(5, device="cpu"), 3)[1]
    batched = trandom.split(trandom.PRNGKey(6, device="cpu"), 3)
    # Slices of 7 over 37,037 elements would be 5,291 Python-level draws
    # a call; 407 elements keep the last slice ragged (407 = 58·7 + 1).
    shape = (37, 11) if slice_ == 7 else (37, 1001)
    draws = (("random_bits", ()), ("uniform", (-2.0, 3.0)), ("normal", ()))
    whole = {(name, k.dim()): _np(getattr(trandom, name)(k, shape, *args))
             for k in (tk, batched) for name, args in draws}
    assert trandom.DRAW_SLICE > 37 * 1001
    assert math.prod(shape) % slice_ and math.prod(shape) > slice_
    monkeypatch.setattr(trandom, "DRAW_SLICE", slice_)
    for k in (tk, batched):
        for name, args in draws:
            got = _np(getattr(trandom, name)(k, shape, *args))
            assert got.shape == k.shape[:-1] + shape
            assert got.tobytes() == whole[name, k.dim()].tobytes(), name
    assert _np(trandom.random_bits(tk, shape)).astype(np.uint32).tobytes() == \
        np.asarray(jax.random.bits(jk, shape)).tobytes()
    assert _np(trandom.uniform(tk, shape, -2.0, 3.0)).tobytes() == np.asarray(
        jax.random.uniform(jk, shape, minval=-2.0, maxval=3.0)).tobytes()
    np.testing.assert_allclose(_np(trandom.normal(tk, shape)),
                               np.asarray(jax.random.normal(jk, shape)),
                               rtol=1e-5, atol=1e-6)


def test_randint_bounds_checked():
    tk = trandom.PRNGKey(0, device="cpu")
    with pytest.raises(ValueError, match="int32"):
        trandom.randint(tk, (2,), 0, 2 ** 31)
