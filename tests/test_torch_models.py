"""Port parity: the Fig-1 CNN and the data it trains on.

The CNN's parameter layout (NHWC images, HWIO conv weights, (d_in,
d_out) dense weights) is the JAX package's, so one parameter tree gives
logits and per-client gradients that agree to f32 ``rtol=1e-4,
atol=1e-5`` (the convolutions sum in other orders). ``init_cnn`` draws
the same threefry bits; torch's ``erfinv`` holds it to ``rtol=1e-5``.
The synthetic data, the label-skew partition and the minibatches are
bitwise equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (a worker's share of the cores)

from repro.core import aggregation as jagg
from repro.data import ClientBatcher as JBatcher
from repro.data import group_label_skew_partition as j_partition
from repro.data import make_confusable_image_classification as j_make_data
from repro.models import cnn as jcnn
from repro_torch import random as trandom
from repro_torch.convert import params_from_jax
from repro_torch.core import aggregation as tagg
from repro_torch.data import ClientBatcher as TBatcher
from repro_torch.data import group_label_skew_partition as t_partition
from repro_torch.data import make_confusable_image_classification as t_make_data
from repro_torch.models import cnn as tcnn


def _flat_j(tree):
    return np.asarray(jagg.ravel_pytree(tree))


def _flat_t(tree):
    return tagg.ravel_pytree(tree).numpy()


@pytest.mark.parametrize("hw", [8, 32])
def test_init_cnn_matches_jax(hw):
    jp = jcnn.init_cnn(jax.random.PRNGKey(2), image_hw=hw)
    tp = tcnn.init_cnn(trandom.PRNGKey(2, device="cpu"), image_hw=hw)
    assert {k: sorted(v) for k, v in tp.items()} == \
        {k: sorted(v) for k, v in jp.items()}
    np.testing.assert_allclose(_flat_t(tp), _flat_j(jp), rtol=1e-5, atol=1e-7)
    if hw == 32:
        assert tagg.ravel_spec(tp).total == 316_554


def test_cnn_forward_loss_accuracy_match_jax():
    rng = np.random.default_rng(0)
    jp = jcnn.init_cnn(jax.random.PRNGKey(0), image_hw=16)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    x = rng.normal(size=(12, 16, 16, 3)).astype(np.float32)
    y = rng.integers(0, 10, 12).astype(np.int32)
    np.testing.assert_allclose(
        tcnn.cnn_forward(tp, torch.from_numpy(x)).numpy(),
        np.asarray(jcnn.cnn_forward(jp, jnp.asarray(x))), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        float(tcnn.cnn_loss(tp, torch.from_numpy(x), torch.from_numpy(y))),
        float(jcnn.cnn_loss(jp, jnp.asarray(x), jnp.asarray(y))), rtol=1e-5)
    assert float(tcnn.cnn_accuracy(tp, torch.from_numpy(x), torch.from_numpy(y))) \
        == float(jcnn.cnn_accuracy(jp, jnp.asarray(x), jnp.asarray(y)))


def test_data_and_batches_bitwise():
    jds = j_make_data(3, 240, image_shape=(8, 8, 3), similarity=0.9, noise=0.8)
    tds = t_make_data(3, 240, image_shape=(8, 8, 3), similarity=0.9, noise=0.8)
    np.testing.assert_array_equal(tds.images, jds.images)
    np.testing.assert_array_equal(tds.labels, jds.labels)
    jparts = j_partition(3, jds.labels, 8, 4, skew=1.0)
    tparts = t_partition(3, tds.labels, 8, 4, skew=1.0)
    for a, b in zip(jparts, tparts):
        np.testing.assert_array_equal(a, b)
    # Uneven shards exercise the resampling pad.
    per = [{"x": jds.images[ix[:len(ix) - i]], "y": jds.labels[ix[:len(ix) - i]]}
           for i, ix in enumerate(jparts)]
    jb = JBatcher(per, 4, seed=3)
    tb = TBatcher(per, 4, seed=3, device="cpu")
    np.testing.assert_array_equal(tb.p.numpy(), np.asarray(jb.p))
    for s in range(5):
        jbatch = jb.sample(jax.random.PRNGKey(s))
        tbatch = tb.sample(trandom.PRNGKey(s, device="cpu"))
        for k in ("x", "y"):
            np.testing.assert_array_equal(tbatch[k].numpy(), np.asarray(jbatch[k]))


def test_per_client_gradients_match_jax():
    """torch.func.vmap(grad) over clients against jax.vmap(jax.grad): one
    flat (N, P) buffer, in the same layout."""
    rng = np.random.default_rng(1)
    n = 4
    per = [{"x": rng.normal(size=(5, 8, 8, 3)).astype(np.float32),
            "y": rng.integers(0, 10, 5).astype(np.int32)} for _ in range(n)]
    jb = JBatcher(per, 3, seed=0)
    tb = TBatcher(per, 3, seed=0, device="cpu")
    jp = jcnn.init_cnn(jax.random.PRNGKey(5), image_hw=8)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    jbatch = jb.sample(jax.random.PRNGKey(9))
    jg = jax.vmap(lambda a, b: jax.grad(jcnn.cnn_loss)(jp, a, b))(
        jbatch["x"], jbatch["y"])
    tg = tcnn.client_grads_fn(tb)(tp, trandom.PRNGKey(9, device="cpu"), None)
    jflat = np.asarray(jagg.ravel_stacked(jg))
    tflat = tagg.ravel_stacked(tg).numpy()
    assert tflat.shape == jflat.shape == (n, tagg.ravel_spec(tp).total)
    np.testing.assert_allclose(tflat, jflat, rtol=1e-4, atol=1e-5)
