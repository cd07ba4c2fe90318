"""The port's cross_entropy against the JAX package's, on the CPU.

Same numpy logits and integer labels on both sides, float32. Values and
the gradient with respect to the logits agree to 1e-6: both take one
log-softmax per row over 37 classes and sum at most 60 terms.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.nn import functional as JF

from paddle_tpu_torch.nn.functional.loss import cross_entropy

TOL = 1e-6


def _inputs(seed, ignore_some):
    rng = np.random.default_rng(seed)
    logits = (3 * rng.standard_normal((3, 20, 37))).astype(np.float32)
    labels = rng.integers(0, 37, (3, 20)).astype(np.int64)
    if ignore_some:
        labels[rng.random((3, 20)) < 0.3] = -100
    return logits, labels


def _jax_ce(logits, labels, **kw):
    x = pt.to_tensor(logits, dtype="float32", stop_gradient=False)
    out = JF.cross_entropy(x, pt.to_tensor(labels, dtype="int64"), **kw)
    return x, out


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("ignore_some", [False, True])
@pytest.mark.parametrize("label_smoothing", [0.0, 0.1])
@pytest.mark.parametrize("label_rank", ["same", "squeezed"])
def test_matches_jax(reduction, ignore_some, label_smoothing, label_rank):
    logits, labels = _inputs(int(ignore_some) + 2, ignore_some)
    lab = labels[..., None] if label_rank == "same" else labels
    kw = dict(reduction=reduction, label_smoothing=label_smoothing)
    jx, jout = _jax_ce(logits, lab, **kw)
    tx = torch.from_numpy(logits).requires_grad_()
    out = cross_entropy(tx, torch.from_numpy(lab), **kw)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(jout.numpy()), atol=TOL, rtol=TOL)
    if reduction != "none":
        jout.backward()
        out.backward()
        np.testing.assert_allclose(tx.grad.numpy(),
                                   np.asarray(jx.grad.numpy()), atol=TOL,
                                   rtol=0)


def test_probabilities_without_softmax_match_jax():
    """use_softmax=False takes the input as probabilities (log of a
    clipped input), as the JAX package does."""
    logits, labels = _inputs(7, True)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    probs = probs.astype(np.float32)
    _, jout = _jax_ce(probs, labels, use_softmax=False)
    out = cross_entropy(torch.from_numpy(probs), torch.from_numpy(labels),
                        use_softmax=False)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout.numpy()),
                               atol=TOL, rtol=TOL)


def test_mean_over_valid_labels_only():
    logits, labels = _inputs(5, False)
    labels[0] = -100
    full = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                         reduction="none")
    mean = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    assert torch.all(full[0] == 0)
    torch.testing.assert_close(mean, full.sum() / 40)
    # every label ignored: the denominator stays 1, the loss 0
    none_valid = cross_entropy(torch.from_numpy(logits),
                               torch.full((3, 20), -100))
    assert none_valid.item() == 0.0


def test_unported_options_raise():
    logits, labels = (torch.from_numpy(a) for a in _inputs(1, False))
    with pytest.raises(NotImplementedError):
        cross_entropy(logits, labels, weight=torch.ones(37))
    with pytest.raises(NotImplementedError):
        cross_entropy(logits, torch.softmax(logits, -1), soft_label=True)
