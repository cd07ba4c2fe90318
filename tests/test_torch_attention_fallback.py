"""The attention functionals' routing rule: what no kernel covers runs the
plain version under autograd, as the reference runs its XLA attention.

`attention_route(dtype, head_dim)` sends float32 and bf16 at a head dim in
HEAD_DIMS (64, 128, 256) to the kernels ("kernel") and every other head
dim and float16 to the plain version ("plain"), decided before any
launch, on every device. At D 32 and 96 the same numpy arrays (float32)
go through the JAX package's entry points (on the CPU its XLA attention)
and the port's: outputs held to 1e-5 and gradients (the JAX package's
tape against torch.autograd, with one random cotangent) to 1e-5 of each
gradient's largest magnitude, since both compute softmax(q k^T / sqrt(D))
v in float32 and differ in summation order only. At D 96 the same holds
in bf16 and float16 within four of the dtype's epsilons of the largest
value (LOW_EPS_MULT). The inputs have no keyless row, where the
reference's CPU fallback and its kernels differ.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.nn.functional as jF
from paddle_tpu.nn.functional.extras import (
    flash_attention_with_sparse_mask as jax_sparse_mask)
from paddle_tpu.nn.functional.flash_attention import (
    flash_attn_unpadded as jax_unpadded)

from paddle_tpu_torch.nn.functional import (
    ATTENTION_ROUTES, attention_route, flash_attention,
    flash_attention_with_sparse_mask, flash_attn_qkvpacked,
    flash_attn_unpadded, flash_attn_varlen_qkvpacked)

ATOL = 1e-5
B, S, H = 2, 64, 2
DOCS = (20, 44)            # as cu_seqlens and as start rows


@pytest.mark.parametrize("d", [16, 32, 64, 80, 96, 128, 160, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.float64])
def test_route_truth_table(dtype, d):
    kernel = dtype in (torch.float32, torch.bfloat16) and d in (64, 128, 256)
    assert attention_route(dtype, d) == ("kernel" if kernel else "plain")
    assert attention_route(dtype, d) in ATTENTION_ROUTES


def _arrays(seed, d, shape=None):
    rng = np.random.default_rng(seed)
    shape = shape or (B, S, H, d)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]


def _jax_leaves(arrays):
    ts = [pt.to_tensor(a) for a in arrays]
    for t in ts:
        t.stop_gradient = False
    return ts


def _torch_leaves(arrays):
    return [torch.tensor(a).requires_grad_() for a in arrays]


def _check(out, jout, tleaves, jleaves):
    np.testing.assert_allclose(out.detach().numpy(), jout.numpy(),
                               atol=ATOL, rtol=0)
    for name, t, j in zip(("dq", "dk", "dv"), tleaves, jleaves):
        ref = j.grad.numpy()
        top = np.abs(ref).max()
        np.testing.assert_allclose(t.grad.numpy() / top, ref / top,
                                   atol=ATOL, rtol=0, err_msg=name)


def _backward(out, g, lib):
    (out * (pt.to_tensor(g) if lib == "jax" else torch.from_numpy(g))) \
        .sum().backward()


def _plain_counted(fn, before):
    assert fn.route_launches["plain"] == before["plain"] + 1
    assert fn.route_launches["kernel"] == before["kernel"]


@pytest.mark.parametrize("d", [32, 96])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_falls_back_to_the_reference(d, causal):
    q, k, v, g = _arrays(d + causal, d)
    jl = _jax_leaves((q, k, v))
    jout, _ = jF.flash_attention(*jl, causal=causal)
    _backward(jout, g, "jax")
    tl = _torch_leaves((q, k, v))
    before = dict(flash_attention.route_launches)
    out, none = flash_attention(*tl, causal=causal)
    _plain_counted(flash_attention, before)
    assert none is None and out.dtype == torch.float32
    _backward(out, g, "torch")
    _check(out, jout, tl, jl)


@pytest.mark.parametrize("d", [32, 96])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attn_unpadded_falls_back_to_the_reference(d, causal):
    total = sum(DOCS) * B
    q, k, v, g = _arrays(2 * d + causal, d, (total, H, d))
    cu = np.cumsum([0] + list(DOCS) * B).astype(np.int32)
    scale = float(d ** -0.5)
    jl = _jax_leaves((q, k, v))
    jout = jax_unpadded(*jl, pt.to_tensor(cu), pt.to_tensor(cu), 44, 44,
                        scale, causal=causal)
    _backward(jout, g, "jax")
    tl = _torch_leaves((q, k, v))
    before = dict(flash_attn_unpadded.route_launches)
    out = flash_attn_unpadded(*tl, torch.from_numpy(cu), torch.from_numpy(cu),
                              44, 44, scale, causal=causal)
    _plain_counted(flash_attn_unpadded, before)
    _backward(out, g, "torch")
    _check(out, jout, tl, jl)


@pytest.mark.parametrize("d", [32, 96])
@pytest.mark.parametrize("causal", [True, False])
def test_sparse_mask_falls_back_to_the_reference(d, causal):
    """Documents as start rows: every row sees its own document's columns
    (and, without causal, the later documents'), so none is keyless."""
    q, k, v, g = _arrays(3 * d + causal, d)
    ends = np.cumsum(DOCS)
    start = np.broadcast_to(np.repeat(ends, DOCS).astype(np.int32),
                            (B, H, S)).copy()
    jl = _jax_leaves((q, k, v))
    jout = jax_sparse_mask(*jl, pt.to_tensor(start), is_causal=causal)
    _backward(jout, g, "jax")
    tl = _torch_leaves((q, k, v))
    before = dict(flash_attention_with_sparse_mask.route_launches)
    out = flash_attention_with_sparse_mask(*tl, torch.from_numpy(start),
                                           is_causal=causal)
    _plain_counted(flash_attention_with_sparse_mask, before)
    _backward(out, g, "torch")
    _check(out, jout, tl, jl)


def test_packed_forms_count_through_their_functionals():
    """flash_attn_qkvpacked counts on flash_attention and
    flash_attn_varlen_qkvpacked on flash_attn_unpadded; at D 64 in float32
    both take the kernel route (their plain versions on the CPU)."""
    rng = np.random.default_rng(5)
    for d, route in ((32, "plain"), (64, "kernel")):
        qkv = torch.from_numpy(rng.standard_normal((B, S, 3, H, d))
                               .astype(np.float32))
        before = flash_attention.route_launches[route]
        out, _ = flash_attn_qkvpacked(qkv, causal=True)
        assert flash_attention.route_launches[route] == before + 1
        ref, _ = jF.flash_attention(*(pt.to_tensor(qkv[:, :, i].numpy())
                                      for i in range(3)), causal=True)
        np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=ATOL)
        cu = torch.tensor([0, 20, 64, 100, 128], dtype=torch.int32)
        before = flash_attn_unpadded.route_launches[route]
        flash_attn_varlen_qkvpacked(qkv.reshape(B * S, 3, H, d), cu, cu, 44,
                                    44, causal=True)
        assert flash_attn_unpadded.route_launches[route] == before + 1


def test_float16_takes_the_plain_route():
    """float16 has no kernel: the plain version, in float32 inside and
    float16 out, equal to the float32 computation on the same values
    rounded to float16."""
    q, k, v, _ = _arrays(9, 64)
    h = [torch.from_numpy(a).half() for a in (q, k, v)]
    before = dict(flash_attention.route_launches)
    out, _ = flash_attention(*h, causal=True)
    _plain_counted(flash_attention, before)
    assert out.dtype == torch.float16
    ref, _ = flash_attention(*(t.float() for t in h), causal=True)
    assert torch.equal(out, ref.half())


# Low precision against the reference: the reference's plain attention
# rounds its scores, its probabilities and its output to the input dtype
# (softmax in float32), the port's plain version rounds only its output
# (float32 inside). Each rounding moves a value by at most half the dtype's
# epsilon (2^-7 for bf16, 2^-10 for float16) of itself; through the
# softmax and the products these differences stay near one epsilon of the
# largest output or gradient (at most 1.25 epsilons seen at these shapes),
# so the bound is four epsilons of the largest. A wrong scale, mask or
# document boundary moves values by a large part of their magnitude.
LOW_EPS_MULT = 4


def _low_arrays(seed, shape, dtype):
    """The same values in both libraries: float32 draws rounded to dtype."""
    rng = np.random.default_rng(seed)
    ts = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
          .to(dtype) for _ in range(4)]
    return ts, [t.float().numpy() for t in ts]


def _check_low(out, jout, tleaves, jleaves, dtype):
    eps = torch.finfo(dtype).eps
    assert out.dtype == dtype

    def close(got, ref, what):
        ref = np.asarray(ref.astype("float32").numpy())
        got = got.float().detach().numpy()
        bound = LOW_EPS_MULT * eps * np.abs(ref).max()
        assert np.abs(got - ref).max() <= bound, (what, np.abs(got - ref)
                                                  .max(), bound)
    close(out, jout, "out")
    for name, t, j in zip(("dq", "dk", "dv"), tleaves, jleaves):
        assert t.grad.dtype == dtype
        close(t.grad, j.grad, name)


@pytest.mark.parametrize("entry", ["flash_attention", "flash_attn_unpadded",
                                   "flash_attention_with_sparse_mask"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_low_precision_falls_back_to_the_reference(dtype, causal, entry):
    """bf16 and float16 at D 96 (float16 takes no kernel at any D) through
    each entry point and the JAX package's, on the same rounded values:
    outputs and q, k, v gradients within LOW_EPS_MULT epsilons of the
    largest, on the counted plain route."""
    d = 96
    name = str(dtype).split(".")[-1]
    packed = entry == "flash_attn_unpadded"
    shape = (sum(DOCS) * B, H, d) if packed else (B, S, H, d)
    ts, vals = _low_arrays(d + causal + 2 * packed, shape, dtype)
    jl = [pt.to_tensor(v, dtype=name) for v in vals[:3]]
    for t in jl:
        t.stop_gradient = False
    tl = [t.clone().requires_grad_() for t in ts[:3]]
    if entry == "flash_attention":
        jout, _ = jF.flash_attention(*jl, causal=causal)
        fn = flash_attention
        before = dict(fn.route_launches)
        out, _ = fn(*tl, causal=causal)
    elif packed:
        cu = np.cumsum([0] + list(DOCS) * B).astype(np.int32)
        scale = float(d ** -0.5)
        jout = jax_unpadded(*jl, pt.to_tensor(cu), pt.to_tensor(cu), 44, 44,
                            scale, causal=causal)
        fn = flash_attn_unpadded
        before = dict(fn.route_launches)
        out = fn(*tl, torch.from_numpy(cu), torch.from_numpy(cu), 44, 44,
                 scale, causal=causal)
    else:
        ends = np.cumsum(DOCS)
        start = np.broadcast_to(np.repeat(ends, DOCS).astype(np.int32),
                                (B, H, S)).copy()
        jout = jax_sparse_mask(*jl, pt.to_tensor(start), is_causal=causal)
        fn = flash_attention_with_sparse_mask
        before = dict(fn.route_launches)
        out = fn(*tl, torch.from_numpy(start), is_causal=causal)
    _plain_counted(fn, before)
    (jout.astype("float32") * pt.to_tensor(vals[3])).sum().backward()
    (out.float() * torch.from_numpy(vals[3])).sum().backward()
    _check_low(out, jout, tl, jl, dtype)
