"""The port's grouped quantized matmul against the JAX package, on the CPU.

The JAX codec quantizes an expert stack w [E, K, N] into codes [E, K, N]
and scales [E, K // block_k, N]. The port quantizes the stack in its
[E, N, K] view (kernels/quant_matmul.py's layout, blocks along the last
dim), and its codes and scales must equal JAX's transposed, bit for bit.
``quant_grouped_matmul`` (the plain version of the CUDA kernel on CPU
tensors) is held against JAX's Pallas kernel ``_gq_kernel`` in interpret
mode (``impl="kernel"``), and ``quantized_grouped_linear``'s
straight-through gradients against JAX's custom VJP.

Tolerances: 1e-5 of each tensor's largest element in float32 (both
dequantize to the same float32 weights and sum K products in different
orders), and for bf16 activations one bf16 ulp of the value plus that.
Only the rows ``dest`` points at are compared (padding rows are
unspecified in both).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import paddle_tpu  # noqa: F401  (x64 on, as in the JAX package's tests)
from paddle_tpu.kernels.pallas import grouped_matmul as jgm
from paddle_tpu.kernels.pallas import quant_matmul as jqm

from paddle_tpu_torch.kernels.grouped_matmul import grouped_metadata
from paddle_tpu_torch.kernels.quant_matmul import (
    configure_matmul_quant, get_matmul_quant, quant_grouped_matmul,
    quant_grouped_matmul_plain, quantize_weight_blockwise,
    quantized_grouped_linear)

REL_TOL = 1e-5
BF16_RTOL = 2.0 ** -7
E, BM = 4, 8


def _setup(k, n, seed, t=37):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, E - 1, t).astype(np.int32)   # expert 3 is empty
    jmd = jgm.grouped_metadata(jnp.asarray(ids), E, BM)
    tmd = grouped_metadata(torch.from_numpy(ids), E, BM)
    row_src = np.asarray(jmd["row_src"])
    x = rng.standard_normal((t, k)).astype(np.float32)
    buf = np.where((row_src >= 0)[:, None], x[np.clip(row_src, 0, None)],
                   0).astype(np.float32)
    w = rng.standard_normal((E, k, n)).astype(np.float32)
    w[1, :, 0] *= 30.0                          # a column of its own range
    w[2, :, 1] = 0.0                            # an all-zero column
    b = rng.standard_normal((E, n)).astype(np.float32)
    return jmd, tmd, buf, w, b


def _close(got, ref, bf16=False):
    lim = REL_TOL * np.abs(ref).max() + (BF16_RTOL * np.abs(ref) if bf16
                                         else 0.0)
    assert (np.abs(got - ref) <= lim).all(), np.abs(got - ref).max()


@pytest.mark.parametrize("qdtype", ["int8", "fp8"])
@pytest.mark.parametrize("k,block_k", [(64, None), (192, 64), (256, None)])
def test_stacked_codec_bit_identical(qdtype, k, block_k):
    _, _, _, w, _ = _setup(k, 24, seed=k)
    jc, js = jqm.quantize_weight_blockwise(jnp.asarray(w), block_k, qdtype)
    tc, ts = quantize_weight_blockwise(torch.from_numpy(w).transpose(1, 2),
                                       block_k, qdtype)
    assert tc.is_contiguous() and ts.is_contiguous()
    assert tuple(tc.shape) == (E, 24, k)
    jc_t = np.ascontiguousarray(np.swapaxes(np.asarray(jc), 1, 2))
    np.testing.assert_array_equal(tc.view(torch.uint8).numpy(),
                                  jc_t.view(np.uint8))
    np.testing.assert_array_equal(ts.numpy(),
                                  np.swapaxes(np.asarray(js), 1, 2))
    assert (ts[2, 1] == 1.0).all()               # zero column: unit scale


@pytest.mark.parametrize("qdtype", ["int8", "fp8"])
@pytest.mark.parametrize("k,n,block_k", [(64, 48, None), (192, 40, 64)])
def test_matches_jax_grouped_kernel(qdtype, k, n, block_k):
    jmd, tmd, buf, w, _ = _setup(k, n, seed=k + n)
    jc, js = jqm.quantize_weight_blockwise(jnp.asarray(w), block_k, qdtype)
    ref = np.asarray(jqm.quant_grouped_matmul(
        jnp.asarray(buf), jc, js, group_offsets=jmd["offsets"],
        group_counts=jmd["counts"], bm=BM, bn=16, impl="kernel"))
    tc, ts = quantize_weight_blockwise(torch.from_numpy(w).transpose(1, 2),
                                       block_k, qdtype)
    before = quant_grouped_matmul.launches
    out = quant_grouped_matmul(torch.from_numpy(buf), tc, ts,
                               group_offsets=tmd["offsets"],
                               group_counts=tmd["counts"], bm=BM)
    assert quant_grouped_matmul.launches == before   # the CPU: plain path
    assert out.dtype == torch.float32 and tuple(out.shape) == (buf.shape[0],
                                                               n)
    d = np.asarray(jmd["dest"])
    _close(out.numpy()[d], ref[d])


def test_bf16_activations():
    jmd, tmd, buf, w, _ = _setup(64, 32, seed=5)
    buf = torch.from_numpy(buf).to(torch.bfloat16)
    jc, js = jqm.quantize_weight_blockwise(jnp.asarray(w))
    ref = np.asarray(jqm.quant_grouped_matmul(
        jnp.asarray(buf.float().numpy(), jnp.bfloat16), jc, js,
        group_offsets=jmd["offsets"], group_counts=jmd["counts"], bm=BM,
        bn=16, impl="kernel").astype(jnp.float32))
    tc, ts = quantize_weight_blockwise(torch.from_numpy(w).transpose(1, 2))
    out = quant_grouped_matmul(buf, tc, ts, group_offsets=tmd["offsets"],
                               group_counts=tmd["counts"], bm=BM)
    assert out.dtype == torch.bfloat16
    d = np.asarray(jmd["dest"])
    _close(out.float().numpy()[d], ref[d], bf16=True)


@pytest.mark.parametrize("qdtype", ["int8", "fp8"])
def test_ste_gradients_match_jax(qdtype):
    """Forward values through the quantized kernel, dx/dw/db in full
    precision against the unquantized weight (JAX's `_qgmm_vjp`)."""
    k, n = 64, 32
    jmd, tmd, buf, w, b = _setup(k, n, seed=13)
    g = np.random.default_rng(14).standard_normal((37, n)).astype(
        np.float32)
    dest = jmd["dest"]

    def jloss(buf, w, b):
        o = jqm.quantized_grouped_linear(
            buf, w, b, group_offsets=jmd["offsets"],
            group_counts=jmd["counts"], qdtype=qdtype, bm=BM, bn=16,
            impl="kernel")
        return jnp.sum(o[dest] * g), o

    (_, jout), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                       has_aux=True)(
        jnp.asarray(buf), jnp.asarray(w), jnp.asarray(b))
    ts = [torch.from_numpy(a).requires_grad_() for a in (buf, w, b)]
    out = quantized_grouped_linear(*ts, group_offsets=tmd["offsets"],
                                   group_counts=tmd["counts"],
                                   qdtype=qdtype, bm=BM)
    (out[tmd["dest"].long()] * torch.from_numpy(g)).sum().backward()
    d = np.asarray(dest)
    _close(out.detach().numpy()[d], np.asarray(jout)[d])
    valid = np.asarray(jmd["row_valid"])
    for name, r, t in zip(("dx", "dw", "db"), jg, ts):
        r, t = np.asarray(r), t.grad.numpy()
        if name == "dx":
            r, t = r[valid], t[valid]
        _close(t, r)


def test_plain_version_is_the_dequantized_grouped_product():
    _, tmd, buf, w, _ = _setup(64, 16, seed=15)
    tc, ts = quantize_weight_blockwise(torch.from_numpy(w).transpose(1, 2))
    out = quant_grouped_matmul_plain(torch.from_numpy(buf), tc, ts,
                                     tmd["offsets"], tmd["counts"], BM)
    assert out.shape == (buf.shape[0], 16)
    with pytest.raises(ValueError):
        quant_grouped_matmul(torch.from_numpy(buf), tc[:, :, :32], ts,
                             group_offsets=tmd["offsets"],
                             group_counts=tmd["counts"], bm=BM)
    with pytest.raises(ValueError, match="qdtype"):
        quantized_grouped_linear(torch.from_numpy(buf), torch.from_numpy(w),
                                 group_offsets=tmd["offsets"],
                                 group_counts=tmd["counts"], qdtype="int4")


def test_matmul_quant_knob_mirrors_jax():
    before = get_matmul_quant()
    try:
        for val in ("int8", "fp8", None):
            assert configure_matmul_quant(val) == \
                jqm.configure_matmul_quant(val) == {"dtype": val}
            assert get_matmul_quant() == val
        assert configure_matmul_quant("none") == {"dtype": None}
        with pytest.raises(ValueError):
            configure_matmul_quant("int4")
    finally:
        configure_matmul_quant(before)
        jqm.configure_matmul_quant(before)
