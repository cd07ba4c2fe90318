"""The port's block-scaled weight codec and quant_matmul against the JAX
package, on the CPU.

The JAX codec quantizes paddle's [K, N] weights in blocks along K; the
port quantizes torch's [N, K] layout along its last dim. Given w [K, N],
the port's codes and scales of w.T must equal JAX's codes and scales
transposed, bit for bit (both round half to even). The port's plain
quant_matmul is held against JAX's Pallas kernel (``impl="kernel"``,
interpret mode on the CPU) within 1e-5 of the output's largest magnitude,
in float32: the two sum K products in different orders.

The CUDA kernel is held against the plain version on the card by
tests/test_torch_cuda_kernels.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from paddle_tpu.kernels.pallas import quant_matmul as jqm

from paddle_tpu_torch.kernels.quant_matmul import (
    FP8_MAX, INT8_MAX, QK_BLOCK, blockwise_weight_bytes,
    dequantize_weight_blockwise, quant_error_bound, quant_matmul,
    quant_matmul_plain, quantize_weight_blockwise)

REL_TOL = 1e-5


def _weight(seed, k, n, block):
    """[K, N] float32 with a column of its own range (1), a zero first
    block in column 0 and an all-zero column (2)."""
    w = np.random.default_rng(seed).standard_normal((k, n)).astype(
        np.float32)
    w[:, 1] *= 40.0
    w[:block, 0] = 0.0
    w[:, 2] = 0.0
    return w


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.uint8)


def test_constants_match():
    assert QK_BLOCK == jqm.QK_BLOCK
    assert INT8_MAX == float(jqm.INT8_MAX) and FP8_MAX == float(jqm.FP8_MAX)


@pytest.mark.parametrize("qdtype", ["int8", "fp8"])
@pytest.mark.parametrize("k,block", [(64, 64), (192, 96), (256, 128)])
def test_codec_bit_identical(qdtype, k, block):
    """K = 64 is one block of 64, 192 blocks of 96 (below 128), 256 two
    blocks of 128; column 2 and column 0's first block are zero (unit
    scale, exact)."""
    w = _weight(k, k, 24, block)
    jc, js = jqm.quantize_weight_blockwise(jnp.asarray(w), qdtype=qdtype)
    tc, ts = quantize_weight_blockwise(torch.from_numpy(w.T.copy()),
                                       qdtype=qdtype)
    assert ts.shape == (24, k // block)
    assert tc.dtype == (torch.int8 if qdtype == "int8"
                        else torch.float8_e4m3fn)
    jc_t = np.asarray(jc).T
    tc_np = tc.view(torch.uint8).numpy()
    np.testing.assert_array_equal(tc_np, _bits(jc_t).reshape(tc_np.shape))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js).T)
    assert (ts[2] == 1.0).all() and ts[0, 0] == 1.0
    assert (tc.view(torch.uint8)[2] == 0).all()
    # the round trip stays inside the codec's own bound
    deq = dequantize_weight_blockwise(tc, ts)
    np.testing.assert_array_equal(
        deq.numpy(), np.asarray(jqm.dequantize_weight_blockwise(jc, js)).T)
    bound = quant_error_bound(torch.from_numpy(w.T.copy()), ts, qdtype)
    assert ((deq - torch.from_numpy(w.T.copy())).abs() <= bound + 1e-6).all()


def test_codec_stacked_layers_and_explicit_block():
    w = np.random.default_rng(3).standard_normal((3, 128, 40)).astype(
        np.float32)
    jc, js = jqm.quantize_weight_blockwise(jnp.asarray(w), block_k=32)
    tc, ts = quantize_weight_blockwise(
        torch.from_numpy(np.swapaxes(w, 1, 2).copy()), block_k=32)
    np.testing.assert_array_equal(tc.numpy(),
                                  np.swapaxes(np.asarray(jc), 1, 2))
    np.testing.assert_array_equal(ts.numpy(),
                                  np.swapaxes(np.asarray(js), 1, 2))
    with pytest.raises(ValueError):
        quantize_weight_blockwise(torch.zeros(4, 10), block_k=3)
    with pytest.raises(ValueError):
        quantize_weight_blockwise(torch.zeros(4, 8), qdtype="int4")


@pytest.mark.parametrize("k,n,block_k", [(4096, 4096, None),
                                         (11008, 4096, None),
                                         (192, 24, None), (256, 8, 64)])
def test_weight_bytes_match(k, n, block_k):
    assert blockwise_weight_bytes(k, n, block_k) == \
        jqm.blockwise_weight_bytes(k, n, block_k)


@pytest.mark.parametrize("qdtype", ["int8", "fp8"])
@pytest.mark.parametrize("lead,k,n", [((5,), 64, 48), ((2, 3), 192, 40),
                                      ((1,), 256, 130)])
def test_plain_matches_jax_kernel(qdtype, lead, k, n):
    rng = np.random.default_rng(k + n)
    w = rng.standard_normal((k, n)).astype(np.float32)
    x = rng.standard_normal(lead + (k,)).astype(np.float32)
    jc, js = jqm.quantize_weight_blockwise(jnp.asarray(w), qdtype=qdtype)
    ref = np.asarray(jqm.quant_matmul(jnp.asarray(x), jc, js,
                                      impl="kernel"))
    tc, ts = quantize_weight_blockwise(torch.from_numpy(w.T.copy()),
                                       qdtype=qdtype)
    before = quant_matmul.launches
    out = quant_matmul(torch.from_numpy(x), tc, ts)
    assert quant_matmul.launches == before     # the CPU takes the plain path
    assert out.dtype == torch.float32 and out.shape == lead + (n,)
    top = np.abs(ref).max()
    np.testing.assert_allclose(out.numpy(), ref, atol=REL_TOL * top, rtol=0)


def test_plain_keeps_bf16_and_checks_inputs():
    rng = np.random.default_rng(1)
    w = torch.from_numpy(rng.standard_normal((16, 64)).astype(np.float32))
    codes, scales = quantize_weight_blockwise(w)
    x = torch.from_numpy(rng.standard_normal((3, 64)).astype(np.float32))
    out = quant_matmul(x.to(torch.bfloat16), codes, scales)
    assert out.dtype == torch.bfloat16
    ref = quant_matmul_plain(x.to(torch.bfloat16).float(), codes, scales)
    torch.testing.assert_close(out.float(), ref.to(torch.bfloat16).float())
    with pytest.raises(ValueError):
        quant_matmul(x[:, :32], codes, scales)
    with pytest.raises(TypeError):
        quant_matmul(x, codes.float(), scales)
