"""The port's block-scaled weight codec and quant_matmul against the JAX
package, on the CPU.

The JAX codec quantizes paddle's [K, N] weights in blocks along K; the
port quantizes torch's [N, K] layout along its last dim. Given w [K, N],
the port's codes and scales of w.T must equal JAX's codes and scales
transposed, bit for bit (both round half to even). The port's plain
quant_matmul is held against JAX's Pallas kernel (``impl="kernel"``,
interpret mode on the CPU) within 1e-5 of the output's largest magnitude,
in float32: the two sum K products in different orders.

The CUDA kernels are held against the plain version on the card by
tests/test_torch_cuda_kernels.py. Here, on the CPU, the tensor-core
kernel's arithmetic is checked by an emulation: every code is exact in
bf16, the products of bf16 codes and bf16 x are summed per K-block (in
float64 here, float32 on the card) and the float32 scale is applied to
each block's partial; that emulation is held against JAX's kernel within
the same 1e-5 of the largest output. The tensor-core GEMV's arithmetic
is emulated the same way with its K-slices written out (a float32
partial a K-block, the scale on a float32 accumulator a slice, the
slices summed in their fixed order in float32) and held to JAX's kernel
too. The wrapper's choice of kernel (`qmm_route`) is checked over dtype,
M, block and alignment.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from paddle_tpu.kernels.pallas import quant_matmul as jqm

from paddle_tpu_torch.kernels.quant_matmul import (
    FP8_MAX, INT8_MAX, QK_BLOCK, QMM_ROUTES, ROWS_MAX_M,
    blockwise_weight_bytes, dequantize_weight_blockwise, qmm_route,
    quant_error_bound, quant_matmul, quant_matmul_plain,
    quantize_weight_blockwise)

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


# -- the tensor-core kernel's arithmetic ----------------------------------------

@pytest.mark.parametrize("qdtype", ["int8", "fp8"])
def test_every_code_is_exact_in_bf16(qdtype):
    """All 255 int8 codes (-127..127) and every finite e4m3 value survive
    code -> bfloat16 -> float32 unchanged, so the tensor cores can take
    the codes themselves."""
    if qdtype == "int8":
        codes = torch.arange(-127, 128, dtype=torch.int8)
        assert codes.numel() == 255
    else:
        codes = torch.arange(256, dtype=torch.int32).to(torch.uint8).view(
            torch.float8_e4m3fn)
        codes = codes[torch.isfinite(codes.float())]
        assert codes.numel() == 254         # 0x7f and 0xff are NaN
        assert codes.float().abs().max() == FP8_MAX
    exact = codes.float()
    np.testing.assert_array_equal(
        codes.to(torch.bfloat16).float().numpy(), exact.numpy())


def _wgmma_emulation(x, codes, scales):
    """The tensor-core kernel's arithmetic: bf16 codes times bf16 x summed
    per K-block (float64 here), the block's float32 scale applied to its
    partial, the blocks summed."""
    k = codes.shape[-1]
    kb = scales.shape[-1]
    bk = k // kb
    xb = x.to(torch.bfloat16).double()
    cb = codes.to(torch.bfloat16).double()
    out = torch.zeros(x.shape[0], codes.shape[0], dtype=torch.float64)
    for j in range(kb):
        blk = slice(j * bk, (j + 1) * bk)
        out += scales[:, j].double() * (xb[:, blk] @ cb[:, blk].t())
    return out


@pytest.mark.parametrize("qdtype", ["int8", "fp8"])
@pytest.mark.parametrize("k", [256, 384])
@pytest.mark.parametrize("block_k", [128, 64])
@pytest.mark.parametrize("m", [40, 100])
def test_wgmma_arithmetic_matches_jax_kernel(qdtype, k, block_k, m):
    """The emulation against JAX's Pallas kernel in interpret mode on the
    same bf16-valued x, within 1e-5 of the largest output (the two sum in
    different orders); folding the scale into a bf16 weight instead
    misses by more than ten times that."""
    n = 48
    rng = np.random.default_rng(k + block_k + m)
    w = rng.standard_normal((k, n)).astype(np.float32)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(
        np.float32)).to(torch.bfloat16).float().numpy()
    jc, js = jqm.quantize_weight_blockwise(jnp.asarray(w), block_k=block_k,
                                           qdtype=qdtype)
    ref = np.asarray(jqm.quant_matmul(jnp.asarray(x), jc, js,
                                      impl="kernel"))
    tc, ts = quantize_weight_blockwise(torch.from_numpy(w.T.copy()),
                                       block_k, qdtype)
    out = _wgmma_emulation(torch.from_numpy(x), tc, ts).numpy()
    top = np.abs(ref).max()
    np.testing.assert_allclose(out, ref, atol=REL_TOL * top, rtol=0)
    folded = dequantize_weight_blockwise(tc, ts).to(torch.bfloat16).double()
    miss = np.abs((torch.from_numpy(x).double() @ folded.t()).numpy()
                  - ref).max()
    assert miss > 10 * REL_TOL * top


@pytest.mark.parametrize("m,dtype,block_k,x_ptr,codes_ptr,route", [
    (1, torch.bfloat16, 128, 0, 0, "gemv_tc"),
    (ROWS_MAX_M, torch.bfloat16, 128, 0, 0, "gemv_tc"),
    (8, torch.bfloat16, 16, 256, 4096, "gemv_tc"),
    (8, torch.bfloat16, 96, 16, 32, "gemv_tc"),
    (ROWS_MAX_M, torch.float32, 128, 4, 1, "rows"),
    (8, torch.float32, 128, 0, 0, "rows"),
    (1, torch.float32, 16, 0, 0, "rows"),
    (8, torch.bfloat16, 8, 0, 0, "rows"),
    (8, torch.bfloat16, 12, 0, 0, "rows"),
    (8, torch.bfloat16, 105, 0, 0, "rows"),
    (8, torch.bfloat16, 128, 8, 0, "rows"),
    (8, torch.bfloat16, 128, 2, 0, "rows"),
    (8, torch.bfloat16, 128, 0, 4, "rows"),
    (ROWS_MAX_M + 1, torch.bfloat16, 128, 0, 0, "wgmma"),
    (1024, torch.bfloat16, 64, 256, 4096, "wgmma"),
    (1024, torch.bfloat16, 256, 16, 32, "wgmma"),
    (1024, torch.bfloat16, 16, 0, 0, "tiled"),
    (1024, torch.bfloat16, 96, 16, 32, "tiled"),
    (1024, torch.float32, 128, 0, 0, "tiled"),
    (1024, torch.bfloat16, 105, 0, 0, "tiled"),
    (1024, torch.bfloat16, 8, 0, 0, "tiled"),
    (1024, torch.bfloat16, 128, 8, 0, "tiled"),
    (1024, torch.bfloat16, 128, 0, 4, "tiled"),
])
def test_route_choice(m, dtype, block_k, x_ptr, codes_ptr, route):
    """Up to ROWS_MAX_M rows, gemv_tc for bf16 x, blocks of whole k16
    steps and 16-byte aligned x and codes, rows otherwise (float32 x: the
    head); above, wgmma for bf16 x, blocks of whole 64-deep stages and
    16-byte aligned x and codes, tiled otherwise."""
    assert route in QMM_ROUTES
    assert qmm_route(m, dtype, block_k, x_ptr, codes_ptr) == route


def _gemv_tc_emulation(x, codes, scales, splits):
    """The tensor-core GEMV's arithmetic with its order written out: exact
    products of bf16 x and bf16 codes summed per K-block into a float32
    partial, each slice's partials scaled onto a float32 accumulator in
    block order (fmaf: one rounding), the slices' accumulators summed in
    slice order in float32."""
    k = codes.shape[-1]
    kb = scales.shape[-1]
    bk = k // kb
    xb = x.to(torch.bfloat16).double()
    cb = codes.to(torch.bfloat16).double()
    out = torch.zeros(x.shape[0], codes.shape[0], dtype=torch.float32)
    for r in range(splits):
        acc = torch.zeros_like(out)
        for j in range(r * kb // splits, (r + 1) * kb // splits):
            blk = slice(j * bk, (j + 1) * bk)
            part = (xb[:, blk] @ cb[:, blk].t()).float()
            acc = (scales[:, j].double() * part.double()
                   + acc.double()).float()
        out = out + acc
    return out


@pytest.mark.parametrize("qdtype", ["int8", "fp8"])
@pytest.mark.parametrize("k,block_k", [(384, 128), (256, 16)])
@pytest.mark.parametrize("m", [1, 8, 32])
def test_gemv_tc_arithmetic_matches_jax_kernel(qdtype, k, block_k, m):
    """The emulation against JAX's Pallas kernel in interpret mode on the
    same bf16-valued x, within 1e-5 of the largest output (the two sum in
    different orders), for cuts of K the kernel takes: one slice, 2 and 3
    (at bk 128, 1 or 2 K-blocks and one each; at bk 16, 5 to 8) and, at
    bk 16, 7 (2 or 3 each), the most it takes."""
    n = 48
    rng = np.random.default_rng(k + block_k + m)
    w = rng.standard_normal((k, n)).astype(np.float32)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(
        np.float32)).to(torch.bfloat16).float().numpy()
    jc, js = jqm.quantize_weight_blockwise(jnp.asarray(w), block_k=block_k,
                                           qdtype=qdtype)
    ref = np.asarray(jqm.quant_matmul(jnp.asarray(x), jc, js,
                                      impl="kernel"))
    tc, ts = quantize_weight_blockwise(torch.from_numpy(w.T.copy()),
                                       block_k, qdtype)
    top = np.abs(ref).max()
    for splits in (1, 2, 3, 7):
        if splits > k // block_k:
            continue
        out = _gemv_tc_emulation(torch.from_numpy(x), tc, ts,
                                 splits).numpy()
        np.testing.assert_allclose(out, ref, atol=REL_TOL * top, rtol=0,
                                   err_msg=f"{splits} slices")


def test_cpu_call_counts_no_route():
    """A CPU tensor takes the plain version: no kernel, no route."""
    rng = np.random.default_rng(2)
    w = torch.from_numpy(rng.standard_normal((16, 64)).astype(np.float32))
    codes, scales = quantize_weight_blockwise(w)
    before = dict(quant_matmul.route_launches)
    quant_matmul(torch.ones(64, 64, dtype=torch.bfloat16), codes, scales)
    assert quant_matmul.route_launches == before
