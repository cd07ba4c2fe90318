#!/usr/bin/env python3
"""Drive the PyTorch port (paddle_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--layers N] [--seed S] [--profile]

Phases, each printing one JSON line; any failure exits non-zero:

1. the card's name and power limit, as nvidia-smi gives them;
2. the build of every CUDA kernel of the serving and training paths (one
   nvcc per source, all started together), then each kernel of the
   serving paths against its plain PyTorch version on the card at the
   serving shapes, with its time, the plain version's time, one PyTorch
   library call's time (a yardstick the port never calls) and the least
   time the card could take: ragged and flash attention, then
   quant_matmul (the decode projections at 8 slots, the head, a
   1024-row prefill product, fp8 codes), ragged attention over the int8
   pool and the split-context partials;
3. PagedDecoder.serve at Llama-2-7B widths (bf16, random weights from a
   seeded torch.Generator) on 16 requests: every request gets its budget
   and the ragged kernel ran once per layer per decode step;
4. the same requests at 4 layers in float32, with the ragged kernel and
   with the dense-gather oracle: the token streams must be identical, and
   two of them must equal greedy generation through the full forward;
5. CachedDecoder.generate at full width, batch 4, 1024-token prompts: the
   prefill runs the flash-attention kernel once per layer;
5b. serve_quant: phase 3's requests with int8_blockwise weights and an
   int8 KV pool (quant_matmul 7 per layer plus the head, per decode step
   and per prefill; the quantized ragged kernel once per layer per step);
   serve_long: 4 prompts of 3000-4000 tokens at max_len 4096 in 4 shards
   (the partials kernel once per layer per step); then, in float32 at 4
   layers, the quantized ragged serve against the quantized dense one and
   2 and 4 shards against the unsharded serve, token for token;
6. the training path's kernels checked and timed the same way at the
   training shapes (after the serving phases, so that those see the card
   as the serving slice left it), then train: bench.py's one-chip
   training configuration (hidden 4096, FFN
   11008, 32 heads, vocab 32000, 4 layers, bf16, batch 6 x 2048, AdamW at
   lr 1e-4 with bf16 moments) through TrainStep, 2 warm-up and 10 timed
   steps: tokens/s, seconds per step, MFU, every step's loss and the peak
   memory. Every loss must be finite, the last below the first, and the
   flash forward and backward kernels must each have run once per layer
   per step;
7. train_parity: 3 steps of a narrow float32 Llama (2 layers, S 256) with
   the flash kernels and again with the plain attention: losses and the
   first step's gradients must agree;
8. one line naming each kernel with its launches on the main path (the
   serve of phase 3 for the ragged kernel, the generate of phase 5 for the
   flash forward, the train of phase 6 for the flash backward, serve_quant
   for quant_matmul and the quantized ragged kernel, serve_long for the
   partials), error and times;
9. the card's name and power limit again, and the result line.

With --profile, short full-width serves (plain, serve_quant's and
serve_long's engines) and two train steps also run under torch.profiler,
and one more line for each gives the device time by kernel and the
device's idle share.

Tolerance of the kernel checks, element by element: |out - ref| <=
2^-7 |ref| + 1e-4. Kernel and plain version both compute in float32 from
the same bf16 inputs and round the output to bf16; their float32 values
differ in summation order only (about 1e-6), so the rounded outputs
differ by at most one bf16 ulp, which is at most 2^-7 of the value. The
float32 lse gets atol 1e-4. A ragged case with a planted last token shows
that a kernel which dropped the inclusive end of the window would fail.
The backward's dq, dk and dv get the same 2^-7 |ref| and an atol of 1e-3
of each gradient's largest magnitude: there the float32 sums run over S
terms whose difference dp - delta cancels, so an element far below the
largest carries a summation-order error of about 1e-6 of the largest
(not of itself); a dropped 32-key tile would move a gradient by about
1e-2 of its largest element.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
BF16_FLOPS = 989e12             # H100 SXM dense bf16 tensor-core peak
BF16_RTOL = 2.0 ** -7           # one bf16 ulp, relative to the value
BF16_ATOL = 1e-4
LSE_ATOL = 1e-4                 # float32 lse, summation order only
GRAD_ATOL = 1e-3                # of the gradient's largest magnitude
# the library yardstick may round p to bf16 before p.v; it is held to
# 2e-2 of the output's largest magnitude (at least 1)
LIB_TOL = 2e-2


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters, warmup=2):
    """Mean device time of fn over iters launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def bf16_err(out, ref, atol=BF16_ATOL):
    """(max abs error, largest ratio of an element's error to its
    tolerance BF16_RTOL * |ref| + atol)."""
    d = (out.float() - ref.float()).abs()
    lim = BF16_RTOL * ref.float().abs() + atol
    return d.max().item(), (d / lim).max().item()


def lib_check(name, lib, ref):
    err = (lib.float() - ref.float()).abs().max().item()
    top = max(1.0, ref.float().abs().max().item())
    check(err <= LIB_TOL * top, f"{name}: library yardstick disagrees "
                                f"({err})")


def bound(bytes_moved, flops, peak_flops):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations")


# -- phase 2: kernels against their plain versions -----------------------------

def ragged_case(torch, np, name, nh, nkv, seed, poison=False, plant=False):
    from paddle_tpu_torch.kernels.ragged_paged_attention import (
        ragged_hbm_bytes, ragged_paged_attention,
        ragged_paged_attention_plain)
    dev = torch.device("cuda")
    S, hd, bs, mb = 8, 128, 64, 32
    W = mb * bs
    rng = np.random.default_rng(seed)
    lens = rng.integers(127, W, S).astype(np.int32)         # 128..2048
    if plant:
        # the ragged extremes: a one-token window, block edges, the end
        lens = np.array([0, 1, 63, 64, 65, 127, 1000, W - 1], np.int32)
    nb = S * mb + 1
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    kp = torch.randn(nb, bs, nkv, hd, generator=gen, device=dev,
                     dtype=torch.bfloat16)
    vp = torch.randn(nb, bs, nkv, hd, generator=gen, device=dev,
                     dtype=torch.bfloat16)
    q = torch.randn(S, nh, hd, generator=gen, device=dev,
                    dtype=torch.bfloat16)
    tables_np = (rng.permutation(nb - 1)[:S * mb] + 1).reshape(S, mb)
    tables_np = tables_np.astype(np.int32)
    tables = torch.as_tensor(tables_np, device=dev)
    seq = torch.as_tensor(lens, device=dev)
    scale = hd ** -0.5
    if plant:
        # the token at position seq_len (the inclusive end) gets a key
        # along its group's queries and a large value: it carries most of
        # each slot's softmax
        sl = torch.arange(S, device=dev)
        pos = seq.long()
        blk = tables.long()[sl, pos // bs]
        qg = q.float().reshape(S, nkv, nh // nkv, hd).mean(2)
        kp[blk, pos % bs] = (4 * qg).to(kp.dtype)
        vp[blk, pos % bs] = 4.0
    clean = None
    if poison:
        # every position past each seq_len is NaN and every table entry
        # past the live block is a garbage id
        clean = ragged_paged_attention(q, kp, vp, tables, seq, scale)
        pos = torch.arange(mb * bs, device=dev)
        dead = pos[None, :] > seq.long()[:, None]             # [S, W]
        rows = tables.long().repeat_interleave(bs, dim=1)     # [S, W]
        lanes = (pos % bs)[None, :].expand(S, -1)
        kp[rows[dead], lanes[dead]] = float("nan")
        vp[rows[dead], lanes[dead]] = float("nan")
        kp[0] = float("nan")
        vp[0] = float("nan")
        live_blk = torch.arange(mb, device=dev)[None, :] <= \
            (seq.long() // bs)[:, None]
        tables = torch.where(live_blk, tables, 1 << 30)
    out = ragged_paged_attention(q, kp, vp, tables, seq, scale)
    ref = ragged_paged_attention_plain(q, kp, vp, tables, seq, scale)
    torch.cuda.synchronize()
    err, ratio = bf16_err(out, ref)
    check(math.isfinite(ratio) and ratio <= 1.0,
          f"{name}: kernel vs plain max abs err {err}, {ratio} x tolerance")
    if plant:
        # the case can see a dropped last token: without it every slot
        # with more than one token moves by far more than the tolerance
        drop = ragged_paged_attention_plain(
            q, kp, vp, tables, (seq - 1).clamp(min=0), scale)
        moved = min(bf16_err(drop[i], ref[i])[1] for i in range(1, S))
        check(moved > 10.0, f"{name}: dropping the last token moves the "
                            f"output by only {moved} x tolerance")
    if poison:
        check(bool(torch.isfinite(out).all()), f"{name}: NaN reached out")
        perr = (out.float() - clean.float()).abs().max().item()
        check(perr == 0.0, f"{name}: poisoned run differs from clean "
                           f"by {perr}")
    kernel_ms = cuda_ms(torch, lambda: ragged_paged_attention(
        q, kp, vp, tables, seq, scale), 50)
    plain_ms = cuda_ms(torch, lambda: ragged_paged_attention_plain(
        q, kp, vp, tables, seq, scale), 5, warmup=1)
    # yardstick: SDPA on each slot's window, pre-gathered (not timed) to
    # a contiguous [S, nh, W, hd] with a per-slot key mask
    safe_tabs = torch.where(tables < nb, tables, 0).long()
    kw = kp[safe_tabs].reshape(S, W, nkv, hd).nan_to_num()
    vw = vp[safe_tabs].reshape(S, W, nkv, hd).nan_to_num()
    kw = kw.repeat_interleave(nh // nkv, dim=2).transpose(1, 2).contiguous()
    vw = vw.repeat_interleave(nh // nkv, dim=2).transpose(1, 2).contiguous()
    mask = (torch.arange(W, device=dev)[None, :]
            <= seq.long()[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_check(name, sdpa(q4, kw, vw, attn_mask=mask, scale=scale)[:, :, 0],
              ref)
    library_ms = cuda_ms(torch, lambda: sdpa(q4, kw, vw, attn_mask=mask,
                                             scale=scale), 20)
    itemsize = 2
    # the bytes the function needs: K and V of each token in the window
    # (the kernel loads no other), q in, o out, the live table entries and
    # seq_lens
    tokens = int((np.minimum(lens, W - 1).astype(np.int64) + 1).sum())
    bytes_moved = (2 * nkv * hd * itemsize * tokens
                   + 2 * q.numel() * itemsize
                   + 4 * int((lens // bs + 1).sum()) + 4 * S)
    flops = 4 * nh * hd * tokens
    bound_ms, bound_by = bound(bytes_moved, flops, BF16_FLOPS)
    rec = {"phase": "kernel_check", "kernel": "ragged_paged_attention",
           "case": name, "dtype": "bfloat16", "slots": S, "nh": nh,
           "nkv": nkv, "hd": hd, "block_size": bs,
           "seq_lens": [int(x) for x in lens], "max_abs_err": err,
           "err_over_tolerance": ratio, "rtol": BF16_RTOL,
           "atol": BF16_ATOL, "kernel_ms": kernel_ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "library": "scaled_dot_product_attention on a pre-gathered "
                      "window", "bound_ms": bound_ms, "bound_by": bound_by,
           "bytes": bytes_moved, "flops": flops,
           # block-granular accounting of the JAX package's helper
           "ragged_hbm_bytes": ragged_hbm_bytes(lens, bs, nkv, hd,
                                                itemsize)}
    emit(rec)
    return rec


def flash_case(torch, name, bh, s, d, causal, seed):
    from paddle_tpu_torch.kernels.flash_attention import (
        _flash_bhsd, flash_attention_fwd_plain)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    q, k, v = (torch.randn(bh, s, d, generator=gen, device=dev,
                           dtype=torch.bfloat16) for _ in range(3))
    scale = d ** -0.5
    o, lse = _flash_bhsd(q, k, v, causal, scale)
    ro, rlse = flash_attention_fwd_plain(q, k, v, causal, scale)
    torch.cuda.synchronize()
    err, ratio = bf16_err(o, ro)
    lse_err = (lse - rlse).abs().max().item()
    check(ratio <= 1.0 and lse_err <= LSE_ATOL,
          f"{name}: kernel vs plain o err {err} ({ratio} x tolerance), "
          f"lse err {lse_err}")
    kernel_ms = cuda_ms(torch, lambda: _flash_bhsd(q, k, v, causal, scale),
                        10)
    plain_ms = cuda_ms(torch, lambda: flash_attention_fwd_plain(
        q, k, v, causal, scale), 3, warmup=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q4, k4, v4 = (x[None] for x in (q, k, v))
    lib_check(name, sdpa(q4, k4, v4, is_causal=causal, scale=scale)[0], ro)
    library_ms = cuda_ms(torch, lambda: sdpa(q4, k4, v4, is_causal=causal,
                                             scale=scale), 10)
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 4 * bh * d * pairs
    bytes_moved = 4 * bh * s * d * 2 + bh * s * 4
    bound_ms, bound_by = bound(bytes_moved, flops, BF16_FLOPS)
    rec = {"phase": "kernel_check", "kernel": "flash_attention_fwd",
           "case": name, "dtype": "bfloat16", "bh": bh, "s": s, "d": d,
           "causal": causal, "max_abs_err": err,
           "err_over_tolerance": ratio, "rtol": BF16_RTOL,
           "atol": BF16_ATOL, "lse_max_abs_err": lse_err,
           "lse_atol": LSE_ATOL, "kernel_ms": kernel_ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "library": "scaled_dot_product_attention", "bound_ms": bound_ms,
           "bound_by": bound_by, "bytes": bytes_moved, "flops": flops}
    emit(rec)
    return rec


def flash_bwd_case(torch, name, bh, s, d, causal, seed):
    """The backward kernels (dq, dk/dv) against their plain version on the
    forward kernel's o and lse, as training gives them. The plain version
    needs several [BH, S, S] float32 tensors, so it runs in chunks of BH."""
    from paddle_tpu_torch.kernels.flash_attention import (
        _flash_bhsd, _flash_bhsd_bwd, flash_attention_bwd_plain)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    q, k, v, do = (torch.randn(bh, s, d, generator=gen, device=dev,
                               dtype=torch.bfloat16) for _ in range(4))
    scale = d ** -0.5
    o, lse = _flash_bhsd(q, k, v, causal, scale)
    chunk = max(1, (1 << 28) // (s * s))

    def plain():
        parts = [flash_attention_bwd_plain(
            q[i:i + chunk], k[i:i + chunk], v[i:i + chunk], o[i:i + chunk],
            lse[i:i + chunk], do[i:i + chunk], causal, scale)
            for i in range(0, bh, chunk)]
        return [torch.cat(t) for t in zip(*parts)]

    got = _flash_bhsd_bwd(q, k, v, o, lse, do, causal, scale)
    ref = plain()
    torch.cuda.synchronize()
    errs, ratios, atols = {}, {}, {}
    for gname, g, r in zip(("dq", "dk", "dv"), got, ref):
        atols[gname] = GRAD_ATOL * r.float().abs().max().item()
        errs[gname], ratios[gname] = bf16_err(g, r, atols[gname])
    ratio = max(ratios.values())
    check(math.isfinite(ratio) and ratio <= 1.0,
          f"{name}: backward kernel vs plain errors {errs}, "
          f"{ratios} x tolerance")
    kernel_ms = cuda_ms(torch, lambda: _flash_bhsd_bwd(
        q, k, v, o, lse, do, causal, scale), 10)
    plain_ms = cuda_ms(torch, plain, 2, warmup=1)
    # yardstick: the backward of SDPA's own forward on the same inputs
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q4, k4, v4 = (x[None].detach().requires_grad_() for x in (q, k, v))
    o4 = sdpa(q4, k4, v4, is_causal=causal, scale=scale)
    do4 = do[None]
    lib = torch.autograd.grad(o4, (q4, k4, v4), do4, retain_graph=True)
    for gname, g, r in zip(("dq", "dk", "dv"), lib, ref):
        lib_check(f"{name} {gname}", g[0], r)
    library_ms = cuda_ms(torch, lambda: torch.autograd.grad(
        o4, (q4, k4, v4), do4, retain_graph=True), 10)
    del o4, lib
    pairs = s * (s + 1) // 2 if causal else s * s
    # five S x S x D products (q k^T, dO v^T, p^T dO, ds k, ds^T q)
    flops = 10 * bh * d * pairs
    # q, k, v, o, dO read, dq, dk, dv written (bf16); lse and delta float32
    bytes_moved = 8 * bh * s * d * 2 + 2 * bh * s * 4
    bound_ms, bound_by = bound(bytes_moved, flops, BF16_FLOPS)
    rec = {"phase": "kernel_check", "kernel": "flash_attention_bwd",
           "case": name, "dtype": "bfloat16", "bh": bh, "s": s, "d": d,
           "causal": causal, "max_abs_err": max(errs.values()),
           "max_abs_err_by_grad": errs, "err_over_tolerance": ratio,
           "rtol": BF16_RTOL, "atol_by_grad": atols,
           "plain_chunk_bh": chunk, "kernel_ms": kernel_ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "library": "backward of scaled_dot_product_attention",
           "bound_ms": bound_ms, "bound_by": bound_by,
           "bytes": bytes_moved, "flops": flops}
    emit(rec)
    del q, k, v, do, o, lse, got, ref
    torch.cuda.empty_cache()
    return rec


# -- phase 2b: the quantized and long-context serving kernels -------------------

QMM_ATOL = 1e-5                  # of the output's largest magnitude


def qmm_case(torch, name, m, k, n, qdtype, x_dtype, seed):
    """quant_matmul at a serve shape: x [m, k] @ dequant(codes [n, k],
    scales [n, k / 128]).T. Kernel and plain version both accumulate in
    float32 (the plain version dequantizes and multiplies on cuBLAS in
    float32) and round to x's dtype: one bf16 ulp of the value, plus 1e-5
    of the largest output for the summation order over k (sums of k
    products of about unit size reach sqrt(k) ~ 100 while the order moves
    them by about sqrt(k) * 6e-8 * 50 = 3e-4; a dropped or wrongly scaled
    K-block moves an output by percents)."""
    from paddle_tpu_torch.kernels.quant_matmul import (
        blockwise_weight_bytes, dequantize_weight_blockwise, quant_matmul,
        quant_matmul_plain, quantize_weight_blockwise)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    w = torch.randn(n, k, generator=gen, device=dev, dtype=torch.bfloat16)
    codes, scales = quantize_weight_blockwise(w, qdtype=qdtype)
    del w
    x = torch.randn(m, k, generator=gen, device=dev, dtype=x_dtype)
    out = quant_matmul(x, codes, scales)
    ref = quant_matmul_plain(x, codes, scales)
    torch.cuda.synchronize()
    atol = QMM_ATOL * ref.float().abs().max().item()
    err, ratio = bf16_err(out, ref, atol)
    if x_dtype == torch.float32:      # no bf16 rounding of the output
        d = (out - ref).abs()
        ratio = (d / (1e-6 * ref.abs() + atol)).max().item()
    check(math.isfinite(ratio) and ratio <= 1.0,
          f"{name}: kernel vs plain max abs err {err}, {ratio} x tolerance")
    kernel_ms = cuda_ms(torch, lambda: quant_matmul(x, codes, scales), 20)
    plain_ms = cuda_ms(torch, lambda: quant_matmul_plain(x, codes, scales),
                       3, warmup=1)
    wlib = dequantize_weight_blockwise(codes, scales).to(torch.bfloat16)
    xlib = x.to(torch.bfloat16)
    linear = torch.nn.functional.linear
    lib_check(name, linear(xlib, wlib), ref)
    library_ms = cuda_ms(torch, lambda: linear(xlib, wlib), 20)
    del wlib
    xsize = x.element_size()
    wbytes = blockwise_weight_bytes(k, n)[0]
    bytes_moved = wbytes + m * k * xsize + m * n * xsize
    flops = 2 * m * k * n
    bound_ms, bound_by = bound(bytes_moved, flops, BF16_FLOPS)
    rec = {"phase": "kernel_check", "kernel": "quant_matmul", "case": name,
           "codes": qdtype, "x_dtype": str(x_dtype).split(".")[-1],
           "m": m, "k": k, "n": n, "block_k": k // scales.shape[1],
           "max_abs_err": err, "err_over_tolerance": ratio,
           "rtol": BF16_RTOL if x_dtype == torch.bfloat16 else 1e-6,
           "atol": atol, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
           "library_ms": library_ms,
           "library": "F.linear on the dequantized bf16 weight (bf16 x)",
           "bound_ms": bound_ms, "bound_by": bound_by,
           "bytes": bytes_moved, "flops": flops,
           "weight_bytes": wbytes, "weight_bytes_bf16": 2 * k * n}
    emit(rec)
    del x, codes, scales, out, ref
    torch.cuda.empty_cache()
    return rec


def ragged_quant_case(torch, np, name, nh, nkv, seed, poison=False,
                      plant=False):
    """The quantized ragged kernel at the serve's shapes (8 slots, hd 128,
    bs 64, 32 blocks), pools quantized from bf16 draws with
    kv_quantize_rows, against its plain version; tolerance as the ragged
    case. poison: code 127 and NaN scales at every position past each
    seq_len (inside the live block too) and garbage table entries past
    it; the output must equal the clean run's, bit for bit."""
    from paddle_tpu_torch.kernels.ragged_paged_attention import (
        kv_dequantize_rows, kv_quantize_rows, ragged_paged_attention_quant,
        ragged_paged_attention_quant_plain)
    dev = torch.device("cuda")
    S, hd, bs, mb = 8, 128, 64, 32
    W = mb * bs
    rng = np.random.default_rng(seed)
    lens = rng.integers(127, W, S).astype(np.int32)
    if plant:
        lens = np.array([0, 1, 63, 64, 65, 127, 1000, W - 1], np.int32)
    nb = S * mb + 1
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    kc, ks = kv_quantize_rows(torch.randn(nb, bs, nkv, hd, generator=gen,
                                          device=dev, dtype=torch.bfloat16))
    vc, vs = kv_quantize_rows(torch.randn(nb, bs, nkv, hd, generator=gen,
                                          device=dev, dtype=torch.bfloat16))
    q = torch.randn(S, nh, hd, generator=gen, device=dev,
                    dtype=torch.bfloat16)
    tables = torch.as_tensor((rng.permutation(nb - 1)[:S * mb] + 1)
                             .reshape(S, mb).astype(np.int32), device=dev)
    seq = torch.as_tensor(lens, device=dev)
    scale = hd ** -0.5
    if plant:
        # the token at seq_len: a key along its group's queries and a large
        # value, stored through the codec
        sl = torch.arange(S, device=dev)
        pos = seq.long()
        blk = tables.long()[sl, pos // bs]
        qg = q.float().reshape(S, nkv, nh // nkv, hd).mean(2)
        pk, pks = kv_quantize_rows(4 * qg)
        pv, pvs = kv_quantize_rows(torch.full_like(qg, 4.0))
        kc[blk, pos % bs], ks[blk, pos % bs] = pk, pks
        vc[blk, pos % bs], vs[blk, pos % bs] = pv, pvs
    def args():                    # tables is rebound by the poison
        return q, kc, ks, vc, vs, tables, seq

    clean = None
    if poison:
        clean = ragged_paged_attention_quant(*args(), scale)
        pos = torch.arange(W, device=dev)
        dead = pos[None, :] > seq.long()[:, None]
        rows = tables.long().repeat_interleave(bs, dim=1)
        lanes = (pos % bs)[None, :].expand(S, -1)
        for codes, scales in ((kc, ks), (vc, vs)):
            codes[rows[dead], lanes[dead]] = 127
            scales[rows[dead], lanes[dead]] = float("nan")
            codes[0] = 127
            scales[0] = float("nan")
        live_blk = torch.arange(mb, device=dev)[None, :] <= \
            (seq.long() // bs)[:, None]
        tables = torch.where(live_blk, tables, 1 << 30)
    out = ragged_paged_attention_quant(*args(), scale)
    ref = ragged_paged_attention_quant_plain(*args(), scale)
    torch.cuda.synchronize()
    err, ratio = bf16_err(out, ref)
    check(math.isfinite(ratio) and ratio <= 1.0,
          f"{name}: kernel vs plain max abs err {err}, {ratio} x tolerance")
    if plant:
        drop = ragged_paged_attention_quant_plain(
            q, kc, ks, vc, vs, tables, (seq - 1).clamp(min=0), scale)
        moved = min(bf16_err(drop[i], ref[i])[1] for i in range(1, S))
        check(moved > 10.0, f"{name}: dropping the last token moves the "
                            f"output by only {moved} x tolerance")
    if poison:
        check(bool(torch.isfinite(out).all()), f"{name}: NaN reached out")
        perr = (out.float() - clean.float()).abs().max().item()
        check(perr == 0.0, f"{name}: poisoned run differs from clean "
                           f"by {perr}")
    kernel_ms = cuda_ms(torch, lambda: ragged_paged_attention_quant(
        *args(), scale), 50)
    plain_ms = cuda_ms(torch, lambda: ragged_paged_attention_quant_plain(
        *args(), scale), 5, warmup=1)
    # yardstick: SDPA on each slot's dequantized window, pre-gathered (not
    # timed) to a contiguous bf16 [S, nh, W, hd] with a per-slot key mask
    safe = torch.where(tables < nb, tables, 0).long()
    kw = kv_dequantize_rows(kc[safe], ks[safe]).reshape(S, W, nkv, hd)
    vw = kv_dequantize_rows(vc[safe], vs[safe]).reshape(S, W, nkv, hd)
    kw, vw = (t.nan_to_num().to(torch.bfloat16)
              .repeat_interleave(nh // nkv, dim=2).transpose(1, 2)
              .contiguous() for t in (kw, vw))
    mask = (torch.arange(W, device=dev)[None, :]
            <= seq.long()[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_check(name, sdpa(q4, kw, vw, attn_mask=mask, scale=scale)[:, :, 0],
              ref)
    library_ms = cuda_ms(torch, lambda: sdpa(q4, kw, vw, attn_mask=mask,
                                             scale=scale), 20)
    # per token: K and V codes of every kv head plus one float32 scale
    # each; then q in, o out, the live table entries and seq_lens
    tokens = int((np.minimum(lens, W - 1).astype(np.int64) + 1).sum())
    bytes_moved = (2 * (nkv * hd + 4) * tokens + 2 * q.numel() * 2
                   + 4 * int((lens // bs + 1).sum()) + 4 * S)
    flops = 4 * nh * hd * tokens
    bound_ms, bound_by = bound(bytes_moved, flops, BF16_FLOPS)
    rec = {"phase": "kernel_check", "kernel": "ragged_paged_attention_quant",
           "case": name, "dtype": "bfloat16 q, int8 pool", "slots": S,
           "nh": nh, "nkv": nkv, "hd": hd, "block_size": bs,
           "seq_lens": [int(x) for x in lens], "max_abs_err": err,
           "err_over_tolerance": ratio, "rtol": BF16_RTOL,
           "atol": BF16_ATOL, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
           "library_ms": library_ms,
           "library": "scaled_dot_product_attention on a pre-gathered, "
                      "dequantized bf16 window",
           "bound_ms": bound_ms, "bound_by": bound_by,
           "bytes": bytes_moved, "flops": flops}
    emit(rec)
    return rec


def partials_case(torch, np, name, seed, shards=4):
    """The split-context partials kernel: 4 slots, 32 x 32 heads, hd 128,
    bs 64, 64 blocks (4096 positions), 4 shards of 16 blocks; one slot of
    100 tokens (three empty trailing shards), one at full span. Per-shard
    o and lse against the plain partials (float32 o atol 1e-4: order of
    the float32 sums over up to 1024 positions; lse atol 1e-4), the merged
    result against the plain sharded version and the unsharded ragged
    kernel (one bf16 ulp, as the ragged case)."""
    from paddle_tpu_torch.kernels.ragged_paged_attention import (
        merge_partials, ragged_paged_attention,
        ragged_paged_attention_partials,
        ragged_paged_attention_partials_plain)
    dev = torch.device("cuda")
    S, nh, nkv, hd, bs, mb = 4, 32, 32, 128, 64, 64
    W = mb * bs
    rng = np.random.default_rng(seed)
    lens = np.array([100, W - 1, *rng.integers(1100, W - 1, S - 2)],
                    np.int32)
    nb = S * mb + 1
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    kp = torch.randn(nb, bs, nkv, hd, generator=gen, device=dev,
                     dtype=torch.bfloat16)
    vp = torch.randn(nb, bs, nkv, hd, generator=gen, device=dev,
                     dtype=torch.bfloat16)
    q = torch.randn(S, nh, hd, generator=gen, device=dev,
                    dtype=torch.bfloat16)
    tables = torch.as_tensor((rng.permutation(nb - 1)[:S * mb] + 1)
                             .reshape(S, mb).astype(np.int32), device=dev)
    seq = torch.as_tensor(lens, device=dev)
    scale = hd ** -0.5
    o, lse = ragged_paged_attention_partials(q, kp, vp, tables, seq, shards,
                                             scale)
    ro, rlse = ragged_paged_attention_partials_plain(q, kp, vp, tables, seq,
                                                     shards, scale)
    merged = merge_partials(o, lse, q.dtype)
    ref = merge_partials(ro, rlse, q.dtype)
    whole = ragged_paged_attention(q, kp, vp, tables, seq, scale)
    torch.cuda.synchronize()
    live = rlse > -1e29
    check(bool(torch.equal(live, lse > -1e29)),
          f"{name}: empty shards disagree")
    check(int((~live).sum()) >= 3 * nh, f"{name}: no empty shard")
    o_err = (o - ro).abs().max().item()
    lse_err = (lse - rlse)[live].abs().max().item()
    err, ratio = bf16_err(merged, ref)
    werr, wratio = bf16_err(merged, whole)
    check(o_err <= 1e-4 and lse_err <= LSE_ATOL and ratio <= 1.0
          and wratio <= 1.0 and bool((o[~live] == 0).all()),
          f"{name}: o err {o_err}, lse err {lse_err}, merged vs plain "
          f"{ratio} x tolerance, vs unsharded kernel {wratio}")
    kernel_ms = cuda_ms(torch, lambda: ragged_paged_attention_partials(
        q, kp, vp, tables, seq, shards, scale), 50)
    sharded_ms = cuda_ms(torch, lambda: merge_partials(
        *ragged_paged_attention_partials(q, kp, vp, tables, seq, shards,
                                         scale), q.dtype), 50)
    ragged_ms = cuda_ms(torch, lambda: ragged_paged_attention(
        q, kp, vp, tables, seq, scale), 50)
    plain_ms = cuda_ms(torch, lambda: ragged_paged_attention_partials_plain(
        q, kp, vp, tables, seq, shards, scale), 3, warmup=1)
    kw = kp[tables.long()].reshape(S, W, nkv, hd).transpose(1, 2) \
        .contiguous()
    vw = vp[tables.long()].reshape(S, W, nkv, hd).transpose(1, 2) \
        .contiguous()
    mask = (torch.arange(W, device=dev)[None, :]
            <= seq.long()[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_check(name, sdpa(q4, kw, vw, attn_mask=mask, scale=scale)[:, :, 0],
              ref)
    library_ms = cuda_ms(torch, lambda: sdpa(q4, kw, vw, attn_mask=mask,
                                             scale=scale), 20)
    # K and V of every live token, q, the float32 partials (o and lse of
    # every shard) written once, the live table entries and seq_lens
    tokens = int((lens.astype(np.int64) + 1).sum())
    bytes_moved = (2 * nkv * hd * 2 * tokens + q.numel() * 2
                   + o.numel() * 4 + lse.numel() * 4
                   + 4 * int((lens // bs + 1).sum()) + 4 * S)
    flops = 4 * nh * hd * tokens
    bound_ms, bound_by = bound(bytes_moved, flops, BF16_FLOPS)
    rec = {"phase": "kernel_check", "kernel": "ragged_paged_attention_partials",
           "case": name, "dtype": "bfloat16", "slots": S, "nh": nh,
           "nkv": nkv, "hd": hd, "block_size": bs, "blocks_per_seq": mb,
           "shards": shards, "seq_lens": [int(x) for x in lens],
           "max_abs_err": max(o_err, err), "o_max_abs_err": o_err,
           "o_atol": 1e-4, "lse_max_abs_err": lse_err,
           "lse_atol": LSE_ATOL, "merged_err_over_tolerance": ratio,
           "merged_vs_unsharded_kernel_err_over_tolerance": wratio,
           "kernel_ms": kernel_ms, "sharded_with_merge_ms": sharded_ms,
           "unsharded_ragged_kernel_ms": ragged_ms, "plain_ms": plain_ms,
           "library_ms": library_ms,
           "library": "scaled_dot_product_attention on a pre-gathered "
                      "window", "bound_ms": bound_ms, "bound_by": bound_by,
           "bytes": bytes_moved, "flops": flops}
    emit(rec)
    del kp, vp, kw, vw, o, ro
    torch.cuda.empty_cache()
    return rec


# -- phases 3-5: the serving path ----------------------------------------------

def make_requests(np, seed, n=16):
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        plen = int(rng.integers(128, 1025))
        budget = int(rng.integers(32, 65))
        prompt = [int(t) for t in rng.integers(0, 32000, plen)]
        reqs.append((f"req{i}", prompt, budget))
    return reqs


def build_model(torch, cfg, seed):
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    return LlamaForCausalLM(cfg, device="cuda", generator=gen)


def serve_phase(torch, np, model, reqs, layers):
    from paddle_tpu_torch.kernels.flash_attention import _flash_bhsd
    from paddle_tpu_torch.kernels.ragged_paged_attention import (
        ragged_paged_attention)
    from paddle_tpu_torch.models.paged_decode import PagedDecoder
    dec = PagedDecoder(model, max_len=2048, block_size=64, max_slots=8,
                       num_blocks=257)
    check(dec.use_ragged_kernel, "ragged kernel is off on the card")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ragged_paged_attention.launches = 0
    _flash_bhsd.launches = 0
    t0 = time.perf_counter()
    out = dec.serve(reqs, chunk=8)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ragged_paged_attention.launches
    for rid, prompt, budget in reqs:
        toks = out[rid]
        check(len(toks) == budget, f"{rid}: {len(toks)} tokens, budget "
                                   f"{budget}")
        check(all(0 <= t < model.config.vocab_size for t in toks),
              f"{rid}: token out of the vocabulary")
    st = dec.serve_stats
    steps = st["decode_steps"]
    check(launches == layers * steps,
          f"ragged launches {launches} != layers {layers} x decode steps "
          f"{steps}")
    check(dec.allocator.in_use == 0, "blocks leaked after serve")
    decode_tokens = sum(b for _, _, b in reqs) - len(reqs)
    ttft = sorted(st["first_token_s"].values())
    rec = {"phase": "serve", "model": "llama_2_7b widths, random weights",
           "dtype": "bfloat16", "layers": layers, "layers_cut": layers != 32,
           "requests": len(reqs),
           "prompt_lens": [len(p) for _, p, _ in reqs],
           "budgets": [b for _, _, b in reqs], "chunk": 8, "max_slots": 8,
           "block_size": 64, "num_blocks": 257, "wall_s": wall,
           "prefill_s": st["prefill_s"], "decode_s": st["decode_s"],
           "decode_steps": steps, "chunks": st["chunks"],
           "decode_tokens": decode_tokens,
           "decode_tokens_per_s": decode_tokens / st["decode_s"],
           "tokens_per_s_end_to_end": sum(b for _, _, b in reqs) / wall,
           "ttft_p50_s": statistics.median(ttft), "ttft_max_s": ttft[-1],
           "peak_blocks": dec.allocator.peak_in_use,
           "ragged_launches": launches,
           "flash_launches": _flash_bhsd.launches,
           "peak_device_bytes": torch.cuda.max_memory_allocated()}
    emit(rec)
    del dec
    torch.cuda.empty_cache()
    return rec


def serve_record(torch, phase, dec, reqs, layers, wall, extra):
    """The serve figures every serving phase prints."""
    st = dec.serve_stats
    decode_tokens = sum(b for _, _, b in reqs) - len(reqs)
    ttft = sorted(st["first_token_s"].values())
    rec = {"phase": phase, "model": "llama_2_7b widths, random weights",
           "dtype": "bfloat16", "layers": layers, "layers_cut": layers != 32,
           "requests": len(reqs),
           "prompt_lens": [len(p) for _, p, _ in reqs],
           "budgets": [b for _, _, b in reqs], "chunk": 8,
           "max_len": dec.max_len, "max_slots": dec.max_slots,
           "block_size": dec.block_size, "num_blocks": dec.num_blocks,
           "wall_s": wall, "prefill_s": st["prefill_s"],
           "decode_s": st["decode_s"], "decode_steps": st["decode_steps"],
           "chunks": st["chunks"], "decode_tokens": decode_tokens,
           "decode_tokens_per_s": decode_tokens / st["decode_s"],
           "ttft_p50_s": statistics.median(ttft), "ttft_max_s": ttft[-1],
           "peak_blocks": dec.allocator.peak_in_use,
           "weight_bytes": dec.weight_stream_bytes["quant"],
           "weight_bytes_bf16": dec.weight_stream_bytes["bf16eq"],
           "pool_bytes": dec.pool_bytes(),
           "pool_bytes_bf16": 2 * dec.n_layers * dec.num_blocks
           * dec.block_size * dec.nkv * dec.hd * 2,
           "peak_device_bytes": torch.cuda.max_memory_allocated()}
    rec.update(extra)
    return rec


def check_served(dec, out, reqs, vocab):
    for rid, prompt, budget in reqs:
        toks = out[rid]
        check(len(toks) == budget, f"{rid}: {len(toks)} tokens, budget "
                                   f"{budget}")
        check(all(0 <= t < vocab for t in toks),
              f"{rid}: token out of the vocabulary")
    check(dec.allocator.in_use == 0, "blocks leaked after serve")


def serve_quant_phase(torch, np, model, reqs, layers):
    """The quantized serving deployment: block-scaled int8 weights and an
    int8 paged KV pool, at phase 3's widths and requests. Every
    projection and the head go through quant_matmul: 7 per layer plus the
    head, once per decode step and once per prefill (the prefill's head
    multiplies the last token only); decode attention through the
    quantized ragged kernel, once per layer per decode step."""
    from paddle_tpu_torch.kernels.quant_matmul import quant_matmul
    from paddle_tpu_torch.kernels.ragged_paged_attention import (
        ragged_paged_attention, ragged_paged_attention_quant)
    from paddle_tpu_torch.models.paged_decode import PagedDecoder
    dec = PagedDecoder(model, max_len=2048, block_size=64, max_slots=8,
                       num_blocks=257, weight_quant="int8_blockwise",
                       kv_quant="int8")
    check(dec.use_ragged_kernel, "ragged kernel is off on the card")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    quant_matmul.launches = 0
    ragged_paged_attention_quant.launches = 0
    ragged_paged_attention.launches = 0
    t0 = time.perf_counter()
    out = dec.serve(reqs, chunk=8)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    qmm, rq = quant_matmul.launches, ragged_paged_attention_quant.launches
    check_served(dec, out, reqs, model.config.vocab_size)
    steps = dec.serve_stats["decode_steps"]
    per_pass = 7 * layers + 1
    check(rq == layers * steps and ragged_paged_attention.launches == 0,
          f"quantized ragged launches {rq} != layers {layers} x decode "
          f"steps {steps} (unquantized: {ragged_paged_attention.launches})")
    check(qmm == per_pass * (steps + len(reqs)),
          f"quant_matmul launches {qmm} != (7 x {layers} + 1) x (decode "
          f"steps {steps} + prefills {len(reqs)})")
    rec = serve_record(torch, "serve_quant", dec, reqs, layers, wall, {
        "weight_quant": "int8_blockwise", "kv_quant": "int8",
        "requests_cut": False, "quant_matmul_launches": qmm,
        "quant_matmul_launches_rule": "(7 x layers + 1) x (decode steps + "
                                      "prefills)",
        "ragged_quant_launches": rq})
    emit(rec)
    del dec
    torch.cuda.empty_cache()
    return rec


def make_long_requests(np, seed, n=4):
    rng = np.random.default_rng(seed + 7)
    return [(f"long{i}", [int(t) for t in rng.integers(
        0, 32000, int(rng.integers(3000, 4001)))], 32) for i in range(n)]


def serve_long_phase(torch, np, model, reqs, layers):
    """The long-context deployment: 4 prompts of 3000-4000 tokens at
    max_len 4096, decode attention as 4-shard split-context partials (one
    launch per layer per decode step, all shards in it)."""
    from paddle_tpu_torch.kernels.ragged_paged_attention import (
        ragged_paged_attention, ragged_paged_attention_partials)
    from paddle_tpu_torch.models.paged_decode import PagedDecoder
    dec = PagedDecoder(model, max_len=4096, block_size=64, max_slots=4,
                       num_blocks=257, attn_shards=4)
    check(dec.use_ragged_kernel, "ragged kernel is off on the card")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ragged_paged_attention_partials.launches = 0
    ragged_paged_attention.launches = 0
    t0 = time.perf_counter()
    out = dec.serve(reqs, chunk=8)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    pl = ragged_paged_attention_partials.launches
    check_served(dec, out, reqs, model.config.vocab_size)
    steps = dec.serve_stats["decode_steps"]
    check(pl == layers * steps and ragged_paged_attention.launches == 0
          and dec.sharded_attn_calls == steps,
          f"partials launches {pl} != layers {layers} x decode steps "
          f"{steps} (unsharded {ragged_paged_attention.launches}, sharded "
          f"steps {dec.sharded_attn_calls})")
    rec = serve_record(torch, "serve_long", dec, reqs, layers, wall, {
        "attn_shards": dec.attn_shards, "partials_launches": pl,
        "partials_launches_rule": "layers x decode steps (one launch "
                                  "holds every shard)"})
    emit(rec)
    del dec
    torch.cuda.empty_cache()
    return rec


def quant_shard_parity_phase(torch, np, reqs, seed):
    """Float32, 4 layers (phase 4's model): the quantized ragged serve
    against the quantized dense serve, and attn_shards 2 and 4 against
    the unsharded ragged serve; every stream must be identical."""
    from paddle_tpu_torch.models.llama import llama_2_7b
    from paddle_tpu_torch.models.paged_decode import PagedDecoder
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = llama_2_7b(num_hidden_layers=4, dtype="float32")
    model = build_model(torch, cfg, seed + 1)
    runs = {}
    for key, kw in (("quant_ragged", dict(kv_quant="int8")),
                    ("quant_dense", dict(kv_quant="int8",
                                         ragged_kernel=False)),
                    ("ragged", {}), ("shards2", dict(attn_shards=2)),
                    ("shards4", dict(attn_shards=4))):
        dec = PagedDecoder(model, max_len=2048, block_size=64, max_slots=8,
                           num_blocks=257, **kw)
        runs[key] = dec.serve(reqs, chunk=8)
        del dec
    same = {}
    for a, b in (("quant_ragged", "quant_dense"), ("shards2", "ragged"),
                 ("shards4", "ragged")):
        same[f"{a}_vs_{b}"] = sum(runs[a][rid] == runs[b][rid]
                                  for rid, _, _ in reqs)
    agree = sum(runs["quant_ragged"][rid] == runs["ragged"][rid]
                for rid, _, _ in reqs)
    check(all(v == len(reqs) for v in same.values()),
          f"parity: identical streams {same} of {len(reqs)}")
    rec = {"phase": "quant_shards_parity", "dtype": "float32", "layers": 4,
           "requests": len(reqs), "identical_streams": same,
           "int8_kv_vs_float32_kv_identical_streams": agree}
    emit(rec)
    del model
    torch.cuda.empty_cache()
    return rec


def profile_phase(torch, model, reqs, phase="profile", **engine_kw):
    """--profile only: a short serve at full width (8 requests, budgets
    cut to 16), run once plainly for its wall time and once under
    torch.profiler for the device time of each kernel. The device's idle
    share is 1 - (kernel time under the profiler) / (plain wall time):
    the profiler slows the host, not the kernels. engine_kw replaces the
    engine's configuration (serve_quant's, serve_long's)."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.models.paged_decode import PagedDecoder
    kw = dict(max_len=2048, block_size=64, max_slots=8, num_blocks=257)
    kw.update(engine_kw)
    dec = PagedDecoder(model, **kw)
    short = [(rid, p, 16) for rid, p, _ in reqs[:8]]
    dec.serve(short[:1], chunk=8)                        # warm up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dec.serve(short, chunk=8)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = dict(dec.serve_stats)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        dec.serve(short, chunk=8)
        torch.cuda.synchronize()
    rows, busy_s = device_kernel_rows(prof)
    rec = {"phase": phase, "engine": kw, "requests": len(short),
           "budget": 16, "wall_s": wall,
           "prefill_s": st["prefill_s"], "decode_s": st["decode_s"],
           "decode_steps": st["decode_steps"],
           "device_busy_s": busy_s if rows else "not measured",
           "device_idle_share": 1 - busy_s / wall if rows
           else "not measured",
           "top_device_kernels": top_kernels(rows, busy_s, 12)}
    emit(rec)
    del dec
    torch.cuda.empty_cache()
    return rec


def device_kernel_rows(prof):
    """[(device us, kernel name, calls)] of a torch.profiler run, largest
    first, and the device's busy seconds. Kernels only: an operator's row
    repeats the device time of the kernels it launched."""
    from torch.autograd import DeviceType
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us, evt.key, evt.count))
    rows.sort(reverse=True)
    return rows, sum(r[0] for r in rows) / 1e6


def top_kernels(rows, busy_s, n):
    return [{"name": k[:90], "device_ms": us / 1e3, "calls": c,
             "share_of_device": us / 1e6 / busy_s} for us, k, c in rows[:n]]


def parity_phase(torch, np, reqs, seed):
    from paddle_tpu_torch.models.llama import llama_2_7b
    from paddle_tpu_torch.models.paged_decode import PagedDecoder
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = llama_2_7b(num_hidden_layers=4, dtype="float32")
    model = build_model(torch, cfg, seed + 1)
    streams = {}
    for ragged in (True, False):
        dec = PagedDecoder(model, max_len=2048, block_size=64, max_slots=8,
                           num_blocks=257, ragged_kernel=ragged)
        streams[ragged] = dec.serve(reqs, chunk=8)
        del dec
    same = sum(streams[True][rid] == streams[False][rid]
               for rid, _, _ in reqs)
    check(same == len(reqs), f"ragged vs dense: {len(reqs) - same} of "
                             f"{len(reqs)} streams differ")
    oracle = 0
    for rid, prompt, budget in reqs[:2]:
        ref = model.generate(torch.tensor([prompt]), max_new_tokens=budget)
        check(streams[True][rid] == ref[0, len(prompt):].tolist(),
              f"{rid}: serve differs from full-forward generate")
        oracle += 1
    rec = {"phase": "ragged_vs_dense", "dtype": "float32", "layers": 4,
           "requests": len(reqs), "identical_streams": same,
           "full_forward_oracle_streams": oracle}
    emit(rec)
    del model
    torch.cuda.empty_cache()
    return rec


def generate_phase(torch, np, model, layers, seed):
    from paddle_tpu_torch.kernels.flash_attention import _flash_bhsd
    from paddle_tpu_torch.models.decode import CachedDecoder
    B, S0, N = 4, 1024, 32
    dec = CachedDecoder(model, max_len=S0 + N)
    ids = np.random.default_rng(seed + 2).integers(0, 32000, (B, S0))
    torch.cuda.synchronize()
    _flash_bhsd.launches = 0
    t0 = time.perf_counter()
    out = dec.generate(torch.as_tensor(ids), max_new_tokens=N)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _flash_bhsd.launches
    check(tuple(out.shape) == (B, S0 + N), f"generate shape {out.shape}")
    check(bool((out[:, :S0] == torch.as_tensor(ids)).all()),
          "generate changed the prompt")
    check(bool(((out >= 0) & (out < 32000)).all()), "token out of vocab")
    check(launches == layers * 1,
          f"flash launches {launches} != {layers} layers x 1 prefill")
    rec = {"phase": "generate", "dtype": "bfloat16", "layers": layers,
           "batch": B, "prompt_len": S0, "new_tokens": N, "wall_s": wall,
           "tokens_per_s": B * N / wall, "flash_launches": launches}
    emit(rec)
    del dec
    torch.cuda.empty_cache()
    return rec


# -- phases 6-7: the training path ---------------------------------------------

TRAIN_LAYERS = 4                 # bench.py's one-chip configuration
TRAIN_BATCH, TRAIN_SEQ = 6, 2048
TRAIN_WARMUP, TRAIN_TIMED = 2, 10


def train_config():
    from paddle_tpu_torch.models.llama import LlamaConfig
    return LlamaConfig(vocab_size=32000, hidden_size=4096,
                       intermediate_size=11008,
                       num_hidden_layers=TRAIN_LAYERS,
                       num_attention_heads=32, num_key_value_heads=32,
                       max_position_embeddings=2048, dtype="bfloat16",
                       recompute=False)


def make_train_step(torch, cfg, seed, lr=1e-4, moment_dtype="bfloat16"):
    from paddle_tpu_torch import (AdamW, LlamaPretrainingCriterion,
                                  TrainStep)
    model = build_model(torch, cfg, seed)
    crit = LlamaPretrainingCriterion(cfg)
    opt = AdamW(learning_rate=lr, parameters=model.parameters(),
                moment_dtype=moment_dtype)
    return model, TrainStep(model, lambda lo, la: crit(lo, la), opt)


def train_batch(torch, np, seed, vocab, batch, seq):
    rng = np.random.default_rng(seed)
    ids = torch.as_tensor(rng.integers(0, vocab, (batch, seq)),
                          device="cuda")
    labels = torch.as_tensor(rng.integers(0, vocab, (batch, seq)),
                             device="cuda")
    return ids, labels


def train_phase(torch, np, seed):
    from paddle_tpu_torch.kernels.flash_attention import (_flash_bhsd,
                                                          _flash_bhsd_bwd)
    from paddle_tpu_torch.observability import model_flops_per_token
    cfg = train_config()
    model, step = make_train_step(torch, cfg, seed)
    n_params = sum(p.numel() for p in model.parameters())
    ids, labels = train_batch(torch, np, seed + 3, cfg.vocab_size,
                              TRAIN_BATCH, TRAIN_SEQ)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _flash_bhsd.launches = 0
    _flash_bhsd_bwd.launches = 0
    losses = [step((ids,), (labels,)) for _ in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_TIMED):
        losses.append(step((ids,), (labels,)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fwd, bwd = _flash_bhsd.launches, _flash_bhsd_bwd.launches
    losses = [x.item() for x in losses]
    steps = TRAIN_WARMUP + TRAIN_TIMED
    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    layers = cfg.num_hidden_layers
    check(fwd == layers * steps and bwd == layers * steps,
          f"flash launches fwd {fwd}, bwd {bwd} != {layers} layers x "
          f"{steps} steps")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    tps = tokens * TRAIN_TIMED / wall
    flops_tok = model_flops_per_token(cfg, TRAIN_SEQ, n_params)
    rec = {"phase": "train", "model": "bench.py one-chip Llama, random "
                                      "weights",
           "dtype": cfg.dtype, "layers": cfg.num_hidden_layers,
           "hidden": cfg.hidden_size, "ffn": cfg.intermediate_size,
           "heads": cfg.num_attention_heads, "vocab": cfg.vocab_size,
           "params": n_params,
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "optimizer": "AdamW lr 1e-4, bf16 moments",
           "warmup_steps": TRAIN_WARMUP, "timed_steps": TRAIN_TIMED,
           "wall_s": wall, "s_per_step": wall / TRAIN_TIMED,
           "tokens_per_s": tps, "model_flops_per_token": flops_tok,
           "mfu": flops_tok * tps / BF16_FLOPS, "losses": losses,
           "peak_device_bytes": torch.cuda.max_memory_allocated(),
           "flash_fwd_launches": fwd, "flash_bwd_launches": bwd}
    emit(rec)
    del model, step
    torch.cuda.empty_cache()
    return rec


def train_profile_phase(torch, np, seed, steps=2):
    """--profile only: `steps` train steps at the train phase's shapes, run
    once plainly for their wall time and once under torch.profiler for the
    device time by kernel, grouped into the flash kernels, matrix products
    (cuBLAS/CUTLASS GEMMs) and the rest (element-wise, reductions,
    AdamW)."""
    from torch.profiler import ProfilerActivity, profile
    cfg = train_config()
    model, step = make_train_step(torch, cfg, seed)
    ids, labels = train_batch(torch, np, seed + 3, cfg.vocab_size,
                              TRAIN_BATCH, TRAIN_SEQ)
    step((ids,), (labels,))                               # warm up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step((ids,), (labels,))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step((ids,), (labels,))
        torch.cuda.synchronize()
    rows, busy_s = device_kernel_rows(prof)
    groups = {"flash_fwd": 0.0, "flash_bwd": 0.0, "gemm": 0.0, "other": 0.0}
    for us, name, _ in rows:
        if "flash_fwd" in name:
            groups["flash_fwd"] += us / 1e6
        elif "flash_bwd" in name:
            groups["flash_bwd"] += us / 1e6
        elif any(t in name.lower() for t in ("gemm", "nvjet", "cutlass",
                                             "xmma")):
            groups["gemm"] += us / 1e6
        else:
            groups["other"] += us / 1e6
    rec = {"phase": "train_profile", "steps": steps, "wall_s": wall,
           "s_per_step": wall / steps,
           "device_busy_s": busy_s if rows else "not measured",
           "device_idle_share": 1 - busy_s / wall if rows
           else "not measured",
           "device_s_per_step_by_group": {
               k: v / steps for k, v in groups.items()},
           "top_device_kernels": top_kernels(rows, busy_s, 15)}
    emit(rec)
    del model, step
    torch.cuda.empty_cache()
    return rec


PARITY_STEPS = 3
PARITY_LOSS_RTOL = 1e-5          # float32, summation order only
PARITY_GRAD_ATOL = 1e-4          # of each gradient's largest magnitude


def train_parity_phase(torch, np, seed):
    """The flash kernels inside whole training steps against the plain
    attention (use_flash_attention=False, a config of the JAX package), in
    float32 on the card with TF32 off."""
    from paddle_tpu_torch.kernels.flash_attention import (_flash_bhsd,
                                                          _flash_bhsd_bwd)
    from paddle_tpu_torch.models.llama import LlamaConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ids, labels = train_batch(torch, np, seed + 4, 1024, 2, 256)
    runs = {}
    for flash in (True, False):
        cfg = LlamaConfig(vocab_size=1024, hidden_size=512,
                          intermediate_size=1024, num_hidden_layers=2,
                          num_attention_heads=4, num_key_value_heads=4,
                          max_position_embeddings=256, dtype="float32",
                          use_flash_attention=flash)
        model, step = make_train_step(torch, cfg, seed + 5,
                                      moment_dtype=None)
        _flash_bhsd.launches = 0
        _flash_bhsd_bwd.launches = 0
        losses, grads = [], None
        for i in range(PARITY_STEPS):
            losses.append(step((ids,), (labels,)).item())
            if i == 0:
                grads = {k: p.grad.clone()
                         for k, p in model.named_parameters()}
        runs[flash] = (losses, grads, _flash_bhsd.launches,
                       _flash_bhsd_bwd.launches)
        del model, step
    (fl, fg, ff, fb), (pl_, pg, pf, pb) = runs[True], runs[False]
    check(ff == fb == 2 * PARITY_STEPS and pf == pb == 0,
          f"flash launches: kernels run {ff}/{fb}, plain run {pf}/{pb}")
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(fl, pl_))
    grad_rel = max(((fg[k] - pg[k]).abs().max()
                    / pg[k].abs().max()).item() for k in pg)
    check(loss_rel <= PARITY_LOSS_RTOL and grad_rel <= PARITY_GRAD_ATOL,
          f"flash vs plain training: loss rel {loss_rel}, step-1 grad "
          f"{grad_rel} of the largest element")
    rec = {"phase": "train_parity", "dtype": "float32", "layers": 2,
           "hidden": 512, "heads": 4, "seq": 256, "batch": 2,
           "steps": PARITY_STEPS, "losses_flash": fl, "losses_plain": pl_,
           "max_loss_rel_diff": loss_rel, "loss_rtol": PARITY_LOSS_RTOL,
           "max_grad_diff_over_max": grad_rel,
           "grad_atol_of_max": PARITY_GRAD_ATOL,
           "flash_fwd_launches": ff, "flash_bwd_launches": fb}
    emit(rec)
    torch.cuda.empty_cache()
    return rec


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=32,
                    help="decoder layers of the full-width model (depth "
                         "is the only thing a time limit may cut)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also profile short full-width serves (plain, "
                         "quantized, long-context) and two train steps "
                         "with torch.profiler (device time by kernel)")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import numpy as np
        from paddle_tpu_torch.kernels import _build
        from paddle_tpu_torch.kernels.flash_attention import _flash_bhsd
        from paddle_tpu_torch.kernels.ragged_paged_attention import (
            ragged_paged_attention)
        from paddle_tpu_torch.models.llama import llama_2_7b
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2

    card = card_line()
    emit({"phase": "card", "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0]})

    sources = ("ragged_paged_attention", "flash_attention_fwd",
               "flash_attention_bwd", "quant_matmul",
               "ragged_paged_attention_quant",
               "ragged_paged_attention_partials")
    t0 = time.perf_counter()
    _build.build(*sources)
    build_s = time.perf_counter() - t0
    ptxas = {}
    for name in sources:
        lines = [ln.strip() for ln in _build.build_log(name).splitlines()
                 if "registers" in ln or "spill" in ln]
        ptxas[name] = lines[:24]
    emit({"phase": "build", "seconds": build_s, "ptxas": ptxas})

    ragged_main = ragged_case(torch, np, "mha_32x32", 32, 32, 11)
    ragged_case(torch, np, "gqa_32x8", 32, 8, 12)
    ragged_case(torch, np, "nan_poison", 32, 32, 13, poison=True)
    ragged_case(torch, np, "last_token_gqa_32x8", 32, 8, 14, plant=True)
    for s in (1024, 2048):
        for d in (64, 128):
            for causal in (True, False):
                flash_case(torch, f"bh64_s{s}_d{d}_{'causal' if causal else 'full'}",
                           64, s, d, causal, s + d + causal)
    # the shape CachedDecoder's prefill gives the kernel in phase 5
    flash_main = flash_case(torch, "generate_prefill_bh128_s1024_d128_causal",
                            128, 1024, 128, True, 7)
    # the quantized and long-context serving kernels at serve_quant's and
    # serve_long's shapes: the decode projections (M = 8 slots), the head
    # (float32 x), one prefill product (M = 1024) and fp8 codes
    qmm_main = None
    for name, m, k, n, qd, xd in (
            ("decode_qkvo_m8_k4096_n4096", 8, 4096, 4096, "int8",
             torch.bfloat16),
            ("decode_gate_up_m8_k4096_n11008", 8, 4096, 11008, "int8",
             torch.bfloat16),
            ("decode_down_m8_k11008_n4096", 8, 11008, 4096, "int8",
             torch.bfloat16),
            ("decode_head_m8_k4096_n32000_f32", 8, 4096, 32000, "int8",
             torch.float32),
            ("prefill_gate_up_m1024_k4096_n11008", 1024, 4096, 11008,
             "int8", torch.bfloat16),
            ("fp8_decode_gate_up_m8_k4096_n11008", 8, 4096, 11008, "fp8",
             torch.bfloat16)):
        rec = qmm_case(torch, name, m, k, n, qd, xd, m + k + n)
        if name.startswith("decode_gate_up"):
            qmm_main = rec
    rquant_main = ragged_quant_case(torch, np, "quant_mha_32x32", 32, 32, 21)
    ragged_quant_case(torch, np, "quant_gqa_32x8", 32, 8, 22)
    ragged_quant_case(torch, np, "quant_nan_poison", 32, 32, 23, poison=True)
    ragged_quant_case(torch, np, "quant_last_token_gqa_32x8", 32, 8, 24,
                      plant=True)
    partials_main = partials_case(torch, np, "shards4_s4_32x32_mb64", 25)

    layers = args.layers
    reqs = make_requests(np, args.seed)
    model = build_model(torch, llama_2_7b(dtype="bfloat16",
                                          num_hidden_layers=layers),
                        args.seed)
    serve = serve_phase(torch, np, model, reqs, layers)
    gen = generate_phase(torch, np, model, layers, args.seed)
    if args.profile:
        profile_phase(torch, model, reqs)
    serve_quant = serve_quant_phase(torch, np, model, reqs, layers)
    long_reqs = make_long_requests(np, args.seed)
    serve_long = serve_long_phase(torch, np, model, long_reqs, layers)
    if args.profile:
        profile_phase(torch, model, reqs, "profile_serve_quant",
                      weight_quant="int8_blockwise", kv_quant="int8")
        profile_phase(torch, model, long_reqs, "profile_serve_long",
                      max_len=4096, max_slots=4, attn_shards=4)
    del model
    torch.cuda.empty_cache()
    parity_phase(torch, np, reqs, args.seed)
    quant_shard_parity_phase(torch, np, reqs, args.seed)

    # the training path's kernel checks run after the serving phases, so
    # that those see the card as the serving slice left it
    # the shape the train phase gives the forward (batch 6 x 32 heads)
    flash_case(torch, "train_bh192_s2048_d128_causal", 192, 2048, 128, True,
               8)
    for s in (1024, 2048):
        for d in (64, 128):
            for causal in (True, False):
                flash_bwd_case(
                    torch, f"bh64_s{s}_d{d}_{'causal' if causal else 'full'}",
                    64, s, d, causal, 3 * s + d + causal)
    for causal in (True, False):                # no tile divides 1000
        flash_bwd_case(torch, f"bh64_s1000_d128_"
                              f"{'causal' if causal else 'full'}",
                       64, 1000, 128, causal, 31 + causal)
    # the shape the train phase gives the backward
    bwd_main = flash_bwd_case(torch, "train_bh192_s2048_d128_causal", 192,
                              2048, 128, True, 9)
    train = train_phase(torch, np, args.seed)
    if args.profile:
        train_profile_phase(torch, np, args.seed)
    train_parity_phase(torch, np, args.seed)

    kernels = []
    for name, route_src, replaces, rec, launches in (
            ("ragged_paged_attention",
             "paddle_tpu_torch/csrc/ragged_paged_attention.cu",
             "paddle_tpu/kernels/pallas/ragged_paged_attention.py:170",
             ragged_main, serve["ragged_launches"]),
            ("flash_attention_fwd",
             "paddle_tpu_torch/csrc/flash_attention_fwd.cu",
             "paddle_tpu/kernels/pallas/flash_attention.py:135",
             flash_main, gen["flash_launches"]),
            ("flash_attention_bwd",
             "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
             "paddle_tpu/kernels/pallas/flash_attention.py:480",
             bwd_main, train["flash_bwd_launches"]),
            ("quant_matmul", "paddle_tpu_torch/csrc/quant_matmul.cu",
             "paddle_tpu/kernels/pallas/quant_matmul.py:177",
             qmm_main, serve_quant["quant_matmul_launches"]),
            ("ragged_paged_attention_quant",
             "paddle_tpu_torch/csrc/ragged_paged_attention_quant.cu",
             "paddle_tpu/kernels/pallas/ragged_paged_attention.py:506",
             rquant_main, serve_quant["ragged_quant_launches"]),
            ("ragged_paged_attention_partials",
             "paddle_tpu_torch/csrc/ragged_paged_attention_partials.cu",
             "paddle_tpu/kernels/pallas/ragged_paged_attention.py:310",
             partials_main, serve_long["partials_launches"])):
        check(launches > 0, f"{name} never ran on the main path")
        kernels.append({"name": name, "route": "cuda", "source": route_src,
                        "replaces": replaces, "launches": launches,
                        "max_abs_err": rec["max_abs_err"],
                        "ms": rec["kernel_ms"], "plain_ms": rec["plain_ms"],
                        "bound_ms": rec["bound_ms"],
                        "bound_by": rec["bound_by"],
                        "library_ms": rec["library_ms"]})
    emit({"kernels": kernels})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:
        traceback.print_exc()
        sys.exit(1)
