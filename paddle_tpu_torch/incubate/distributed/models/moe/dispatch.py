"""The expert-parallel token exchange and the expert activations
(counterpart of paddle_tpu/incubate/distributed/models/moe/dispatch.py).

The JAX package runs the exchange inside one shard_map over the ``ep``
mesh axis; here each rank runs that body (``_ep_body``) on its own rows
and the exchange is a collective over the expert group:

1. the rank's routes are ranked by (destination rank, expert) with
   one-hot cumsums (int32, no sort) and their token rows placed in a
   [ep, cap, H] send buffer, cap = every local route (dropless: each
   route always fits), with the [ep, E_local] count matrix;
2. ``ep_all_to_all`` exchanges the rows (under the wire codec) and the
   count matrix travels exact in int32;
3. the received rows are regrouped into one tile-aligned grouped buffer
   (groups at multiples of ``bm``) and gate -> up -> down run through
   the grouped-matmul kernels over this rank's experts (the quantized
   grouped kernel under ``qdtype``);
4. the results go back into the receive layout, home through
   ``ep_all_to_all``, and are combined with the gate weights (float32
   sum, activation dtype out).

``ep_all_to_all`` is an autograd Function: its backward is the same
exchange of the gradients under the same codec (the tiled leading-axis
all_to_all is its own transpose). Its calls and the bytes they put on
the wire (the payload as the codec encoded it: codes and scales, bf16
values, or the exact values) are counted in ``ep_all_to_all.counters``.
gelu in ``_ACTS`` is the exact erf form, as paddle's default.
"""
from __future__ import annotations

import functools

import torch
from torch.nn import functional as F

__all__ = ["ep_all_to_all", "moe_ep_forward", "dispatch_wire_bytes",
           "group_mean", "reduce_scatter_rows", "all_gather_rows", "_ACTS"]

_ACTS = {
    "gelu": functools.partial(F.gelu, approximate="none"),
    "relu": F.relu,
    "silu": F.silu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
}


def _exchange(x, group, compress):
    from .....distributed.collective import wire_all_to_all
    c = ep_all_to_all.counters
    c["calls"] += 1
    return wire_all_to_all(x, group, compress, group.nranks, counters=c)


class _EpAllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, compress):
        ctx.group, ctx.compress = group, compress
        return _exchange(x, group, compress)

    @staticmethod
    def backward(ctx, dy):
        dx = _exchange(dy.contiguous(), ctx.group, ctx.compress)
        return dx, None, None


def ep_all_to_all(x, group, compress=None):
    """The token exchange: x [ep, cap, ...] with row d bound for group rank
    d; returns [ep, cap, ...] with row s received from group rank s.
    Differentiable: the backward is the same exchange of the gradients
    under the same codec."""
    return _EpAllToAll.apply(x, group, compress)


ep_all_to_all.counters = {"calls": 0, "wire_bytes": 0}


def _sum_over(x, group):
    from .....distributed.collective import _ar
    import torch.distributed as tdist
    out = x.contiguous().clone()
    _ar(out, tdist.ReduceOp.SUM, group)
    return out


class _GroupMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum_over(x, group) / group.nranks

    @staticmethod
    def backward(ctx, dy):
        return _sum_over(dy, ctx.group) / ctx.group.nranks, None


def group_mean(x, group):
    """The mean of every group rank's ``x``, on each rank; differentiable
    (the backward averages the ranks' gradients the same way)."""
    return _GroupMean.apply(x, group)


def _rs_rows(x, group):
    from .....distributed.collective import _rs
    import torch.distributed as tdist
    n = group.nranks
    out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
    _rs(out.reshape(-1), x.contiguous().reshape(-1), tdist.ReduceOp.SUM,
        group)
    return out


def _ag_rows(x, group):
    from .....distributed.collective import _ag
    n = group.nranks
    out = x.new_empty((x.shape[0] * n,) + tuple(x.shape[1:]))
    _ag(out.reshape(-1), x.contiguous().reshape(-1), group)
    return out


class _ReduceScatterRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _rs_rows(x, group)

    @staticmethod
    def backward(ctx, dy):
        return _ag_rows(dy, ctx.group), None


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _ag_rows(x, group)

    @staticmethod
    def backward(ctx, dy):
        return _rs_rows(dy, ctx.group), None


def reduce_scatter_rows(x, group):
    """Group rank r gets the sum over the ranks of block r of x's dim 0;
    differentiable (the backward all-gathers)."""
    return _ReduceScatterRows.apply(x, group)


def all_gather_rows(x, group):
    """Every rank's x stacked along dim 0 in group-rank order;
    differentiable (the backward reduce-scatters the gradients)."""
    return _AllGatherRows.apply(x, group)


def dispatch_wire_bytes(n_ranks, cap, h, itemsize, compress=None,
                        directions=2):
    """Wire bytes one rank's dispatch moves per MoE layer forward:
    [ep, cap, H] per direction, priced per value under the codec (int8 =
    1 byte + a float32 scale per 256 values; bf16 = 2 bytes)."""
    from .....distributed.fleet.grad_buckets import wire_bytes
    nbytes = int(n_ranks) * int(cap) * int(h) * int(itemsize)
    return wire_bytes(nbytes, compress, itemsize=itemsize) * directions


def _excl_cumsum(x, dim=0):
    c = x.cumsum(dim, dtype=torch.int32)
    return c - x


def _ep_body(x, val, idx, w1, b1, w2, b2, *, group, ep, num_expert, el, k,
             bm, act, compress, qdtype):
    from .....kernels.grouped_matmul import (_onehot_ranks,
                                             aligned_group_size,
                                             grouped_matmul)
    nloc, h = x.shape
    tloc = nloc * k
    cap = tloc                       # dropless: every local route fits
    i32 = torch.int32
    dev = x.device
    e_flat = idx.reshape(-1).to(i32)
    # rank within (dst rank, expert): the stable expert-sorted order the
    # receiver's regroup assumes
    counts, rank = _onehot_ranks(e_flat, num_expert)     # [E], [tloc]
    cmat = counts.reshape(ep, el)                        # [dst, e_local]
    e_start = _excl_cumsum(cmat, 1).reshape(-1)          # [E] in-block
    dst_of = e_flat // el
    send_slot = dst_of * cap + e_start[e_flat.long()] + rank
    slot_src = torch.full((ep * cap,), -1, dtype=i32, device=dev)
    slot_src.scatter_(0, send_slot.long(),
                      torch.arange(tloc, dtype=i32, device=dev))
    tok = slot_src.clamp(min=0) // k
    zero = torch.zeros((), dtype=x.dtype, device=dev)
    send = torch.where((slot_src >= 0)[:, None],
                       x.index_select(0, tok.long()), zero)

    # the dispatch wire: token rows under the codec, the counts exact
    recv = ep_all_to_all(send.reshape(ep, cap, h), group, compress)
    from .....distributed.collective import _a2a
    cmat_r = torch.empty_like(cmat)
    _a2a(cmat_r.reshape(-1), cmat.contiguous().reshape(-1), group)

    # regroup the received rows into the tile-aligned grouped layout
    off_in_src = _excl_cumsum(cmat_r, 1)                 # [src, el]
    prior = _excl_cumsum(cmat_r, 0)                      # [src, el]
    gcounts = cmat_r.sum(0, dtype=i32)                   # [el]
    tiles = (gcounts + (bm - 1)) // bm
    goffs = _excl_cumsum(tiles) * bm                     # [el] row offsets
    src_tot = cmat_r.sum(1, dtype=i32)                   # [src]
    j = torch.arange(cap, dtype=i32, device=dev)[None, :].expand(ep, cap)
    csum = cmat_r.cumsum(1, dtype=i32)                   # [src, el]
    exp_of = (j[:, :, None] >= csum[:, None, :]).sum(2, dtype=i32)
    exp_of = exp_of.clamp(0, el - 1)                     # [src, cap]
    valid = j < src_tot[:, None]
    rowbase = torch.arange(ep, dtype=i32, device=dev)[:, None] * el
    flat_of = (rowbase + exp_of).long()
    prior_g = prior.reshape(-1)[flat_of]
    off_g = off_in_src.reshape(-1)[flat_of]
    dest = goffs[exp_of.long()] + prior_g + (j - off_g)  # [src, cap]
    tp = aligned_group_size(ep * cap, el, bm)
    lin = torch.arange(ep * cap, dtype=i32, device=dev)
    row_src = torch.full((tp + 1,), -1, dtype=i32, device=dev)
    row_src.scatter_(0, torch.where(valid, dest, tp).reshape(-1).long(),
                     lin)
    row_src = row_src[:tp]
    buf = torch.where((row_src >= 0)[:, None],
                      recv.reshape(ep * cap, h).index_select(
                          0, row_src.clamp(min=0).long()), zero)

    if qdtype:
        from .....kernels.quant_matmul import quantized_grouped_linear

        def gmm(a, w, b):
            return quantized_grouped_linear(
                a, w, b, group_offsets=goffs, group_counts=gcounts,
                qdtype=qdtype, bm=bm)
    else:
        def gmm(a, w, b):
            return grouped_matmul(a, w, b, group_offsets=goffs,
                                  group_counts=gcounts, bm=bm)
    hmid = _ACTS[act](gmm(buf, w1, b1))
    y = gmm(hmid, w2, b2)

    # home leg: grouped rows -> receive layout -> the exchange back
    yback = torch.where(valid.reshape(-1)[:, None],
                        y.index_select(0, dest.clamp(0, tp - 1)
                                       .reshape(-1).long()), zero)
    ret = ep_all_to_all(yback.reshape(ep, cap, h), group, compress)
    picked = ret.reshape(ep * cap, h).index_select(0, send_slot.long()) \
        .reshape(nloc, k, h)                             # per-route rows
    wgt = val.float()[..., None]
    return (picked.float() * wgt).sum(1).to(x.dtype)


def moe_ep_forward(flat, topk_val, topk_idx, w1, b1, w2, b2, *, group,
                   num_expert, bm=8, act="gelu", compress=None, qdtype=None):
    """Expert-parallel dropless MoE FFN on this rank's rows: the exchange
    carries each route to the rank that owns its expert and the result
    home. flat [N_local, H], topk_val/idx [N_local, K]; w1 [E_local, H, F],
    b1 [E_local, 1, F], w2 [E_local, F, H], b2 [E_local, 1, H] are this
    rank's experts (group rank r owns experts r * E_local ...). Every rank
    of ``group`` must pass the same N_local. Returns [N_local, H]."""
    ep = int(group.nranks)
    if num_expert % ep:
        raise ValueError(f"grouped ep dispatch needs num_expert "
                         f"({num_expert}) divisible by the ep degree ({ep})")
    el = num_expert // ep
    if w1.shape[0] != el:
        raise ValueError(f"w1 holds {w1.shape[0]} experts; a rank of ep "
                         f"{ep} owns {el} of {num_expert}")
    return _ep_body(flat, topk_val, topk_idx.to(torch.int32), w1, b1, w2, b2,
                    group=group, ep=ep, num_expert=num_expert, el=el,
                    k=topk_idx.shape[1], bm=int(bm), act=act,
                    compress=compress, qdtype=qdtype)
