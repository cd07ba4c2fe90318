"""MultiHeadAttention (counterpart of paddle_tpu/nn/layer/transformer.py).

Query, key, value and output projections with biases, and unmasked,
non-causal attention over [batch, seq, heads, head_dim] through the port's
``flash_attention``: on a CUDA tensor the flash-attention kernels (forward
and, under autograd, the backward), as the JAX layer reaches the Pallas
kernel on its chip; on a CPU tensor their plain versions. The kernels
take head dims 64, 128 and 256 and raise on others. An attention mask, a
KV cache, need_weights, dropout, and keys of another length than the
queries are not ported and raise.
"""
from __future__ import annotations

from torch import nn

from ...framework.device import resolve_device, seed
from ..functional.flash_attention import flash_attention
from .common import linear

__all__ = ["MultiHeadAttention"]


class MultiHeadAttention(nn.Module):
    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None, device=None, dtype=None, generator=None):
        super().__init__()
        for name, val, off in (("dropout", dropout, 0.0),
                               ("need_weights", need_weights, False),
                               ("weight_attr", weight_attr, None),
                               ("bias_attr", bias_attr, None)):
            if val != off:
                raise NotImplementedError(
                    f"MultiHeadAttention({name}={val!r}) is not ported to "
                    f"the PyTorch package yet")
        dev = resolve_device(device)
        gen = seed(0, dev) if generator is None else generator
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.q_proj = linear(embed_dim, embed_dim, dev, dtype, gen)
        self.k_proj = linear(kdim or embed_dim, embed_dim, dev, dtype, gen)
        self.v_proj = linear(vdim or embed_dim, embed_dim, dev, dtype, gen)
        self.out_proj = linear(embed_dim, embed_dim, dev, dtype, gen)

    def _heads(self, x):
        b, s = x.shape[0], x.shape[1]
        return x.reshape(b, s, self.num_heads, self.head_dim)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        if attn_mask is not None or cache is not None:
            raise NotImplementedError(
                "MultiHeadAttention with an attn_mask or a cache is not "
                "ported to the PyTorch package yet")
        key = query if key is None else key
        value = query if value is None else value
        if key.shape[1] != query.shape[1] or value.shape[1] != query.shape[1]:
            raise NotImplementedError(
                "keys and values of another length than the queries are "
                "not ported to the PyTorch package yet")
        q = self._heads(self.q_proj(query))
        k = self._heads(self.k_proj(key))
        v = self._heads(self.v_proj(value))
        out = flash_attention(q, k, v, causal=False)
        b, s = out.shape[0], out.shape[1]
        return self.out_proj(out.reshape(b, s, self.embed_dim))
