"""KV-cache decode engine (counterpart of paddle_tpu/models/decode.py).

``CachedDecoder`` stacks the model's weights per kind ([L, out, in], the
torch.nn.Linear layout), prefills a prompt in one causal forward that
writes every layer's K/V into [L, B, max_len, Hkv, D] caches, and then
decodes one token per step against the caches. The caches are updated in
place. A prompt whose length is a multiple of 128 prefills through the
flash-attention forward kernel (kernels/flash_attention.py), as the JAX
engine switches to its Pallas kernel there, where `attention_route` gives
"kernel" for the model's dtype and head dim; other lengths, and a head
dim no kernel takes (80, 96), use the plain causal softmax on every
device. ``CachedDecoder.route_launches`` counts the prefill attention
calls by route.

``generate`` fuses up to ``CHUNK`` (32) decode steps into one chunk, greedy
or sampled (temperature / top-k / top-p, noise from a ``generator=``), as
the JAX engine fuses them into one executable; a tail shorter than CHUNK
runs as the largest power of two that fits, and a last single step runs
alone. On the card each chunk is one CUDA graph (``jit/chunk_graph.py``)
keyed on (n, top_k, use_top_p), over static buffers that hold the last
token, the position, the caches, the temperature, top_p and the chunk's
uniform draws; it advances the token and the position in place. With
``eos_token_id=None`` nothing is read back until the end; otherwise each
chunk's tokens are read once.

``weight_quant`` stores the projections and the head quantized, as the JAX
engine does, and drops the dense copies:
- ``"int8"``: int8 codes with one scale per output channel; each product
  dequantizes the layer's weight in the model dtype and multiplies (no
  kernel, as in the JAX engine);
- ``"int8_blockwise"``: int8 codes with one float32 scale per (output
  column, block of up to 128 inputs), multiplied by the quant_matmul
  kernel (kernels/quant_matmul.py), which dequantizes in registers.
Every product against a stacked weight goes through ``_layer_mm`` and the
head through ``_head_logits``.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch.nn import functional as F

from ..framework.device import resolve_device, torch_dtype
from ..jit.chunk_graph import ChunkGraphs
from ..kernels.flash_attention import _flash_bhsd
from ..kernels.quant_matmul import (blockwise_weight_bytes, quant_matmul,
                                    quantize_weight_blockwise)
from ..nn.functional.flash_attention import (ATTENTION_ROUTES,
                                             attention_route)
from ..nn.layer.norm import rms_norm as _rms
from .generation import (gumbel_from_uniform, sample_next,
                         sample_next_traced, sampling_args)

__all__ = ["CachedDecoder"]

NEG_INF = -1e30
_MATS = ("wq", "wk", "wv", "wo", "wg", "wu", "wd")


class CachedDecoder:
    """Serving engine over a LlamaForCausalLM, on ``device`` (default
    ``cuda``; raises without a card unless ``device="cpu"``)."""

    # prefill attention calls (one a layer a prefill) by route: "kernel"
    # (the flash forward) or "plain", across every engine
    route_launches = dict.fromkeys(ATTENTION_ROUTES, 0)

    def __init__(self, model, max_len=None, weight_quant=None, device=None):
        if weight_quant not in (None, "int8", "int8_blockwise"):
            raise ValueError(f"unknown weight_quant {weight_quant!r}")
        cfg = model.config
        self.weight_quant = weight_quant
        self.device = resolve_device(device)
        self.cfg = cfg
        self.dtype = torch_dtype(cfg.dtype)
        self.max_len = int(max_len or cfg.max_position_embeddings)
        self.nh = cfg.num_attention_heads
        self.nkv = cfg.num_key_value_heads
        self.hd = cfg.head_dim
        self.eps = cfg.rms_norm_eps
        self.n_layers = cfg.num_hidden_layers
        self.scale = 1.0 / math.sqrt(self.hd)
        llama = model.llama
        layers = list(llama.layers)
        with torch.no_grad():
            def stack(get):
                return torch.stack([get(l).detach() for l in layers]).to(
                    self.device)

            self.w = {
                "wq": stack(lambda l: l.self_attn.q_proj.weight),
                "wk": stack(lambda l: l.self_attn.k_proj.weight),
                "wv": stack(lambda l: l.self_attn.v_proj.weight),
                "wo": stack(lambda l: l.self_attn.o_proj.weight),
                "wg": stack(lambda l: l.mlp.gate_proj.weight),
                "wu": stack(lambda l: l.mlp.up_proj.weight),
                "wd": stack(lambda l: l.mlp.down_proj.weight),
                "ln1": stack(lambda l: l.input_layernorm.weight),
                "ln2": stack(lambda l: l.post_attention_layernorm.weight),
            }
            self.embed = llama.embed_tokens.weight.detach().to(self.device)
            self.norm_w = llama.norm.weight.detach().to(self.device)
            # the head multiplies in float32 ([V, H]); a tied model reuses
            # the embedding (the JAX engine's embed.T)
            head = self.embed if model.lm_head is None \
                else model.lm_head.weight.detach().to(self.device)
            self.head = head.float()
            self._quantize_weights()
            if llama.rope_cos.shape[0] < self.max_len:
                raise ValueError(f"max_len {self.max_len} exceeds the "
                                 f"model's rope tables "
                                 f"({llama.rope_cos.shape[0]})")
            self.cos = llama.rope_cos[:self.max_len].to(self.device)
            self.sin = llama.rope_sin[:self.max_len].to(self.device)
        # decode steps fused into one generate chunk (an instance knob, as
        # in the JAX engine: tests shrink it to mix chunks and tails)
        self.CHUNK = 32
        self._gen = None
        self._gen_graphs = ChunkGraphs(
            self.device, lambda: [(quant_matmul, "launches"),
                                  (quant_matmul, "route_launches")])

    def _quantize_weights(self):
        """Quantize the projections and the head for ``weight_quant`` (the
        JAX engine's codecs, on the [out, in] layout), drop the dense
        copies, and price one full weight read in this storage format
        against bf16: ``weight_stream_bytes``."""
        quant_b = bf16eq_b = 0
        self.wq8, self.wscale = {}, {}
        if self.weight_quant == "int8":
            for k in _MATS:
                a = self.w[k].float()                    # [L, out, in]
                s = (a.abs().amax(dim=-1, keepdim=True) / 127.0
                     ).clamp_min(1e-12)
                self.wq8[k] = torch.round(a / s).to(torch.int8)
                self.wscale[k] = s
                quant_b += a.numel() + s.numel() * 4
                bf16eq_b += a.numel() * 2
                del a
            hs = (self.head.abs().amax(dim=-1, keepdim=True) / 127.0
                  ).clamp_min(1e-12)                     # per vocab row
            self.head_q8 = torch.round(self.head / hs).to(torch.int8)
            self.head_scale = hs
            quant_b += self.head.numel() + hs.numel() * 4
            bf16eq_b += self.head.numel() * 2
        elif self.weight_quant == "int8_blockwise":
            for k in _MATS:
                # one layer at a time: the codec's float32 temporaries stay
                # the size of one weight
                pairs = [quantize_weight_blockwise(w) for w in self.w[k]]
                self.wq8[k] = torch.stack([q for q, _ in pairs])
                self.wscale[k] = torch.stack([s for _, s in pairs])
                nl, nout, kin = self.w[k].shape
                qb, bb = blockwise_weight_bytes(kin, nout)
                quant_b += nl * qb
                bf16eq_b += nl * bb
                del pairs
            self.head_q8, self.head_scale = \
                quantize_weight_blockwise(self.head)
            qb, bb = blockwise_weight_bytes(self.head.shape[1],
                                            self.head.shape[0])
            quant_b += qb
            bf16eq_b += bb
        else:
            # the head is priced in the model dtype, as the JAX engine
            # stores it (this engine keeps a float32 copy to multiply)
            itemsize = torch.finfo(self.dtype).bits // 8
            for k in _MATS:
                quant_b += self.w[k].numel() * itemsize
                bf16eq_b += self.w[k].numel() * 2
            quant_b += self.head.numel() * itemsize
            bf16eq_b += self.head.numel() * 2
        if self.weight_quant is not None:
            # the dense stacks and the float32 head are dead weight now
            self.w = {k: self.w[k] for k in ("ln1", "ln2")}
            self.head = None
        self.weight_stream_bytes = {"quant": int(quant_b),
                                    "bf16eq": int(bf16eq_b)}

    # -- building blocks ---------------------------------------------------
    def _layer_mm(self, x, name, l):
        """x [..., in] times layer l's weight ``name`` -> [..., out], in
        the engine's weight storage: dense, per-channel int8 (dequantized
        in the model dtype, then a plain product) or block-scaled int8
        (the quant_matmul kernel)."""
        if self.weight_quant == "int8_blockwise":
            return quant_matmul(x, self.wq8[name][l], self.wscale[name][l])
        if self.weight_quant == "int8":
            return F.linear(x, self.wq8[name][l].to(x.dtype)
                            * self.wscale[name][l].to(x.dtype))
        return F.linear(x, self.w[name][l])

    def _head_logits(self, x):
        """float32 logits of the normed hidden state x [..., H]."""
        if self.weight_quant == "int8_blockwise":
            return quant_matmul(x.float(), self.head_q8, self.head_scale)
        if self.weight_quant == "int8":
            return F.linear(x.float(), self.head_q8.float()
                            * self.head_scale)
        return F.linear(x.float(), self.head)

    @staticmethod
    def _rope_at(x, cos, sin):
        # x [..., Hn, D]; cos/sin broadcastable [..., 1, D]; rotate-half
        c, s = cos.to(x.dtype), sin.to(x.dtype)
        x1, x2 = x.chunk(2, dim=-1)
        return x * c + torch.cat([-x2, x1], dim=-1) * s

    def _mlp(self, x, l):
        h2 = _rms(x, self.w["ln2"][l], self.eps)
        g = self._layer_mm(h2, "wg", l)
        u = self._layer_mm(h2, "wu", l)
        return x + self._layer_mm(F.silu(g) * u, "wd", l)

    def _qkv(self, x, l, cos, sin):
        """Normed projections of x [..., H] with RoPE applied: q [..., nh,
        hd], k and v [..., nkv, hd]. cos/sin broadcast against them."""
        h1 = _rms(x, self.w["ln1"][l], self.eps)
        lead = x.shape[:-1]
        q = self._layer_mm(h1, "wq", l).reshape(*lead, self.nh, self.hd)
        k = self._layer_mm(h1, "wk", l).reshape(*lead, self.nkv, self.hd)
        v = self._layer_mm(h1, "wv", l).reshape(*lead, self.nkv, self.hd)
        return self._rope_at(q, cos, sin), self._rope_at(k, cos, sin), v

    # -- one decode step ---------------------------------------------------
    @torch.no_grad()
    def _step(self, tokens, pos, kcache, vcache):
        """tokens [B] int; pos, the position being written: a 0-d integer
        tensor on the engine's device (an int is taken too); caches [L, B,
        T, Hkv, D], written in place. Attends over the whole cache with
        the positions past pos masked, as the JAX engine's step does, so
        no shape depends on pos. Returns logits [B, V] float32."""
        if not torch.is_tensor(pos):
            pos = torch.tensor(pos, device=self.device)
        pos = pos.long().reshape(1)
        x = self.embed[tokens.long()]                    # [B, H]
        B = x.shape[0]
        T = kcache.shape[2]
        cos = self.cos[pos][:, None, :]
        sin = self.sin[pos][:, None, :]
        keep = torch.arange(T, device=x.device) <= pos   # [T]
        nrep = self.nh // self.nkv
        for l in range(self.n_layers):
            q, k, v = self._qkv(x, l, cos, sin)
            kc, vc = kcache[l], vcache[l]
            kc.index_copy_(1, pos, k[:, None].to(kc.dtype))
            vc.index_copy_(1, pos, v[:, None].to(vc.dtype))
            # grouped attention against the unrepeated cache
            qg = q.reshape(B, self.nkv, nrep, self.hd).float()
            att = torch.einsum("bgnd,btgd->bgnt", qg,
                               kc.float()) * self.scale
            att = att.masked_fill(~keep, NEG_INF)
            p = torch.softmax(att, dim=-1)
            o = torch.einsum("bgnt,btgd->bgnd", p, vc.float()).to(x.dtype)
            x = x + self._layer_mm(o.reshape(B, self.nh * self.hd), "wo",
                                   l)
            x = self._mlp(x, l)
        return self._head_logits(_rms(x, self.norm_w, self.eps))

    def _chunk(self, tok, pos, kcache, vcache, n, sampler=None):
        """n fused decode steps from tok [B] at position pos (0-d tensor):
        each step's token feeds the next. ``sampler`` (None: greedy argmax)
        maps (step i, logits) to the next tokens. Returns [B, n]
        tokens."""
        out = []
        for i in range(n):
            logits = self._step(tok, pos + i, kcache, vcache)
            tok = (torch.argmax(logits, dim=-1) if sampler is None
                   else sampler(i, logits))
            out.append(tok)
        return torch.stack(out, dim=1)

    def _gen_state(self, batch, sampled):
        """The static buffers of generate for ``batch`` rows: the caches
        (zeroed), the last token, the position, and for sampling the
        temperature, top_p and CHUNK uniform draws [CHUNK, B, V]. Kept
        across calls while the batch and CHUNK stay, since the graphs bind
        their addresses."""
        g = self._gen
        if g is None or g["batch"] != batch or g["chunk"] != self.CHUNK:
            self._gen_graphs.clear()
            self._gen = None
            g = {"batch": batch, "chunk": self.CHUNK, "u": None}
            g["kc"], g["vc"] = self.new_caches(batch)
            g["tok"] = torch.zeros(batch, dtype=torch.long,
                                   device=self.device)
            g["pos"] = torch.zeros((), dtype=torch.long, device=self.device)
            g["temp"] = torch.ones((), device=self.device)
            g["top_p"] = torch.ones((), device=self.device)
            self._gen = g
        else:
            g["kc"].zero_()
            g["vc"].zero_()
        if sampled and g["u"] is None:
            g["u"] = torch.zeros((self.CHUNK, batch, self.cfg.vocab_size),
                                 device=self.device)
        return g

    def _gen_chunk(self, g, n, do_sample, top_k, use_top_p, generator):
        """One fused chunk of n steps on generate's static buffers,
        advancing the token and the position in place; returns the [B, n]
        tokens (overwritten by the next replay of the same graph). A
        sampled chunk first draws its n uniforms [B, V] from
        ``generator``, one draw a step, as the per-token loop does."""
        sampler = None
        if do_sample:
            for i in range(n):
                g["u"][i].uniform_(generator=generator)

            def sampler(i, logits):
                return sample_next_traced(
                    logits, g["temp"], top_k, use_top_p, g["top_p"],
                    gumbel_from_uniform(g["u"][i]))

        def body():
            toks = self._chunk(g["tok"], g["pos"], g["kc"], g["vc"], n,
                               sampler)
            g["tok"].copy_(toks[:, -1])
            g["pos"].add_(n)
            return toks

        def warmup():
            # writes the cache rows pos..pos+n-1 that the chunk itself
            # writes next, with the same values; the static state stays
            self._chunk(g["tok"], g["pos"], g["kc"], g["vc"], n, sampler)

        key = (int(n), int(top_k), bool(use_top_p)) if do_sample \
            else (int(n),)
        return self._gen_graphs.run(key, body, warmup)

    # -- prefill -----------------------------------------------------------
    @torch.no_grad()
    def _prefill(self, ids, kcache, vcache):
        """ids [B, S0] -> last-token logits [B, V] f32; fills the caches'
        first S0 positions in place. S0 % 128 == 0 runs the flash kernel
        where `attention_route` takes the dtype and head dim."""
        B, S0 = ids.shape
        x = self.embed[ids]                              # [B, S0, H]
        cos = self.cos[:S0][None, :, None, :]
        sin = self.sin[:S0][None, :, None, :]
        nrep = self.nh // self.nkv
        use_flash = (S0 % 128 == 0
                     and attention_route(x.dtype, self.hd) == "kernel")
        CachedDecoder.route_launches["kernel" if use_flash else "plain"] \
            += self.n_layers
        causal = torch.ones(S0, S0, dtype=torch.bool,
                            device=self.device).tril()
        for l in range(self.n_layers):
            q, k, v = self._qkv(x, l, cos, sin)
            kcache[l, :, :S0] = k
            vcache[l, :, :S0] = v
            if use_flash:
                keys = k.repeat_interleave(nrep, dim=2) if nrep > 1 else k
                vals = v.repeat_interleave(nrep, dim=2) if nrep > 1 else v

                def fold(a):
                    return a.transpose(1, 2).reshape(B * self.nh, S0,
                                                     self.hd)

                o, _ = _flash_bhsd(fold(q), fold(keys), fold(vals), True,
                                   self.scale)
                o = o.reshape(B, self.nh, S0, self.hd).transpose(1, 2)
            else:
                qg = q.reshape(B, S0, self.nkv, nrep, self.hd).float()
                att = torch.einsum("bqgnd,bkgd->bgnqk", qg,
                                   k.float()) * self.scale
                att = att.masked_fill(~causal, NEG_INF)
                p = torch.softmax(att, dim=-1)
                o = torch.einsum("bgnqk,bkgd->bqgnd", p, v.float())
            o = o.to(x.dtype).reshape(B, S0, self.nh * self.hd)
            x = x + self._layer_mm(o, "wo", l)
            x = self._mlp(x, l)
        return self._head_logits(_rms(x[:, -1], self.norm_w, self.eps))

    # -- public ------------------------------------------------------------
    def new_caches(self, batch):
        shape = (self.n_layers, batch, self.max_len, self.nkv, self.hd)
        return (torch.zeros(shape, dtype=self.dtype, device=self.device),
                torch.zeros(shape, dtype=self.dtype, device=self.device))

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens=32, do_sample=False,
                 temperature=1.0, top_k=0, top_p=1.0, eos_token_id=None,
                 pad_token_id=0, generator=None):
        """Generation with the token contract of models.generation.generate
        (an int64 CPU tensor [B, S0 + max_new_tokens], pad after each
        row's first eos), O(1) work a token through the caches, in fused
        chunks of CHUNK steps (the loop of the JAX engine's generate).
        do_sample draws from ``generator`` (a torch.Generator on the
        engine's device; None: its default generator), one [B, V] uniform
        draw a token in step order, so fused chunks give the per-token
        loop's stream (CHUNK = 1) under the same seed; with eos_token_id
        set, the draws of a chunk past every row's eos are made all the
        same."""
        ids = np.asarray(input_ids.cpu() if torch.is_tensor(input_ids)
                         else input_ids)
        b, s0 = ids.shape
        total = s0 + max_new_tokens
        if total > self.max_len:
            raise ValueError(f"{total} tokens exceed max_len {self.max_len}")
        buf = np.full((b, total), pad_token_id, np.int64)
        buf[:, :s0] = ids
        if max_new_tokens <= 0:
            return torch.from_numpy(buf)
        g = self._gen_state(b, do_sample)
        kc, vc = g["kc"], g["vc"]
        logits = self._prefill(torch.as_tensor(ids, device=self.device),
                               kc, vc)
        temp, use_top_p, top_p = sampling_args(temperature, top_p)
        first = sample_next(logits, do_sample, temperature, top_k, top_p,
                            generator)
        g["tok"].copy_(first)
        g["pos"].fill_(s0)
        g["temp"].fill_(temp)
        g["top_p"].fill_(top_p)
        pieces = [first[:, None]]      # generated tokens, on the device
        done = s0                      # buf columns filled from pieces
        t = s0

        def flush():
            nonlocal done
            if len(pieces) > 0:
                new = torch.cat(pieces, dim=1).cpu().numpy()
                buf[:, done:done + new.shape[1]] = new
                done += new.shape[1]
                pieces.clear()

        while t + 1 < total:
            n = min(total - 1 - t, self.CHUNK)
            if n < self.CHUNK:
                # tails round down to powers of two: the chunk lengths stay
                # {CHUNK, 16, 8, 4, 2} whatever max_new_tokens is
                n = 1 << (n.bit_length() - 1)
            if n >= 2:
                toks = self._gen_chunk(g, n, do_sample, top_k, use_top_p,
                                       generator).clone()
            else:
                logits = self._step(g["tok"], g["pos"], kc, vc)
                nxt = sample_next(logits, do_sample, temperature, top_k,
                                  top_p, generator)
                g["tok"].copy_(nxt)
                g["pos"].add_(1)
                toks = nxt[:, None]
            pieces.append(toks)
            t += n
            if eos_token_id is not None:
                flush()
                if (buf[:, s0:t + 1] == eos_token_id).any(axis=1).all():
                    break
        flush()
        if eos_token_id is not None:
            for row in buf:
                hits = np.where(row[s0:] == eos_token_id)[0]
                if len(hits):
                    row[s0 + hits[0] + 1:] = pad_token_id
        return torch.from_numpy(buf)
