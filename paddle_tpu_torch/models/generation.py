"""Generation through the full forward, and the sampler (counterpart of
paddle_tpu/models/generation.py). Every step runs the whole causal
forward over the tokens so far; it is the oracle the cached and paged
decoders are held to.

Sampling is greedy, or temperature / top-k / top-p (nucleus) with a draw
from the filtered distribution. The draw is ``argmax(filtered logits +
gumbel)``, which is what ``jax.random.categorical`` computes, so the core
(`sample_next_traced`) takes the Gumbel noise as an argument and a test
can hand both packages the same noise. The port's noise comes from an
explicit ``torch.Generator`` (``generator=``; None: the device's default
generator), one uniform draw of [B, V] per generated token
(`gumbel_noise`), where the JAX package draws from its global key.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["generate", "sample_next", "sample_next_traced", "gumbel_noise",
           "gumbel_from_uniform", "top_p_keep", "sampling_args"]

NEG_INF = -1e30


def gumbel_from_uniform(u):
    """Standard Gumbel noise -log(-log(u)) of uniforms u in [0, 1) (0 is
    raised to the smallest normal float32, as jax.random.gumbel's
    uniform starts there)."""
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(u.clamp_min(tiny)))


def gumbel_noise(shape, generator=None, device=None):
    """One draw of standard Gumbel noise of ``shape`` (float32) from
    ``generator``: a uniform draw of that shape, then
    `gumbel_from_uniform`."""
    u = torch.empty(shape, dtype=torch.float32, device=device)
    return gumbel_from_uniform(u.uniform_(generator=generator))


def top_p_keep(logits, top_p):
    """The nucleus mask of float32 logits [B, V]: a token is kept when
    the probability mass strictly ahead of it, in descending order (ties
    in index order), is below top_p (a float or a 0-d tensor)."""
    probs = torch.softmax(logits, dim=-1)
    sorted_p, order = torch.sort(probs, dim=-1, descending=True,
                                 stable=True)
    csum = torch.cumsum(sorted_p, dim=-1)
    keep_sorted = (csum - sorted_p) < top_p
    return torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)


def sample_next_traced(logits, temperature, top_k, use_top_p, top_p,
                       gumbel):
    """The sampling core (the JAX package's `_sample_next_traced`):
    logits [B, V] -> token ids [B] (int64). temperature and top_p may be
    0-d tensors on the logits' device, so a captured chunk serves every
    value; top_k and use_top_p shape the work. Dividing by a temperature
    of 1.0 is exact. A float temperature or top_p becomes a 0-d tensor on
    the logits' device first: the card divides by a host scalar as a
    product with its reciprocal, which can differ from the division in
    the last bit, and the fused chunks divide by a tensor."""
    def on_device(v):
        return v if torch.is_tensor(v) else torch.tensor(
            float(v), dtype=torch.float32, device=logits.device)

    logits = logits.float() / on_device(temperature)
    if top_k and top_k > 0:
        kth = torch.topk(logits, int(top_k), dim=-1).values[:, -1:]
        logits = torch.where(logits < kth, NEG_INF, logits)
    if use_top_p:
        logits = torch.where(top_p_keep(logits, on_device(top_p)), logits,
                             NEG_INF)
    return torch.argmax(logits + gumbel, dim=-1)


def sampling_args(temperature, top_p):
    """(temperature, use_top_p, top_p) as the sampler takes them: a
    temperature of 0 or 1 is 1.0, and top-p filters only below 1."""
    use_temp = bool(temperature) and temperature != 1.0
    use_top_p = bool(top_p) and top_p < 1.0
    return (float(temperature) if use_temp else 1.0, use_top_p,
            float(top_p))


def sample_next(logits, do_sample, temperature, top_k, top_p,
                generator=None):
    """logits [B, V] -> token ids [B] (int64): argmax when not sampling
    (no noise drawn), else one Gumbel draw from ``generator`` through
    `sample_next_traced`."""
    if not do_sample:
        return torch.argmax(logits.float(), dim=-1)
    temp, use_top_p, top_p = sampling_args(temperature, top_p)
    noise = gumbel_noise(logits.shape, generator, logits.device)
    return sample_next_traced(logits, temp, top_k, use_top_p, top_p, noise)


@torch.no_grad()
def generate(model, input_ids, max_new_tokens=32, do_sample=False,
             temperature=1.0, top_k=0, top_p=1.0, eos_token_id=None,
             pad_token_id=0, generator=None):
    """input_ids [B, S0] (tensor or array of ints). Returns an int64 CPU
    tensor [B, S0 + max_new_tokens]; after a row's eos its positions hold
    pad_token_id. do_sample draws each token from the temperature / top-k
    / top-p filtered distribution with noise from ``generator`` (a
    torch.Generator on the model's device; None: the device's default
    generator)."""
    ids = np.asarray(input_ids.cpu() if torch.is_tensor(input_ids)
                     else input_ids)
    b, s0 = ids.shape
    total = s0 + max_new_tokens
    buf = np.full((b, total), pad_token_id, np.int64)
    buf[:, :s0] = ids
    dev = model.device
    finished = np.zeros(b, bool)
    for t in range(s0, total):
        logits = model(torch.as_tensor(buf[:, :t], device=dev))[:, -1]
        nxt = sample_next(logits, do_sample, temperature, top_k, top_p,
                          generator).cpu().numpy()
        if eos_token_id is not None:
            nxt = np.where(finished, pad_token_id, nxt)
            finished |= nxt == eos_token_id
        buf[:, t] = nxt
        if eos_token_id is not None and finished.all():
            break
    return torch.from_numpy(buf)
