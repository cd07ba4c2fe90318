"""Greedy generation through the full forward (counterpart of
paddle_tpu/models/generation.py). Every step runs the whole causal
forward over the tokens so far; it is the oracle the cached and paged
decoders are held to. Sampling is a later slice of the port."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["generate"]


@torch.no_grad()
def generate(model, input_ids, max_new_tokens=32, do_sample=False,
             temperature=1.0, top_k=0, top_p=1.0, eos_token_id=None,
             pad_token_id=0):
    """input_ids [B, S0] (tensor or array of ints). Returns an int64 CPU
    tensor [B, S0 + max_new_tokens]; after a row's eos its positions hold
    pad_token_id. temperature/top_k/top_p shape sampling only, which
    raises (greedy decoding ignores them, as in the JAX package)."""
    if do_sample:
        raise NotImplementedError(
            "sampling is not ported yet; the port generates greedily")
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
        nxt = torch.argmax(logits.float(), dim=-1).cpu().numpy()
        if eos_token_id is not None:
            nxt = np.where(finished, pad_token_id, nxt)
            finished |= nxt == eos_token_id
        buf[:, t] = nxt
        if eos_token_id is not None and finished.all():
            break
    return torch.from_numpy(buf)
