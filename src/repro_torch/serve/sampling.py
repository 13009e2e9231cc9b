"""Token sampling for batched decode (counterpart of
``repro/serve/sampling.py``).

Two entry points share one masking core:

  * :func:`sample` — one (temperature, top_k) for the whole batch (the
    static ``generate`` path).
  * :func:`sample_slots` — per-row temperature / top_k / generator, used by
    the continuous-batching engine where every slot is an independent
    request with its own sampling params and random stream.

Greedy decoding is the argmax (ties to the lower token id, as
``jnp.argmax``); sampled decoding draws from ``torch.Generator``s, so its
tokens cannot match JAX's key streams.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

NEG_INF = -1e30


def top_k_mask(logits: torch.Tensor, top_k: int) -> torch.Tensor:
    """Mask all but the top-k logits per row to NEG_INF; exactly k survive,
    ties at the kth value broken toward the lower token id."""
    V = logits.shape[-1]
    k = top_k if top_k > 0 else V
    order = torch.argsort(-logits, dim=-1, stable=True)
    ranks = torch.argsort(order, dim=-1)
    return torch.where(ranks < k, logits, torch.full_like(logits, NEG_INF))


def sample(
    logits: torch.Tensor, *, temperature: float = 0.0, top_k: int = 0,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """logits: (B, V) -> tokens (B,) int64.  temperature 0 = greedy."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits / temperature
    if top_k > 0:
        logits = top_k_mask(logits, top_k)
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def sample_slots(
    logits: torch.Tensor,  # (S, V)
    temperature: Sequence[float],  # (S,); <= 0 -> greedy for that slot
    top_k: Sequence[int],  # (S,); 0 -> no truncation
    generators: Sequence[Optional[torch.Generator]],  # (S,); None for greedy rows
) -> torch.Tensor:
    """Per-slot sampling: each row draws with its own temperature, top-k and
    generator, so a row's token depends on nothing but its own logits and
    stream (not on the other slots of the pool).  Returns (S,) int64."""
    out = torch.argmax(logits, dim=-1)
    for s, temp in enumerate(temperature):
        if temp <= 0.0:
            continue
        row = logits[s : s + 1] / max(float(temp), 1e-6)
        if top_k[s] > 0:
            row = top_k_mask(row, int(top_k[s]))
        probs = torch.softmax(row.float(), dim=-1)
        out[s] = torch.multinomial(probs, 1, generator=generators[s])[0, 0]
    return out
