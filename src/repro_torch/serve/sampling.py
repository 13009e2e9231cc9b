"""Token sampling for batched decode (counterpart of
``repro/serve/sampling.py``).  Greedy decoding is the argmax (ties to the
lower token id, as ``jnp.argmax``); sampled decoding draws from a
``torch.Generator``, so its tokens cannot match JAX's key streams."""
from __future__ import annotations

from typing import Optional

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
