"""Language model serving path: embedding → blocks → norm → logits, with
prefill and the decode step (counterpart of ``repro/models/lm.py``).

JAX stacks the layers of each pattern position on a leading axis and runs
them with ``lax.scan``; here the layers are a flat list, in the order that
scan visits them (group by group, pattern position within a group, then
the unstacked tail), and a Python loop runs them.  ``forward`` and the loss
belong to the training path and are not ported yet.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.common.device import resolve_device
from repro_torch.configs.base import ModelConfig, check_supported
from repro_torch.models import blocks as B
from repro_torch.models.layers import apply_norm, embed, init_embedding, init_norm
from repro_torch.models.mixer_api import DEFAULT_CONTEXT, ApplyContext


def layer_mixers(cfg: ModelConfig) -> List[str]:
    """Mixer name of every layer, in execution order."""
    plen = len(cfg.pattern)
    n_groups = cfg.n_layers // plen
    return list(cfg.pattern) * n_groups + list(cfg.pattern[: cfg.n_layers % plen])


def init_lm(cfg: ModelConfig, *, seed: int = 0, device="cuda") -> Dict[str, Any]:
    """Random weights from a seeded ``torch.Generator`` on ``device``, with
    the shapes and scales of the JAX ``init_lm`` (the draws differ; parity
    tests move JAX's weights through ``repro_torch.bridge``)."""
    check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params: Dict[str, Any] = {
        "embed": init_embedding(cfg.vocab_size, cfg.d_model, gen, dev),
        "final_norm": init_norm(cfg.d_model, dev),
        "blocks": [B.init_block(cfg, m, gen, dev) for m in layer_mixers(cfg)],
    }
    w = torch.randn(cfg.d_model, cfg.vocab_size, generator=gen, device=dev)
    params["head"] = {"w": w / math.sqrt(cfg.d_model)}
    return params


def _logits(params, x: torch.Tensor) -> torch.Tensor:
    """Final RMSNorm and the untied head; fp32 logits."""
    x = apply_norm(params["final_norm"], x)
    return (x @ params["head"]["w"].to(x.dtype)).float()


def prefill(
    params,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # (B, L) prompt
    max_len: int,
    dtype=torch.bfloat16,
    compute_dtype=None,
    *,
    ctx: Optional[ApplyContext] = None,
) -> Tuple[torch.Tensor, List[Any]]:
    """Prompt forward pass returning (logits (B, L, V) fp32, per-layer
    caches).  ``compute_dtype`` defaults to the cache dtype."""
    ctx = ctx or DEFAULT_CONTEXT
    x = embed(params["embed"], tokens, dtype=compute_dtype or dtype)
    caches = []
    for p, mixer in zip(params["blocks"], layer_mixers(cfg)):
        x, c = B.block_prefill(p, cfg, mixer, x, max_len, dtype, ctx)
        caches.append(c)
    return _logits(params, x), caches


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                dtype=torch.bfloat16, device="cuda") -> List[Any]:
    dev = resolve_device(device)
    return [
        B.init_block_cache(cfg, m, batch, max_len, dtype, dev)
        for m in layer_mixers(cfg)
    ]


def decode_step(
    params, cfg: ModelConfig, token_t: torch.Tensor, caches: List[Any],
    compute_dtype=torch.bfloat16,
) -> Tuple[torch.Tensor, List[Any]]:
    """One decode step: token_t (B,) -> (logits (B, V) fp32, new caches).

    The mixers update the large cache tensors in place (the Hyena operand
    history gains one row per step), so the caches passed in are consumed:
    use the returned list from here on."""
    x = embed(params["embed"], token_t, dtype=compute_dtype)  # (B, D)
    new = []
    for p, mixer, c in zip(params["blocks"], layer_mixers(cfg), caches):
        x, c = B.block_decode(p, cfg, mixer, x, c)
        new.append(c)
    return _logits(params, x), new
