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
from repro_torch.core.conv_api import get_conv_backend
from repro_torch.models import blocks as B
from repro_torch.models.layers import apply_norm, embed, init_embedding, init_norm
from repro_torch.models.mixer_api import DEFAULT_CONTEXT, ApplyContext, get_mixer


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
    caches).  ``compute_dtype`` defaults to the cache dtype.  A long-conv
    backend that does not take the prompt's length on this device raises
    here, before any work."""
    ctx = ctx or DEFAULT_CONTEXT
    L = tokens.shape[-1]
    if any(get_mixer(m).uses_conv_backend for m in set(layer_mixers(cfg))):
        get_conv_backend(ctx.conv_backend_for(L)).validate_len(L, tokens.device)
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
    compute_dtype=torch.bfloat16, active: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, List[Any]]:
    """One decode step: token_t (B,) -> (logits (B, V) fp32, new caches).

    The mixers update the large cache tensors in place (the Hyena operand
    history gains one row per step), so the caches passed in are consumed:
    use the returned list from here on.  With ``active`` ((B,) bool, the
    slot-masked step of continuous batching), every per-slot cache row
    where it is False keeps its bytes (scheduler invariant I3)."""
    x = embed(params["embed"], token_t, dtype=compute_dtype)  # (B, D)
    new = []
    for p, mixer, c in zip(params["blocks"], layer_mixers(cfg), caches):
        x, c = B.block_decode(p, cfg, mixer, x, c, active)
        new.append(c)
    if active is not None:
        new = mask_slots(cfg, new, caches, active)
    return _logits(params, x), new


# ----------------------------------------------------- cache slot pooling
#
# Continuous-batching serving (repro_torch.serve.engine.ServeEngine) keeps
# ONE pooled cache list whose batch dim is a fixed pool of request slots.
# These lift the per-mixer slot contract (TokenMixer.cache_slot_axes et al.)
# over the LM's caches.  JAX stacks the caches of each pattern position for
# lax.scan and shifts their slot axes by one; the port keeps a flat list of
# per-layer caches, so the mixers' axes apply unshifted.  Insert and reset
# write the pool in place.


def _mixers(cfg: ModelConfig):
    from repro_torch.models.mixer_api import get_mixer

    for name in layer_mixers(cfg):
        m = get_mixer(name)
        yield m, m.make_config(cfg)


def cache_slot_axes(cfg: ModelConfig, caches: List[Any]) -> List[Dict[str, int]]:
    """Slot axis per leaf of every layer's cache; -1 = shared across slots
    (e.g. hyena's decode filter taps)."""
    out = []
    for (m, mc), cache in zip(_mixers(cfg), caches):
        spec = m.cache_slot_axes(mc)
        out.append({k: spec.get(k, 0) for k in cache})
    return out


def make_slot_pool(cfg: ModelConfig, one_cache: List[Any], n_slots: int) -> List[Any]:
    """An ``n_slots``-wide zeroed pool shaped like a single-request cache
    (the first prefill's, batch 1); shared leaves keep one copy."""
    pool = []
    for axes, cache in zip(cache_slot_axes(cfg, one_cache), one_cache):
        layer = {}
        for k, leaf in cache.items():
            if axes[k] < 0:
                layer[k] = leaf
            else:
                shape = list(leaf.shape)
                shape[axes[k]] = n_slots
                layer[k] = leaf.new_zeros(shape)
        pool.append(layer)
    return pool


def slot_insert(cfg: ModelConfig, caches: List[Any], slot: int, one: List[Any]) -> List[Any]:
    """Copy a batch-1 cache (a fresh prefill's) into ``slot`` of the pool."""
    return [m.cache_insert(mc, c, slot, o) for (m, mc), c, o in zip(_mixers(cfg), caches, one)]


def slot_reset(cfg: ModelConfig, caches: List[Any], slot: int) -> List[Any]:
    """Zero one slot across every per-slot leaf, so an evicted request's
    state cannot leak into the slot's next occupant."""
    return [m.cache_reset(mc, c, slot) for (m, mc), c in zip(_mixers(cfg), caches)]


def mask_slots(cfg: ModelConfig, new_caches: List[Any], old_caches: List[Any],
               active: torch.Tensor) -> List[Any]:
    """Slot-masked cache update: keep ``new`` where ``active`` (bool (S,)),
    ``old`` elsewhere, so free slots hold exactly their reset state.  A leaf
    the step updated in place is the same tensor in both lists; the step
    kept its inactive rows itself."""
    return [
        m.cache_mask(mc, n, o, active)
        for (m, mc), n, o in zip(_mixers(cfg), new_caches, old_caches)
    ]
