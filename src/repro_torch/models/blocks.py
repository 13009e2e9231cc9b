"""Transformer-family block: RMSNorm → token mixer → residual, RMSNorm →
channel MLP of kind ``cfg.mlp`` → residual (counterpart of ``repro/models/blocks.py``).  Every mixer
operation goes through the ``mixer_api`` registry; this module names no
mixer."""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import apply_mlp, apply_norm, init_mlp, init_norm
from repro_torch.models.mixer_api import DEFAULT_CONTEXT, ApplyContext, get_mixer


def init_block(cfg: ModelConfig, mixer: str, gen: torch.Generator, device) -> Dict[str, Any]:
    m = get_mixer(mixer)
    p: Dict[str, Any] = {
        "norm1": init_norm(cfg.d_model, device),
        "mixer": m.init(m.make_config(cfg), gen, device),
    }
    if cfg.d_ff > 0:
        p["norm2"] = init_norm(cfg.d_model, device)
        p["mlp"] = init_mlp(cfg.d_model, cfg.d_ff, gen, device, cfg.mlp)
    return p


def init_block_cache(cfg: ModelConfig, mixer: str, batch: int, max_len: int,
                     dtype, device):
    m = get_mixer(mixer)
    return m.init_cache(m.make_config(cfg), batch, max_len, dtype, device)


def _channel(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.d_ff == 0:
        return x
    return x + apply_mlp(params["mlp"], apply_norm(params["norm2"], x), cfg.mlp)


def block_prefill(
    params, cfg: ModelConfig, mixer: str, x: torch.Tensor, max_len: int,
    dtype=torch.bfloat16, ctx: Optional[ApplyContext] = None,
) -> Tuple[torch.Tensor, Any]:
    """Full-sequence forward that also returns a populated decode cache."""
    ctx = ctx or DEFAULT_CONTEXT
    m = get_mixer(mixer)
    h = apply_norm(params["norm1"], x)
    h, cache = m.prefill(params["mixer"], m.make_config(cfg), h, max_len, dtype, ctx)
    return _channel(params, cfg, x + h), cache


def block_decode(
    params, cfg: ModelConfig, mixer: str, x_t: torch.Tensor, cache, active=None
) -> Tuple[torch.Tensor, Any]:
    m = get_mixer(mixer)
    h = apply_norm(params["norm1"], x_t)
    h, cache = m.decode_step(params["mixer"], m.make_config(cfg), h, cache, active)
    return _channel(params, cfg, x_t + h), cache
