"""Implicit Hyena filter parameterization (counterpart of
``repro/core/filters.py``; paper §3.3, Alg. 2, App. D.3).

A filter bank ``h ∈ R^{order × D × L}`` comes from a positional basis
``[t, cos 2πkt, sin 2πkt]`` on ``t = linspace(0, 1, L)``, a shallow FFN
with ``sin(ω·)`` activations (ω = 14), and the exponential-decay window
``exp(-rate·t·8) + 0.1·sigmoid(bias)``; each filter is then l1-normalized
over the grid (+1e-8).

Mixed dtypes follow JAX's promotion: the fp32 basis times bf16 weights
computes in fp32, while bf16-only terms (``exp(decay_log_rate)``,
``0.1·sigmoid(window_bias)``) round in bf16 before they meet fp32.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class FilterConfig:
    d_model: int
    order: int
    ffn_width: int = 64
    ffn_depth: int = 4  # number of linear layers (>= 2)
    pos_dim: int = 65  # 2K + 1
    sine_freq: float = 14.0
    decay_fast: float = 0.3
    decay_slow: float = 1.5
    normalized: bool = True
    max_support: int = 0  # >0: hard-truncate taps at this lag


def _linspace01(L: int, device) -> torch.Tensor:
    """``jnp.linspace(0, 1, L)`` bit for bit: ``i · fp32(1/(L-1))`` (XLA
    turns the division by a constant into that product) with the endpoint
    set to exactly 1; torch.linspace rounds differently."""
    if L == 1:
        return torch.zeros(1, device=device)
    step = torch.tensor(np.float32(1) / np.float32(L - 1), device=device)
    t = torch.arange(L - 1, dtype=torch.float32, device=device) * step
    return torch.cat([t, torch.ones(1, device=device)])


def positional_encoding(L: int, pos_dim: int, device="cpu") -> torch.Tensor:
    """(L, pos_dim) truncated complex-exponential basis. pos_dim = 2K + 1."""
    K = (pos_dim - 1) // 2
    t = _linspace01(L, device)[:, None]  # (L, 1)
    if K == 0:
        return t
    k = torch.arange(K, dtype=torch.float32, device=device)[None, :]
    ang = 2.0 * math.pi * k * t  # (L, K)
    return torch.cat([t, torch.cos(ang), torch.sin(ang)], dim=-1)


def init_hyena_filter(cfg: FilterConfig, gen: torch.Generator, device) -> Dict[str, Any]:
    """Params for the implicit filter FFN + window (same shapes and scales
    as the JAX init; the random draws differ)."""
    if cfg.ffn_depth < 2:
        raise ValueError(f"ffn_depth must be >= 2, got {cfg.ffn_depth}")
    dims = [cfg.pos_dim] + [cfg.ffn_width] * (cfg.ffn_depth - 1) + [
        cfg.order * cfg.d_model
    ]
    layers = []
    for i in range(len(dims) - 1):
        w = torch.randn(dims[i], dims[i + 1], generator=gen, device=device)
        layers.append({
            "w": w / math.sqrt(dims[i]),
            "b": torch.zeros(dims[i + 1], device=device),
        })
    n_ch = cfg.order * cfg.d_model
    return {
        "ffn": layers,
        "decay_log_rate": torch.linspace(
            math.log(cfg.decay_fast), math.log(cfg.decay_slow), n_ch,
            device=device,
        ),
        "window_bias": torch.zeros(n_ch, device=device),
        "skip": torch.ones(n_ch, device=device),
    }


def _scale(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x * c`` with ``c`` rounded to x's dtype first, as JAX does with a
    weakly typed Python scalar (torch would multiply by the fp32 value)."""
    return x * torch.tensor(c, dtype=x.dtype, device=x.device)


def evaluate_filters(params: Dict[str, Any], cfg: FilterConfig, L: int) -> torch.Tensor:
    """h: (order, d_model, L) float32 — Algorithm 2."""
    device = params["skip"].device
    h = positional_encoding(L, cfg.pos_dim, device)  # (L, De) fp32
    n_layers = len(params["ffn"])
    for i, layer in enumerate(params["ffn"]):
        h = h @ layer["w"].float() + layer["b"].float()
        if i < n_layers - 1:
            h = torch.sin(cfg.sine_freq * h)
    t = torch.arange(L, dtype=torch.float32, device=device)[:, None] / max(L, 1)
    rate = torch.exp(params["decay_log_rate"])[None, :]  # (1, C)
    window = torch.exp(-rate * t * 8.0)
    window = window + _scale(torch.sigmoid(params["window_bias"]), 0.1)[None, :]
    h = h * window  # (L, C)
    if cfg.max_support:
        keep = torch.arange(L, device=device) < cfg.max_support
        h = torch.where(keep[:, None], h, 0.0)
    h = h.reshape(L, cfg.order, cfg.d_model).permute(1, 2, 0)  # (order, D, L)
    if cfg.normalized:
        h = h / (h.abs().sum(dim=-1, keepdim=True) + 1e-8)
    return h.contiguous()


def filter_skip(params: Dict[str, Any], cfg: FilterConfig) -> torch.Tensor:
    """Per-(order, D) skip gain, shape (order, D)."""
    return params["skip"].reshape(cfg.order, cfg.d_model)
