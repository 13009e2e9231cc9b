"""Shared layers: RMSNorm, the GELU channel MLP and the embedding
(counterpart of ``repro/models/layers.py``, for the kinds the Hyena LMs
use; ``configs.base.check_supported`` refuses the others).  The norm
computes in fp32 and casts back; dense layers cast their weights to the
activation dtype, as in JAX."""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F


def init_norm(d: int, device="cpu") -> Dict[str, Any]:
    return {"g": torch.zeros(d, device=device)}


def apply_norm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm ``x·rsqrt(mean(x²)+eps)·(1+g)`` in fp32, where ``1+g``
    rounds in g's dtype first (bf16 under the serving policy, as in JAX)."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps) * (1.0 + params["g"])
    return y.to(x.dtype)


def init_dense(d_in: int, d_out: int, gen: torch.Generator, device, bias=False):
    p = {"w": torch.randn(d_in, d_out, generator=gen, device=device) / math.sqrt(d_in)}
    if bias:
        p["b"] = torch.zeros(d_out, device=device)
    return p


def dense(params, x: torch.Tensor) -> torch.Tensor:
    y = x @ params["w"].to(x.dtype)
    if "b" in params:
        y = y + params["b"].to(x.dtype)
    return y


def init_mlp(d_model: int, d_ff: int, gen: torch.Generator, device):
    return {
        "up": init_dense(d_model, d_ff, gen, device),
        "down": init_dense(d_ff, d_model, gen, device),
    }


def apply_mlp(params, x: torch.Tensor) -> torch.Tensor:
    """The 2-layer GELU MLP; ``jax.nn.gelu`` is the tanh approximation."""
    h = F.gelu(dense(params["up"], x), approximate="tanh")
    return dense(params["down"], h)


def init_embedding(vocab: int, d_model: int, gen: torch.Generator, device):
    return {"table": 0.02 * torch.randn(vocab, d_model, generator=gen, device=device)}


def embed(params, tokens: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    return params["table"].to(dtype)[tokens]

