"""Shared layers: RMSNorm, the channel-MLP kinds, the embedding and RoPE
(counterpart of ``repro/models/layers.py``; LayerNorm is not ported and
``configs.base.check_supported`` refuses it).  The norm and RoPE compute
in fp32 and cast back; dense layers cast their weights to the activation
dtype, as in JAX."""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F


def init_norm(d: int, device) -> Dict[str, Any]:
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


MLP_KINDS = ("swiglu", "geglu", "gelu", "squared_relu")


def init_mlp(d_model: int, d_ff: int, gen: torch.Generator, device, kind: str = "swiglu"):
    """The gated kinds (``swiglu``, ``geglu``) carry ``up``, ``gate`` and
    ``down``; ``gelu`` and ``squared_relu`` are the plain 2-layer MLP."""
    p = {"up": init_dense(d_model, d_ff, gen, device)}
    if kind in ("swiglu", "geglu"):
        p["gate"] = init_dense(d_model, d_ff, gen, device)
    p["down"] = init_dense(d_ff, d_model, gen, device)
    return p


def apply_mlp(params, x: torch.Tensor, kind: str = "swiglu") -> torch.Tensor:
    """``jax.nn.gelu`` is the tanh approximation; ``squared_relu`` is
    Nemotron-4's (Primer) relu(x)²."""
    if kind == "swiglu":
        h = F.silu(dense(params["gate"], x)) * dense(params["up"], x)
    elif kind == "geglu":
        h = F.gelu(dense(params["gate"], x), approximate="tanh") * dense(params["up"], x)
    elif kind == "gelu":
        h = F.gelu(dense(params["up"], x), approximate="tanh")
    elif kind == "squared_relu":
        h = torch.square(F.relu(dense(params["up"], x)))
    else:
        raise ValueError(f"unknown mlp kind {kind!r}; have {MLP_KINDS}")
    return dense(params["down"], h)


def init_embedding(vocab: int, d_model: int, gen: torch.Generator, device):
    return {"table": 0.02 * torch.randn(vocab, d_model, generator=gen, device=device)}


def embed(params, tokens: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    return params["table"].to(dtype)[tokens]



def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    """``1 / theta^(2i/Dh)`` for i < Dh/2, fp32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """Split-half rotary embedding of x (B, L, H, Dh) at ``positions`` (L,)
    or (B, L), computed in fp32 and cast back to x's dtype."""
    B, L, H, Dh = x.shape
    freqs = rope_freqs(Dh, theta, x.device)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs  # (B, L, Dh/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
