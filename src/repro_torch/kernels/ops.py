"""Public wrappers of the port's kernels (counterpart of
``repro/kernels/ops.py``).

Each wrapper runs the plain PyTorch version on CPU tensors and launches
the hand-written CUDA kernel on CUDA tensors, which raises on what it does
not take; nothing falls back from the card to the plain version.  The port
keeps no autotune plans: the conv and attention tile sizes are the callers'
arguments, and the short conv and RMSNorm kernels pick their own launch
shape.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import rmsnorm as _rn
from repro_torch.kernels import short_conv as _sc
from repro_torch.kernels import toeplitz_conv as _tc


def short_conv_gate(
    u: torch.Tensor,  # (B, L, D)
    w: torch.Tensor,  # (D, K)
    gate: Optional[torch.Tensor] = None,  # (B, L, D)
) -> torch.Tensor:
    """Depthwise causal FIR ``y_t = Σ_k w_k·u_{t−k}`` in fp32, times the
    gate in fp32, then cast to u's dtype."""
    fn = _sc.short_conv_gate_plain if u.device.type == "cpu" else _sc.short_conv_gate
    return fn(u, w, gate)


def toeplitz_conv(
    u: torch.Tensor,  # (B, L, D)
    h: torch.Tensor,  # (D, L)
    skip: Optional[torch.Tensor] = None,  # (D,)
    gate: Optional[torch.Tensor] = None,  # (B, L, D)
    *,
    chunk: int = 128,
    n_chunk_diags: Optional[int] = None,
) -> torch.Tensor:
    """Chunked block-Toeplitz causal conv (ConvBackend contract), banded to
    ``n_chunk_diags`` chunk diagonals when given."""
    fn = _tc.toeplitz_conv_plain if u.device.type == "cpu" else _tc.toeplitz_conv
    return fn(u, h, skip, gate, chunk=chunk, n_chunk_diags=n_chunk_diags)


def flash_attention(
    q: torch.Tensor,  # (B, H, Lq, Dh)
    k: torch.Tensor,  # (B, Hkv, Lk, Dh)
    v: torch.Tensor,  # (B, Hkv, Lk, Dh)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    q_offset: Optional[int] = None,
) -> torch.Tensor:
    """Causal / windowed GQA softmax attention, query row i at position
    ``q_offset + i`` (default ``Lk − Lq``); a row that sees no key gives 0."""
    fn = _fa.flash_attention_plain if q.device.type == "cpu" else _fa.flash_attention
    return fn(q, k, v, causal=causal, window=window, scale=scale, q_offset=q_offset)


def rmsnorm(x: torch.Tensor, g: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """``x·rsqrt(mean(x²) + eps)·(1 + g)`` over the last dim in fp32, with g
    cast to fp32 before ``1 + g``, then cast to x's dtype."""
    fn = _rn.rmsnorm_plain if x.device.type == "cpu" else _rn.rmsnorm
    return fn(x, g, eps=eps)
