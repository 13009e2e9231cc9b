"""Public wrappers of the port's kernels (counterpart of
``repro/kernels/ops.py``).

Each wrapper runs the plain PyTorch version on CPU tensors and launches
the hand-written CUDA kernel on CUDA tensors, which raises on what it does
not take; nothing falls back from the card to the plain version.  The port
keeps no autotune plans: tile sizes are the callers' arguments.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import toeplitz_conv as _tc


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
