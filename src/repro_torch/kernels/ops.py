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
