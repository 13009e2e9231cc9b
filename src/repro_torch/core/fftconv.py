"""Causal long convolution via FFT (counterpart of ``repro/core/fftconv.py``).

The aperiodic causal convolution ``y_t = Σ_{n≤t} h_{t-n} u_n`` is evaluated
by zero-padding input and filter to ``next_fast_len(2L - 1)`` points and
multiplying in the frequency domain.  The FFT runs in fp32; inputs and
outputs keep their dtype.

The optional ``gate`` fuses the Hyena recurrence's gate ``xⁿ ⊙ conv(v)``
into the epilogue in the order of ``_fused_epilogue``: skip-add in fp32,
downcast, then the gate multiply in the output dtype, so the fused result
equals ``gate * conv(u)`` bit for bit (DESIGN.md §7).

Layouts: activations are channel-last ``(B, L, D)``; filters ``(D, L)``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def next_fast_len(n: int) -> int:
    """Smallest 5-smooth (2^a·3^b·5^c) integer >= n."""
    if n <= 1:
        return 1
    best = 1 << (n - 1).bit_length()  # next power of two is always valid
    f5 = 1
    while f5 < best:
        f35 = f5
        while f35 < best:
            f = f35
            while f < n:
                f *= 2
            if f < best:
                best = f
            f35 *= 3
        f5 *= 5
    return best


def _fused_epilogue(y, u32, skip, gate, dtype):
    """y (+ skip·u) in fp32, downcast, then (· gate) in the output dtype."""
    if skip is not None:
        y = y + u32 * skip.float()[None, None, :]
    y = y.to(dtype)
    if gate is not None:
        y = y * gate.to(dtype)
    return y


def fft_causal_conv(
    u: torch.Tensor,  # (B, L, D)
    h: torch.Tensor,  # (D, L)
    skip: Optional[torch.Tensor] = None,  # (D,) residual gain: y += skip * u
    gate: Optional[torch.Tensor] = None,  # (B, L, D) elementwise output gate
) -> torch.Tensor:
    """Depthwise causal convolution of every channel with its own length-L
    filter, via real FFT on ``next_fast_len(2L - 1)`` points."""
    B, L, D = u.shape
    if tuple(h.shape) != (D, L):
        raise ValueError(f"h has shape {tuple(h.shape)}, expected {(D, L)}")
    n = next_fast_len(2 * L - 1)
    u32 = u.float()
    U = torch.fft.rfft(u32, n=n, dim=1)  # (B, F, D)
    H = torch.fft.rfft(h.float(), n=n, dim=1).T  # (F, D)
    y = torch.fft.irfft(U * H[None], n=n, dim=1)[:, :L, :]
    return _fused_epilogue(y, u32, skip, gate, u.dtype)


def direct_causal_conv(
    u: torch.Tensor,  # (B, L, D)
    h: torch.Tensor,  # (D, L)
    skip: Optional[torch.Tensor] = None,
    gate: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """O(L²) reference: the materialized lower-triangular Toeplitz matmul."""
    B, L, D = u.shape
    t = torch.arange(L, device=u.device)
    idx = t[:, None] - t[None, :]  # h index; negative => acausal
    S = torch.where(
        (idx >= 0)[None], h.float()[:, idx.clamp(0, L - 1)], 0.0
    )  # (D, L, L)
    u32 = u.float()
    y = torch.einsum("dij,bjd->bid", S, u32)
    return _fused_epilogue(y, u32, skip, gate, u.dtype)


def short_causal_conv(
    u: torch.Tensor,  # (B, L, D)
    w: torch.Tensor,  # (D, K) short explicit filter
    bias: Optional[torch.Tensor] = None,  # (D,)
) -> torch.Tensor:
    """Depthwise causal FIR ``y_t = Σ_{k<K} w_k · u_{t-k}`` as K shifted
    adds in fp32, cast back to the input dtype."""
    L = u.shape[1]
    K = w.shape[1]
    u32 = u.float()
    y = torch.zeros_like(u32)
    for k in range(K):
        shifted = u32 if k == 0 else F.pad(u32, (0, 0, k, 0))[:, :L]
        y = y + shifted * w[:, k].float()[None, None, :]
    if bias is not None:
        y = y + bias.float()[None, None, :]
    return y.to(u.dtype)
