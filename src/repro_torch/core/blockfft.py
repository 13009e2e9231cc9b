"""Block-FFT causal conv: the four-step (Bailey) FFT with the small DFTs
evaluated as dense matmuls (counterpart of ``repro/core/blockfft.py``).

Four-step decomposition, N = R·S (x row-major A[r,s] = x[rS+s]):

    X[k1 + k2·R] = Σ_s W_S^{s k2} [ W_N^{s k1} Σ_r A[r,s] W_R^{r k1} ]

  1. DFT_R over rows      — (R×R) matmul
  2. twiddle W_N^{s·k1}   — elementwise
  3. DFT_S over columns   — (S×S) matmul

This is the plain version of the two-level FFT conv kernel
(``repro_torch.kernels.twolevel_fft``): the kernel computes the same
stages from the same tables.
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.fftconv import next_fast_len


def factor_candidates(N: int, limit: int = 6) -> Tuple[Tuple[int, int], ...]:
    """Valid (R, S) splits of N, nearest-√N first."""
    divs = [r for r in range(1, math.isqrt(N) + 1) if N % r == 0]
    pairs = []
    for r in reversed(divs):
        pairs.append((r, N // r))
        if (N // r, r) != (r, N // r):
            pairs.append((N // r, r))
    return tuple(pairs[:limit])


def _factor(N: int) -> Tuple[int, int]:
    """N = R·S with R preferring the power of two near √N; when N's
    power-of-two part is too small, the largest divisor <= √N (so L=1000
    gives N=2000 = 40·50, and L=100 gives N=200 = 10·20)."""
    R = 1 << max(math.ceil(math.log2(math.sqrt(N))), 0)
    while R <= N and N % R:
        R *= 2
    if R <= N and N % R == 0:
        return R, N // R
    R = max(r for r in range(1, math.isqrt(N) + 1) if N % r == 0)
    return R, N // R


def resolve_factors(N: int, factors: Optional[Tuple[int, int]]) -> Tuple[int, int]:
    """The (R, S) split a caller gets: the default split when ``factors`` is
    None, else ``factors``, which must multiply to ``N``."""
    if factors is None:
        return _factor(N)
    if factors[0] * factors[1] != N:
        raise ValueError(f"factors {tuple(factors)} do not multiply to N={N}")
    return int(factors[0]), int(factors[1])


@functools.lru_cache(maxsize=32)
def _dft_mats(N: int, factors: Optional[Tuple[int, int]] = None):
    """(R, S, FR, FS, TW) as complex64 numpy arrays, built in float64 and
    rounded once, exactly as the JAX package builds them."""
    R, S = _factor(N) if factors is None else factors
    if R * S != N:
        raise ValueError(f"factors {factors} do not multiply to N={N}")
    r = np.arange(R)
    s = np.arange(S)
    FR = np.exp(-2j * np.pi * np.outer(r, r) / R).astype(np.complex64)
    FS = np.exp(-2j * np.pi * np.outer(s, s) / S).astype(np.complex64)
    TW = np.exp(-2j * np.pi * np.outer(r, s) / N).astype(np.complex64)
    return R, S, FR, FS, TW


@functools.lru_cache(maxsize=32)
def dft_tables(N: int, factors: Tuple[int, int], device: str):
    """``_dft_mats`` as complex64 tensors on ``device`` (cached)."""
    R, S, FR, FS, TW = _dft_mats(N, factors)
    to = lambda a: torch.from_numpy(a).to(device)
    return to(FR), to(FS), to(TW)


def _four_step_fft(x: torch.Tensor, N: int, factors: Tuple[int, int]) -> torch.Tensor:
    """x: (B, N, D) real/complex -> spectrum C (B, R, S, D) with
    X[k1 + k2·R] = C[:, k1, k2, :]."""
    R, S = factors
    FR, FS, TW = dft_tables(N, (R, S), str(x.device))
    B, _, D = x.shape
    A = x.reshape(B, R, S, D).to(torch.complex64)
    Bm = torch.einsum("kr,brsd->bksd", FR, A)
    Bm = Bm * TW[None, :, :, None]
    return torch.einsum("bksd,sj->bkjd", Bm, FS)


def _four_step_ifft(C: torch.Tensor, N: int, factors: Tuple[int, int]) -> torch.Tensor:
    """Inverse of ``_four_step_fft`` (same layout); (B, N, D) complex."""
    FR, FS, TW = dft_tables(N, factors, str(C.device))
    Dm = torch.einsum("bkjd,sj->bksd", C, FS.conj())
    Dm = Dm * TW.conj()[None, :, :, None]
    A = torch.einsum("kr,bksd->brsd", FR.conj(), Dm) / N
    return A.reshape(C.shape[0], N, C.shape[-1])


def filter_spectrum(h: torch.Tensor, N: int, factors: Tuple[int, int]) -> torch.Tensor:
    """(D, L) taps -> (R, S, D) complex64 spectrum on the four-step grid."""
    L = h.shape[1]
    hp = F.pad(h.float().T, (0, 0, 0, N - L))[None]  # (1, N, D)
    return _four_step_fft(hp, N, factors)[0]


def blockfft_causal_conv(
    u: torch.Tensor,  # (B, L, D)
    h: torch.Tensor,  # (D, L)
    skip: Optional[torch.Tensor] = None,
    gate: Optional[torch.Tensor] = None,  # (B, L, D)
    *,
    factors: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    B, L, D = u.shape
    N = next_fast_len(2 * L - 1)
    factors = resolve_factors(N, factors)
    u32 = u.float()
    up = F.pad(u32, (0, 0, 0, N - L))
    U = _four_step_fft(up, N, factors)
    H = filter_spectrum(h, N, factors)[None]
    y = _four_step_ifft(U * H, N, factors).real[:, :L, :]
    if skip is not None:
        y = y + u32 * skip.float()[None, None, :]
    # downcast BEFORE the gate: fused == gate * unfused bit for bit
    y = y.to(u.dtype)
    if gate is not None:
        y = y * gate.to(u.dtype)
    return y
