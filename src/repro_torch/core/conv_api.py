"""ConvBackend registry: the single dispatch point for Hyena's long causal
convolution (counterpart of ``repro/core/conv_api.py``).

Every backend implements ``fn(u, h, skip, gate=None) -> y`` with
``u: (B, L, D)``, ``h: (D, L)``, ``skip: (D,) | None`` and
``gate: (B, L, D) | None``.  A backend with ``supports_gate`` fuses the
gate in the §7 order (skip in fp32, downcast, gate); the others get it as a
separate multiply, with the same result.

Built-ins: ``fft`` (the default, as in JAX), ``fft_local``, ``direct``
(the O(L²) oracle), ``blockfft`` (the plain four-step transform),
``blockfft_overlap`` (the two-level FFT conv kernel of
``repro_torch.kernels.twolevel_fft``) and ``toeplitz`` (the chunked
block-Toeplitz kernel of ``repro_torch.kernels.toeplitz_conv``, through
``repro_torch.kernels.ops``).  The JAX ``fft_sp`` backend (context
parallelism across a mesh) is not ported yet.  Resolution — including the
``REPRO_CONV_BACKEND`` environment override — goes through
:func:`resolve_conv_backend`.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, Optional

import torch

from repro_torch.kernels.twolevel_fft import MAX_N as _TWOLEVEL_MAX_N

ENV_VAR = "REPRO_CONV_BACKEND"
DEFAULT_BACKEND = "fft"


@dataclasses.dataclass(frozen=True)
class ConvBackend:
    """A registered long-conv implementation with capability flags."""

    name: str
    fn: Callable
    description: str = ""
    max_len: int = 0  # 0 = unconstrained; else largest supported L
    supports_gate: bool = False  # fn fuses the elementwise output gate
    # 0 = as on the CPU; else the largest L that the backend's CUDA kernel
    # takes (on CPU tensors the backend runs its plain version, any L)
    cuda_max_len: int = 0

    def validate_len(self, L: int, device=None) -> None:
        """Raise unless the backend takes length L; on a CUDA ``device``
        also the range of its kernel, so that a model refuses the length
        before any work instead of failing mid-forward."""
        limit, where = self.max_len, ""
        if self.cuda_max_len and device is not None and torch.device(device).type == "cuda":
            if not limit or self.cuda_max_len < limit:
                limit, where = self.cuda_max_len, " on CUDA"
        if limit and L > limit:
            raise ValueError(
                f"conv backend '{self.name}' supports L <= {limit}{where}, "
                f"got {L}"
            )

    def __call__(self, u, h, skip=None, gate=None):
        if gate is None:
            return self.fn(u, h, skip)
        if self.supports_gate:
            return self.fn(u, h, skip, gate)
        return (gate * self.fn(u, h, skip).to(gate.dtype)).to(u.dtype)


_BACKENDS: Dict[str, ConvBackend] = {}


def register_conv_backend(backend: ConvBackend) -> ConvBackend:
    """Duplicate names raise unless the registration is identical."""
    prev = _BACKENDS.get(backend.name)
    if prev is not None and prev != backend:
        raise ValueError(f"conv backend '{backend.name}' already registered")
    _BACKENDS[backend.name] = backend
    return backend


def conv_backend_names() -> tuple:
    return tuple(sorted(_BACKENDS))


def get_conv_backend(name: Optional[str]) -> ConvBackend:
    """Look up a backend; ``None`` means the registry default."""
    name = name or DEFAULT_BACKEND
    if name not in _BACKENDS:
        raise ValueError(
            f"unknown conv backend '{name}'; registered: "
            f"{list(conv_backend_names())}"
        )
    return _BACKENDS[name]


def resolve_conv_backend(
    override: Optional[str] = None, *, default: str = DEFAULT_BACKEND
) -> str:
    """Priority: explicit ``override`` > ``$REPRO_CONV_BACKEND`` >
    ``default``; unknown names raise, naming their source."""
    env = os.environ.get(ENV_VAR)
    if override:
        name, source = override, "override"
    elif env:
        name, source = env, f"${ENV_VAR}"
    else:
        name, source = default, "default"
    if name not in _BACKENDS:
        raise ValueError(
            f"unknown conv backend '{name}' (from {source}); registered "
            f"backends: {sorted(_BACKENDS)}"
        )
    return name


# --------------------------------------------------------------- built-ins

def _fft_local(u, h, skip=None, gate=None):
    from repro_torch.core.fftconv import fft_causal_conv

    return fft_causal_conv(u, h, skip, gate)


def _direct(u, h, skip=None, gate=None):
    from repro_torch.core.fftconv import direct_causal_conv

    return direct_causal_conv(u, h, skip, gate)


def _blockfft(u, h, skip=None, gate=None):
    from repro_torch.core.blockfft import blockfft_causal_conv

    return blockfft_causal_conv(u, h, skip, gate)


def _blockfft_overlap(u, h, skip=None, gate=None):
    from repro_torch.kernels.twolevel_fft import twolevel_fft_conv

    return twolevel_fft_conv(u, h, skip, gate)


def _toeplitz(u, h, skip=None, gate=None):
    from repro_torch.kernels import ops

    return ops.toeplitz_conv(u, h, skip, gate)


register_conv_backend(ConvBackend(
    name="fft", fn=_fft_local, supports_gate=True,
    description="O(L log L) torch.fft real FFT on fast-composite >= 2L-1 "
    "points; gate+skip fused into the post-iFFT elementwise pass (the JAX "
    "backend's single-device path).",
))
register_conv_backend(ConvBackend(
    name="fft_local", fn=_fft_local, supports_gate=True,
    description="single-device torch.fft path, the same function as 'fft'.",
))
register_conv_backend(ConvBackend(
    name="direct", fn=_direct, max_len=4096, supports_gate=True,
    description="O(L²) materialized lower-triangular Toeplitz matmul — "
    "the correctness oracle for tiny L.",
))
register_conv_backend(ConvBackend(
    name="blockfft", fn=_blockfft, supports_gate=True,
    description="four-step (Bailey) FFT with the small DFTs as dense "
    "complex matmuls — the plain version of the two-level kernel.",
))
register_conv_backend(ConvBackend(
    name="blockfft_overlap", fn=_blockfft_overlap,
    supports_gate=True, cuda_max_len=_TWOLEVEL_MAX_N // 2,
    description="two-level (inner R / outer S) FFT conv as one hand-written "
    "CUDA kernel per call (kernels/twolevel_fft.py), within the kernel's "
    "range on CUDA tensors; on CPU tensors its plain four-step version, "
    "any L.",
))
register_conv_backend(ConvBackend(
    name="toeplitz", fn=_toeplitz, supports_gate=True,
    description="chunked block-Toeplitz causal conv (C = 128) as one "
    "hand-written CUDA kernel per call (kernels/toeplitz_conv.py); on CPU "
    "tensors its plain chunked version.",
))
