"""Two-level (inner R / outer S) FFT causal conv: a hand-written CUDA
kernel for Hopper and its plain PyTorch version.

Replaces the Pallas TPU kernel ``repro/kernels/twolevel_fft.py``
(``twolevel_fft_conv``, body ``_twolevel_kernel``).  It computes the gated
causal long conv of the ``blockfft_overlap`` backend on
N = ``next_fast_len(2L-1)`` = R·S points: the inner R-point DFT of the real
input, the twiddle, the outer S-point DFT, the product with the filter
spectrum H, the inverse with the real part taken and the 1/N scale, and the
epilogue of ``_fused_epilogue`` (skip-add in fp32, downcast, then the gate
in the output dtype).  H is computed outside the kernel with the plain
four-step transform and the same (R, S), as the JAX wrapper does.

Kernel (``csrc/twolevel_fft.cu``): one block per (batch row, tile of
``td`` = 1, 2 or 4 channels) holds the padded column in shared memory as
fp32 (re, im), 8·N bytes per channel, and runs every stage on it as direct
DFT sums, each thread one grid position for all channels of the tile,
with the tables read from global memory exactly as ``_dft_mats`` builds
them.  What bounds it on the card: its own fp32 operations on the CUDA
cores (4NR + 8NS FMAs per channel), though at the served shape the
function's least time is set by bytes (an O(N log N) FFT needs fewer
operations than moving u, gate and the output takes); the design keeps
every intermediate in shared memory so the conv output and inputs cross
device memory once, and leaves the tensor cores to a later version.  It takes
L <= 8192 (N <= 16384, 128 KB of shared memory), fp32 or bf16 ``u`` and
``gate``, any (R, S) split and any D, and raises on anything else.

On a CPU tensor the wrapper runs the plain version
(``blockfft_causal_conv`` with the same factors); on a CUDA tensor it
launches the kernel or raises.  ``launch_with_spectrum`` is the launch
alone, given H; ``twolevel_fft_conv.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.blockfft import (
    _dft_mats,
    blockfft_causal_conv,
    filter_spectrum,
    resolve_factors,
)
from repro_torch.core.fftconv import next_fast_len

MAX_N = 16384  # L <= 8192
STAGED = 16  # must equal STAGED in csrc/twolevel_fft.cu
MAX_THREADS = 1024
TILE_SMEM_BYTES = 64 * 1024  # the channel tile shrinks until 8·N·td fits this
_KERNEL_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def launch_shape(N: int, D: int) -> Tuple[int, int, int]:
    """(channels per block ``td``, threads per block, shared bytes) for a
    length-N column: 4 channels (fewer when D is smaller) halved until
    8·N·td fits 64 KB, and enough threads that each stages at most
    STAGED position-channel outputs (STAGED / td positions)."""
    td = 4 if D >= 4 else 2 if D >= 2 else 1
    while td > 1 and 8 * N * td > TILE_SMEM_BYTES:
        td //= 2
    positions = STAGED // td
    least = -(-N // positions)
    threads = min(MAX_THREADS, max(least, min(256, N)))
    threads = -(-threads // 32) * 32
    if N > positions * threads:
        raise ValueError(f"N={N} exceeds the kernel's {MAX_N}-point limit")
    return td, threads, 8 * N * td


@functools.lru_cache(maxsize=32)
def _device_tables(N: int, factors: Tuple[int, int], device: str):
    """fp32 (re, im) planes of FR, TW and FS on ``device``."""
    R, S, FR, FS, TW = _dft_mats(N, factors)
    # the kernel's inverse DFTs read FR[k, r] and FS[q, s] for FS[s, q]
    if not (np.array_equal(FR, FR.T) and np.array_equal(FS, FS.T)):
        raise ValueError(f"DFT tables for {factors} are not symmetric")
    planes = []
    for m in (FR, TW, FS):
        planes.append(torch.from_numpy(np.ascontiguousarray(m.real)).to(device))
        planes.append(torch.from_numpy(np.ascontiguousarray(m.imag)).to(device))
    return tuple(planes)


@functools.lru_cache(maxsize=None)
def _kernel(dtype_tag: str):
    from repro_torch.kernels.build import load

    lib = load("twolevel_fft")
    fn = getattr(lib, f"twolevel_fft_conv_{dtype_tag}")
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.twolevel_error_string.argtypes = [ctypes.c_int]
    lib.twolevel_error_string.restype = ctypes.c_char_p
    lib.twolevel_staged.restype = ctypes.c_int
    if lib.twolevel_staged() != STAGED:
        raise RuntimeError("csrc/twolevel_fft.cu disagrees on STAGED")
    return lib, fn


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def twolevel_fft_conv(
    u: torch.Tensor,  # (B, L, D)
    h: torch.Tensor,  # (D, L)
    skip: Optional[torch.Tensor] = None,  # (D,)
    gate: Optional[torch.Tensor] = None,  # (B, L, D)
    *,
    factors: Optional[Tuple[int, int]] = None,  # (R, S) split of N
) -> torch.Tensor:
    """Gated causal long conv (ConvBackend contract) through the CUDA
    kernel for CUDA tensors, its plain version for CPU tensors."""
    B, L, D = u.shape
    if tuple(h.shape) != (D, L):
        raise ValueError(f"h has shape {tuple(h.shape)}, expected {(D, L)}")
    if u.device.type == "cpu":
        return blockfft_causal_conv(u, h, skip, gate, factors=factors)
    if u.device.type != "cuda":
        raise ValueError(f"twolevel_fft_conv takes CPU or CUDA tensors, got {u.device}")
    if h.device != u.device:
        raise ValueError(f"h is on {h.device}, u on {u.device}")
    N = next_fast_len(2 * L - 1)
    if N > MAX_N:
        raise ValueError(f"kernel takes L <= {MAX_N // 2}, got L={L}")
    R, S = resolve_factors(N, factors)
    H = filter_spectrum(h, N, (R, S))  # (R, S, D) complex64
    return launch_with_spectrum(u, H, skip, gate)


def launch_with_spectrum(
    u: torch.Tensor,  # (B, L, D) on a CUDA device
    H: torch.Tensor,  # (R, S, D) complex64 filter spectrum, R·S = N
    skip: Optional[torch.Tensor] = None,
    gate: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The kernel alone, given the filter spectrum that
    :func:`twolevel_fft_conv` computes; it counts its launches on
    ``twolevel_fft_conv.launches``."""
    B, L, D = u.shape
    R, S = H.shape[0], H.shape[1]
    N = R * S
    if u.device.type != "cuda":
        raise ValueError(f"the kernel takes CUDA tensors, got {u.device}")
    if N != next_fast_len(2 * L - 1) or tuple(H.shape) != (R, S, D) or H.dtype != torch.complex64:
        raise ValueError(
            f"H is {H.dtype} {tuple(H.shape)}, not a complex64 spectrum for u {tuple(u.shape)}"
        )
    if u.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"kernel takes fp32 or bf16 u, got {u.dtype}")
    if gate is not None and (gate.dtype != u.dtype or gate.shape != u.shape):
        raise ValueError(
            f"gate must match u: got {gate.dtype} {tuple(gate.shape)}, "
            f"u is {u.dtype} {tuple(u.shape)}"
        )
    if skip is not None and tuple(skip.shape) != (D,):
        raise ValueError(f"skip has shape {tuple(skip.shape)}, expected {(D,)}")
    for name, t in (("H", H), ("skip", skip), ("gate", gate)):
        if t is not None and t.device != u.device:
            raise ValueError(f"{name} is on {t.device}, u on {u.device}")
    out = torch.empty_like(u, memory_format=torch.contiguous_format)
    if out.numel() == 0:
        return out
    td, threads, smem = launch_shape(N, D)
    u = u.contiguous()
    gate = None if gate is None else gate.contiguous()
    skip32 = None if skip is None else skip.float().contiguous()
    H = H.contiguous()  # read as interleaved (re, im) fp32 pairs
    tables = _device_tables(N, (R, S), str(u.device))
    lib, fn = _kernel(_KERNEL_DTYPES[u.dtype])
    stream = torch.cuda.current_stream(u.device).cuda_stream
    err = fn(
        u.data_ptr(), _ptr(gate), _ptr(skip32), H.data_ptr(),
        *(t.data_ptr() for t in tables), out.data_ptr(),
        B, L, D, R, S, td, threads, smem, stream,
    )
    if err != 0:
        raise RuntimeError(
            f"twolevel_fft_conv launch failed: "
            f"{lib.twolevel_error_string(err).decode()} (B={B}, L={L}, D={D}, "
            f"R={R}, S={S}, td={td}, threads={threads}, smem={smem})"
        )
    twolevel_fft_conv.launches += 1
    return out


twolevel_fft_conv.launches = 0
