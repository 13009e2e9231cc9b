"""Chunked block-Toeplitz causal long conv: a hand-written CUDA kernel for
Hopper and its plain PyTorch version.

Replaces the Pallas TPU kernel ``repro/kernels/toeplitz_conv.py``
(``toeplitz_conv``, body ``_toeplitz_kernel``) with the function of its
oracle ``repro/kernels/ref.py::toeplitz_conv``.  With C = min(chunk, L) and
the sequence zero-padded to whole chunks, output chunk i adds, for every
chunk diagonal r <= i with r < K, the per-channel C x C Toeplitz product
``T_r[d] @ u_{i-r}[d]`` with ``T_r[a, b] = h[d, rC + a - b]`` (a negative
lag reads 0).  K is the number of chunks (the exact causal conv) or
``n_chunk_diags`` (the banded approximation).  The epilogue is
``_fused_epilogue``'s: skip·u in fp32, downcast, then the gate in the
output dtype.

Kernel (``csrc/toeplitz_conv.cu``): one block per (32-channel tile, output
chunk, batch row) loops over its diagonals, stages u_{i-r} and the 2C-1
taps of each channel in shared memory as fp32, and keeps each thread's 16
output rows in fp32 registers; see the source for the register window.
What bounds it on the card: its own fp32 FMAs on the CUDA cores (C² per
chunk pair, row and channel: 1.02 GFLOP at B=1, L=1024, D=864), while the
function's least time is set by its bytes; the design keeps the loads well
below the FMA count and leaves the tensor cores to a later version, whose
precision must then be chosen (the reference sums in fp32).  It takes
C <= 256, fp32 or bf16 ``u`` and ``gate``, fp32 ``h``, and views whose
last dim is unit-stride; it raises on anything else.

:func:`toeplitz_conv` is the kernel alone (CUDA tensors only) and counts
its launches on ``toeplitz_conv.launches``; :func:`toeplitz_conv_plain` is
the plain version.  ``repro_torch.kernels.ops.toeplitz_conv`` picks one of
them by the tensors' device.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.fftconv import _fused_epilogue

MAX_CHUNK = 256  # must equal MAX_C in csrc/toeplitz_conv.cu
_KERNEL_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def chunking(L: int, chunk: int, n_chunk_diags: Optional[int]) -> Tuple[int, int, int]:
    """(C, n_chunks, K) of a length-L call, as the JAX kernel sets them."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if n_chunk_diags is not None and n_chunk_diags < 1:
        raise ValueError(f"n_chunk_diags must be >= 1, got {n_chunk_diags}")
    C = max(1, min(chunk, L))
    n = -(-L // C)
    K = n if n_chunk_diags is None else min(n_chunk_diags, n)
    return C, n, K


def _check_shapes(u, h, skip, gate) -> None:
    B, L, D = u.shape
    if tuple(h.shape) != (D, L):
        raise ValueError(f"h has shape {tuple(h.shape)}, expected {(D, L)}")
    if skip is not None and tuple(skip.shape) != (D,):
        raise ValueError(f"skip has shape {tuple(skip.shape)}, expected {(D,)}")
    if gate is not None and gate.shape != u.shape:
        raise ValueError(f"gate has shape {tuple(gate.shape)}, expected {tuple(u.shape)}")


def toeplitz_conv_plain(
    u: torch.Tensor,  # (B, L, D)
    h: torch.Tensor,  # (D, L)
    skip: Optional[torch.Tensor] = None,  # (D,)
    gate: Optional[torch.Tensor] = None,  # (B, L, D)
    *,
    chunk: int = 128,
    n_chunk_diags: Optional[int] = None,
) -> torch.Tensor:
    """The kernel's chunked sum in plain PyTorch: per chunk diagonal r, the
    gathered Toeplitz blocks T_r (D, C, C) and one batched product over
    every output chunk i >= r, accumulated in fp32."""
    _check_shapes(u, h, skip, gate)
    B, L, D = u.shape
    if u.numel() == 0:
        return torch.empty_like(u)
    C, n, K = chunking(L, chunk, n_chunk_diags)
    u32 = u.float()
    U = F.pad(u32, (0, 0, 0, n * C - L)).reshape(B, n, C, D)
    # hp[:, C + lag] = h[:, lag]; zero for lag < 0 and past L
    hp = F.pad(h.float(), (C, n * C - L))
    a = torch.arange(C, device=u.device)
    lag = C + a[:, None] - a[None, :]  # (C, C): C + a - b
    Y = torch.zeros(B, n, C, D, dtype=torch.float32, device=u.device)
    for r in range(K):
        T = hp[:, r * C + lag]  # (D, C, C) = h[rC + a - b]
        Y[:, r:] += torch.einsum("dxy,znyd->znxd", T, U[:, : n - r])
    y = Y.reshape(B, n * C, D)[:, :L]
    return _fused_epilogue(y, u32, skip, gate, u.dtype)


@functools.lru_cache(maxsize=None)
def _kernel(dtype_tag: str):
    from repro_torch.kernels.build import load

    lib = load("toeplitz_conv")
    fn = getattr(lib, f"toeplitz_conv_{dtype_tag}")
    fn.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_int64] * 5 + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    lib.toeplitz_error_string.argtypes = [ctypes.c_int]
    lib.toeplitz_error_string.restype = ctypes.c_char_p
    lib.toeplitz_max_chunk.restype = ctypes.c_int
    if lib.toeplitz_max_chunk() != MAX_CHUNK:
        raise RuntimeError("csrc/toeplitz_conv.cu disagrees on MAX_CHUNK")
    return lib, fn


def toeplitz_conv(
    u: torch.Tensor,  # (B, L, D) on a CUDA device
    h: torch.Tensor,  # (D, L) fp32
    skip: Optional[torch.Tensor] = None,  # (D,)
    gate: Optional[torch.Tensor] = None,  # (B, L, D), u's dtype
    *,
    chunk: int = 128,
    n_chunk_diags: Optional[int] = None,
) -> torch.Tensor:
    """The CUDA kernel; raises on what it does not take, and counts its
    launches on ``toeplitz_conv.launches``."""
    _check_shapes(u, h, skip, gate)
    B, L, D = u.shape
    if u.device.type != "cuda":
        raise ValueError(f"the kernel takes CUDA tensors, got {u.device}")
    for name, t in (("h", h), ("skip", skip), ("gate", gate)):
        if t is not None and t.device != u.device:
            raise ValueError(f"{name} is on {t.device}, u on {u.device}")
    if u.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"kernel takes fp32 or bf16 u, got {u.dtype}")
    if gate is not None and gate.dtype != u.dtype:
        raise ValueError(f"gate must be {u.dtype} like u, got {gate.dtype}")
    if h.dtype != torch.float32:
        raise ValueError(f"kernel takes fp32 h, got {h.dtype}")
    for name, t in (("u", u), ("gate", gate), ("h", h)):
        if t is not None and t.shape[-1] > 1 and t.stride(-1) != 1:
            raise ValueError(f"{name} is not contiguous in its last dim: strides {t.stride()}")
    out = torch.empty((B, L, D), dtype=u.dtype, device=u.device)
    if out.numel() == 0:
        return out
    C, _, K = chunking(L, chunk, n_chunk_diags)
    if C > MAX_CHUNK:
        raise ValueError(f"kernel takes chunks of at most {MAX_CHUNK} rows, got {C}")
    skip32 = None if skip is None else skip.float().contiguous()
    lib, fn = _kernel(_KERNEL_DTYPES[u.dtype])
    stream = torch.cuda.current_stream(u.device).cuda_stream
    g_strides = (0, 0) if gate is None else (gate.stride(0), gate.stride(1))
    err = fn(
        u.data_ptr(), h.data_ptr(), None if skip32 is None else skip32.data_ptr(),
        None if gate is None else gate.data_ptr(), out.data_ptr(),
        B, L, D, C, K, u.stride(0), u.stride(1), *g_strides, h.stride(0), stream,
    )
    if err != 0:
        raise RuntimeError(
            f"toeplitz_conv launch failed: {lib.toeplitz_error_string(err).decode()} "
            f"(B={B}, L={L}, D={D}, C={C}, K={K})"
        )
    toeplitz_conv.launches += 1
    return out


toeplitz_conv.launches = 0
