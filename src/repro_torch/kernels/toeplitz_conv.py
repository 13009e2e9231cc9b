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

Kernel (``csrc/toeplitz_conv.cu``), two paths:

- bf16 ``u``: the tensor cores.  Each chunk diagonal is a GEMM per channel,
  ``Y_d[:, (b, i)] += T_r[d] · U_d[:, (b, i - r)]`` over every column
  (b, i), as TF32 ``mma.sync`` m16n8k8 tiles with fp32 sums; the taps are
  rounded to TF32 (``TOLERANCE`` derives the bound), u is exact in TF32.
  The A fragments come from a window of the channel's taps by the index
  rule of :func:`tc_window_start` and :func:`tc_fragment_index`; a block
  owns G channels (:func:`tc_launch_shape`) and all their columns.
- fp32 ``u``: the CUDA-core kernel (one block per 32-channel tile, output
  chunk and batch row, fp32 FMAs), which holds the 1e-4 gate.

It takes C <= 256, fp32 or bf16 ``u`` and ``gate``, fp32 ``h``, and views
whose last dim is unit-stride; it raises on anything else.  What bounds it
on the card and what its design does about it: see the source.

:func:`toeplitz_conv` is the kernel alone (CUDA tensors only) and counts
its launches on ``toeplitz_conv.launches``; :func:`toeplitz_conv_plain` is
the plain version.  ``repro_torch.kernels.ops.toeplitz_conv`` picks one of
them by the tensors' device.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.fftconv import _fused_epilogue

MAX_CHUNK = 256  # must equal MAX_C in csrc/toeplitz_conv.cu
_KERNEL_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
SMEM_PER_BLOCK = 232448  # H100: 227 KB of dynamic shared memory a block
# the tensor-core instance (must equal tc::RING, tc::COLS, tc::MAX_WARPS and
# tc::MW_MAX in csrc/toeplitz_conv.cu)
TC_RING, TC_COLS, TC_MAX_WARPS, TC_MW_MAX = 16, 8, 16, 4

# (rtol, atol) of the kernel against its plain version, by dtype;
# chip_smoke.py and tests/port/test_torch_cuda.py hold it to these.
# fp32 (the CUDA-core kernel): the same fp32 products summed in another
# order.  bf16 (the tensor-core kernel): u is bf16, 8 significant bits,
# which TF32 (11) holds exactly; each tap is rounded to TF32 by
# round-to-nearest (ties away), a relative error of at most 2^-11, and the
# sums stay fp32.  So the conv sum moves by at most
# 2^-11·Σ_k |h[k]|·|u[t-k]| -- no more than 2^-11·max|u| for a filter of l1
# norm <= 1 -- and, the rounding errors of independent signs adding in
# quadrature, typically by a few 2^-11 of the rms of the sum, not of its
# l1 bound.  Both sums are then rounded to bf16 (at most 2^-9 of the value
# each) and the gate multiplies in bf16 (again at most 2^-9 each side), so
# two outputs whose fp32 values agree may still land one or two bf16 ulps
# apart: rtol 2^-6 holds those roundings, and atol 2^-10 = 9.8e-4 the TF32
# part.  A model of the kernel's rounding on the CPU
# (tests/port/test_torch_toeplitz.py) leaves at most atol / 4 beyond
# rtol·|plain| at randn inputs and asserts it.
TOLERANCE = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2.0 ** -6, 2.0 ** -10)}


def tc_dims(C: int) -> Tuple[int, int, int, int]:
    """(CP, MW, KT, strips) of the tensor-core instance for chunks of C
    rows: CP = the power of two >= max(C, 16) rows, MW m-tiles of 16 rows a
    warp (TC_MW_MAX, 2 at CP = 256, fewer below 64 rows), KT k-tiles of 8
    rows, and the warps (row strips) a channel; ``tc::Plan`` in the CUDA
    source."""
    CP = 16
    while CP < C:
        CP *= 2
    MW = 2 if CP == 256 else min(TC_MW_MAX, CP // 16)
    return CP, MW, CP // 8, CP // 16 // MW


def tc_window_start(r: int, C: int, mi0: int, KT: int) -> int:
    """Lag of entry 0 of the tap window that a warp whose strip starts at
    m-tile ``mi0`` keeps for diagonal r; entry w is the pair
    (h[W0 + w - 1], h[W0 + w]), rounded to TF32."""
    return r * C + 16 * mi0 - 8 * (KT - 1) - 6


def tc_fragment_index(s: int, lane, KT: int):
    """Window entries (p0, p1) of the A fragment that ``lane`` (g = lane //
    4, t = lane % 4) holds for the tiles with s = 2·mi - ki (mi counted from
    the strip's first m-tile): p0 = (a2, a0), p1 = (a3, a1), i.e. the taps
    x - 1, x and x + 7, x + 8 of x = rC + 16·mi - 8·ki + g - 2t, k-slot t
    standing for input row 2t of the k-tile and slot t + 4 for row 2t + 1.
    The kernel's index rule (``frag`` in csrc/toeplitz_conv.cu)."""
    g, t = np.asarray(lane) >> 2, np.asarray(lane) & 3
    p0 = 8 * (s + KT - 1) + g - 2 * t + 6
    return p0, p0 + 8


def tc_smem_bytes(C: int, G: int) -> int:
    """Dynamic shared memory of a tensor-core block of G channels: G rings
    of TC_RING chunk slots, G output tiles of TC_COLS columns, one tap
    window per warp (``tc::Plan::smem_bytes``)."""
    CP, MW, KT, strips = tc_dims(C)
    pad4 = lambda n: (n + 27) // 32 * 32 + 4
    ring = TC_RING * pad4(CP // 2) + 4
    tile = TC_COLS * pad4(CP) + 4
    wsp = -(-(8 * (2 * (MW - 1) + KT - 1) + 22) // 32) * 32
    return 4 * G * (ring + tile) + 8 * G * strips * wsp


def tc_launch_shape(D: int, C: int, n_sm: int) -> Tuple[int, int, int, int]:
    """(G channels a block, threads a block, dynamic shared memory, blocks)
    of a tensor-core launch: the fewest channels a block with which D / G
    blocks fit the card's n_sm SMs in one wave (7 at D = 864, 124 blocks),
    at most TC_MAX_WARPS warps a block."""
    _, _, _, strips = tc_dims(C)
    G = min(TC_MAX_WARPS // strips, max(1, -(-D // n_sm)))
    return G, 32 * G * strips, tc_smem_bytes(C, G), -(-D // G)


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
def _kernel():
    from repro_torch.kernels.build import load

    lib = load("toeplitz_conv")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.toeplitz_conv_f32.argtypes = [ptr] * 5 + [i32] * 5 + [i64] * 5 + [ptr]
    lib.toeplitz_conv_f32.restype = i32
    lib.toeplitz_tc_bf16.argtypes = [ptr] * 5 + [i32] * 6 + [i64] * 5 + [ptr]
    lib.toeplitz_tc_bf16.restype = i32
    lib.toeplitz_tc_smem_bytes.argtypes = [i32, i32]
    lib.toeplitz_tc_smem_bytes.restype = i32
    lib.toeplitz_error_string.argtypes = [i32]
    lib.toeplitz_error_string.restype = ctypes.c_char_p
    lib.toeplitz_max_chunk.restype = i32
    if lib.toeplitz_max_chunk() != MAX_CHUNK:
        raise RuntimeError("csrc/toeplitz_conv.cu disagrees on MAX_CHUNK")
    for C in (1, 16, 17, 97, 128, 200, 256):
        if lib.toeplitz_tc_smem_bytes(C, 3) != tc_smem_bytes(C, 3):
            raise RuntimeError("csrc/toeplitz_conv.cu disagrees on the tensor-core plan")
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    lib = _kernel()
    stream = torch.cuda.current_stream(u.device).cuda_stream
    ptrs = (u.data_ptr(), h.data_ptr(), None if skip32 is None else skip32.data_ptr(),
            None if gate is None else gate.data_ptr(), out.data_ptr())
    strides = (u.stride(0), u.stride(1), *((0, 0) if gate is None else gate.stride()[:2]),
               h.stride(0))
    if u.dtype == torch.bfloat16:
        G = tc_launch_shape(D, C, _sm_count(u.device.index or 0))[0]
        err = lib.toeplitz_tc_bf16(*ptrs, B, L, D, C, K, G, *strides, stream)
    else:
        err = lib.toeplitz_conv_f32(*ptrs, B, L, D, C, K, *strides, stream)
    if err != 0:
        raise RuntimeError(
            f"toeplitz_conv launch failed: {lib.toeplitz_error_string(err).decode()} "
            f"(B={B}, L={L}, D={D}, C={C}, K={K})"
        )
    toeplitz_conv.launches += 1
    return out


toeplitz_conv.launches = 0
