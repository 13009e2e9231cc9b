"""Depthwise causal short conv with an optional gate: a hand-written CUDA
kernel for Hopper and its plain PyTorch version.

Replaces the Pallas TPU kernel ``repro/kernels/short_conv.py``
(``short_conv_gate``, body ``_short_conv_kernel``) with the function of its
oracle ``repro/kernels/ref.py::short_conv_gate``:

    y[b, t, d] = Σ_{k<K} w[d, k] · u[b, t − k, d]   (u before t = 0 reads 0)

in fp32, with u and w read as fp32, the taps added in the order k = 0 ..
K − 1, and the gate multiplied in fp32 **before** the downcast to u's dtype.
That order is not ``repro_torch.core.fftconv._fused_epilogue``'s, which
downcasts first and then gates, so this function is not a drop-in for the
model's short conv (``core/fftconv.py::short_causal_conv``), which no path
routes through it.

The Pallas body takes its causal halo from the previous L block only, so
it computes another function when K − 1 exceeds its L block and when K = 1;
this module computes the oracle's for every K >= 1 and L >= 1.

Kernel (``csrc/short_conv.cu``): one thread per channel and a few
consecutive output rows (8, or 4 with a gate) loads its rows, their K − 1
halo rows and its gate rows into registers and sums the taps in fp32, each
product rounded before its add, so its fp32 sums equal the plain version's
bit for bit.  What bounds it on the card:
its bytes (u, the output and the gate once).  It takes K <= 8, fp32 or
bf16 ``u`` with a ``gate`` of the same dtype, fp32 or bf16 ``w``, and views
whose last dim is unit-stride; it raises on anything else.

:func:`short_conv_gate` is the kernel alone (CUDA tensors only) and counts
its launches on ``short_conv_gate.launches``; :func:`short_conv_gate_plain`
is the plain version.  ``repro_torch.kernels.ops.short_conv_gate`` picks
one of them by the tensors' device.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

MAX_K = 8  # must equal MAX_K in csrc/short_conv.cu
_KERNEL_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _check_shapes(u, w, gate) -> None:
    if u.dim() != 3:
        raise ValueError(f"u must be (B, L, D), got shape {tuple(u.shape)}")
    D = u.shape[2]
    if w.dim() != 2 or w.shape[0] != D:
        raise ValueError(f"w has shape {tuple(w.shape)}, expected ({D}, K)")
    if gate is not None and gate.shape != u.shape:
        raise ValueError(f"gate has shape {tuple(gate.shape)}, expected {tuple(u.shape)}")


def short_conv_gate_plain(
    u: torch.Tensor,  # (B, L, D)
    w: torch.Tensor,  # (D, K)
    gate: Optional[torch.Tensor] = None,  # (B, L, D)
) -> torch.Tensor:
    """``ref.short_conv_gate`` in plain PyTorch: K shifted fp32 products
    added onto zeros, times the fp32 gate, then the downcast."""
    _check_shapes(u, w, gate)
    B, L, D = u.shape
    u32 = u.float()
    w32 = w.float()
    y = torch.zeros(B, L, D, dtype=torch.float32, device=u.device)
    for k in range(w.shape[1]):
        shifted = u32 if k == 0 else F.pad(u32, (0, 0, k, 0))[:, :L]
        y = y + shifted * w32[:, k]
    if gate is not None:
        y = y * gate.float()
    return y.to(u.dtype)


@functools.lru_cache(maxsize=None)
def _kernel(u_tag: str, w_tag: str):
    from repro_torch.kernels.build import load

    lib = load("short_conv")
    fn = getattr(lib, f"short_conv_{u_tag}_{w_tag}")
    fn.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_int64] * 6 + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    lib.short_conv_error_string.argtypes = [ctypes.c_int]
    lib.short_conv_error_string.restype = ctypes.c_char_p
    lib.short_conv_max_k.restype = ctypes.c_int
    if lib.short_conv_max_k() != MAX_K:
        raise RuntimeError("csrc/short_conv.cu disagrees on MAX_K")
    return lib, fn


def short_conv_gate(
    u: torch.Tensor,  # (B, L, D) on a CUDA device
    w: torch.Tensor,  # (D, K)
    gate: Optional[torch.Tensor] = None,  # (B, L, D), u's dtype
) -> torch.Tensor:
    """The CUDA kernel; raises on what it does not take, and counts its
    launches on ``short_conv_gate.launches``."""
    _check_shapes(u, w, gate)
    B, L, D = u.shape
    K = w.shape[1]
    if u.device.type != "cuda":
        raise ValueError(f"the kernel takes CUDA tensors, got {u.device}")
    for name, t in (("w", w), ("gate", gate)):
        if t is not None and t.device != u.device:
            raise ValueError(f"{name} is on {t.device}, u on {u.device}")
    if u.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"kernel takes fp32 or bf16 u, got {u.dtype}")
    if gate is not None and gate.dtype != u.dtype:
        raise ValueError(f"gate must be {u.dtype} like u, got {gate.dtype}")
    if w.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"kernel takes fp32 or bf16 w, got {w.dtype}")
    if not 1 <= K <= MAX_K:
        raise ValueError(f"kernel takes 1 <= K <= {MAX_K} taps, got K={K}")
    for name, t in (("u", u), ("gate", gate)):
        if t is not None and D > 1 and t.stride(-1) != 1:
            raise ValueError(f"{name} is not contiguous in its last dim: strides {t.stride()}")
    out = torch.empty((B, L, D), dtype=u.dtype, device=u.device)
    if out.numel() == 0:
        return out
    lib, fn = _kernel(_KERNEL_DTYPES[u.dtype], _KERNEL_DTYPES[w.dtype])
    stream = torch.cuda.current_stream(u.device).cuda_stream
    g_strides = (0, 0) if gate is None else (gate.stride(0), gate.stride(1))
    err = fn(
        u.data_ptr(), w.data_ptr(), None if gate is None else gate.data_ptr(), out.data_ptr(),
        B, L, D, K, u.stride(0), u.stride(1), *g_strides, w.stride(0), w.stride(1), stream,
    )
    if err != 0:
        raise RuntimeError(
            f"short_conv_gate launch failed: {lib.short_conv_error_string(err).decode()} "
            f"(B={B}, L={L}, D={D}, K={K})"
        )
    short_conv_gate.launches += 1
    return out


short_conv_gate.launches = 0
