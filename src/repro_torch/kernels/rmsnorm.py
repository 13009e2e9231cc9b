"""RMSNorm: a hand-written CUDA kernel for Hopper and its plain PyTorch
version.

Replaces the Pallas TPU kernel ``repro/kernels/rmsnorm.py`` (``rmsnorm``,
body ``_rmsnorm_kernel``) with the function of its oracle
``repro/kernels/ref.py::rmsnorm``: per row of the last dim

    y = x · rsqrt(mean(x²) + eps) · (1 + g)

in fp32, with g cast to fp32 **before** ``1 + g``, and y cast back to x's
dtype.  The model's norm (``models/layers.py::apply_norm``) adds 1 to g in
g's own dtype, so this function is not a drop-in for it, and no model path
routes through it.

Kernel (``csrc/rmsnorm.cu``): one warp per row sums the squares in fp32
with warp shuffles, then scales the row; its lanes read 16 bytes at a time
where the rows allow it.  What bounds it on the card: its
bytes (x and y once).  It takes any leading dims (flattened to rows), any
D >= 1, fp32 or bf16 ``x``, fp32 or bf16 ``g``, and an ``x`` whose last dim
is unit-stride; it raises on anything else.

:func:`rmsnorm` is the kernel alone (CUDA tensors only) and counts its
launches on ``rmsnorm.launches``; :func:`rmsnorm_plain` is the plain
version.  ``repro_torch.kernels.ops.rmsnorm`` picks one of them by the
tensors' device.
"""
from __future__ import annotations

import ctypes
import functools

import torch

_KERNEL_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _check_shapes(x, g) -> None:
    if x.dim() < 1:
        raise ValueError("x must have a last dim to normalise")
    if tuple(g.shape) != (x.shape[-1],):
        raise ValueError(f"g has shape {tuple(g.shape)}, expected {(x.shape[-1],)}")


def rmsnorm_plain(x: torch.Tensor, g: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """``ref.rmsnorm`` in plain PyTorch."""
    _check_shapes(x, g)
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps) * (1.0 + g.float())
    return y.to(x.dtype)


@functools.lru_cache(maxsize=None)
def _kernel(x_tag: str, g_tag: str):
    from repro_torch.kernels.build import load

    lib = load("rmsnorm")
    fn = getattr(lib, f"rmsnorm_{x_tag}_{g_tag}")
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_float, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    lib.rmsnorm_error_string.argtypes = [ctypes.c_int]
    lib.rmsnorm_error_string.restype = ctypes.c_char_p
    return lib, fn


def rmsnorm(x: torch.Tensor, g: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """The CUDA kernel; raises on what it does not take, and counts its
    launches on ``rmsnorm.launches``."""
    _check_shapes(x, g)
    if x.device.type != "cuda":
        raise ValueError(f"the kernel takes CUDA tensors, got {x.device}")
    if g.device != x.device:
        raise ValueError(f"g is on {g.device}, x on {x.device}")
    if x.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"kernel takes fp32 or bf16 x, got {x.dtype}")
    if g.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"kernel takes fp32 or bf16 g, got {g.dtype}")
    D = x.shape[-1]
    if D > 1 and x.stride(-1) != 1:
        raise ValueError(f"x is not contiguous in its last dim: strides {x.stride()}")
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    x2 = x.reshape(-1, D)  # a view unless the leading dims cannot merge
    lib, fn = _kernel(_KERNEL_DTYPES[x.dtype], _KERNEL_DTYPES[g.dtype])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x2.data_ptr(), g.data_ptr(), out.data_ptr(), x2.shape[0], D, x2.stride(0),
             g.stride(0), eps, stream)
    if err != 0:
        raise RuntimeError(
            f"rmsnorm launch failed: {lib.rmsnorm_error_string(err).decode()} "
            f"(rows={x2.shape[0]}, D={D})"
        )
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0
