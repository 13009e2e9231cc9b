"""Causal / windowed GQA attention with an online softmax: a hand-written
CUDA kernel for Hopper and its plain PyTorch version.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``flash_attention``, body ``_flash_kernel``) with the function of its
oracle ``repro/kernels/ref.py::flash_attention``:
``o = softmax(scale·q·kᵀ + mask)·v`` for q (B, H, Lq, Dh) and k, v
(B, Hkv, Lk, Dh), query head h reading KV head ``h // (H / Hkv)``.  Query
row i sits at position ``q_offset + i`` (default ``Lk − Lq``, the Pallas
kernel's fixed choice) and sees key j where ``j <= q_offset + i``
(causal) and ``j > q_offset + i − window`` (a window).  q is scaled in
fp32 before the dot, the softmax runs in fp32, and the output is in the
input dtype.  A row that sees no key gives 0, as the Pallas kernel's
``l == 0`` guard does (the ``ref`` oracle gives NaN there).

Kernel (``csrc/flash_attention.cu``): one block per (64 query rows, query
head, batch row), looping over the key tiles that the causal or window
mask leaves visible, with the running max, sum and accumulator in fp32
registers.  Its function is bound by operations (4·Dh per visible (query,
key) pair and head: 25.8 GFLOP at B=4, H=24, L=1024, Dh=128, 26 µs on the
bf16 tensor cores).  bf16 inputs run on the tensor cores: one warpgroup of
4 warps × 16 rows, q·Kᵀ and P·V as ``mma.sync`` m16n8k16 bf16 tiles with
fp32 accumulators, K and V in 64-key tiles (32 at Dh = 256) through a
two-stage ``cp.async`` ring in shared memory laid out with TMA's 128-byte
swizzle, and P rounded to bf16 in registers between the two products (see
:data:`TOLERANCE`).  Views whose rows do not start on 16 bytes take a
second instance of the same kernel that stages its tiles element by
element.  fp32 inputs run on the CUDA cores (eight warps of eight rows,
32-key tiles staged as fp32), bound by their FMA rate and shared loads.
Later work: ``wgmma`` with shared-memory descriptors, TMA loads with
``mbarrier`` waits, warp specialisation, the G query heads of one KV head in
one block, a backward pass.  It takes Dh ∈ {64, 128, 256}, fp32 or bf16,
H % Hkv == 0 and views whose last dim is unit-stride; it raises on
anything else.

:func:`flash_attention` is the kernel alone (CUDA tensors only) and counts
its launches on ``flash_attention.launches``;
:func:`flash_attention_plain` is the plain version.
``repro_torch.kernels.ops.flash_attention`` picks one of them by the
tensors' device.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

NEG_INF = -1e30
HEAD_DIMS = (64, 128, 256)  # must equal the instances in csrc/flash_attention.cu
_KERNEL_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
# (rtol, atol) of the kernel against flash_attention_plain, by dtype.
# fp32: both sum the same fp32 products in other orders.  bf16: the kernel
# rounds p to bf16 (round to nearest, 8 significant bits: relative error
# at most 2^-8) before p·v, as every tensor-core flash kernel does, so
# |o − plain| ≤ 2^-8·Σⱼ pⱼ|vⱼ| plus each output's own bf16 rounding (at
# most 2^-8 of the value on each side).  Where a row's weight sits on few
# keys, Σⱼ pⱼ|vⱼ| ≈ |o| and the bound is 3·2^-8·|o|, inside rtol = 2^-6;
# where it is spread over many keys, |o| shrinks by cancellation while the
# rounding errors, of independent signs, grow only as the root of their
# sum of squares, and atol = 2^-7 (one bf16 ulp at |o| in [1, 2)) holds
# that part for unit-variance v (randn).  The plain version with p rounded
# to bf16 stays within this tolerance of the plain version
# (tests/port/test_torch_attention.py).
TOLERANCE = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2.0 ** -6, 2.0 ** -7)}


def _check_shapes(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be 4-d: (B, H, Lq, Dh), (B, Hkv, Lk, Dh)")
    B, H, Lq, Dh = q.shape
    Bk, Hkv, Lk, Dk = k.shape
    if Bk != B or Dk != Dh or v.shape != k.shape:
        raise ValueError(
            f"shapes do not fit: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}"
        )
    if Hkv < 1 or H % Hkv:
        raise ValueError(f"H = {H} query heads is not a multiple of Hkv = {Hkv}")


def _resolve(q, k, scale, q_offset):
    Dh, Lq, Lk = q.shape[3], q.shape[2], k.shape[2]
    return (Dh ** -0.5 if scale is None else float(scale),
            Lk - Lq if q_offset is None else int(q_offset))


def flash_attention_plain(
    q: torch.Tensor,  # (B, H, Lq, Dh)
    k: torch.Tensor,  # (B, Hkv, Lk, Dh)
    v: torch.Tensor,  # (B, Hkv, Lk, Dh)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    q_offset: Optional[int] = None,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the full (Lq, Lk) scores of
    every head in fp32, masked with ``NEG_INF``, softmax, then the masked
    probabilities zeroed so that a row that sees no key gives 0."""
    _check_shapes(q, k, v)
    B, H, Lq, Dh = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    G = H // Hkv
    scale, q_offset = _resolve(q, k, scale, q_offset)
    qg = (q.float() * scale).reshape(B, Hkv, G, Lq, Dh)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float())
    qpos = torch.arange(Lq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(Lk, device=q.device)[None, :]
    mask = torch.ones(Lq, Lk, dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1) * mask
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return o.reshape(B, H, Lq, Dh).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _kernel(dtype_tag: str):
    from repro_torch.kernels.build import load

    lib = load("flash_attention")
    fn = getattr(lib, f"flash_attention_{dtype_tag}")
    fn.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_float]
        + [ctypes.c_int] * 3 + [ctypes.c_int64] * 12
        + ([ctypes.c_int] if dtype_tag == "bf16" else []) + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    lib.flash_error_string.argtypes = [ctypes.c_int]
    lib.flash_error_string.restype = ctypes.c_char_p
    lib.flash_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.flash_smem_bytes.restype = ctypes.c_int
    return lib, fn


def _strides(t: torch.Tensor):
    return t.stride(0), t.stride(1), t.stride(2)


def rows_aligned16(*ts: torch.Tensor) -> bool:
    """Whether every row of these (B, H, L, Dh) views starts on a 16-byte
    boundary (the data pointer and the first three strides): the bf16
    kernel then copies its tiles by 16-byte ``cp.async``, else it takes its
    element-wise instance."""
    return all(
        t.data_ptr() % 16 == 0 and all(st * t.element_size() % 16 == 0 for st in t.stride()[:3])
        for t in ts
    )


def flash_attention(
    q: torch.Tensor,  # (B, H, Lq, Dh) on a CUDA device
    k: torch.Tensor,  # (B, Hkv, Lk, Dh)
    v: torch.Tensor,  # (B, Hkv, Lk, Dh)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    q_offset: Optional[int] = None,
) -> torch.Tensor:
    """The CUDA kernel; raises on what it does not take, and counts its
    launches on ``flash_attention.launches``.  q, k and v may be any views
    whose last dim is unit-stride (the mixer passes (B, L, H, Dh)
    projections transposed); the output is (B, H, Lq, Dh), a transposed
    view of a contiguous (B, Lq, H, Dh) tensor."""
    _check_shapes(q, k, v)
    B, H, Lq, Dh = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    if q.device.type != "cuda":
        raise ValueError(f"the kernel takes CUDA tensors, got {q.device}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype}, q is {q.dtype}")
    if q.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"kernel takes fp32 or bf16 q, k, v, got {q.dtype}")
    if Dh not in HEAD_DIMS:
        raise ValueError(f"kernel takes head dims {HEAD_DIMS}, got Dh = {Dh}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} is not contiguous in its last dim: strides {t.stride()}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    scale, q_offset = _resolve(q, k, scale, q_offset)
    out = torch.empty((B, Lq, H, Dh), dtype=q.dtype, device=q.device).transpose(1, 2)
    if out.numel() == 0:
        return out
    lib, fn = _kernel(_KERNEL_DTYPES[q.dtype])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    aligned = (int(rows_aligned16(q, k, v)),) if q.dtype == torch.bfloat16 else ()
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, H, Hkv, Lq, Lk, Dh, scale, int(causal), 0 if window is None else int(window),
        q_offset, *_strides(q), *_strides(k), *_strides(v), *_strides(out), *aligned, stream,
    )
    if err != 0:
        raise RuntimeError(
            f"flash_attention launch failed: {lib.flash_error_string(err).decode()} "
            f"(B={B}, H={H}, Hkv={Hkv}, Lq={Lq}, Lk={Lk}, Dh={Dh})"
        )
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
