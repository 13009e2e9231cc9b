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

Kernel (``csrc/short_conv.cu``), three instances of one function, picked
by :func:`short_conv_plan` from the tensors' pointers, strides and K:

- ``"vector"``: a thread owns one 16-byte vector of channels and walks a
  run of consecutive rows (:func:`vector_geometry`), its K − 1 previous rows
  a sliding window of registers and a ring of rows of u and the gate in
  flight ahead of the sums; every load and store is one 16-byte access.  It
  needs 16-byte aligned data pointers, batch and row strides that are
  multiples of the vector, D a multiple of it, and K <= MAX_UNROLLED_K.
- ``"scalar"``: one element a thread, for any view whose channel dim is
  unit-stride (a ragged D, a view off 16 bytes).
- ``"general"``: K > MAX_UNROLLED_K, K a run-time argument, the taps and
  the halo read through L1.

Every instance sums the taps in fp32, each product rounded before its add,
so its fp32 sums equal the plain version's bit for bit.  What bounds it on
the card: its bytes (u, the output and the gate once).  It takes any
K >= 1, fp32 or bf16 ``u`` with a ``gate`` of the same dtype, fp32 or bf16
``w``, and views whose last dim is unit-stride; it raises on anything else.

:func:`short_conv_gate` is the kernel alone (CUDA tensors only) and counts
its launches on ``short_conv_gate.launches`` and, per instance, on
``short_conv_gate.vector_launches``, ``.scalar_launches`` and
``.general_launches``; :func:`short_conv_gate_plain` is the plain
version.  ``repro_torch.kernels.ops.short_conv_gate`` picks one of them by
the tensors' device.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

MAX_UNROLLED_K = 8  # must equal MAX_UNROLLED_K in csrc/short_conv.cu
AHEAD = 4  # rows of u (and the gate) in flight per vector thread; AHEAD in the .cu
VECTOR_BYTES = 16
# rows a vector thread walks, the most (ungated, gated): timed on the H100
# at hyena-153m's projection beside other run lengths and ring depths, where
# these put the least time there (PERF.md)
RUN_ROWS = 16
RUN_ROWS_GATED = 8
# fewer vector threads than this (132 SMs x 2 blocks of 128) and the runs
# are halved, down to AHEAD rows, so that a small call still fills the card
FILL_THREADS = 132 * 2 * 128
INSTANCES = ("vector", "scalar", "general")
_INSTANCE_CODES = {name: i for i, name in enumerate(INSTANCES)}
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


def vector_width(dtype: torch.dtype) -> int:
    """V, the channels of one 16-byte vector: 8 in bf16, 4 in fp32."""
    return VECTOR_BYTES // dtype.itemsize


def short_conv_plan(u: torch.Tensor, w: torch.Tensor, gate: Optional[torch.Tensor] = None) -> str:
    """The instance the kernel takes for these tensors: ``"general"`` past
    K = MAX_UNROLLED_K, else ``"vector"`` where u and the gate start on 16
    bytes, their batch and row strides are multiples of V (a dim of size 1
    is never stepped, so its stride does not count) and D is a multiple of
    V, else ``"scalar"``.  The output, a fresh contiguous (B, L, D), starts
    on 16 bytes and keeps its rows there when D does."""
    if w.shape[1] > MAX_UNROLLED_K:
        return "general"
    V = vector_width(u.dtype)
    if u.shape[2] % V:
        return "scalar"
    for t in (u, gate):
        if t is None:
            continue
        if t.data_ptr() % VECTOR_BYTES:
            return "scalar"
        if any(size > 1 and stride % V for size, stride in zip(t.shape[:2], t.stride()[:2])):
            return "scalar"
    return "vector"


def vector_geometry(B: int, L: int, n_vec: int, *, gated: bool):
    """(R, n_runs, threads) of the vector instance: runs of R consecutive
    rows (RUN_ROWS or RUN_ROWS_GATED, halved while fewer than FILL_THREADS
    threads would run, down to AHEAD), cut at L, one thread per (batch row,
    run, vector)."""
    R = RUN_ROWS_GATED if gated else RUN_ROWS
    while R > AHEAD and B * -(-L // R) * n_vec < FILL_THREADS:
        R //= 2
    R = min(R, L)
    n_runs = -(-L // R)
    return R, n_runs, B * n_runs * n_vec


def entry_point(lib: ctypes.CDLL, u_tag: str, w_tag: str):
    """The C entry point of a build of csrc/short_conv.cu for u's and w's
    dtype tags ("f32", "bf16"), its argument types set: (u, w, gate, out,
    B, L, D, K, instance, R, u's batch and row strides, the gate's, w's two
    strides, stream); it returns a cudaError_t."""
    fn = getattr(lib, f"short_conv_{u_tag}_{w_tag}")
    fn.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_int64] * 6 + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    for name in ("max_unrolled_k", "ahead"):
        getattr(lib, f"short_conv_{name}").restype = ctypes.c_int
    lib.short_conv_error_string.argtypes = [ctypes.c_int]
    lib.short_conv_error_string.restype = ctypes.c_char_p
    return fn


@functools.lru_cache(maxsize=None)
def _kernel(u_tag: str, w_tag: str):
    from repro_torch.kernels.build import load

    lib = load("short_conv")
    fn = entry_point(lib, u_tag, w_tag)
    for name, want in (("max_unrolled_k", MAX_UNROLLED_K), ("ahead", AHEAD)):
        if getattr(lib, f"short_conv_{name}")() != want:
            raise RuntimeError(f"csrc/short_conv.cu disagrees on {name.upper()}")
    return lib, fn


def short_conv_gate(
    u: torch.Tensor,  # (B, L, D) on a CUDA device
    w: torch.Tensor,  # (D, K)
    gate: Optional[torch.Tensor] = None,  # (B, L, D), u's dtype
) -> torch.Tensor:
    """The CUDA kernel; raises on what it does not take, and counts its
    launches on ``short_conv_gate.launches`` and on the instance's own
    counter."""
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
    if K < 1:
        raise ValueError(f"kernel takes K >= 1 taps, got K={K}")
    for name, t in (("u", u), ("gate", gate)):
        if t is not None and D > 1 and t.stride(-1) != 1:
            raise ValueError(f"{name} is not contiguous in its last dim: strides {t.stride()}")
    instance = short_conv_plan(u, w, gate)
    out = torch.empty((B, L, D), dtype=u.dtype, device=u.device)
    if out.numel() == 0:
        return out
    R = vector_geometry(B, L, D // vector_width(u.dtype), gated=gate is not None)[0]
    lib, fn = _kernel(_KERNEL_DTYPES[u.dtype], _KERNEL_DTYPES[w.dtype])
    stream = torch.cuda.current_stream(u.device).cuda_stream
    g_strides = (0, 0) if gate is None else (gate.stride(0), gate.stride(1))
    err = fn(
        u.data_ptr(), w.data_ptr(), None if gate is None else gate.data_ptr(), out.data_ptr(),
        B, L, D, K, _INSTANCE_CODES[instance], R, u.stride(0), u.stride(1), *g_strides,
        w.stride(0), w.stride(1), stream,
    )
    if err != 0:
        raise RuntimeError(
            f"short_conv_gate launch failed: {lib.short_conv_error_string(err).decode()} "
            f"({instance} instance, B={B}, L={L}, D={D}, K={K})"
        )
    short_conv_gate.launches += 1
    setattr(short_conv_gate, f"{instance}_launches",
            getattr(short_conv_gate, f"{instance}_launches") + 1)
    return out


short_conv_gate.launches = 0
short_conv_gate.vector_launches = 0
short_conv_gate.scalar_launches = 0
short_conv_gate.general_launches = 0


def reset_launch_counts(counts: Optional[dict] = None) -> None:
    """Set the total and every per-instance launch count to 0, or to
    ``counts`` (as :func:`launch_counts` gives them)."""
    counts = counts or {}
    short_conv_gate.launches = counts.get("launches", 0)
    for name in INSTANCES:
        setattr(short_conv_gate, f"{name}_launches", counts.get(name, 0))


def launch_counts() -> dict:
    """The total and per-instance launch counts, by name."""
    return {"launches": short_conv_gate.launches,
            **{name: getattr(short_conv_gate, f"{name}_launches") for name in INSTANCES}}
