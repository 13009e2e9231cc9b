"""Two-level (inner R / outer S) FFT causal conv: a hand-written CUDA
kernel for Hopper and its plain PyTorch version.

Replaces the Pallas TPU kernel ``repro/kernels/twolevel_fft.py``
(``twolevel_fft_conv``, body ``_twolevel_kernel``).  It computes the gated
causal long conv of the ``blockfft_overlap`` backend on
N = ``next_fast_len(2L-1)`` = R·S points: the inner R-point DFT of the real
input, the twiddle, the outer S-point DFT, the product with the filter
spectrum H, the inverse with the real part taken and the 1/N scale, and the
epilogue of ``_fused_epilogue`` (skip-add in fp32, downcast, then the gate
in the output dtype).

Kernel (``csrc/twolevel_fft.cu``), two paths:

- bf16 ``u`` with R <= 64 and S <= 64 (L <= 2048 at the default split):
  the four DFT stages as TF32 tensor-core products (``mma.sync`` m16n8k8,
  operands rounded by ``cvt.rna.tf32.f32``, fp32 sums), the twiddles, the
  product with H and the epilogue in fp32.  A team of 1, 2 or 4 warps owns
  a column; stage 1's output feeds stage 2 and stage 2's stage 3 straight
  from registers, and the tables (FR, FS, TW, built here in fragment order
  by :func:`_tc_tables`) sit in shared memory once per block.  A block's
  teams own consecutive channels and walk the batch rows together: u and
  the gate come in as [t][teams] tiles by ``cp.async``, the next row's
  while this one computes, and the output leaves the same way.  The filter
  spectrum is computed in the same launch, by the same TF32 stages 1-2 on
  the taps h, once per unit (a channel and all its batch rows at the
  served shape).  u, the gate and h are read through their strides, so the
  model's split views and sliced taps cost no copy.
- fp32 ``u``, and bf16 shapes past those factors: the CUDA-core kernel
  (direct fp32 DFT sums, one block per batch row and tile of 1, 2 or 4
  channels), with H from the plain four-step transform in fp32
  (:func:`~repro_torch.core.blockfft.filter_spectrum`), also reading u and
  the gate through their strides.

It takes L <= 8192 (N <= 16384), fp32 or bf16 ``u`` and ``gate``, any
(R, S) split, any D and any strides, and raises on anything else.  What
bounds it on the card and what its design does about it: see the source.

On a CPU tensor the wrapper runs the plain version
(``blockfft_causal_conv`` with the same factors); on a CUDA tensor it
launches the kernel, once per call, or raises.  ``launch_with_spectrum`` is
the launch given H (the kernel alone, without the filter's transform);
``twolevel_fft_conv.launches`` counts kernel launches.
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
# the tensor-core instance: R <= TC_MAX_R, S <= TC_MAX_S, at most
# TC_MAX_TEAMS teams a block (must equal tc::MAX_R, 8·tc::MAX_NT and
# tc::MAX_TEAMS in csrc/twolevel_fft.cu)
TC_MAX_R, TC_MAX_S, TC_MAX_TEAMS = 64, 64, 8
SMEM_PER_BLOCK = 232448  # H100: 227 KB of dynamic shared memory a block
SMEM_PER_SM = 233472  # 228 KB an SM, 1 KB of it reserved per block
_KERNEL_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}

# (rtol, atol) of the kernel against its plain version (blockfft_causal_conv),
# by dtype; chip_smoke.py and tests/port/test_torch_cuda.py hold it to these.
# fp32 (the CUDA-core kernel): the same fp32 DFT sums in other orders.
# bf16 (the tensor-core kernel): each operand of the four products -- and
# of the two that compute H -- is rounded to TF32, 10 explicit mantissa
# bits, by round-to-nearest (ties away): a relative error of at most 2^-11
# per operand, so each product term is off by at most 2·2^-11 of its size,
# and the sums stay fp32.  The DFT stages are unitary up to their scale, so
# those errors, of independent signs, add in quadrature instead of growing
# with N: the fp32 conv output y moves by a few 2^-11 of the rms of y, not
# of |y| at each t.  Both y's are then rounded to bf16 (8 significant
# bits: at most 2^-9 of the value each), and the gate multiplies in bf16
# (again at most 2^-9 each side), so two outputs whose fp32 values agree
# may still land one or two bf16 ulps apart: rtol 2^-6 holds those
# roundings, and atol 2^-10 = 9.8e-4 the TF32 part.  A model of the
# kernel's rounding on the CPU (tests/port/test_torch_conv.py) leaves at
# most atol / 4 beyond rtol·|plain| at randn inputs and asserts it; the
# kernel left 6.4e-5 at the served shape and 1.3e-4 at L = 333 on the H100
# (PERF.md).
TOLERANCE = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2.0 ** -6, 2.0 ** -10)}


def launch_shape(N: int, D: int) -> Tuple[int, int, int]:
    """The CUDA-core instance's (channels per block ``td``, threads per
    block, shared bytes) for a length-N column: 4 channels (fewer when D is
    smaller) halved until 8·N·td fits 64 KB, and enough threads that each
    stages at most STAGED position-channel outputs (STAGED / td positions)."""
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


def takes_tensor_cores(dtype: torch.dtype, R: int, S: int) -> bool:
    """Whether a call of this dtype and split runs on the tensor-core
    instance (else on the CUDA-core one)."""
    return dtype == torch.bfloat16 and R <= TC_MAX_R and S <= TC_MAX_S


def _tc_dims(R: int, S: int) -> Tuple[int, int, int]:
    """(MT m-tiles of 16 rows, NT n-tiles of 8 columns, padded Rp = 16·MT);
    MT is 1, 2 or 4, as the kernel pads it (its ``Plan``)."""
    MT = 1 if R <= 16 else 2 if R <= 32 else 4
    return MT, -(-S // 8), 16 * MT


def krow(i: np.ndarray, kap: np.ndarray) -> np.ndarray:
    """Row of the R axis that k-slot ``kap`` (0..7) of k-step ``i`` stands
    for in the R-long sums (stages 1 and 4); ``krow`` in the CUDA source."""
    return 16 * (i >> 1) + 4 * (i & 1) + (kap & 3) + 8 * (kap >> 2)


@functools.lru_cache(maxsize=32)
def _tc_tables(N: int, factors: Tuple[int, int]) -> np.ndarray:
    """The tensor-core instance's tables as one fp32 array, in the fragment
    order of ``mma.m16n8k8`` (lane l: g = l // 4, q = l % 4), zero past R
    and S:

    - FR's A fragments, [m-tile mt][k-step i][re, im][lane][4]: rows
      16mt + (g, g+8, g, g+8) by k-slots (q, q, q+4, q+4), slot k standing
      for column ``krow(i, k)``; stages 1 and 4 share it (FR is symmetric);
    - FS's B fragments, [k-step j][n-tile jn][lane] (re0, re1, im0, im1):
      rows 8j + 2q and 8j + 2q + 1 (k-slots q and q + 4: the C-to-A reuse
      of the stage before), column 8jn + g; stages 2 and 3 share it (FS is
      symmetric); then the same fragments' (-im0, -im1);
    - TW in C-fragment order, [mt][jn][re, im][lane][4]: (16mt + g,
      8jn + 2q), (16mt + g, 8jn + 2q + 1), then the same rows + 8."""
    R, S, FR, FS, TW = _dft_mats(N, factors)
    # the kernel's inverse DFTs read FR[k, r] for FR[r, k] and FS[q, s] for FS[s, q]
    if not (np.array_equal(FR, FR.T) and np.array_equal(FS, FS.T)):
        raise ValueError(f"DFT tables for {factors} are not symmetric")
    MT, NT, Rp = _tc_dims(R, S)
    Sp = 8 * NT
    FRp = np.zeros((Rp, Rp), np.complex64)
    FRp[:R, :R] = FR
    FSp = np.zeros((Sp, Sp), np.complex64)
    FSp[:S, :S] = FS
    TWp = np.zeros((Rp, Sp), np.complex64)
    TWp[:R, :S] = TW
    lane = np.arange(32)
    g, q = lane >> 2, lane & 3

    mt = np.arange(MT)[:, None, None]
    i = np.arange(2 * MT)[None, :, None]
    rows = (16 * mt + g, 16 * mt + g + 8, 16 * mt + g, 16 * mt + g + 8)
    cols = (krow(i, q), krow(i, q), krow(i, q + 4), krow(i, q + 4))
    a = np.stack([FRp[r, c] for r, c in zip(rows, cols)], -1)  # (MT, KR, 32, 4)
    fr = np.stack([a.real, a.imag], 2)  # (MT, KR, 2, 32, 4)

    j = np.arange(NT)[:, None, None]
    jn = np.arange(NT)[None, :, None]
    b0, b1 = FSp[8 * j + 2 * q, 8 * jn + g], FSp[8 * j + 2 * q + 1, 8 * jn + g]
    fs = np.stack([b0.real, b1.real, b0.imag, b1.imag], -1)  # (NT, NT, 32, 4)
    fsn = np.stack([-b0.imag, -b1.imag], -1)  # (NT, NT, 32, 2)

    mt = np.arange(MT)[:, None, None]
    rows = (16 * mt + g, 16 * mt + g, 16 * mt + g + 8, 16 * mt + g + 8)
    cols = (8 * jn + 2 * q, 8 * jn + 2 * q + 1, 8 * jn + 2 * q, 8 * jn + 2 * q + 1)
    w = np.stack([TWp[r, c] for r, c in zip(rows, cols)], -1)  # (MT, NT, 32, 4)
    tw = np.stack([w.real, w.imag], 2)  # (MT, NT, 2, 32, 4)
    return np.concatenate([fr.ravel(), fs.ravel(), fsn.ravel(), tw.ravel()]).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _tc_device_tables(N: int, factors: Tuple[int, int], device: str) -> torch.Tensor:
    return torch.from_numpy(_tc_tables(N, factors)).to(device)


def tc_smem_bytes(R: int, S: int, L: int, teams: int) -> int:
    """Dynamic shared memory of a tensor-core block: the tables, per team
    the column / E buffer and H (fp32, 16·MT × 8·NT complex each), and two
    steps' u and gate tiles (bf16, L × teams each)."""
    MT, NT, Rp = _tc_dims(R, S)
    tables = 2 * Rp * Rp + 192 * NT * NT + 256 * MT * NT
    return 4 * (tables + teams * 512 * MT * NT) + 8 * L * teams


@functools.lru_cache(maxsize=256)
def tc_launch_shape(R: int, S: int, B: int, L: int, D: int, sm_count: int):
    """(teams a block, threads, shared bytes, grid, batch rows per unit) of
    the tensor-core instance.  A block's teams own consecutive channels, as
    many as the launch bounds (512 threads for S <= 32, else 256), the
    shared memory, D and 8 allow, 5-7 rounded down to 4 so that the rows of
    its tiles copy as one chunk (2, 4 or 8 channels).  A unit is that group
    of channels and a run of ``bpu`` batch rows; H is computed once per unit
    (about half a column's work), so ``bpu`` = B unless shorter runs balance
    the grid's waves better."""
    MT, NT, _ = _tc_dims(R, S)
    max_threads = 512 if NT <= 4 else 256
    teams = min(TC_MAX_TEAMS, max_threads // (32 * MT), D)
    while teams > 1 and tc_smem_bytes(R, S, L, teams) > SMEM_PER_BLOCK:
        teams -= 1
    if 4 < teams < 8:
        teams = 4
    threads = 32 * MT * teams
    smem = tc_smem_bytes(R, S, L, teams)
    per_sm = max(1, min(SMEM_PER_SM // (smem + 1024), 2048 // threads))
    groups = -(-D // teams)
    best = None
    for bpu in sorted({-(-B // n) for n in range(1, B + 1)}, reverse=True):
        units = groups * -(-B // bpu)
        grid = min(units, sm_count * per_sm)
        cost = -(-units // grid) * (0.5 + bpu)
        if best is None or cost < best[0]:
            best = (cost, grid, bpu)
    return teams, threads, smem, best[1], best[2]


def rows_aligned(t: Optional[torch.Tensor], teams: int) -> bool:
    """Whether every (b, t) row of a (B, L, D) bf16 view, from a channel
    that is a multiple of ``teams`` on, starts on a 2·teams-byte boundary
    with its channels adjacent: the kernel then copies a group's row as one
    chunk."""
    if t is None:
        return True
    n = 2 * teams
    return (teams in (2, 4, 8) and t.stride(2) == 1 and t.data_ptr() % n == 0
            and all(st * 2 % n == 0 for st in t.stride()[:2]))


@functools.lru_cache(maxsize=None)
def _sm_count(device: str) -> int:
    return torch.cuda.get_device_properties(torch.device(device)).multi_processor_count


@functools.lru_cache(maxsize=32)
def _device_tables(N: int, factors: Tuple[int, int], device: str):
    """fp32 (re, im) planes of FR, TW and FS on ``device``, for the
    CUDA-core instance."""
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
def _kernel():
    from repro_torch.kernels.build import load

    lib = load("twolevel_fft")
    i64, ptr, i32 = ctypes.c_int64, ctypes.c_void_p, ctypes.c_int
    for tag in ("f32", "bf16"):
        fn = getattr(lib, f"twolevel_fft_conv_{tag}")
        fn.argtypes = ([ptr] + [i64] * 3) * 2 + [ptr] * 9 + [i32] * 8 + [ptr]
        fn.restype = i32
    lib.twolevel_tc_bf16.argtypes = (
        ([ptr] + [i64] * 3) * 2 + [ptr, i32, i64] + [ptr, i32, i64, i64]
        + [ptr] * 3 + [i32] * 11 + [ptr]
    )
    lib.twolevel_tc_bf16.restype = i32
    lib.twolevel_tc_max_threads.argtypes = [i32]
    lib.twolevel_tc_max_threads.restype = i32
    lib.twolevel_error_string.argtypes = [i32]
    lib.twolevel_error_string.restype = ctypes.c_char_p
    lib.twolevel_staged.restype = i32
    if lib.twolevel_staged() != STAGED:
        raise RuntimeError("csrc/twolevel_fft.cu disagrees on STAGED")
    if (lib.twolevel_tc_max_threads(4), lib.twolevel_tc_max_threads(8)) != (512, 256):
        raise RuntimeError("csrc/twolevel_fft.cu disagrees on the tensor-core launch bounds")
    return lib


@functools.lru_cache(maxsize=256)
def _plan(L: int, factors: Optional[Tuple[int, int]]) -> Tuple[int, int, int]:
    """(N, R, S) of a length-L call: the host work a call repeats."""
    N = next_fast_len(2 * L - 1)
    if N > MAX_N:
        raise ValueError(f"kernel takes L <= {MAX_N // 2}, got L={L}")
    return (N, *resolve_factors(N, factors))


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _strides(t: Optional[torch.Tensor]) -> Tuple[int, int, int]:
    return (0, 0, 0) if t is None else tuple(t.stride())


def _check_operands(u, skip, gate) -> None:
    D = u.shape[2]
    if u.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"kernel takes fp32 or bf16 u, got {u.dtype}")
    if gate is not None and (gate.dtype != u.dtype or gate.shape != u.shape):
        raise ValueError(
            f"gate must match u: got {gate.dtype} {tuple(gate.shape)}, "
            f"u is {u.dtype} {tuple(u.shape)}"
        )
    if skip is not None and tuple(skip.shape) != (D,):
        raise ValueError(f"skip has shape {tuple(skip.shape)}, expected {(D,)}")
    for name, t in (("skip", skip), ("gate", gate)):
        if t is not None and t.device != u.device:
            raise ValueError(f"{name} is on {t.device}, u on {u.device}")


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
    N, R, S = _plan(L, None if factors is None else tuple(factors))
    _check_operands(u, skip, gate)
    if takes_tensor_cores(u.dtype, R, S):
        if h.dtype not in (torch.float32, torch.bfloat16):
            h = h.float()
        return _launch_tc(u, skip, gate, R, S, h=h)
    return _launch_core(u, filter_spectrum(h, N, (R, S)), skip, gate)


def launch_with_spectrum(
    u: torch.Tensor,  # (B, L, D) on a CUDA device
    H: torch.Tensor,  # (R, S, D) complex64 filter spectrum, R·S = N
    skip: Optional[torch.Tensor] = None,
    gate: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The kernel given the filter spectrum (``filter_spectrum``'s layout),
    which :func:`twolevel_fft_conv` computes itself: the same instances
    without the filter's transform.  It counts its launches on
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
    if H.device != u.device:
        raise ValueError(f"H is on {H.device}, u on {u.device}")
    _check_operands(u, skip, gate)
    H = H.contiguous()  # read as interleaved (re, im) fp32 pairs
    if takes_tensor_cores(u.dtype, R, S):
        return _launch_tc(u, skip, gate, R, S, H=H)
    return _launch_core(u, H, skip, gate)


def _raise_failed(lib, err: int, what: str) -> None:
    raise RuntimeError(
        f"twolevel_fft_conv launch failed: {lib.twolevel_error_string(err).decode()} ({what})"
    )


def _launch_tc(u, skip, gate, R, S, *, h=None, H=None) -> torch.Tensor:
    """The tensor-core instance: H computed from the taps h in the launch,
    or read from H."""
    B, L, D = u.shape
    out = torch.empty((B, L, D), dtype=u.dtype, device=u.device)
    if out.numel() == 0:
        return out
    if skip is not None and skip.dtype not in (torch.float32, torch.bfloat16):
        skip = skip.float()
    dev = str(u.device)
    teams, threads, smem, grid, bpu = tc_launch_shape(R, S, B, L, D, _sm_count(dev))
    vec_in = rows_aligned(u, teams) and rows_aligned(gate, teams)
    vec_out = rows_aligned(out, teams) and D % teams == 0
    tables = _tc_device_tables(R * S, (R, S), dev)
    lib = _kernel()
    stream = torch.cuda.current_stream(u.device).cuda_stream
    err = lib.twolevel_tc_bf16(
        u.data_ptr(), *_strides(u), _ptr(gate), *_strides(gate),
        _ptr(skip), int(skip is not None and skip.dtype == torch.bfloat16),
        0 if skip is None else skip.stride(0),
        _ptr(h), int(h is not None and h.dtype == torch.bfloat16),
        *((0, 0) if h is None else h.stride()),
        _ptr(H), tables.data_ptr(), out.data_ptr(),
        B, L, D, R, S, teams, bpu, int(vec_in), int(vec_out), grid, smem, stream,
    )
    if err != 0:
        _raise_failed(lib, err, f"tensor cores, B={B}, L={L}, D={D}, R={R}, S={S}, "
                                f"teams={teams}, bpu={bpu}, grid={grid}, smem={smem}")
    twolevel_fft_conv.launches += 1
    return out


def _launch_core(u, H, skip, gate) -> torch.Tensor:
    """The CUDA-core instance, given H."""
    B, L, D = u.shape
    R, S = H.shape[0], H.shape[1]
    N = R * S
    out = torch.empty((B, L, D), dtype=u.dtype, device=u.device)
    if out.numel() == 0:
        return out
    td, threads, smem = launch_shape(N, D)
    skip32 = None if skip is None else skip.float().contiguous()
    H = H.contiguous()
    tables = _device_tables(N, (R, S), str(u.device))
    lib = _kernel()
    fn = getattr(lib, f"twolevel_fft_conv_{_KERNEL_DTYPES[u.dtype]}")
    stream = torch.cuda.current_stream(u.device).cuda_stream
    err = fn(
        u.data_ptr(), *_strides(u), _ptr(gate), *_strides(gate), _ptr(skip32), H.data_ptr(),
        *(t.data_ptr() for t in tables), out.data_ptr(),
        B, L, D, R, S, td, threads, smem, stream,
    )
    if err != 0:
        _raise_failed(lib, err, f"CUDA cores, B={B}, L={L}, D={D}, R={R}, S={S}, td={td}, "
                                f"threads={threads}, smem={smem}")
    twolevel_fft_conv.launches += 1
    return out


twolevel_fft_conv.launches = 0
