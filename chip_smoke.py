#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package ``repro``.  Phases:

1. Build every CUDA kernel of the served path from ``csrc/`` with ``nvcc``
   (sm_90a), timed; print ptxas's registers and spills of every kernel
   (raised if an instance of the flash kernel's bf16 path, of the
   two-level conv's or the toeplitz conv's tensor-core path, or of
   RMSNorm's row-tile kernel spills); print the card's name and
   power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
   them.
2. Hold each kernel against its plain PyTorch version on the card at the
   shapes the served paths give it (and a non-power-of-two split, a ragged
   channel tile, a banded Toeplitz call, gated and ungated, skip or not,
   fp32 and bf16; for the two-level conv also N = 675 = 25·27 and the model
   path's operands, u and the gate as split views of the projection and h
   sliced from the max_len grid, read in place: bit for bit what contiguous
   copies give, gated equal to gate × ungated, and one device kernel and no
   copy in a traced call; for the flash attention kernel MHA, MQA, Dh 64 and 256, a
   window, a ragged L, decode offsets, rows that see no key, the mixer's
   transposed views, and in bf16 the edges of its key tiles: an Lk that is
   no multiple of the tile with Lq != Lk, a window ending inside a tile,
   Dh 64 and 256 at L = 512, rows that see no key, and views whose rows
   start off 16 bytes, for its element-wise instance; for the toeplitz
   conv, whose bf16 path runs on the tensor cores, B = 4 at L = 2048,
   chunks of 64 and 256, L = 1, 37, 97 and 1000 and a banded call); print
   each max error beside its tolerance and raise past it.  Float32 matmuls run in
   full fp32 (``torch.backends.cuda.matmul.allow_tf32 = False``).  The short conv
   kernel at hyena-153m's projection (B=4, L=1024, (N+1)·D = 2592, K=3,
   bf16, gated and ungated) and at K=1, K=4, K=8 with L < K−1, L=1, a
   ragged D, fp32, a bf16 w and views of a wider projection; RMSNorm at
   hyena-153m's (4, 1024, 864) and phi4-mini's (4, 1024, 3072) rows in
   bf16 and at one row, D=5, D=1, a 4-D input, D=8192, fp32, a bf16 g,
   rows read through a row stride and rows of zeros.  Each also refuses
   what it does not take (fp16, a non-unit-stride last dim, K > 8).
3. The served path: hyena-153m at full width (18 layers, D=864, order 2,
   vocab 50257) with weights from a seed, ``generate()`` with
   ``ServeConfig(max_len=2048, conv_backend="blockfft_overlap")`` in bf16,
   4 requests of 1024-token prompts, 32 greedy new tokens.  The kernel
   counters are set to 0 just before and read just after: the prefill must
   launch the two-level FFT conv kernel exactly n_layers·order = 36 times.
   The prefill's logits must be finite and agree with the same prefill on
   the plain ``blockfft`` backend on the card.
3b. The continuous-batching engine: ``ServeEngine`` serves hyena-153m at
   full width with ``ServeConfig(max_len=2048, n_slots=4,
   conv_backend="toeplitz")`` in bf16, 8 greedy requests of prompt lengths
   1024, 1000, 768, 512, 333, 200, 97 and 1 with horizons of 8 to 32, to
   the end of ``drain()``.  Every request must complete; each admission is
   one batch-1 prefill, so the counters (0 just before, read just after)
   must show n_layers·order = 36 ``toeplitz_conv`` launches per request;
   every per-slot cache leaf of the pool must be zero after the drain; the
   last-token logits of a 1024-token prefill on ``toeplitz`` must agree
   with the kernel's plain version on the card.  The same requests at
   fp32 must give exactly the tokens of per-request ``generate()``.
3c. The attention family: phi4-mini-3.8b at full width (32 layers,
   D=3072, 24 query and 8 KV heads of 128, SwiGLU d_ff=8192, vocab
   200064) with weights from a seed, ``generate()`` with
   ``ServeConfig(max_len=2048)`` in bf16, 4 requests of 1024-token
   prompts, 32 greedy new tokens.  The counters (0 just before, read just
   after) must show exactly n_layers = 32 ``flash_attention`` launches and
   none of the conv kernels; a bare prefill, counted the same way, must
   launch it 32 times too.  Its last-token logits must be finite and agree
   with the same prefill through the kernel's plain version, swapped in
   for that comparison within this process.
   Every model path above must launch neither the short conv nor the
   RMSNorm kernel: no model routes through them.
3d. The ops entry point, the only path of the short conv and RMSNorm
   kernels: with the counters at 0, ``kernels.ops.short_conv_gate`` on
   hyena-153m's projection with the first layer's ``short_filter``, gated
   and ungated, and ``kernels.ops.rmsnorm`` on hyena-153m's and
   phi4-mini's rows, in bf16.  The counters must show exactly one launch
   per call, and each output must be finite, of the input's shape and
   dtype, and agree with the plain version.
3e. The two-level backend's range on the card: ``generate()`` of
   hyena-153m on ``blockfft_overlap`` with an 8193-token prompt must raise
   ``ValueError`` from ``lm.prefill``'s length check with every kernel
   counter still at 0 (nothing launched).
4. Times (CUDA events; the host clock around synchronised work for the
   served paths): prefill ms, decode ms per step and tokens/s of
   ``generate()`` for hyena-153m and for phi4-mini; the engine's wall time, new tokens/s, ms per admission
   prefill and per pooled decode step; each kernel's ms per call (``ms``:
   the wrapper; for the FFT conv one launch that computes the filter
   spectrum too, timed in turns with the ``torch.fft`` conv, with its device
   time from ``torch.profiler`` and its TFLOP/s of dense four-step products;
   the toeplitz conv likewise in turns with the ``torch.fft`` conv at B = 1
   and B = 4, with its device time and its TFLOP/s of the chunked form's
   products;
   ``kernel_ms`` is the launch given H; then each two-level instance's
   registers, shared memory and spill bytes from the ptxas report)
   beside its plain version, the ``torch.fft`` conv of the same function
   (``library_ms``; for the toeplitz conv at B=1 and, as ``library_ms_b4``,
   at B=4) and its bound: the larger of the bytes the function
   must move over 3.35 TB/s and an FFT conv's fp32 operations (a banded
   call: the band's products) over 67 TFLOP/s, the H100 SXM's published
   peaks.  phi4-mini's prefill also with the kernel's plain version and
   with ``scaled_dot_product_attention`` in the kernel's place (a
   yardstick).  The flash kernel's ms and TFLOP/s at phi4-mini's served
   shape, timed in turns with ``scaled_dot_product_attention`` (kernel,
   library, library, kernel; ``library_ms``, a yardstick the port never
   calls), beside its plain version and its bound: the larger of q, k, v
   and o moved once over 3.35 TB/s and the visible (query, key) pairs'
   4·Dh operations over the tensor cores' 989 TFLOP/s (bf16; 67 TFLOP/s
   for fp32 inputs); then each flash instance's registers, shared memory
   and spill bytes from the ptxas report.  The short conv and RMSNorm
   kernels at the shapes of phase 3d, each call on one of several input
   sets that together exceed the 50 MB L2 cache (a caller finds them
   cold): the wrapper's ms by CUDA events (RMSNorm's in turns with the
   library) and the kernel's device ms by ``torch.profiler`` (RMSNorm's
   beside the library call's), beside the plain version, a library yardstick the
   port never calls (``F.conv1d(groups=D)`` with causal padding, then the
   gate; ``F.rms_norm(weight=1+g)``) and the bound, the bytes the function
   must move (u, the gate and the output, or x and y, once; w or g once)
   over 3.35 TB/s.

Prints ``{"kernels": [...]}`` on the line before the last and, as the last
line, ``{"ok": true, "device": {...}}``.  Any failed phase raises and the
script exits non-zero without that line; so does a machine without CUDA.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 on the tensor cores

ARCH = "hyena-153m"
BATCH, PROMPT_LEN, MAX_LEN, NEW_TOKENS = 4, 1024, 2048, 32
SEED = 0
# phase 3b: the engine's 8 mixed-length requests
ENGINE_SLOTS = 4
ENGINE_PROMPTS = (1024, 1000, 768, 512, 333, 200, 97, 1)
ENGINE_HORIZONS = (32, 8, 24, 16, 32, 12, 20, 28)
# phase 3c: the attention family at the static batch's shape
ATTN_ARCH = "phi4-mini-3.8b"

# kernel against plain version: bf16 outputs may land one bf16 ulp apart
# (2^-7 of the value) where the fp32 sums straddle a rounding boundary, and
# the gate multiply adds its own rounding; the two-level and toeplitz
# convs' TF32 products stay inside atol (derived beside
# kernels/twolevel_fft.py::TOLERANCE and kernels/toeplitz_conv.py::TOLERANCE,
# which check_twolevel and check_toeplitz hold equal); fp32 outputs differ
# only by the order of the sums.
TOLERANCE = {"float32": (1e-4, 1e-4), "bfloat16": (2.0 ** -6, 2.0 ** -10)}  # (rtol, atol)
# flash attention against its plain version: fp32 outputs differ only by
# the order of the fp32 sums; the bf16 kernel rounds p to bf16 (relative
# error 2^-8) before p·v, so it may differ by 2^-8·Σ p|v| plus each
# output's bf16 rounding: rtol 2^-6 and atol 2^-7, as derived beside
# kernels/flash_attention.py::TOLERANCE (check_flash holds the two equal)
FLASH_TOLERANCE = {"float32": (1e-5, 1e-5), "bfloat16": (2.0 ** -6, 2.0 ** -7)}
# short conv against its plain version: the kernel's fp32 sums equal the
# plain version's bit for bit (the same products, each rounded before its
# add, in the same order), so bf16 outputs agree too; the bound stated is
# one bf16 ulp (at most 2^-7 of the value)
SHORT_CONV_TOLERANCE = {"float32": (1e-6, 1e-6), "bfloat16": (2.0 ** -7, 2.0 ** -10)}
# RMSNorm against its plain version: the sum of squares is taken in another
# order (fp32); bf16 outputs may land one bf16 ulp apart
NORM_TOLERANCE = {"float32": (1e-5, 1e-5), "bfloat16": (2.0 ** -7, 2.0 ** -10)}
# served-path logits, kernel against plain version, both bf16: the conv
# outputs' one-ulp differences feed 18 bf16 residual layers; logits are
# ~N(0, 1) at init
LOGITS_ATOL, LOGITS_MEAN_ATOL = 0.5, 0.05


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_profile(fn, label: str, top: int = 8) -> None:
    """Trace ``fn`` with torch.profiler and print the device time by
    kernel name and the device's busy share of the traced wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for e in prof.key_averages():
        # device-side kernel and copy events only: a CPU op's row repeats
        # the device time of the kernels it launched
        if not str(e.device_type).endswith("CUDA"):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((us, e.count, e.key))
    busy = sum(r[0] for r in rows)
    if not busy:
        log(f"  profile {label}: device time not measured (no device events traced)")
        return
    log(f"  profile {label}: wall {wall_us / 1e3:.2f} ms, device busy {busy / 1e3:.2f} ms "
        f"({100 * busy / wall_us:.1f} %)")
    for us, n, key in sorted(rows, reverse=True)[:top]:
        log(f"    {us / 1e3:8.3f} ms  {n:5d}x  {key[:90]}")


def ptxas_report(name: str):
    """One dict per kernel instance of ``csrc/<name>.cu``, read from the
    ``-Xptxas -v`` log that ``kernels/build.py`` keeps: its function name,
    registers, static shared memory and spill bytes."""
    import re

    from repro_torch.kernels import build

    out = []
    for ln in (build.BUILD_DIR / f"{name}.log").read_text().splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", ln):
            out.append({"function": m.group(1), "registers": None, "smem": 0,
                        "spill_stores": None, "spill_loads": None})
        elif out and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)):
            out[-1]["spill_stores"], out[-1]["spill_loads"] = int(m.group(1)), int(m.group(2))
        elif out and (m := re.search(r"Used (\d+) registers", ln)):
            out[-1]["registers"] = int(m.group(1))
            if m := re.search(r"(\d+) bytes smem", ln):
                out[-1]["smem"] = int(m.group(1))
    return out


def flash_instances():
    """The flash kernel's instances from its ptxas report, each labelled
    (path, Dh, aligned) with the dynamic shared memory a block takes."""
    import re

    from repro_torch.kernels.flash_attention import _kernel

    lib, _ = _kernel("bf16")
    out = []
    for inst in ptxas_report("flash_attention"):
        if m := re.search(r"attention_kernelILi(\d+)ELb([01])E", inst["function"]):
            path, dh, aligned = "bf16", int(m.group(1)), m.group(2) == "1"
        elif m := re.search(r"flash_attention_kernelIfLi(\d+)E", inst["function"]):
            path, dh, aligned = "fp32", int(m.group(1)), None
        else:
            continue
        out.append(inst | {"path": path, "Dh": dh, "aligned": aligned,
                           "dynamic_smem": lib.flash_smem_bytes(int(path == "bf16"), dh)})
    return out


def log_flash_instances(instances) -> None:
    for i in sorted(instances, key=lambda i: (i["path"], i["Dh"], str(i["aligned"]))):
        kind = i["path"] + ("" if i["aligned"] is None else
                            (" cp.async" if i["aligned"] else " element-wise"))
        log(f"  flash instance {kind} Dh={i['Dh']}: {i['registers']} registers, "
            f"{i['dynamic_smem']} B dynamic + {i['smem']} B static shared memory, "
            f"spill stores {i['spill_stores']} B, spill loads {i['spill_loads']} B")


def twolevel_instances():
    """The two-level conv's instances from its ptxas report: the tensor-core
    path's (NT n-tiles, H given or not) and the CUDA-core path's (dtype,
    channels per block)."""
    import re

    out = []
    for inst in ptxas_report("twolevel_fft"):
        if m := re.search(r"twolevel_tc_kernelILi(\d+)ELb([01])E", inst["function"]):
            label = f"tensor cores NT={m.group(1)}" + (" H given" if m.group(2) == "1" else "")
            out.append(inst | {"path": "tc", "label": label})
        elif m := re.search(r"twolevel_fft_conv_kernelI(f|13__nv_bfloat16)Li(\d)E", inst["function"]):
            dtype = "fp32" if m.group(1) == "f" else "bf16"
            out.append(inst | {"path": "core", "label": f"CUDA cores {dtype} td={m.group(2)}"})
    return out


def toeplitz_instances():
    """The toeplitz conv's instances from its ptxas report: the tensor-core
    path's (CP padded chunk rows) and the CUDA-core fp32 kernel."""
    import re

    out = []
    for inst in ptxas_report("toeplitz_conv"):
        if m := re.search(r"toeplitz_tc_kernelILi(\d+)E", inst["function"]):
            out.append(inst | {"path": "tc", "label": f"tensor cores CP={m.group(1)}"})
        elif "toeplitz_conv_kernel" in inst["function"]:
            out.append(inst | {"path": "core", "label": "CUDA cores fp32"})
    return out


def rmsnorm_instances():
    """RMSNorm's instances from its ptxas report: the row-tile kernel's
    (dtype, V elements a chunk, NV chunks a lane) and the general kernel's."""
    import re

    out = []
    for inst in ptxas_report("rmsnorm"):
        if m := re.search(r"rmsnorm_rows_kernelI(f|13__nv_bfloat16)Li(\d+)ELi(\d+)E",
                          inst["function"]):
            dtype = "fp32" if m.group(1) == "f" else "bf16"
            out.append(inst | {"path": "rows",
                               "label": f"row tiles {dtype} V={m.group(2)} NV={m.group(3)}"})
        elif "rmsnorm_kernel" in inst["function"]:
            out.append(inst | {"path": "general", "label": "general " + inst["function"][:40]})
    return out


def log_instances(kernel, instances) -> None:
    for i in instances:
        log(f"  {kernel} instance {i['label']}: {i['registers']} registers, {i['smem']} B "
            f"static shared memory, spill stores {i['spill_stores']} B, spill loads "
            f"{i['spill_loads']} B")


def toeplitz_flops(B, L, D, C, K) -> float:
    """The chunked form's products of one toeplitz call: 2·C² operations
    (a multiply and an add) per (output chunk, chunk diagonal), batch row
    and channel, the diagonal blocks counted whole (1.02 GFLOP at B = 1,
    L = 1024, D = 864, C = 128).  The tensor-core kernel computes more: it
    pads the columns to tiles of eight and C to CP rows."""
    n = -(-L // C)
    return 2.0 * C * C * B * D * sum(min(i + 1, K) for i in range(n))


def fourstep_flops(B, L, D) -> float:
    """The dense four-step products of one two-level conv call on
    N = R·S points (R, S the default split): per column stage 1 (two real
    products R×R by R×S), stages 2 and 3 (four R×S by S×S each) and stage 4
    (two R×R by R×S), 8NR + 16NS operations, and per channel stages 1-2 on
    the taps, 4NR + 8NS.  The kernel skips stage 1's zero half and stage
    4's rows past L, so it does fewer."""
    from repro_torch.core.blockfft import resolve_factors
    from repro_torch.core.fftconv import next_fast_len

    N = next_fast_len(2 * L - 1)
    R, S = resolve_factors(N, None)
    return float(B * D * (8 * N * R + 16 * N * S) + D * (4 * N * R + 8 * N * S))


def conv_inputs(B, L, D, dtype, seed, device):
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    u = torch.randn(B, L, D, generator=g, device=device).to(dtype)
    h = torch.randn(D, L, generator=g, device=device) / L
    skip = torch.randn(D, generator=g, device=device)
    gate = torch.randn(B, L, D, generator=g, device=device).to(dtype)
    return u, h, skip, gate


def conv_bound_ms(B, L, D, dtype, *, gated=True, skip=True, spectrum_given=False,
                  band=None):
    """(ms, "bytes" or "operations"): the least time the card could take for
    one causal long-conv call, whatever the algorithm; with all chunk
    diagonals, ``toeplitz_conv`` and ``twolevel_fft_conv`` compute the same
    function.  The larger of
      bytes: u, the output and the gate (if ``gated``) in ``dtype``, skip
        (if given) in fp32, and the filter in fp32 (the taps h, D·L, or
        with ``spectrum_given`` the spectrum H, N·D complex, that
        ``launch_with_spectrum`` reads instead), each moved once, over the
        memory rate;
      operations over the fp32 rate: for the exact conv those of an FFT
        conv on N points, per row and channel a real FFT of the column and
        its inverse (2.5·N·log2 N each, half a complex radix-2 FFT's
        5·N·log2 N), the spectral product (6 per complex bin, N/2 + 1
        bins) and 4 per output (scale, skip multiply-add, gate), plus a
        real FFT per channel for the filter's spectrum unless it is given;
        for a call banded to ``band`` = (C, K) chunk diagonals, a multiply
        and an add for each (t, t') pair of the band and the same 4 per
        output."""
    import numpy as np

    from repro_torch.core.fftconv import next_fast_len

    N = next_fast_len(2 * L - 1)
    esize = 2 if str(dtype).endswith("bfloat16") else 4
    rfft = 2.5 * N * math.log2(N)
    filter_bytes = N * D * 8 if spectrum_given else D * L * 4
    nbytes = (2 + gated) * B * L * D * esize + filter_bytes + (D * 4 if skip else 0)
    if band is None:
        flops = B * D * (2 * rfft + 6 * (N // 2 + 1) + 4 * L)
        flops += 0 if spectrum_given else D * rfft
    else:
        C, K = band
        t = np.arange(L)
        # (t, t') pairs with t' <= t and t//C - t'//C < K
        first = np.maximum((t // C - K + 1) * C, 0)
        flops = B * D * (2 * int((t - first + 1).sum()) + 4 * L)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def compare(name, got, want, dtype, label, tolerance=TOLERANCE):
    """Max abs error of a kernel's output against its plain version, raised
    past the stated tolerance."""
    import torch

    torch.cuda.synchronize()
    if not torch.isfinite(got.float()).all():
        raise RuntimeError(f"{name} output not finite at {label}")
    diff = (got.float() - want.float()).abs()
    rtol, atol = tolerance[str(dtype).split(".")[-1]]
    excess = (diff - rtol * want.float().abs()).max().item()
    err = diff.max().item()
    log(f"  {name} {label}: max_abs_err={err:.3e}, beyond rtol·|plain| {excess:.2e} "
        f"(tolerance {atol:g} + {rtol:g}·|plain|)")
    if excess > atol:
        raise RuntimeError(f"{name} disagrees with its plain version at {label}")
    return err


def check_twolevel(device) -> float:
    """Phase 2, kernel 1; returns the max abs error at the served shape."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.blockfft import blockfft_causal_conv
    from repro_torch.kernels.twolevel_fft import TOLERANCE as TL_TOLERANCE
    from repro_torch.kernels.twolevel_fft import twolevel_fft_conv

    if {str(d).split(".")[-1]: t for d, t in TL_TOLERANCE.items()} != TOLERANCE:
        raise RuntimeError("TOLERANCE is not the two-level kernel module's TOLERANCE")
    cases = [
        # (B, L, D, dtype, gated, with skip)
        (BATCH, PROMPT_LEN, 864, torch.bfloat16, True, True),  # the served path
        (BATCH, PROMPT_LEN, 864, torch.bfloat16, False, True),
        (BATCH, PROMPT_LEN, 864, torch.float32, True, True),
        (BATCH, 2048, 864, torch.bfloat16, True, True),
        (BATCH, 2048, 864, torch.float32, False, False),
        (BATCH, 1000, 864, torch.float32, True, False),  # N = 2000 = 40·50
        (BATCH, 1000, 864, torch.bfloat16, False, True),
        (2, 1000, 865, torch.float32, True, True),  # ragged channel tile
        (2, 100, 5, torch.float32, True, True),  # N = 200 = 10·20
        (1, 8192, 8, torch.float32, True, True),  # the largest L taken
        (BATCH, 333, 864, torch.bfloat16, True, True),  # N = 675 = 25·27
    ]
    errs = []
    for i, (B, L, D, dtype, gated, with_skip) in enumerate(cases):
        u, h, skip, gate = conv_inputs(B, L, D, dtype, seed=100 + i, device=device)
        skip = skip if with_skip else None
        gate = gate if gated else None
        errs.append(compare(
            "twolevel_fft_conv", twolevel_fft_conv(u, h, skip, gate),
            blockfft_causal_conv(u, h, skip, gate), dtype,
            f"B={B} L={L} D={D} {str(dtype)[6:]} gate={gated} skip={with_skip}",
        ))
    # the model path's operands (models/hyena.py): u and the gate are
    # torch.split views of the projection, h is sliced from the max_len
    # grid, skip is in the compute dtype; read in place
    for dtype in (torch.bfloat16, torch.float32):
        g = torch.Generator(device=device).manual_seed(15)
        z = torch.randn(BATCH, PROMPT_LEN, 3 * 864, generator=g, device=device).to(dtype)
        u, gate, _ = torch.split(z, 864, dim=-1)
        h = (torch.randn(864, MAX_LEN, generator=g, device=device) / PROMPT_LEN)[:, :PROMPT_LEN]
        skip = torch.randn(864, generator=g, device=device).to(dtype)
        before = twolevel_fft_conv.launches
        got = twolevel_fft_conv(u, h, skip, gate)
        if twolevel_fft_conv.launches != before + 1:
            raise RuntimeError("a twolevel_fft_conv call did not launch the kernel once")
        compare("twolevel_fft_conv", got, blockfft_causal_conv(u, h, skip, gate), dtype,
                f"B={BATCH} L={PROMPT_LEN} D=864 {str(dtype)[6:]} split views, sliced h")
        same = torch.equal(got, twolevel_fft_conv(u.contiguous(), h.contiguous(), skip,
                                                  gate.contiguous()))
        gated = torch.equal(got, gate * twolevel_fft_conv(u, h, skip))
        log(f"  twolevel_fft_conv views ({str(dtype)[6:]}): equal to contiguous copies bit for "
            f"bit {same}; gated equals gate * ungated bit for bit {gated}")
        if not (same and gated):
            raise RuntimeError("twolevel_fft_conv on views differs from contiguous copies")
        if dtype == torch.bfloat16:
            # one device kernel: no copy of a view, no plain-torch transform of h
            twolevel_fft_conv(u, h, skip, gate)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                twolevel_fft_conv(u, h, skip, gate)
                torch.cuda.synchronize()
            kernels = [e.key for e in prof.key_averages()
                       if str(e.device_type).endswith("CUDA") and e.count]
            log(f"  device kernels of one call on the model path's operands: {kernels}")
            if kernels and (len(kernels) != 1 or "twolevel_tc_kernel" not in kernels[0]):
                raise RuntimeError("the model path's call ran more than the tensor-core kernel")
    # the wrapper raises on what the kernel does not take
    u, h, _, _ = conv_inputs(1, 8193, 2, torch.float32, seed=1, device=device)
    try:
        twolevel_fft_conv(u, h)
    except ValueError as e:
        log(f"  L=8193 refused: {e}")
    else:
        raise RuntimeError("kernel accepted L > 8192")
    return errs[0]


def check_toeplitz(device) -> float:
    """Phase 2, kernel 2; returns the max abs error at the engine's
    admission shape (B=1, L=1024, bf16, gated, skip)."""
    import torch

    from repro_torch.kernels.toeplitz_conv import TOLERANCE as TT_TOLERANCE
    from repro_torch.kernels.toeplitz_conv import toeplitz_conv, toeplitz_conv_plain

    if {str(d).split(".")[-1]: t for d, t in TT_TOLERANCE.items()} != TOLERANCE:
        raise RuntimeError("TOLERANCE is not the toeplitz kernel module's TOLERANCE")
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        # (B, L, D, dtype, gated, with skip, n_chunk_diags, chunk)
        (1, 1024, 864, bf16, True, True, None, 128),  # an admission
        (1, 1024, 864, f32, False, True, None, 128),
        (4, 1024, 864, bf16, True, True, None, 128),
        (4, 1024, 864, f32, True, False, None, 128),
        (1, 1000, 864, bf16, True, True, None, 128),  # L not a multiple of C
        (1, 1000, 864, f32, False, False, None, 128),
        (1, 37, 864, bf16, True, True, None, 128),  # L < C
        (1, 37, 864, f32, True, False, None, 128),
        (1, 97, 864, bf16, True, True, None, 128),  # one chunk padded to 128 rows
        (1, 1, 864, bf16, True, True, None, 128),  # L = 1
        (1, 1, 864, f32, False, True, None, 128),
        (2, 300, 865, f32, True, True, 2, 128),  # banded, ragged tile
        (2, 300, 865, bf16, False, False, 2, 128),
        (4, 2048, 864, bf16, True, True, None, 128),  # 64 columns, 16 diagonals
        (4, 2048, 864, f32, True, True, None, 128),
        (1, 2048, 864, bf16, True, True, None, 256),  # two row strips a channel
        (2, 1000, 865, bf16, False, True, None, 256),
        (2, 1000, 865, bf16, True, True, None, 64),  # 16 columns a batch row
        (1, 1024, 864, bf16, True, False, 3, 64),
    ]
    errs = []
    for i, (B, L, D, dtype, gated, with_skip, K, chunk) in enumerate(cases):
        u, h, skip, gate = conv_inputs(B, L, D, dtype, seed=200 + i, device=device)
        skip = skip if with_skip else None
        gate = gate if gated else None
        errs.append(compare(
            "toeplitz_conv", toeplitz_conv(u, h, skip, gate, chunk=chunk, n_chunk_diags=K),
            toeplitz_conv_plain(u, h, skip, gate, chunk=chunk, n_chunk_diags=K), dtype,
            f"B={B} L={L} D={D} {str(dtype)[6:]} gate={gated} skip={with_skip} K={K} "
            f"chunk={chunk}",
        ))
    # the model path's operands: torch.split views and the max_len filter
    # sliced to L, read in place
    g = torch.Generator(device=device).manual_seed(7)
    for B in (1, 4):
        z = torch.randn(B, PROMPT_LEN, 3 * 864, generator=g, device=device).bfloat16()
        h = torch.randn(864, MAX_LEN, generator=g, device=device)[:, :PROMPT_LEN] / PROMPT_LEN
        u, gate, skip = z[..., :864], z[..., 864:1728], torch.randn(864, device=device)
        fused = toeplitz_conv(u, h, skip, gate)
        compare("toeplitz_conv", fused,
                toeplitz_conv_plain(u.contiguous(), h.contiguous(), skip, gate.contiguous()),
                torch.bfloat16, f"B={B} L=1024 D=864 bfloat16 views of the projection")
        if not torch.equal(fused, gate * toeplitz_conv(u, h, skip)):
            raise RuntimeError("toeplitz_conv: gated output is not gate * ungated")
    log("  toeplitz_conv: gated output equals gate * ungated bit for bit")
    for bad, kw in ((u.half(), {}), (u, {"chunk": 512})):
        try:
            toeplitz_conv(bad, h, **kw)
        except ValueError as e:
            log(f"  refused: {e}")
        else:
            raise RuntimeError("toeplitz_conv accepted what it does not take")
    return errs[0]


def flash_flops(B, H, Lq, Lk, Dh, *, causal=True, window=None, q_offset=None) -> float:
    """4·Dh operations (q·kᵀ and p·v, a multiply and an add each) per
    visible (query, key) pair and head, counted for this call's mask."""
    import numpy as np

    qpos = np.arange(Lq) + (Lk - Lq if q_offset is None else q_offset)
    hi = np.minimum(qpos + 1, Lk) if causal else np.full(Lq, Lk)
    lo = np.maximum(qpos - window + 1, 0) if window is not None else np.zeros(Lq, int)
    return 4.0 * Dh * B * H * int(np.maximum(hi - lo, 0).sum())


def flash_bound_ms(B, H, Hkv, Lq, Lk, Dh, dtype, *, causal=True, window=None,
                   q_offset=None):
    """(ms, "bytes" or "operations"): the least time the card could take for
    one attention call.  The larger of
      bytes: q and o (B·H·Lq·Dh each) and k and v (B·Hkv·Lk·Dh each) in
        ``dtype``, each moved once, over the memory rate;
      operations: 4·Dh per visible (query, key) pair and head (q·kᵀ and
        p·v, a multiply and an add each), counted for this call's mask,
        over the tensor cores' bf16 rate (the fp32 rate for fp32 inputs)."""
    esize = 2 if str(dtype).endswith("bfloat16") else 4
    nbytes = 2 * B * Dh * esize * (H * Lq + Hkv * Lk)
    flops = flash_flops(B, H, Lq, Lk, Dh, causal=causal, window=window, q_offset=q_offset)
    peak = PEAK_BF16_FLOPS if esize == 2 else PEAK_FP32_FLOPS
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_flash(device) -> float:
    """Phase 2, kernel 3; returns the max abs error at phi4-mini's served
    shape (B=4, H=24, Hkv=8, L=1024, Dh=128, bf16)."""
    import torch

    from repro_torch.kernels.flash_attention import TOLERANCE, flash_attention
    from repro_torch.kernels.flash_attention import flash_attention_plain, rows_aligned16

    if {str(d).split(".")[-1]: t for d, t in TOLERANCE.items()} != FLASH_TOLERANCE:
        raise RuntimeError("FLASH_TOLERANCE is not the kernel module's TOLERANCE")
    cases = [
        # (B, H, Hkv, Lq, Lk, Dh, dtype, window, causal)
        (BATCH, 24, 8, PROMPT_LEN, PROMPT_LEN, 128, torch.bfloat16, None, True),  # served
        (BATCH, 24, 8, PROMPT_LEN, PROMPT_LEN, 128, torch.float32, None, True),
        (2, 8, 8, 512, 512, 128, torch.bfloat16, None, True),  # MHA
        (2, 8, 8, 512, 512, 128, torch.float32, None, True),
        (2, 8, 1, 300, 300, 128, torch.bfloat16, None, True),  # MQA, ragged L
        (2, 8, 1, 300, 300, 128, torch.float32, None, True),
        (2, 4, 2, 256, 256, 64, torch.bfloat16, None, True),  # Dh 64
        (2, 4, 2, 256, 256, 64, torch.float32, None, True),
        (1, 10, 1, 1000, 1000, 256, torch.bfloat16, None, True),  # Dh 256, ragged L
        (1, 10, 1, 1000, 1000, 256, torch.float32, None, True),
        (2, 8, 2, PROMPT_LEN, PROMPT_LEN, 128, torch.bfloat16, 100, True),  # window < L
        (1, 4, 1, 600, 600, 256, torch.float32, 128, True),
        (2, 24, 8, 1, 1000, 128, torch.bfloat16, None, True),  # decode offsets
        (2, 24, 8, 7, 1000, 128, torch.float32, None, True),
        (2, 24, 8, 7, 1000, 128, torch.bfloat16, None, True),
        (1, 4, 2, 100, 40, 64, torch.float32, None, True),  # 60 rows see no key
        (1, 4, 2, 70, 90, 128, torch.bfloat16, 33, False),  # no causal mask
        # the edges of the bf16 kernel's 64-key tiles (32 at Dh = 256)
        (1, 4, 2, 200, 333, 128, torch.bfloat16, None, True),  # Lk % 64 != 0, Lq != Lk
        (1, 4, 2, 512, 512, 128, torch.bfloat16, 40, True),  # window ends inside a tile
        (1, 4, 2, 512, 512, 64, torch.bfloat16, None, True),  # Dh 64 at L = 512
        (1, 4, 1, 512, 512, 256, torch.bfloat16, None, True),  # Dh 256 at L = 512
        (1, 4, 2, 130, 50, 128, torch.bfloat16, None, True),  # 80 rows see no key
    ]
    errs = []
    for i, (B, H, Hkv, Lq, Lk, Dh, dtype, window, causal) in enumerate(cases):
        g = torch.Generator(device=device).manual_seed(300 + i)
        q = torch.randn(B, H, Lq, Dh, generator=g, device=device).to(dtype)
        k = torch.randn(B, Hkv, Lk, Dh, generator=g, device=device).to(dtype)
        v = torch.randn(B, Hkv, Lk, Dh, generator=g, device=device).to(dtype)
        got = flash_attention(q, k, v, causal=causal, window=window)
        errs.append(compare(
            "flash_attention", got,
            flash_attention_plain(q, k, v, causal=causal, window=window), dtype,
            f"B={B} H={H} Hkv={Hkv} Lq={Lq} Lk={Lk} Dh={Dh} {str(dtype)[6:]} "
            f"window={window} causal={causal}", FLASH_TOLERANCE,
        ))
        if Lq > Lk and got[:, :, : Lq - Lk].any():
            raise RuntimeError("flash_attention: a row that sees no key is not 0")
    # the mixer's operands: (B, L, H, Dh) projections transposed, read in place
    g = torch.Generator(device=device).manual_seed(9)
    H, Hkv, Dh = 24, 8, 128
    qkv = torch.randn(BATCH, PROMPT_LEN, (H + 2 * Hkv) * Dh, generator=g, device=device).bfloat16()
    q, k, v = (x.view(BATCH, PROMPT_LEN, -1, Dh).transpose(1, 2)
               for x in qkv.split([H * Dh, Hkv * Dh, Hkv * Dh], dim=-1))
    compare("flash_attention", flash_attention(q, k, v, q_offset=3),
            flash_attention_plain(q.contiguous(), k.contiguous(), v.contiguous(), q_offset=3),
            torch.bfloat16, f"B=4 L=1024 bf16 transposed views, q_offset=3, rows on 16 bytes "
            f"{rows_aligned16(q, k, v)}", FLASH_TOLERANCE)
    # rows that start off 16 bytes (the element-wise instance): the split of a
    # projection one element wider, sliced past its first element
    wide = torch.randn(2, 300, (H + 2 * Hkv) * Dh + 1, generator=g, device=device).bfloat16()
    q, k, v = (x.unflatten(-1, (-1, Dh)).transpose(1, 2)
               for x in wide[..., 1:].split([H * Dh, Hkv * Dh, Hkv * Dh], dim=-1))
    if rows_aligned16(q, k, v):
        raise RuntimeError("a view off 16 bytes was taken for aligned")
    compare("flash_attention", flash_attention(q, k, v, window=100),
            flash_attention_plain(q.contiguous(), k.contiguous(), v.contiguous(), window=100),
            torch.bfloat16, "B=2 L=300 bf16 views off 16 bytes, window=100", FLASH_TOLERANCE)
    for bad in ((q[..., :96], k[..., :96], v[..., :96]), (q[:, :23], k, v)):
        try:
            flash_attention(*bad)
        except ValueError as e:
            log(f"  refused: {e}")
        else:
            raise RuntimeError("flash_attention accepted what it does not take")
    return errs[0]


def short_conv_inputs(B, L, D, K, dtype, seed, device, w_dtype=None):
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    u = torch.randn(B, L, D, generator=g, device=device).to(dtype)
    w = (torch.randn(D, K, generator=g, device=device) / K ** 0.5).to(w_dtype or torch.float32)
    gate = torch.randn(B, L, D, generator=g, device=device).to(dtype)
    return u, w, gate


def short_conv_bound_ms(B, L, D, K, dtype, *, gated, w_dtype=None):
    """(ms, "bytes" or "operations"): the least time of one short conv
    call.  The larger of
      bytes: u, the output and the gate (if ``gated``) in ``dtype`` and w
        (D·K) in its dtype, each moved once, over the memory rate;
      operations: a multiply and an add per tap and output, and a multiply
        for the gate, over the fp32 rate."""
    esize = 2 if str(dtype).endswith("bfloat16") else 4
    wsize = 2 if str(w_dtype).endswith("bfloat16") else 4
    nbytes = (2 + gated) * B * L * D * esize + D * K * wsize
    flops = B * L * D * (2 * K + gated)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def rmsnorm_bound_ms(rows, D, dtype, g_dtype):
    """(ms, "bytes" or "operations"): the least time of one RMSNorm call.
    The larger of
      bytes: x and y (rows·D) in ``dtype`` and g (D) in ``g_dtype``, each
        moved once, over the memory rate;
      operations: per element a square and an add, a scale, 1 + g and a
        multiply, over the fp32 rate."""
    esize = 2 if str(dtype).endswith("bfloat16") else 4
    gsize = 2 if str(g_dtype).endswith("bfloat16") else 4
    nbytes = 2 * rows * D * esize + D * gsize
    flops = 5 * rows * D
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_short_conv(device) -> float:
    """Phase 2, kernel 4; returns the max abs error at hyena-153m's
    projection (B=4, L=1024, 2592 channels, K=3, bf16, gated)."""
    import torch

    from repro_torch.kernels.short_conv import short_conv_gate, short_conv_gate_plain

    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        # (B, L, D, K, dtype, gated, w dtype)
        (BATCH, PROMPT_LEN, 2592, 3, bf16, True, f32),  # hyena-153m's projection
        (BATCH, PROMPT_LEN, 2592, 3, bf16, False, f32),
        (BATCH, PROMPT_LEN, 2592, 3, f32, True, f32),
        (2, 300, 2592, 1, bf16, True, f32),  # K = 1
        (2, 300, 2592, 4, f32, False, f32),  # K = 4
        (2, 300, 2592, 4, bf16, True, f32),
        (2, 5, 64, 8, bf16, True, bf16),  # K = 8, L < K - 1, bf16 w
        (3, 1, 2592, 3, bf16, True, f32),  # L = 1
        (2, 100, 33, 3, f32, True, f32),  # ragged D
        (2, 100, 33, 3, bf16, False, bf16),
    ]
    errs = []
    for i, (B, L, D, K, dtype, gated, w_dtype) in enumerate(cases):
        u, w, gate = short_conv_inputs(B, L, D, K, dtype, 400 + i, device, w_dtype)
        gate = gate if gated else None
        errs.append(compare(
            "short_conv_gate", short_conv_gate(u, w, gate), short_conv_gate_plain(u, w, gate),
            dtype, f"B={B} L={L} D={D} K={K} {str(dtype)[6:]} gate={gated} "
            f"w={str(w_dtype)[6:]}", SHORT_CONV_TOLERANCE,
        ))
    # views of a wider projection and a transposed w, read in place
    g = torch.Generator(device=device).manual_seed(11)
    z = torch.randn(BATCH, PROMPT_LEN, 3 * 864, generator=g, device=device).bfloat16()
    u, gate = z[..., :864], z[..., 864:1728]
    w = torch.randn(3, 864, generator=g, device=device).t()
    compare("short_conv_gate", short_conv_gate(u, w, gate),
            short_conv_gate_plain(u.contiguous(), w.contiguous(), gate.contiguous()),
            torch.bfloat16, "B=4 L=1024 D=864 bfloat16 views of a projection, w transposed",
            SHORT_CONV_TOLERANCE)
    before = short_conv_gate.launches
    for bad_u, bad_w in ((u.half(), w), (u.transpose(1, 2).contiguous().transpose(1, 2), w),
                         (u, torch.randn(864, 9, device=device))):
        try:
            short_conv_gate(bad_u, bad_w)
        except ValueError as e:
            log(f"  refused: {e}")
        else:
            raise RuntimeError("short_conv_gate accepted what it does not take")
    if short_conv_gate.launches != before:
        raise RuntimeError("a refused short_conv_gate call counted a launch")
    return errs[0]


def check_rmsnorm(device) -> float:
    """Phase 2, kernel 5; returns the max abs error at hyena-153m's rows
    (4, 1024, 864) in bf16."""
    import torch

    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_plain

    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        # (shape, dtype, g dtype)
        ((BATCH, PROMPT_LEN, 864), bf16, f32),  # hyena-153m
        ((BATCH, PROMPT_LEN, 3072), bf16, f32),  # phi4-mini-3.8b
        ((BATCH, PROMPT_LEN, 864), f32, f32),
        ((BATCH, PROMPT_LEN, 3072), f32, bf16),
        ((1, 3072), bf16, bf16),  # one row
        ((3, 7, 5), f32, f32),  # D = 5
        ((17, 1), bf16, f32),  # D = 1
        ((2, 3, 4, 864), bf16, f32),  # 4-D
        ((3, 8192), f32, f32),  # qwen2-72b's d_model
        ((3, 8192), bf16, f32),
    ]
    errs = []
    for i, (shape, dtype, g_dtype) in enumerate(cases):
        gen = torch.Generator(device=device).manual_seed(500 + i)
        x = torch.randn(shape, generator=gen, device=device).to(dtype)
        x.view(-1, shape[-1])[0] = 0
        g = (0.5 * torch.randn(shape[-1], generator=gen, device=device)).to(g_dtype)
        got = rmsnorm(x, g)
        errs.append(compare("rmsnorm", got, rmsnorm_plain(x, g), dtype,
                            f"x {shape} {str(dtype)[6:]} g {str(g_dtype)[6:]}", NORM_TOLERANCE))
        if got.view(-1, shape[-1])[0].any():
            raise RuntimeError("rmsnorm: a row of zeros does not give zeros")
    # rows of a wider tensor, read through their row stride: 16-byte aligned
    # (128-bit loads) and not (one element at a time)
    gen = torch.Generator(device=device).manual_seed(12)
    wide = torch.randn(BATCH, PROMPT_LEN, 1000, generator=gen, device=device).bfloat16()
    g = torch.randn(864, generator=gen, device=device)
    for start in (0, 1):
        x = wide[..., start:start + 864]
        compare("rmsnorm", rmsnorm(x, g, eps=1e-5), rmsnorm_plain(x.contiguous(), g, eps=1e-5),
                torch.bfloat16, f"x (4, 1024, 864) bfloat16 rows of stride 1000 from element "
                f"{start}, eps 1e-5", NORM_TOLERANCE)
    before = rmsnorm.launches
    for bad_x, bad_g in ((x.half(), g), (x.transpose(1, 2), torch.zeros(PROMPT_LEN, device=device)),
                         (x, g.half())):
        try:
            rmsnorm(bad_x, bad_g)
        except ValueError as e:
            log(f"  refused: {e}")
        else:
            raise RuntimeError("rmsnorm accepted what it does not take")
    if rmsnorm.launches != before:
        raise RuntimeError("a refused rmsnorm call counted a launch")
    return errs[0]


def conv1d_short_conv(u, w_flipped, gate):
    """The short conv as ``F.conv1d`` over channels-first views with causal
    padding, then the gate in u's dtype (a yardstick: the port never calls
    it).  ``w_flipped`` is (D, 1, K), the taps reversed, in u's dtype."""
    import torch.nn.functional as F

    K = w_flipped.shape[-1]
    y = F.conv1d(u.transpose(1, 2), w_flipped, padding=K - 1, groups=u.shape[-1])
    y = y[..., : u.shape[1]].transpose(1, 2)
    return y if gate is None else y * gate


def cold_ms(fn, arg_sets, iters: int = 24, warmup: int = 3) -> float:
    """``cuda_ms`` of ``fn(*args)`` with each call on the next of
    ``arg_sets``, whose bytes together exceed the L2 cache."""
    calls = [0]

    def step():
        fn(*arg_sets[calls[0] % len(arg_sets)])
        calls[0] += 1

    return cuda_ms(step, iters=iters, warmup=warmup)


def kernel_device_ms(fn, arg_sets, kernel_name, iters: int = 24):
    """Device time per launch of the kernels whose name holds
    ``kernel_name``, traced by torch.profiler over ``iters`` calls of
    ``fn`` cycling over ``arg_sets``; with ``kernel_name`` None, the device
    time of every kernel a call runs, per call.  None where the trace holds
    no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn(*arg_sets[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
        torch.cuda.synchronize()
    us, n = 0.0, 0
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA") and (kernel_name is None or kernel_name in e.key):
            us += (getattr(e, "self_device_time_total", None)
                   or getattr(e, "self_cuda_time_total", 0))
            n += e.count
    if kernel_name is None:
        n = iters if n else 0
    return us / n / 1e3 if n and us else None


def swapped_attention(fn, run):
    """``run()`` with ``kernels.ops.flash_attention`` replaced by ``fn`` in
    this process only: the kernel's plain version for a comparison, or the
    library yardstick for a timing."""
    from repro_torch.kernels import ops

    dispatch = ops.flash_attention
    ops.flash_attention = fn
    try:
        return run()
    finally:
        ops.flash_attention = dispatch


def sdpa_prefill_attention(q, k, v, *, causal=True, window=None, scale=None, q_offset=None):
    """``scaled_dot_product_attention`` in the flash kernel's place, for the
    causal prefill of a global-attention model only (a yardstick: the port
    never calls it)."""
    import torch

    if not causal or window is not None or q.shape[2] != k.shape[2] or q_offset:
        raise ValueError("the yardstick takes a causal prefill without a window or offset")
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True, scale=scale, enable_gqa=True)


def pool_is_free(cfg, pool) -> bool:
    from repro_torch.models import lm

    return all(
        not leaf.any().item()
        for axes, layer in zip(lm.cache_slot_axes(cfg, pool), pool)
        for k, leaf in layer.items() if axes[k] >= 0
    )


def serve_engine(params, cfg, scfg, prompts, timed=False):
    """Run the 8 requests through a fresh ServeEngine to the end of drain();
    returns (engine, tokens per request, times).  With ``timed``, each
    admission prefill and each pooled decode quantum is timed on the host
    clock (both end in a device-to-host copy of the sampled tokens)."""
    from repro_torch.serve.engine import ServeEngine

    eng = ServeEngine(params, cfg, scfg)
    times = {"prefill": [], "decode": []}
    if timed:
        for name, attr in (("prefill", "prefill_into_slot"), ("decode", "decode_active")):
            fn = getattr(eng, attr)

            def wrapped(*args, _fn=fn, _t=times[name]):
                t0 = time.perf_counter()
                out = _fn(*args)
                _t.append(time.perf_counter() - t0)
                return out

            setattr(eng, attr, wrapped)
    rids = [eng.submit(p.cpu().numpy(), max_new_tokens=n)
            for p, n in zip(prompts, ENGINE_HORIZONS)]
    t0 = time.perf_counter()
    out = eng.drain()
    times["wall"] = time.perf_counter() - t0
    return eng, [out[r] for r in rids], times


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.common.policy import Policy
    from repro_torch.configs import get_config
    from repro_torch.core.blockfft import blockfft_causal_conv, filter_spectrum, resolve_factors
    from repro_torch.core.fftconv import fft_causal_conv, next_fast_len
    from repro_torch.core.conv_api import ConvBackend, register_conv_backend
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_plain
    from repro_torch.kernels.short_conv import short_conv_gate, short_conv_gate_plain
    from repro_torch.kernels.toeplitz_conv import chunking, toeplitz_conv, toeplitz_conv_plain
    from repro_torch.kernels.toeplitz_conv import tc_launch_shape
    from repro_torch.kernels.twolevel_fft import MAX_N as TWOLEVEL_MAX_N
    from repro_torch.kernels.twolevel_fft import launch_with_spectrum
    from repro_torch.kernels.twolevel_fft import tc_launch_shape as twolevel_launch_shape
    from repro_torch.kernels.twolevel_fft import twolevel_fft_conv
    from repro_torch.models import lm
    from repro_torch.models.mixer_api import ApplyContext
    from repro_torch.serve.engine import ServeConfig, generate

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()

    # ---- phase 1: build
    log("phase 1: build")
    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"  built {sorted(libs)} for sm_90a in {time.perf_counter() - t0:.1f} s")
    for name in libs:
        ptxas = [ln for ln in (build.BUILD_DIR / f"{name}.log").read_text().splitlines()
                 if "registers" in ln or "spill" in ln]
        for ln in ptxas:
            log(f"  ptxas {name}: {ln.strip()}")
    flash_inst = flash_instances()
    bf16_inst = [i for i in flash_inst if i["path"] == "bf16"]
    spills = [i for i in bf16_inst if i["spill_stores"] or i["spill_loads"]]
    if len(bf16_inst) != 6 or spills:
        raise RuntimeError(f"the six bf16 flash instances must build without spills: {spills}")
    tl_inst = twolevel_instances()
    tc_inst = [i for i in tl_inst if i["path"] == "tc"]
    spills = [i["label"] for i in tc_inst if i["spill_stores"] or i["spill_loads"]]
    if len(tc_inst) != 16 or spills:
        raise RuntimeError(f"the 16 tensor-core two-level instances must build without "
                           f"spills: {spills}")
    tt_inst, rn_inst = toeplitz_instances(), rmsnorm_instances()
    log_instances("toeplitz", tt_inst)
    log_instances("rmsnorm", rn_inst)
    for kernel, insts, path, want in (("toeplitz", tt_inst, "tc", 5),
                                      ("rmsnorm", rn_inst, "rows", 24)):
        mine = [i for i in insts if i["path"] == path]
        spills = [i["label"] for i in mine if i["spill_stores"] or i["spill_loads"]]
        if len(mine) != want or spills:
            raise RuntimeError(f"the {want} {kernel} {path} instances must build without "
                               f"spills: {len(mine)} built, spilling {spills}")
    log(f"  card: {card}")
    log("  torch.backends.cuda.matmul.allow_tf32 = False (fp32 matmuls in full fp32)")

    # ---- phase 2: kernel against its plain version
    log("phase 2: kernels against their plain versions on the card")
    served_err = check_twolevel(device)
    toeplitz_err = check_toeplitz(device)
    flash_err = check_flash(device)
    short_conv_err = check_short_conv(device)
    norm_err = check_rmsnorm(device)

    def zero_counts():
        twolevel_fft_conv.launches = toeplitz_conv.launches = flash_attention.launches = 0
        short_conv_gate.launches = rmsnorm.launches = 0

    # ---- phase 3: the served path
    log(f"phase 3: {ARCH} at full width, generate() with blockfft_overlap, bf16")
    cfg = get_config(ARCH)
    params = lm.init_lm(cfg, seed=SEED, device=device)
    g = torch.Generator(device=device).manual_seed(SEED + 1)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT_LEN), generator=g, device=device)
    scfg = ServeConfig(max_len=MAX_LEN, conv_backend="blockfft_overlap")
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    tokens = generate(params, cfg, prompts, scfg=scfg, max_new_tokens=NEW_TOKENS)
    torch.cuda.synchronize()
    first_call_s = time.perf_counter() - t0
    launches = twolevel_fft_conv.launches
    other = (toeplitz_conv.launches + flash_attention.launches + short_conv_gate.launches
             + rmsnorm.launches)
    want_launches = cfg.n_layers * cfg.hyena_order
    log(f"  generate: tokens {tuple(tokens.shape)}, twolevel_fft_conv launches "
        f"{launches} (expected {want_launches}), other kernels' launches {other}, "
        f"first call {first_call_s:.2f} s")
    if launches != want_launches or other:
        raise RuntimeError(f"prefill launched the kernel {launches} times, not {want_launches}")
    if tuple(tokens.shape) != (BATCH, NEW_TOKENS) or not (
        (tokens >= 0).all() and (tokens < cfg.vocab_size).all()
    ):
        raise RuntimeError("generate returned malformed tokens")

    cast = Policy().cast_compute(params)

    def prefill(backend):
        return lm.prefill(cast, cfg, prompts, MAX_LEN, dtype=torch.bfloat16,
                          ctx=ApplyContext(conv_backend=backend))

    with torch.no_grad():
        logits_k, caches = prefill("blockfft_overlap")
        logits_p, _ = prefill("blockfft")
        logits_f, _ = prefill("fft")
    torch.cuda.synchronize()
    last_k, last_p, last_f = (x[:, -1].float() for x in (logits_k, logits_p, logits_f))
    if not torch.isfinite(logits_k).all():
        raise RuntimeError("prefill logits are not finite")
    d = (last_k - last_p).abs()
    d_lib = (last_f - last_p).abs()
    log(f"  last-token logits, kernel vs plain blockfft: max_abs {d.max().item():.4f} "
        f"mean_abs {d.mean().item():.5f} (tolerance {LOGITS_ATOL} / {LOGITS_MEAN_ATOL}); "
        f"torch.fft vs plain for scale: max_abs {d_lib.max().item():.4f} "
        f"mean_abs {d_lib.mean().item():.5f}; |logits| max {last_p.abs().max().item():.3f}")
    if d.max().item() > LOGITS_ATOL or d.mean().item() > LOGITS_MEAN_ATOL:
        raise RuntimeError("served-path logits disagree with the plain version")
    agree = (last_k.argmax(-1) == tokens[:, 0]).all().item()
    log(f"  greedy first token of generate() equals argmax of the prefill logits: {agree}")
    if not agree:
        raise RuntimeError("generate's first token is not the prefill argmax")

    # ---- phase 3b: the continuous-batching engine on the toeplitz kernel
    log(f"phase 3b: {ARCH} at full width, ServeEngine with toeplitz, bf16, "
        f"{len(ENGINE_PROMPTS)} greedy requests on {ENGINE_SLOTS} slots")
    # the kernel's plain version as a backend, for the logits comparison
    register_conv_backend(ConvBackend(
        name="toeplitz_plain", fn=toeplitz_conv_plain, supports_gate=True,
        description="plain PyTorch version of the toeplitz kernel",
    ))
    g = torch.Generator(device=device).manual_seed(SEED + 2)
    eprompts = [torch.randint(0, cfg.vocab_size, (n,), generator=g, device=device)
                for n in ENGINE_PROMPTS]
    escfg = ServeConfig(max_len=MAX_LEN, n_slots=ENGINE_SLOTS, conv_backend="toeplitz")
    torch.cuda.synchronize()
    zero_counts()
    eng, etokens, etimes = serve_engine(params, cfg, escfg, eprompts)
    torch.cuda.synchronize()
    t_launches = toeplitz_conv.launches
    other = (twolevel_fft_conv.launches + flash_attention.launches + short_conv_gate.launches
             + rmsnorm.launches)
    want_t = cfg.n_layers * cfg.hyena_order * len(ENGINE_PROMPTS)
    statuses = sorted({r.status for r in eng.request_results().values()})
    log(f"  drain: {len(eng.request_results())} requests, statuses {statuses}, "
        f"toeplitz_conv launches {t_launches} (expected {want_t} = "
        f"{cfg.n_layers * cfg.hyena_order} per admission), other kernels' launches "
        f"{other}, quarantined {eng.health()['quarantined']}, first run {etimes['wall']:.2f} s")
    if statuses != ["completed"] or len(eng.request_results()) != len(ENGINE_PROMPTS):
        raise RuntimeError(f"engine requests ended {statuses}")
    if t_launches != want_t or other:
        raise RuntimeError(f"the engine launched toeplitz_conv {t_launches} times, not {want_t}")
    for toks, n in zip(etokens, ENGINE_HORIZONS):
        if len(toks) != n or toks.min() < 0 or toks.max() >= cfg.vocab_size:
            raise RuntimeError("the engine returned malformed tokens")
    free = pool_is_free(cfg, eng.pool)
    log(f"  every per-slot cache leaf of the pool is zero after the drain: {free}")
    if not free:
        raise RuntimeError("the pool holds state after the drain")
    with torch.no_grad():
        one = eprompts[0][None]
        lk, _ = lm.prefill(cast, cfg, one, MAX_LEN, dtype=torch.bfloat16,
                           ctx=ApplyContext(conv_backend="toeplitz"))
        lp, _ = lm.prefill(cast, cfg, one, MAX_LEN, dtype=torch.bfloat16,
                           ctx=ApplyContext(conv_backend="toeplitz_plain"))
    lk, lp = lk[:, -1].float(), lp[:, -1].float()
    d = (lk - lp).abs()
    log(f"  last-token logits of a {ENGINE_PROMPTS[0]}-token admission, toeplitz kernel vs "
        f"its plain version: max_abs {d.max().item():.4f} mean_abs {d.mean().item():.5f} "
        f"(tolerance {LOGITS_ATOL} / {LOGITS_MEAN_ATOL}); |logits| max {lp.abs().max().item():.3f}")
    if not torch.isfinite(lk).all() or d.max().item() > LOGITS_ATOL or d.mean().item() > LOGITS_MEAN_ATOL:
        raise RuntimeError("engine prefill logits disagree with the plain version")
    if int(lk.argmax(-1)) != int(etokens[0][0]):
        raise RuntimeError("the engine's first token is not the prefill argmax")
    escfg32 = dataclasses.replace(escfg, cache_dtype=torch.float32)
    _, tok32, _ = serve_engine(params, cfg, escfg32, eprompts)
    same = 0
    for toks, p, n in zip(tok32, eprompts, ENGINE_HORIZONS):
        want = generate(params, cfg, p[None], scfg=escfg32, max_new_tokens=n)[0].cpu().numpy()
        same += int(np.array_equal(toks, want))
    log(f"  fp32: engine tokens identical to per-request generate() for {same} of "
        f"{len(ENGINE_PROMPTS)} requests")
    if same != len(ENGINE_PROMPTS):
        raise RuntimeError("fp32 engine tokens differ from per-request generate()")

    # ---- phase 3c: the attention family on the flash kernel
    acfg = get_config(ATTN_ARCH)
    log(f"phase 3c: {ATTN_ARCH} at full width ({acfg.n_layers} layers, D={acfg.d_model}, "
        f"H={acfg.n_heads}, Hkv={acfg.n_kv_heads}, Dh={acfg.head_dim}, {acfg.mlp} "
        f"d_ff={acfg.d_ff}, vocab {acfg.vocab_size}), generate() in bf16")
    aparams = lm.init_lm(acfg, seed=SEED, device=device)
    g = torch.Generator(device=device).manual_seed(SEED + 3)
    aprompts = torch.randint(0, acfg.vocab_size, (BATCH, PROMPT_LEN), generator=g, device=device)
    ascfg = ServeConfig(max_len=MAX_LEN)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    atokens = generate(aparams, acfg, aprompts, scfg=ascfg, max_new_tokens=NEW_TOKENS)
    torch.cuda.synchronize()
    a_first_s = time.perf_counter() - t0
    f_launches = flash_attention.launches
    other = (twolevel_fft_conv.launches + toeplitz_conv.launches + short_conv_gate.launches
             + rmsnorm.launches)
    log(f"  generate: tokens {tuple(atokens.shape)}, flash_attention launches {f_launches} "
        f"(expected {acfg.n_layers}), other kernels' launches {other}, first call "
        f"{a_first_s:.2f} s")
    if f_launches != acfg.n_layers or other:
        raise RuntimeError(f"the attention path launched flash_attention {f_launches} times "
                           f"and other kernels {other} times, "
                           f"not {acfg.n_layers}")
    if tuple(atokens.shape) != (BATCH, NEW_TOKENS) or not (
        (atokens >= 0).all() and (atokens < acfg.vocab_size).all()
    ):
        raise RuntimeError("generate returned malformed tokens")
    acast = Policy().cast_compute(aparams)

    def aprefill():
        return lm.prefill(acast, acfg, aprompts, MAX_LEN, dtype=torch.bfloat16)

    with torch.no_grad():
        zero_counts()
        alogits, acaches = aprefill()
        torch.cuda.synchronize()
        bare = flash_attention.launches
        alast_k = alogits[:, -1].float()
        del alogits
        alogits, _ = swapped_attention(flash_attention_plain, aprefill)
        alast_p = alogits[:, -1].float()
        del alogits
    torch.cuda.synchronize()
    log(f"  a bare prefill launched flash_attention {bare} times (expected {acfg.n_layers})")
    if bare != acfg.n_layers:
        raise RuntimeError("the prefill did not launch flash_attention once per layer")
    if not torch.isfinite(alast_k).all():
        raise RuntimeError("phi4-mini prefill logits are not finite")
    d = (alast_k - alast_p).abs()
    log(f"  last-token logits, kernel vs its plain version: max_abs {d.max().item():.4f} "
        f"mean_abs {d.mean().item():.5f} (tolerance {LOGITS_ATOL} / {LOGITS_MEAN_ATOL}); "
        f"|logits| max {alast_p.abs().max().item():.3f}")
    if d.max().item() > LOGITS_ATOL or d.mean().item() > LOGITS_MEAN_ATOL:
        raise RuntimeError("phi4-mini logits disagree with the plain version")
    agree = (alast_k.argmax(-1) == atokens[:, 0]).all().item()
    log(f"  greedy first token of generate() equals argmax of the prefill logits: {agree}")
    if not agree:
        raise RuntimeError("generate's first token is not the prefill argmax")

    # ---- phase 3d: the ops entry point of the short conv and RMSNorm kernels
    log("phase 3d: kernels.ops.short_conv_gate and kernels.ops.rmsnorm at full width, bf16")
    w_sc = params["blocks"][0]["mixer"]["short_filter"]  # (inner, K) fp32
    sc_D, sc_K = w_sc.shape
    u_sc, _, gate_sc = short_conv_inputs(BATCH, PROMPT_LEN, sc_D, sc_K, torch.bfloat16, 13, device)
    gen = torch.Generator(device=device).manual_seed(14)
    norm_in = [(torch.randn(BATCH, PROMPT_LEN, d, generator=gen, device=device).bfloat16(),
                0.1 * torch.randn(d, generator=gen, device=device))
               for d in (cfg.d_model, acfg.d_model)]
    torch.cuda.synchronize()
    zero_counts()
    with torch.no_grad():
        sc_out = [ops.short_conv_gate(u_sc, w_sc, gate_sc), ops.short_conv_gate(u_sc, w_sc)]
        norm_out = [ops.rmsnorm(x, g) for x, g in norm_in]
    torch.cuda.synchronize()
    sc_launches, norm_launches = short_conv_gate.launches, rmsnorm.launches
    other = twolevel_fft_conv.launches + toeplitz_conv.launches + flash_attention.launches
    log(f"  2 short conv calls (B={BATCH}, L={PROMPT_LEN}, {sc_D} channels, K={sc_K}, gated "
        f"and ungated): short_conv_gate launches {sc_launches}; 2 rmsnorm calls (D="
        f"{cfg.d_model}, {acfg.d_model}): rmsnorm launches {norm_launches}; other kernels' "
        f"launches {other}")
    if (sc_launches, norm_launches, other) != (2, 2, 0):
        raise RuntimeError("kernels.ops did not launch each kernel once per call")
    for name, out, want in (
        ("short_conv_gate", sc_out[0], short_conv_gate_plain(u_sc, w_sc, gate_sc)),
        ("short_conv_gate", sc_out[1], short_conv_gate_plain(u_sc, w_sc)),
        *(("rmsnorm", o, rmsnorm_plain(x, g)) for o, (x, g) in zip(norm_out, norm_in)),
    ):
        if out.shape != want.shape or out.dtype != torch.bfloat16:
            raise RuntimeError(f"{name} returned {out.dtype} {tuple(out.shape)}")
        compare(name, out, want, torch.bfloat16, f"ops call {tuple(out.shape)}",
                SHORT_CONV_TOLERANCE if name == "short_conv_gate" else NORM_TOLERANCE)
    del sc_out, norm_out

    # ---- phase 3e: the two-level backend refuses past its kernel's range
    # before any work
    long_len = TWOLEVEL_MAX_N // 2 + 1  # 8193: one past the kernel's range
    log(f"phase 3e: {ARCH} on blockfft_overlap, a {long_len}-token prompt")
    g = torch.Generator(device=device).manual_seed(SEED + 4)
    long_prompt = torch.randint(0, cfg.vocab_size, (1, long_len), generator=g, device=device)
    torch.cuda.synchronize()
    zero_counts()
    try:
        generate(params, cfg, long_prompt, max_new_tokens=2,
                 scfg=ServeConfig(max_len=long_len + 8, conv_backend="blockfft_overlap"))
    except ValueError as e:
        refusal = str(e)
    else:
        raise RuntimeError(f"generate() took a {long_len}-token prompt on blockfft_overlap")
    torch.cuda.synchronize()
    counts = (twolevel_fft_conv.launches, toeplitz_conv.launches, flash_attention.launches,
              short_conv_gate.launches, rmsnorm.launches)
    log(f"  refused: {refusal}; kernel launches {counts}")
    if any(counts):
        raise RuntimeError("the refused prefill launched a kernel")
    del long_prompt

    # ---- phase 4: times
    log(f"phase 4: times on {card}")
    with torch.no_grad():
        prefill_ms = cuda_ms(lambda: prefill("blockfft_overlap"), iters=3, warmup=1)
        prefill_plain_ms = cuda_ms(lambda: prefill("blockfft"), iters=3, warmup=1)
        tok = logits_k[:, -1].argmax(-1)
        steps = 16
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            lg, caches = lm.decode_step(cast, cfg, tok, caches)
            tok = lg.argmax(-1)
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) * 1e3 / steps
        t0 = time.perf_counter()
        generate(params, cfg, prompts, scfg=scfg, max_new_tokens=NEW_TOKENS)
        torch.cuda.synchronize()
        generate_s = time.perf_counter() - t0
    log(f"  prefill (B={BATCH}, L={PROMPT_LEN}): {prefill_ms:.2f} ms with the kernel, "
        f"{prefill_plain_ms:.2f} ms with plain blockfft")
    log(f"  decode: {decode_ms:.2f} ms/step = {BATCH * 1e3 / decode_ms:.1f} tokens/s "
        f"(B={BATCH}, cache {MAX_LEN})")
    log(f"  generate (prefill + {NEW_TOKENS} tokens): {generate_s:.3f} s = "
        f"{BATCH * NEW_TOKENS / generate_s:.1f} new tokens/s")

    with torch.no_grad():
        device_profile(lambda: prefill("blockfft_overlap"), "prefill")
        lg, caches = lm.decode_step(cast, cfg, tok, caches)
        device_profile(lambda: lm.decode_step(cast, cfg, tok, caches), "decode step")

    u, h, skip, gate = conv_inputs(BATCH, PROMPT_LEN, cfg.d_model, torch.bfloat16, 7, device)
    N = next_fast_len(2 * PROMPT_LEN - 1)
    H = filter_spectrum(h, N, resolve_factors(N, None)).contiguous()
    tl_kernel = lambda: twolevel_fft_conv(u, h, skip, gate)
    tl_library = lambda: fft_causal_conv(u, h, skip, gate)
    tl_given = lambda: launch_with_spectrum(u, H, skip, gate)
    with torch.no_grad():
        saved = twolevel_fft_conv.launches
        # in turns, kernel, library, library, kernel
        turns = [cuda_ms(fn, iters=50) for fn in (tl_kernel, tl_library, tl_library, tl_kernel)]
        kernel_ms = cuda_ms(tl_given, iters=50)
        k_dev_ms = kernel_device_ms(tl_kernel, [()], "twolevel")
        kh_dev_ms = kernel_device_ms(tl_given, [()], "twolevel")
        twolevel_fft_conv.launches = saved  # timing launches are not the path's
        p_ms = cuda_ms(lambda: blockfft_causal_conv(u, h, skip, gate))
    k_ms, f_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    bound_ms, bound_by = conv_bound_ms(BATCH, PROMPT_LEN, cfg.d_model, torch.bfloat16)
    kbound_ms, kbound_by = conv_bound_ms(BATCH, PROMPT_LEN, cfg.d_model, torch.bfloat16,
                                         spectrum_given=True)
    tl_flops = fourstep_flops(BATCH, PROMPT_LEN, cfg.d_model)
    tl_tflops = tl_flops / (k_dev_ms or k_ms) / 1e9
    dev = lambda t: "not measured" if t is None else f"{t:.4f} ms"
    log(f"  twolevel_fft_conv (B={BATCH}, L={PROMPT_LEN}, D={cfg.d_model}, bf16, gated): "
        f"{k_ms:.4f} ms/call ({turns[0]:.4f}, {turns[3]:.4f}), one launch with the filter "
        f"spectrum, its device time {dev(k_dev_ms)}, {tl_tflops:.1f} TFLOP/s of the "
        f"{tl_flops / 1e9:.2f} GFLOP of dense four-step products; bound {bound_ms:.4f} ms by "
        f"{bound_by} ({100 * bound_ms / k_ms:.2f} % of it); the launch given H {kernel_ms:.4f} "
        f"ms (device {dev(kh_dev_ms)}), bound {kbound_ms:.4f} ms by {kbound_by} "
        f"({100 * kbound_ms / kernel_ms:.2f} %); plain blockfft {p_ms:.4f} ms; torch.fft conv "
        f"{f_ms:.4f} ms ({turns[1]:.4f}, {turns[2]:.4f}) in turns with it, "
        f"{k_ms / f_ms:.2f}x its time")
    log_instances("twolevel", tl_inst)
    tc_smem = twolevel_launch_shape(*resolve_factors(N, None), BATCH, PROMPT_LEN, cfg.d_model,
                              torch.cuda.get_device_properties(0).multi_processor_count)
    log(f"  the served launch: {tc_smem[0]} teams of 4 warps ({tc_smem[1]} threads) a block, "
        f"{tc_smem[2]} B of dynamic shared memory, {tc_smem[3]} blocks, {tc_smem[4]} batch "
        f"rows a unit")

    _, _, times = serve_engine(params, cfg, escfg, eprompts, timed=True)
    new_tokens = sum(ENGINE_HORIZONS)
    pre, dec = times["prefill"], times["decode"]
    log(f"  engine (bf16, toeplitz, {ENGINE_SLOTS} slots, {len(ENGINE_PROMPTS)} requests, "
        f"{new_tokens} new tokens): wall {times['wall']:.3f} s = "
        f"{new_tokens / times['wall']:.1f} new tokens/s; admission prefill mean "
        f"{1e3 * sum(pre) / len(pre):.2f} ms over {len(pre)} (each: "
        f"{', '.join(f'{1e3 * t:.1f}' for t in pre)} ms for L = {ENGINE_PROMPTS}); "
        f"pooled decode step mean {1e3 * sum(dec) / len(dec):.2f} ms over {len(dec)} steps; "
        f"prefill {100 * sum(pre) / times['wall']:.1f} % of the wall time")
    with torch.no_grad():
        device_profile(lambda: lm.prefill(cast, cfg, eprompts[0][None], MAX_LEN,
                                          ctx=ApplyContext(conv_backend="toeplitz")),
                       "admission prefill (toeplitz, L=1024)")

    tt = {}
    for B, seed in ((1, 8), (BATCH, 9)):
        u, h, skip, gate = conv_inputs(B, PROMPT_LEN, cfg.d_model, torch.bfloat16, seed, device)
        t_kernel = lambda: ops.toeplitz_conv(u, h, skip, gate)
        t_library = lambda: fft_causal_conv(u, h, skip, gate)
        with torch.no_grad():
            saved = toeplitz_conv.launches
            # in turns, kernel, library, library, kernel
            turns = [cuda_ms(fn, iters=50) for fn in (t_kernel, t_library, t_library, t_kernel)]
            dev_ms = kernel_device_ms(t_kernel, [()], "toeplitz")
            toeplitz_conv.launches = saved  # timing launches are not the path's
            plain_ms = cuda_ms(lambda: toeplitz_conv_plain(u, h, skip, gate)) if B == 1 else None
        C, _, K = chunking(PROMPT_LEN, 128, None)
        flops = toeplitz_flops(B, PROMPT_LEN, cfg.d_model, C, K)
        tt[B] = {"ms": (turns[0] + turns[3]) / 2, "library_ms": (turns[1] + turns[2]) / 2,
                 "turns": turns, "device_ms": dev_ms, "plain_ms": plain_ms, "flops": flops,
                 "bound": conv_bound_ms(B, PROMPT_LEN, cfg.d_model, torch.bfloat16)}
    for B, t in tt.items():
        b_ms, b_by = t["bound"]
        tflops = t["flops"] / (t["device_ms"] or t["ms"]) / 1e9
        t["tflops"] = tflops
        plain = "" if t["plain_ms"] is None else f"; plain {t['plain_ms']:.4f} ms"
        log(f"  toeplitz_conv (B={B}, L={PROMPT_LEN}, D={cfg.d_model}, bf16, gated, skip): "
            f"{t['ms']:.4f} ms/call ({t['turns'][0]:.4f}, {t['turns'][3]:.4f}), device time "
            f"{dev(t['device_ms'])}, {tflops:.1f} TFLOP/s of the {t['flops'] / 1e9:.2f} GFLOP of "
            f"the chunked form's products; bound {b_ms:.4f} ms by {b_by} "
            f"({100 * b_ms / t['ms']:.2f} % of it){plain}; torch.fft conv "
            f"{t['library_ms']:.4f} ms ({t['turns'][1]:.4f}, {t['turns'][2]:.4f}) in turns "
            f"with it, {t['ms'] / t['library_ms']:.2f}x its time")
    tc_plan = tc_launch_shape(cfg.d_model, 128, torch.cuda.get_device_properties(0).multi_processor_count)
    log(f"  the admission's toeplitz launch: {tc_plan[0]} channels a block ({tc_plan[1]} "
        f"threads), {tc_plan[2]} B of dynamic shared memory, {tc_plan[3]} blocks")
    t_ms, tp_ms, tf_ms = tt[1]["ms"], tt[1]["plain_ms"], tt[1]["library_ms"]
    tb_ms, tb_by = tt[1]["bound"]

    # phi4-mini: the served path and the flash kernel at its shape
    with torch.no_grad():
        a_prefill_ms = cuda_ms(aprefill, iters=3, warmup=1)
        a_prefill_plain_ms = swapped_attention(
            flash_attention_plain, lambda: cuda_ms(aprefill, iters=3, warmup=1))
        a_prefill_sdpa_ms = swapped_attention(
            sdpa_prefill_attention, lambda: cuda_ms(aprefill, iters=3, warmup=1))
        tok = alast_k.argmax(-1)
        steps = 16
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            lg, acaches = lm.decode_step(acast, acfg, tok, acaches)
            tok = lg.argmax(-1)
        torch.cuda.synchronize()
        a_decode_ms = (time.perf_counter() - t0) * 1e3 / steps
        t0 = time.perf_counter()
        generate(aparams, acfg, aprompts, scfg=ascfg, max_new_tokens=NEW_TOKENS)
        torch.cuda.synchronize()
        a_generate_s = time.perf_counter() - t0
    log(f"  {ATTN_ARCH} prefill (B={BATCH}, L={PROMPT_LEN}): {a_prefill_ms:.2f} ms with the "
        f"kernel, {a_prefill_plain_ms:.2f} ms with its plain version, {a_prefill_sdpa_ms:.2f} ms "
        f"with scaled_dot_product_attention in its place (a yardstick)")
    log(f"  {ATTN_ARCH} decode: {a_decode_ms:.2f} ms/step = {BATCH * 1e3 / a_decode_ms:.1f} "
        f"tokens/s (B={BATCH}, cache {MAX_LEN})")
    log(f"  {ATTN_ARCH} generate (prefill + {NEW_TOKENS} tokens): {a_generate_s:.3f} s = "
        f"{BATCH * NEW_TOKENS / a_generate_s:.1f} new tokens/s")
    with torch.no_grad():
        device_profile(aprefill, f"{ATTN_ARCH} prefill")
        lg, acaches = lm.decode_step(acast, acfg, tok, acaches)
        device_profile(lambda: lm.decode_step(acast, acfg, tok, acaches),
                       f"{ATTN_ARCH} decode step")

    # the served shape, in the layout the mixer hands the kernel
    H, Hkv, Dh = acfg.n_heads, acfg.n_kv_heads, acfg.head_dim
    g = torch.Generator(device=device).manual_seed(10)
    qkv = torch.randn(BATCH, PROMPT_LEN, (H + 2 * Hkv) * Dh, generator=g, device=device).bfloat16()
    q, k, v = (x.view(BATCH, PROMPT_LEN, -1, Dh).transpose(1, 2)
               for x in qkv.split([H * Dh, Hkv * Dh, Hkv * Dh], dim=-1))
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True)
    kernel = lambda: flash_attention(q, k, v)
    with torch.no_grad():
        saved = flash_attention.launches
        # in turns, kernel, library, library, kernel
        turns = [cuda_ms(fn, iters=50) for fn in (kernel, sdpa, sdpa, kernel)]
        flash_attention.launches = saved  # timing launches are not the path's
        fp_ms = cuda_ms(lambda: flash_attention_plain(q, k, v))
        d_lib = (sdpa().float() - flash_attention_plain(q, k, v).float()).abs().max().item()
    fa_ms, fl_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    fb_ms, fb_by = flash_bound_ms(BATCH, H, Hkv, PROMPT_LEN, PROMPT_LEN, Dh, torch.bfloat16)
    f_tflops = flash_flops(BATCH, H, PROMPT_LEN, PROMPT_LEN, Dh) / fa_ms / 1e9
    log(f"  flash_attention (B={BATCH}, H={H}, Hkv={Hkv}, L={PROMPT_LEN}, Dh={Dh}, bf16, "
        f"causal, transposed views): {fa_ms:.4f} ms/call ({turns[0]:.4f}, {turns[3]:.4f}) = "
        f"{f_tflops:.1f} TFLOP/s, bound {fb_ms:.4f} ms by {fb_by} ({100 * fb_ms / fa_ms:.2f} % "
        f"of it); scaled_dot_product_attention {fl_ms:.4f} ms ({turns[1]:.4f}, "
        f"{turns[2]:.4f}) in turns with it, {fa_ms / fl_ms:.2f}x its time (its max abs "
        f"difference from the plain version {d_lib:.3e}); plain {fp_ms:.4f} ms")
    log_flash_instances(flash_inst)

    # the short conv and RMSNorm kernels at phase 3d's shapes, on input sets
    # that together exceed the L2 cache
    sc_sets = [short_conv_inputs(BATCH, PROMPT_LEN, sc_D, sc_K, torch.bfloat16, 20 + i, device)
               for i in range(4)]
    sc_sets = [(u, w_sc, gate) for u, _, gate in sc_sets]
    w_flip = w_sc.flip(-1)[:, None, :].bfloat16()
    sc_times = {}
    with torch.no_grad():
        for gated in (True, False):
            sets = sc_sets if gated else [(u, w, None) for u, w, _ in sc_sets]
            saved = short_conv_gate.launches
            ms = cold_ms(ops.short_conv_gate, sets)
            dev_ms = kernel_device_ms(ops.short_conv_gate, sets, "short_conv_kernel")
            short_conv_gate.launches = saved  # timing launches are not the path's
            lib_sets = [(u, w_flip, g) for u, _, g in sets]
            sc_times[gated] = {
                "ms": ms, "kernel_ms": dev_ms,
                "plain_ms": cold_ms(short_conv_gate_plain, sets),
                "library_ms": cold_ms(conv1d_short_conv, lib_sets),
                "bound": short_conv_bound_ms(BATCH, PROMPT_LEN, sc_D, sc_K, torch.bfloat16,
                                             gated=gated),
            }
        u, _, gate = sc_sets[0]
        d_lib = (conv1d_short_conv(u, w_flip, gate).float()
                 - short_conv_gate_plain(u, w_sc, gate).float()).abs().max().item()
    for gated, t in sc_times.items():
        b_ms, b_by = t["bound"]
        log(f"  short_conv_gate (B={BATCH}, L={PROMPT_LEN}, {sc_D} channels, K={sc_K}, bf16, "
            f"gate={gated}): {t['ms']:.4f} ms/call (the kernel's device time "
            f"{dev(t['kernel_ms'])}), bound "
            f"{b_ms:.4f} ms by {b_by} ({100 * b_ms / t['ms']:.2f} % of it); plain "
            f"{t['plain_ms']:.4f} ms; F.conv1d(groups=D) + gate {t['library_ms']:.4f} ms")
    log(f"  F.conv1d yardstick's max abs difference from the plain version (bf16, gated) "
        f"{d_lib:.3e}")

    norm_times = {}
    with torch.no_grad():
        for x0, g0 in norm_in:
            d = x0.shape[-1]
            n_sets = max(2, -(-120_000_000 // (2 * x0.numel() * x0.element_size())))
            sets = [(torch.randn_like(x0), g0) for _ in range(n_sets)]
            weight = (1.0 + g0).bfloat16()
            lib_sets = [(x, weight) for x, _ in sets]
            library = lambda x, wt: torch.nn.functional.rms_norm(x, (x.shape[-1],), wt, 1e-6)
            saved = rmsnorm.launches
            # in turns, kernel, library, library, kernel
            turns = [cold_ms(fn, st) for fn, st in ((ops.rmsnorm, sets), (library, lib_sets),
                                                     (library, lib_sets), (ops.rmsnorm, sets))]
            dev_ms = kernel_device_ms(ops.rmsnorm, sets, "rmsnorm")
            rmsnorm.launches = saved  # timing launches are not the path's
            norm_times[d] = {
                "ms": (turns[0] + turns[3]) / 2, "kernel_ms": dev_ms, "turns": turns,
                "plain_ms": cold_ms(rmsnorm_plain, sets),
                "library_ms": (turns[1] + turns[2]) / 2,
                "library_device_ms": kernel_device_ms(library, lib_sets, None),
                "bound": rmsnorm_bound_ms(BATCH * PROMPT_LEN, d, torch.bfloat16, torch.float32),
            }
            del sets, lib_sets
    for d, t in norm_times.items():
        b_ms, b_by = t["bound"]
        kd, ld = t["kernel_ms"], t["library_device_ms"]
        share = "" if kd is None else f", {100 * b_ms / kd:.1f} % of the bound"
        log(f"  rmsnorm (x ({BATCH}, {PROMPT_LEN}, {d}) bf16, g fp32): the kernel's device time "
            f"{dev(kd)}{share}, F.rms_norm(weight=1+g)'s {dev(ld)}; wrapper {t['ms']:.4f} ms/call "
            f"({t['turns'][0]:.4f}, {t['turns'][3]:.4f}), F.rms_norm {t['library_ms']:.4f} ms "
            f"({t['turns'][1]:.4f}, {t['turns'][2]:.4f}) in turns with it; bound {b_ms:.4f} ms "
            f"by {b_by}; plain {t['plain_ms']:.4f} ms")

    log(card)
    print(json.dumps({"kernels": [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:25",
        "launches": f_launches,
        "max_abs_err": flash_err,
        "ms": fa_ms,
        "plain_ms": fp_ms,
        "bound_ms": fb_ms,
        "bound_by": fb_by,
        "library_ms": fl_ms,
    }, {
        "name": "toeplitz_conv",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/toeplitz_conv.cu",
        "replaces": "src/repro/kernels/toeplitz_conv.py:42",
        "launches": t_launches,
        "max_abs_err": toeplitz_err,
        "ms": t_ms,  # the wrapper at B=1, in turns with the library
        "device_ms": tt[1]["device_ms"],  # its device time by torch.profiler
        "tflops": tt[1]["tflops"],  # the chunked form's products over the device time
        "plain_ms": tp_ms,
        "bound_ms": tb_ms,
        "bound_by": tb_by,
        "library_ms": tf_ms,
        "ms_b4": tt[BATCH]["ms"],
        "device_ms_b4": tt[BATCH]["device_ms"],
        "tflops_b4": tt[BATCH]["tflops"],
        "bound_ms_b4": tt[BATCH]["bound"][0],
        "library_ms_b4": tt[BATCH]["library_ms"],
    }, {
        "name": "twolevel_fft_conv",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/twolevel_fft.cu",
        "replaces": "src/repro/kernels/twolevel_fft.py:85",
        "launches": launches,
        "max_abs_err": served_err,
        "ms": k_ms,  # the wrapper: one launch, the filter spectrum H in it
        "device_ms": k_dev_ms,  # that launch's device time by torch.profiler
        "tflops": tl_tflops,  # dense four-step products over the device time
        "kernel_ms": kernel_ms,  # the launch given H
        "kernel_device_ms": kh_dev_ms,
        "plain_ms": p_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": f_ms,
    }, {
        "name": "short_conv_gate",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/short_conv.cu",
        "replaces": "src/repro/kernels/short_conv.py:24",
        "launches": sc_launches,
        "max_abs_err": short_conv_err,
        "ms": sc_times[True]["ms"],  # the wrapper, gated, on cold inputs
        "kernel_ms": sc_times[True]["kernel_ms"],  # device time by torch.profiler
        "plain_ms": sc_times[True]["plain_ms"],
        "bound_ms": sc_times[True]["bound"][0],
        "bound_by": sc_times[True]["bound"][1],
        "library_ms": sc_times[True]["library_ms"],
        "ungated": {k: v for k, v in sc_times[False].items() if k != "bound"}
        | {"bound_ms": sc_times[False]["bound"][0]},
    }, {
        "name": "rmsnorm",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
        "replaces": "src/repro/kernels/rmsnorm.py:18",
        "launches": norm_launches,
        "max_abs_err": norm_err,
        "ms": norm_times[cfg.d_model]["ms"],  # the wrapper at D=864, on cold inputs
        "kernel_ms": norm_times[cfg.d_model]["kernel_ms"],
        "plain_ms": norm_times[cfg.d_model]["plain_ms"],
        "bound_ms": norm_times[cfg.d_model]["bound"][0],
        "bound_by": norm_times[cfg.d_model]["bound"][1],
        "library_ms": norm_times[cfg.d_model]["library_ms"],
        "library_device_ms": norm_times[cfg.d_model]["library_device_ms"],
        f"d{acfg.d_model}": {k: v for k, v in norm_times[acfg.d_model].items()
                             if k not in ("bound", "turns")}
        | {"bound_ms": norm_times[acfg.d_model]["bound"][0]},
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
