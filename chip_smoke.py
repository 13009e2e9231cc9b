#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package ``repro``.  Phases:

1. Build every CUDA kernel of the served path from ``csrc/`` with ``nvcc``
   (sm_90a), timed; print the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
   them.
2. Hold each kernel against its plain PyTorch version on the card at the
   shapes the served paths give it (and a non-power-of-two split, a ragged
   channel tile, a banded Toeplitz call, gated and ungated, skip or not,
   fp32 and bf16; for the flash attention kernel MHA, MQA, Dh 64 and 256, a
   window, a ragged L, decode offsets, rows that see no key, the mixer's
   transposed views); print each max error beside its tolerance and raise
   past it.  Float32 matmuls run in full fp32
   (``torch.backends.cuda.matmul.allow_tf32 = False``).
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
4. Times (CUDA events; the host clock around synchronised work for the
   served paths): prefill ms, decode ms per step and tokens/s of
   ``generate()`` for hyena-153m and for phi4-mini; the engine's wall time, new tokens/s, ms per admission
   prefill and per pooled decode step; each kernel's ms per call (``ms``:
   the wrapper; for the FFT conv it computes the filter spectrum in plain
   PyTorch and launches the kernel, ``kernel_ms`` is the kernel alone)
   beside its plain version, the ``torch.fft`` conv of the same function
   (``library_ms``) and its bound: the larger of the bytes the function
   must move over 3.35 TB/s and an FFT conv's fp32 operations (a banded
   call: the band's products) over 67 TFLOP/s, the H100 SXM's published
   peaks.  phi4-mini's prefill also with the kernel's plain version and
   with ``scaled_dot_product_attention`` in the kernel's place (a
   yardstick).  The flash kernel's ms at phi4-mini's served shape, beside its
   plain version, ``scaled_dot_product_attention`` (``library_ms``, a
   yardstick the port never calls) and its bound: the larger of q, k, v
   and o moved once over 3.35 TB/s and the visible (query, key) pairs'
   4·Dh operations over the tensor cores' 989 TFLOP/s (bf16; 67 TFLOP/s
   for fp32 inputs).

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
# the gate multiply adds its own rounding; fp32 outputs differ only by the
# order of the DFT sums.
TOLERANCE = {"float32": (1e-4, 1e-4), "bfloat16": (2.0 ** -6, 2.0 ** -10)}  # (rtol, atol)
# flash attention against its plain version: fp32 outputs differ only by
# the order of the fp32 sums; bf16 as above, without a gate
FLASH_TOLERANCE = {"float32": (1e-5, 1e-5), "bfloat16": (2.0 ** -6, 2.0 ** -10)}
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
    log(f"  {name} {label}: max_abs_err={err:.3e} (tolerance {atol:g} + {rtol:g}·|plain|)")
    if excess > atol:
        raise RuntimeError(f"{name} disagrees with its plain version at {label}")
    return err


def check_twolevel(device) -> float:
    """Phase 2, kernel 1; returns the max abs error at the served shape."""
    import torch

    from repro_torch.core.blockfft import blockfft_causal_conv
    from repro_torch.kernels.twolevel_fft import twolevel_fft_conv

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

    from repro_torch.kernels.toeplitz_conv import toeplitz_conv, toeplitz_conv_plain

    cases = [
        # (B, L, D, dtype, gated, with skip, n_chunk_diags)
        (1, 1024, 864, torch.bfloat16, True, True, None),  # an admission
        (1, 1024, 864, torch.float32, False, True, None),
        (4, 1024, 864, torch.bfloat16, True, True, None),
        (4, 1024, 864, torch.float32, True, False, None),
        (1, 1000, 864, torch.bfloat16, True, True, None),  # L not a multiple of C
        (1, 1000, 864, torch.float32, False, False, None),
        (1, 37, 864, torch.bfloat16, True, True, None),  # L < C
        (1, 37, 864, torch.float32, True, False, None),
        (1, 1, 864, torch.bfloat16, True, True, None),  # L = 1
        (1, 1, 864, torch.float32, False, True, None),
        (2, 300, 865, torch.float32, True, True, 2),  # banded, ragged tile
        (2, 300, 865, torch.bfloat16, False, False, 2),
    ]
    errs = []
    for i, (B, L, D, dtype, gated, with_skip, K) in enumerate(cases):
        u, h, skip, gate = conv_inputs(B, L, D, dtype, seed=200 + i, device=device)
        skip = skip if with_skip else None
        gate = gate if gated else None
        errs.append(compare(
            "toeplitz_conv", toeplitz_conv(u, h, skip, gate, n_chunk_diags=K),
            toeplitz_conv_plain(u, h, skip, gate, n_chunk_diags=K), dtype,
            f"B={B} L={L} D={D} {str(dtype)[6:]} gate={gated} skip={with_skip} K={K}",
        ))
    # the model path's operands: torch.split views and the max_len filter
    # sliced to L, read in place
    g = torch.Generator(device=device).manual_seed(7)
    z = torch.randn(1, PROMPT_LEN, 3 * 864, generator=g, device=device).bfloat16()
    h = torch.randn(864, MAX_LEN, generator=g, device=device)[:, :PROMPT_LEN] / PROMPT_LEN
    u, gate, skip = z[..., :864], z[..., 864:1728], torch.randn(864, device=device)
    fused = toeplitz_conv(u, h, skip, gate)
    compare("toeplitz_conv", fused,
            toeplitz_conv_plain(u.contiguous(), h.contiguous(), skip, gate.contiguous()),
            torch.bfloat16, "B=1 L=1024 D=864 bfloat16 views of the projection")
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


def flash_bound_ms(B, H, Hkv, Lq, Lk, Dh, dtype, *, causal=True, window=None,
                   q_offset=None):
    """(ms, "bytes" or "operations"): the least time the card could take for
    one attention call.  The larger of
      bytes: q and o (B·H·Lq·Dh each) and k and v (B·Hkv·Lk·Dh each) in
        ``dtype``, each moved once, over the memory rate;
      operations: 4·Dh per visible (query, key) pair and head (q·kᵀ and
        p·v, a multiply and an add each), counted for this call's mask,
        over the tensor cores' bf16 rate (the fp32 rate for fp32 inputs)."""
    import numpy as np

    esize = 2 if str(dtype).endswith("bfloat16") else 4
    nbytes = 2 * B * Dh * esize * (H * Lq + Hkv * Lk)
    qpos = np.arange(Lq) + (Lk - Lq if q_offset is None else q_offset)
    hi = np.minimum(qpos + 1, Lk) if causal else np.full(Lq, Lk)
    lo = np.maximum(qpos - window + 1, 0) if window is not None else np.zeros(Lq, int)
    pairs = int(np.maximum(hi - lo, 0).sum())
    flops = 4.0 * Dh * B * H * pairs
    peak = PEAK_BF16_FLOPS if esize == 2 else PEAK_FP32_FLOPS
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_flash(device) -> float:
    """Phase 2, kernel 3; returns the max abs error at phi4-mini's served
    shape (B=4, H=24, Hkv=8, L=1024, Dh=128, bf16)."""
    import torch

    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain

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
            torch.bfloat16, "B=4 L=1024 bf16 transposed views, q_offset=3", FLASH_TOLERANCE)
    for bad in ((q[..., :96], k[..., :96], v[..., :96]), (q[:, :23], k, v)):
        try:
            flash_attention(*bad)
        except ValueError as e:
            log(f"  refused: {e}")
        else:
            raise RuntimeError("flash_attention accepted what it does not take")
    return errs[0]


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
    from repro_torch.kernels.toeplitz_conv import toeplitz_conv, toeplitz_conv_plain
    from repro_torch.kernels.twolevel_fft import launch_with_spectrum, twolevel_fft_conv
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
    log(f"  card: {card}")
    log("  torch.backends.cuda.matmul.allow_tf32 = False (fp32 matmuls in full fp32)")

    # ---- phase 2: kernel against its plain version
    log("phase 2: kernels against their plain versions on the card")
    served_err = check_twolevel(device)
    toeplitz_err = check_toeplitz(device)
    flash_err = check_flash(device)

    def zero_counts():
        twolevel_fft_conv.launches = toeplitz_conv.launches = flash_attention.launches = 0

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
    other = toeplitz_conv.launches + flash_attention.launches
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
    other = twolevel_fft_conv.launches + flash_attention.launches
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
    other = twolevel_fft_conv.launches + toeplitz_conv.launches
    log(f"  generate: tokens {tuple(atokens.shape)}, flash_attention launches {f_launches} "
        f"(expected {acfg.n_layers}), conv kernels' launches {other}, first call "
        f"{a_first_s:.2f} s")
    if f_launches != acfg.n_layers or other:
        raise RuntimeError(f"the attention path launched flash_attention {f_launches} times, "
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
    with torch.no_grad():
        saved = twolevel_fft_conv.launches
        k_ms = cuda_ms(lambda: twolevel_fft_conv(u, h, skip, gate))
        kernel_ms = cuda_ms(lambda: launch_with_spectrum(u, H, skip, gate))
        twolevel_fft_conv.launches = saved  # timing launches are not the path's
        p_ms = cuda_ms(lambda: blockfft_causal_conv(u, h, skip, gate))
        f_ms = cuda_ms(lambda: fft_causal_conv(u, h, skip, gate))
    bound_ms, bound_by = conv_bound_ms(BATCH, PROMPT_LEN, cfg.d_model, torch.bfloat16)
    kbound_ms, kbound_by = conv_bound_ms(BATCH, PROMPT_LEN, cfg.d_model, torch.bfloat16,
                                         spectrum_given=True)
    log(f"  twolevel_fft_conv (B={BATCH}, L={PROMPT_LEN}, D={cfg.d_model}, bf16, gated): "
        f"{k_ms:.4f} ms/call with the filter spectrum, bound {bound_ms:.4f} ms by {bound_by} "
        f"({100 * bound_ms / k_ms:.2f} % of it); the kernel alone (H given) {kernel_ms:.4f} ms, "
        f"bound {kbound_ms:.4f} ms by {kbound_by} ({100 * kbound_ms / kernel_ms:.2f} %); "
        f"plain blockfft {p_ms:.4f} ms; torch.fft conv {f_ms:.4f} ms")

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

    u, h, skip, gate = conv_inputs(1, PROMPT_LEN, cfg.d_model, torch.bfloat16, 8, device)
    u4, h4, skip4, gate4 = conv_inputs(BATCH, PROMPT_LEN, cfg.d_model, torch.bfloat16, 9, device)
    with torch.no_grad():
        saved = toeplitz_conv.launches
        t_ms = cuda_ms(lambda: ops.toeplitz_conv(u, h, skip, gate))
        t4_ms = cuda_ms(lambda: ops.toeplitz_conv(u4, h4, skip4, gate4))
        toeplitz_conv.launches = saved  # timing launches are not the path's
        tp_ms = cuda_ms(lambda: toeplitz_conv_plain(u, h, skip, gate))
        tf_ms = cuda_ms(lambda: fft_causal_conv(u, h, skip, gate))
    tb_ms, tb_by = conv_bound_ms(1, PROMPT_LEN, cfg.d_model, torch.bfloat16)
    t4b_ms, _ = conv_bound_ms(BATCH, PROMPT_LEN, cfg.d_model, torch.bfloat16)
    log(f"  toeplitz_conv (B=1, L={PROMPT_LEN}, D={cfg.d_model}, bf16, gated): {t_ms:.4f} "
        f"ms/call, bound {tb_ms:.4f} ms by {tb_by} ({100 * tb_ms / t_ms:.2f} % of it); plain "
        f"{tp_ms:.4f} ms; torch.fft conv {tf_ms:.4f} ms; at B={BATCH}: {t4_ms:.4f} ms/call, "
        f"bound {t4b_ms:.4f} ms")

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
    with torch.no_grad():
        saved = flash_attention.launches
        fa_ms = cuda_ms(lambda: flash_attention(q, k, v))
        flash_attention.launches = saved  # timing launches are not the path's
        fp_ms = cuda_ms(lambda: flash_attention_plain(q, k, v))
        fl_ms = cuda_ms(sdpa)
        d_lib = (sdpa().float() - flash_attention_plain(q, k, v).float()).abs().max().item()
    fb_ms, fb_by = flash_bound_ms(BATCH, H, Hkv, PROMPT_LEN, PROMPT_LEN, Dh, torch.bfloat16)
    log(f"  flash_attention (B={BATCH}, H={H}, Hkv={Hkv}, L={PROMPT_LEN}, Dh={Dh}, bf16, "
        f"causal, transposed views): {fa_ms:.4f} ms/call, bound {fb_ms:.4f} ms by {fb_by} "
        f"({100 * fb_ms / fa_ms:.2f} % of it); plain {fp_ms:.4f} ms; "
        f"scaled_dot_product_attention {fl_ms:.4f} ms (its max abs difference from the "
        f"plain version {d_lib:.3e})")

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
        "ms": t_ms,
        "plain_ms": tp_ms,
        "bound_ms": tb_ms,
        "bound_by": tb_by,
        "library_ms": tf_ms,
    }, {
        "name": "twolevel_fft_conv",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/twolevel_fft.cu",
        "replaces": "src/repro/kernels/twolevel_fft.py:85",
        "launches": launches,
        "max_abs_err": served_err,
        "ms": k_ms,  # the wrapper: filter spectrum H (plain torch) + kernel
        "kernel_ms": kernel_ms,  # the CUDA kernel alone, H given
        "plain_ms": p_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": f_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
