"""The CUDA kernels of the PyTorch port against their plain versions, on
the card.  Every test here needs a CUDA device and skips without one; run
them on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/port/test_torch_cuda.py

This file imports no JAX, so it runs where only PyTorch is installed.
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.blockfft import blockfft_causal_conv
from repro_torch.core.blockfft import filter_spectrum
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import TOLERANCE as FLASH_TOLERANCE
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
from repro_torch.kernels.flash_attention import rows_aligned16
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_plain
from repro_torch.kernels import short_conv
from repro_torch.kernels.short_conv import short_conv_gate, short_conv_gate_plain
from repro_torch.kernels.toeplitz_conv import TOLERANCE as TOEPLITZ_TOLERANCE
from repro_torch.kernels.toeplitz_conv import toeplitz_conv, toeplitz_conv_plain
from repro_torch.kernels.twolevel_fft import launch_with_spectrum, twolevel_fft_conv
from repro_torch.serve.engine import ServeConfig, ServeEngine, generate
from repro_torch.models import lm

pytestmark = pytest.mark.cuda

# (rtol, atol): fp32 outputs differ by the order of the DFT sums; bf16
# outputs may land one bf16 ulp (2^-7 of the value) apart, plus the gate's
# own rounding, and the two-level kernel's TF32 products stay inside atol
# (kernels/twolevel_fft.py::TOLERANCE derives it)
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2.0 ** -6, 2.0 ** -10)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = prev


def _inputs(B, L, D, dtype, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    u = torch.randn(B, L, D, generator=g, device=device).to(dtype)
    h = torch.randn(D, L, generator=g, device=device) / L
    skip = torch.randn(D, generator=g, device=device)
    gate = torch.randn(B, L, D, generator=g, device=device).to(dtype)
    return u, h, skip, gate


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,L,D,factors", [
    (2, 100, 5, (10, 20)),  # non-power-of-two split, ragged channel tile
    (1, 37, 3, None),
    (2, 1000, 33, None),  # N = 2000 = 40·50
    (2, 1024, 64, (32, 64)),  # a non-default split of N = 2048
    (1, 8192, 4, None),  # the largest L the kernel takes
    (1, 1, 3, None),  # L = 1: N = 1 = 1·1
    (2, 17, 5, None),  # N = 36 = 6·6
])
def test_twolevel_kernel_matches_plain(cuda, dtype, B, L, D, factors):
    u, h, skip, gate = _inputs(B, L, D, dtype, cuda, seed=L + D)
    rtol, atol = TOL[dtype]
    for sk, g in ((skip, gate), (skip, None), (None, None), (None, gate)):
        got = twolevel_fft_conv(u, h, sk, g, factors=factors)
        want = blockfft_causal_conv(u, h, sk, g, factors=factors)
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)
        assert got.dtype == dtype and got.shape == u.shape
    # DESIGN §7 inside the kernel: gated == gate * ungated, bit for bit
    fused = twolevel_fft_conv(u, h, skip, gate, factors=factors)
    assert torch.equal(fused, gate * twolevel_fft_conv(u, h, skip, factors=factors))


def test_twolevel_kernel_counts_launches_and_refuses(cuda):
    u, h, skip, gate = _inputs(1, 64, 8, torch.float32, cuda)
    before = twolevel_fft_conv.launches
    twolevel_fft_conv(u, h, skip, gate)
    assert twolevel_fft_conv.launches == before + 1
    with pytest.raises(ValueError, match="L <= 8192"):
        twolevel_fft_conv(*_inputs(1, 8193, 1, torch.float32, cuda)[:2])
    with pytest.raises(ValueError, match="fp32 or bf16"):
        twolevel_fft_conv(u.half(), h)
    with pytest.raises(ValueError, match="gate must match"):
        twolevel_fft_conv(u, h, skip, gate.bfloat16())
    assert twolevel_fft_conv.launches == before + 1


def test_launch_with_spectrum_is_the_wrapper_without_h(cuda):
    """The kernel alone, given the spectrum, computes the wrapper's function
    (within TOL of the plain version: the wrapper's bf16 launch computes H
    itself in TF32, this one reads the plain version's fp32 H), counts its
    launch, and refuses a spectrum that does not fit u."""
    u, h, skip, gate = _inputs(2, 1000, 33, torch.bfloat16, cuda)
    H = filter_spectrum(h, 2000, (40, 50))
    before = twolevel_fft_conv.launches
    got = launch_with_spectrum(u, H, skip, gate)
    assert twolevel_fft_conv.launches == before + 1
    rtol, atol = TOL[torch.bfloat16]
    want = blockfft_causal_conv(u, h, skip, gate, factors=(40, 50))
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)
    with pytest.raises(ValueError, match="complex64 spectrum"):
        launch_with_spectrum(u[:, :500], H, skip, gate[:, :500])  # N = 1000
    with pytest.raises(ValueError, match="complex64 spectrum"):
        launch_with_spectrum(u, H.real, skip, gate)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_twolevel_kernel_reads_the_model_paths_views(cuda, dtype):
    """u and the gate as torch.split views of the projection and h sliced
    from the max_len grid, as models/hyena.py passes them: one launch, and
    bit for bit what contiguous copies give."""
    B, L, D = 2, 1024, 64
    g = torch.Generator(device=cuda).manual_seed(5)
    z = torch.randn(B, L, 3 * D, generator=g, device=cuda).to(dtype)
    h = (torch.randn(D, 2048, generator=g, device=cuda) / L)[:, :L]
    skip = torch.randn(D, generator=g, device=cuda).to(dtype)
    u, gate, _ = torch.split(z, D, dim=-1)
    before = twolevel_fft_conv.launches
    got = twolevel_fft_conv(u, h, skip, gate)
    assert twolevel_fft_conv.launches == before + 1
    assert torch.equal(got, twolevel_fft_conv(u.contiguous(), h.contiguous(), skip,
                                              gate.contiguous()))
    rtol, atol = TOL[dtype]
    want = blockfft_causal_conv(u, h, skip, gate)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)


def test_generate_on_cuda_launches_the_kernel_per_order_and_layer(cuda):
    cfg = get_config("hyena-153m").reduced()
    params = lm.init_lm(cfg, seed=0, device=cuda)
    prompts = torch.randint(0, cfg.vocab_size, (2, 100), device=cuda,
                            generator=torch.Generator(device=cuda).manual_seed(1))
    out = {}
    for backend in ("blockfft_overlap", "blockfft"):
        scfg = ServeConfig(max_len=128, conv_backend=backend, cache_dtype=torch.float32)
        before = twolevel_fft_conv.launches
        out[backend] = generate(params, cfg, prompts, scfg=scfg, max_new_tokens=6)
        launched = twolevel_fft_conv.launches - before
        assert launched == (cfg.n_layers * cfg.hyena_order if backend == "blockfft_overlap" else 0)
    assert torch.equal(out["blockfft_overlap"], out["blockfft"])


# (B, L, D, n_chunk_diags): the shapes the engine's admissions give the
# toeplitz kernel (L below the chunk, L = 1, L not a multiple of 128) and a
# banded call with a ragged channel tile
TOEPLITZ_SHAPES = [
    (1, 1024, 864, None), (4, 1024, 864, None), (1, 1000, 864, None),
    (1, 37, 864, None), (1, 1, 864, None), (2, 300, 865, 2),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,L,D,K", TOEPLITZ_SHAPES)
def test_toeplitz_kernel_matches_plain(cuda, dtype, B, L, D, K):
    u, h, skip, gate = _inputs(B, L, D, dtype, cuda, seed=L + D)
    rtol, atol = TOL[dtype]
    for sk, g in ((skip, gate), (skip, None), (None, None), (None, gate)):
        got = toeplitz_conv(u, h, sk, g, n_chunk_diags=K)
        want = toeplitz_conv_plain(u, h, sk, g, n_chunk_diags=K)
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)
        assert got.dtype == dtype and got.shape == u.shape
    fused = toeplitz_conv(u, h, skip, gate, n_chunk_diags=K)
    assert torch.equal(fused, gate * toeplitz_conv(u, h, skip, n_chunk_diags=K))


# (B, L, chunk) of the bf16 tensor-core instance: chunks padded to 64, 128
# and 256 rows, L = 1 and 97 (one chunk, padded), L not a multiple of the
# chunk, and B·n past one pass of eight columns (with the chunk that each
# diagonal adds loaded during the one before)
TC_TOEPLITZ = [(B, L, chunk) for B in (1, 4) for L in (1, 97, 1000, 1024, 2048)
               for chunk in (64, 128, 256)]


@pytest.mark.parametrize("B,L,chunk", TC_TOEPLITZ)
def test_toeplitz_tensor_core_instance_matches_plain(cuda, B, L, chunk):
    """At a ragged channel group (D = 865), exact and banded to two chunk
    diagonals, gated with skip and bare, within the kernel's bf16
    tolerance; gated equals gate * ungated bit for bit."""
    D = 865
    u, h, skip, gate = _inputs(B, L, D, torch.bfloat16, cuda, seed=B + L + chunk)
    rtol, atol = TOEPLITZ_TOLERANCE[torch.bfloat16]
    for K in (None, 2):
        for sk, g in ((skip, gate), (None, None)):
            got = toeplitz_conv(u, h, sk, g, chunk=chunk, n_chunk_diags=K)
            want = toeplitz_conv_plain(u, h, sk, g, chunk=chunk, n_chunk_diags=K)
            torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)
        fused = toeplitz_conv(u, h, skip, gate, chunk=chunk, n_chunk_diags=K)
        assert torch.equal(fused, gate * toeplitz_conv(u, h, skip, chunk=chunk, n_chunk_diags=K))


def test_toeplitz_kernel_takes_views_counts_launches_and_refuses(cuda):
    """The model path hands the kernel torch.split views of the projection
    and the max_len filter sliced to L; the kernel reads them in place."""
    B, L, D = 2, 300, 40
    z = torch.randn(B, L, 3 * D, device=cuda)
    hbig = torch.randn(D, 512, device=cuda) / L
    u, gate, h = z[..., :D], z[..., D:2 * D], hbig[:, :L]
    before = toeplitz_conv.launches
    got = ops.toeplitz_conv(u, h, None, gate, chunk=64)
    assert toeplitz_conv.launches == before + 1
    want = toeplitz_conv_plain(u.contiguous(), h.contiguous(), None, gate.contiguous(), chunk=64)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="fp32 or bf16"):
        toeplitz_conv(u.half(), h)
    with pytest.raises(ValueError, match="fp32 h"):
        toeplitz_conv(u, h.bfloat16())
    with pytest.raises(ValueError, match="last dim"):
        toeplitz_conv(u.transpose(1, 2).contiguous().transpose(1, 2), h)
    with pytest.raises(ValueError, match="at most 256"):
        toeplitz_conv(u, h, chunk=300)
    assert toeplitz_conv.launches == before + 1


def test_engine_on_cuda_launches_toeplitz_per_admission(cuda):
    """Every admission of the continuous-batching engine is one batch-1
    prefill: n_layers·order kernel launches, and the greedy tokens equal
    the per-request generate()."""
    cfg = get_config("hyena-153m").reduced()
    params = lm.init_lm(cfg, seed=0, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(2)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), device=cuda, generator=g) for n in (1, 37, 100)]
    scfg = ServeConfig(max_len=128, n_slots=2, decode_quantum=2,
                       cache_dtype=torch.float32, conv_backend="toeplitz")
    before = toeplitz_conv.launches
    eng = ServeEngine(params, cfg, scfg)
    rids = [eng.submit(p.cpu().numpy(), max_new_tokens=5) for p in prompts]
    out = eng.drain()
    assert toeplitz_conv.launches - before == cfg.n_layers * cfg.hyena_order * len(prompts)
    for rid, p in zip(rids, prompts):
        want = generate(params, cfg, p[None], scfg=scfg, max_new_tokens=5)[0].cpu().numpy()
        assert out[rid].tolist() == want.tolist()
    for axes, layer in zip(lm.cache_slot_axes(cfg, eng.pool), eng.pool):
        assert all(not v.any() for k, v in layer.items() if axes[k] >= 0)


# (B, H, Hkv, Lq, Lk, Dh, window, causal): the served shape of phi4-mini,
# MHA, MQA, Dh 64 and 256, a window shorter than L, a ragged L, decode
# offsets (Lq = 1 and 7 against Lk = 1000), rows that see no key (Lq > Lk)
# and a call without the causal mask; then the edges of the bf16 kernel's
# tiles: an Lk that is no multiple of the key tile with Lq != Lk, a window
# that ends inside a tile, Dh 64 and 256 at L = 512, and rows that see no
# key at Dh 128
FLASH_CASES = [
    (4, 24, 8, 1024, 1024, 128, None, True),
    (2, 8, 8, 512, 512, 128, None, True),
    (2, 8, 1, 300, 300, 128, None, True),
    (2, 4, 2, 256, 256, 64, None, True),
    (1, 4, 1, 257, 257, 256, None, True),
    (1, 8, 2, 1024, 1024, 128, 100, True),
    (1, 4, 1, 600, 600, 256, 128, True),
    (2, 8, 2, 1000, 1000, 128, None, True),
    (2, 24, 8, 1, 1000, 128, None, True),
    (2, 24, 8, 7, 1000, 128, None, True),
    (1, 4, 2, 100, 40, 64, None, True),
    (1, 4, 2, 70, 90, 128, 33, False),
    (1, 4, 2, 200, 333, 128, None, True),
    (1, 4, 2, 512, 512, 128, 40, True),
    (1, 4, 2, 512, 512, 64, None, True),
    (1, 4, 1, 512, 512, 256, None, True),
    (1, 4, 2, 130, 50, 128, None, True),
]
# (rtol, atol): fp32 outputs differ by the order of the fp32 sums; the bf16
# kernel rounds p to bf16 before p·v (its bound is derived beside
# kernels/flash_attention.py::TOLERANCE)
FLASH_TOL = FLASH_TOLERANCE


def _qkv(B, H, Hkv, Lq, Lk, Dh, dtype, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    mk = lambda h, n: torch.randn(B, h, n, Dh, generator=g, device=device).to(dtype)
    return mk(H, Lq), mk(Hkv, Lk), mk(Hkv, Lk)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Hkv,Lq,Lk,Dh,window,causal", FLASH_CASES)
def test_flash_kernel_matches_plain(cuda, dtype, B, H, Hkv, Lq, Lk, Dh, window, causal):
    q, k, v = _qkv(B, H, Hkv, Lq, Lk, Dh, dtype, cuda, seed=Lq + Lk + Dh)
    got = flash_attention(q, k, v, causal=causal, window=window)
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    rtol, atol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)
    assert got.dtype == dtype and got.shape == q.shape
    if Lq > Lk:
        assert not got[:, :, : Lq - Lk].any()


def test_flash_kernel_takes_views_counts_launches_and_refuses(cuda):
    """The mixer hands the kernel its (B, L, H, Dh) projections transposed,
    and a free query offset; the kernel reads them in place."""
    B, L, H, Hkv, Dh = 2, 130, 6, 2, 64
    g = torch.Generator(device=cuda).manual_seed(3)
    qkv = torch.randn(B, L, (H + 2 * Hkv) * Dh, generator=g, device=cuda).bfloat16()
    q, k, v = qkv.split([H * Dh, Hkv * Dh, Hkv * Dh], dim=-1)
    q, k, v = (x.view(B, L, -1, Dh).transpose(1, 2) for x in (q, k, v))
    assert rows_aligned16(q, k, v)  # the cp.async instance
    before = flash_attention.launches
    got = ops.flash_attention(q, k, v, q_offset=5, window=40)
    assert flash_attention.launches == before + 1
    want = flash_attention_plain(q.contiguous(), k.contiguous(), v.contiguous(),
                                 q_offset=5, window=40)
    rtol, atol = FLASH_TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)
    # rows that start off 16 bytes: a split of a projection one element wider,
    # sliced past its first element, goes to the element-wise instance
    wide = torch.randn(B, L, (H + 2 * Hkv) * Dh + 1, generator=g, device=cuda).bfloat16()[..., 1:]
    q, k, v = (x.unflatten(-1, (-1, Dh)).transpose(1, 2)
               for x in wide.split([H * Dh, Hkv * Dh, Hkv * Dh], dim=-1))
    assert not rows_aligned16(q, k, v)
    got = ops.flash_attention(q, k, v, q_offset=5, window=40)
    assert flash_attention.launches == before + 2
    want = flash_attention_plain(q.contiguous(), k.contiguous(), v.contiguous(),
                                 q_offset=5, window=40)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)
    with pytest.raises(ValueError, match="head dims"):
        flash_attention(*_qkv(1, 2, 1, 8, 8, 96, torch.bfloat16, cuda))
    with pytest.raises(ValueError, match="multiple of Hkv"):
        flash_attention(*_qkv(1, 3, 2, 8, 8, 64, torch.bfloat16, cuda))
    with pytest.raises(ValueError, match="fp32 or bf16"):
        flash_attention(*_qkv(1, 2, 1, 8, 8, 64, torch.float16, cuda))
    assert flash_attention.launches == before + 2


def test_generate_on_cuda_launches_flash_once_per_layer(cuda, monkeypatch):
    """Reduced phi4-mini with head_dim 64 (the kernel takes Dh in {64, 128,
    256}; ``reduced()`` gives 16): one kernel launch per layer in the
    prefill, none in decode, and the same greedy tokens as the plain version
    at fp32."""
    cfg = dataclasses.replace(get_config("phi4-mini-3.8b").reduced(), head_dim=64)
    params = lm.init_lm(cfg, seed=0, device=cuda)
    prompts = torch.randint(0, cfg.vocab_size, (2, 100), device=cuda,
                            generator=torch.Generator(device=cuda).manual_seed(1))
    scfg = ServeConfig(max_len=128, cache_dtype=torch.float32)
    before = flash_attention.launches
    got = generate(params, cfg, prompts, scfg=scfg, max_new_tokens=6)
    assert flash_attention.launches - before == cfg.n_layers
    monkeypatch.setattr(ops, "flash_attention", flash_attention_plain)
    want = generate(params, cfg, prompts, scfg=scfg, max_new_tokens=6)
    assert torch.equal(got, want)


# (B, L, D, K, w dtype, (fp32 instance, bf16 instance)): hyena-153m's
# projection ((N+1)·D = 2592 channels, K = 3), K = 1, 4 and 8 (with
# L < K − 1), L = 1, L shorter than a run (runs are at least AHEAD = 4
# rows) and L not a multiple of it, a ragged D (33; 2592 + 4, whole fp32
# vectors but not whole bf16 ones), and K = 9, 16 and 64 with L < K − 1
VEC, SCALAR, GENERAL = ("vector",) * 2, ("scalar",) * 2, ("general",) * 2
SHORT_CONV_SHAPES = [
    (4, 1024, 2592, 3, torch.float32, VEC), (2, 300, 2592, 1, torch.float32, VEC),
    (2, 300, 2592, 4, torch.float32, VEC), (2, 5, 64, 8, torch.bfloat16, VEC),
    (3, 1, 2592, 3, torch.float32, VEC), (2, 3, 2592, 3, torch.float32, VEC),
    (2, 1001, 864, 3, torch.bfloat16, VEC), (2, 100, 33, 3, torch.bfloat16, SCALAR),
    (2, 100, 2596, 3, torch.float32, ("vector", "scalar")),
    (2, 5, 64, 9, torch.float32, GENERAL), (2, 10, 72, 16, torch.bfloat16, GENERAL),
    (2, 40, 40, 64, torch.float32, GENERAL),
]


def _bf16_ulp(x):
    """One bf16 ulp at |x| (8 significant bits), floored at the smallest normal."""
    return torch.exp2(torch.floor(torch.log2(x.float().abs().clamp_min(2.0 ** -126))) - 7)


def _assert_short_conv_agrees(got, want):
    """fp32 bit for bit (the same products, each rounded before its add, in
    the same order); bf16 within one bf16 ulp (both round the same sums)."""
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == torch.float32:
        assert torch.equal(got, want)
    else:
        assert ((got.float() - want.float()).abs() <= _bf16_ulp(want)).all()


def _short_conv_inputs(B, L, D, K, dtype, w_dtype, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    u = torch.randn(B, L, D, generator=g, device=device).to(dtype)
    w = torch.randn(D, K, generator=g, device=device).to(w_dtype)
    gate = torch.randn(B, L, D, generator=g, device=device).to(dtype)
    return u, w, gate


def _short_conv_counted(u, w, gate):
    """The kernel's output and the one per-instance counter it moved."""
    before = short_conv.launch_counts()
    got = short_conv_gate(u, w, gate)
    after = short_conv.launch_counts()
    moved = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    assert len(moved) == 2 and moved["launches"] == 1, moved
    return got, next(k for k in moved if k != "launches")


def _off16(shape, dtype, device, seed):
    """A (B, L, D) tensor whose data starts one element past 16 bytes."""
    g = torch.Generator(device=device).manual_seed(seed)
    n = shape[0] * shape[1] * shape[2]
    return torch.randn(n + 1, generator=g, device=device).to(dtype)[1:].view(shape)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,L,D,K,w_dtype,instances", SHORT_CONV_SHAPES)
def test_short_conv_kernel_matches_plain(cuda, dtype, B, L, D, K, w_dtype, instances):
    u, w, gate = _short_conv_inputs(B, L, D, K, dtype, w_dtype, cuda, seed=L + D + K)
    want_instance = instances[dtype == torch.bfloat16]
    for g in (gate, None):
        got, took = _short_conv_counted(u, w, g)
        assert took == want_instance == short_conv.short_conv_plan(u, w, g)
        _assert_short_conv_agrees(got, short_conv_gate_plain(u, w, g))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_short_conv_projection_off_16_bytes_takes_the_scalar_instance(cuda, dtype):
    """hyena-153m's projection from a buffer one element off 16 bytes: the
    scalar instance, equal to the plain version as the vector one is on the
    aligned copy."""
    shape = (4, 1024, 2592)
    u, gate = _off16(shape, dtype, cuda, 1), _off16(shape, dtype, cuda, 2)
    w = torch.randn(2592, 3, device=cuda)
    for g in (gate, None):
        got, took = _short_conv_counted(u, w, g)
        assert took == "scalar"
        want = short_conv_gate_plain(u, w, g)
        _assert_short_conv_agrees(got, want)
        aligned = short_conv_gate(u.clone(), w, None if g is None else g.clone())
        assert torch.equal(aligned, got)


# (case, buffer width, u's channels, the gate's channels, K, instance):
# split views of a wider projection, read in place by every instance
SPLIT_VIEW_CASES = [
    ("40-channel views", 120, (0, 40), (40, 80), 3, "vector"),
    ("views one element off 16 bytes", 2593, (1, 865), (865, 1729), 3, "scalar"),
    ("views of the projection at K = 9", 2592, (0, 864), (864, 1728), 9, "general"),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case,width,u_ch,g_ch,K,instance", SPLIT_VIEW_CASES,
                         ids=[c[0] for c in SPLIT_VIEW_CASES])
def test_short_conv_kernel_reads_split_views_in_place(cuda, dtype, case, width, u_ch, g_ch, K,
                                                      instance):
    """Each instance steps a view's own batch and row strides: split views
    of one buffer equal the plain version on their contiguous copies."""
    g = torch.Generator(device=cuda).manual_seed(width + K)
    z = torch.randn(2, 300, width, generator=g, device=cuda).to(dtype)
    u, gate = z[..., u_ch[0]:u_ch[1]], z[..., g_ch[0]:g_ch[1]]
    w = torch.randn(K, u.shape[2], generator=g, device=cuda).t()
    for gt in (gate, None):
        got, took = _short_conv_counted(u, w, gt)
        assert took == instance
        want = short_conv_gate_plain(u.contiguous(), w.contiguous(),
                                     None if gt is None else gt.contiguous())
        _assert_short_conv_agrees(got, want)


def test_short_conv_kernel_takes_views_counts_launches_and_refuses(cuda):
    """hyena-153m's split views of its projection and a transposed w are
    read in place by the vector instance; a call the kernel does not take
    raises before anything runs."""
    B, L, D, K = 2, 300, 864, 3
    z = torch.randn(B, L, 3 * D, device=cuda).bfloat16()
    u, gate = z[..., :D], z[..., D:2 * D]
    w = torch.randn(K, D, device=cuda).t()
    before = short_conv.launch_counts()
    got = ops.short_conv_gate(u, w, gate)
    after = short_conv.launch_counts()
    assert (after["launches"], after["vector"]) == (before["launches"] + 1, before["vector"] + 1)
    want = short_conv_gate_plain(u.contiguous(), w.contiguous(), gate.contiguous())
    _assert_short_conv_agrees(got, want)
    with pytest.raises(ValueError, match="fp32 or bf16 u"):
        ops.short_conv_gate(u.half(), w)
    with pytest.raises(ValueError, match="fp32 or bf16 w"):
        ops.short_conv_gate(u, w.half())
    with pytest.raises(ValueError, match="last dim"):
        ops.short_conv_gate(u.transpose(1, 2).contiguous().transpose(1, 2), w)
    with pytest.raises(ValueError, match="K >= 1"):
        ops.short_conv_gate(u, torch.randn(D, 0, device=cuda))
    with pytest.raises(ValueError, match="w is on"):
        ops.short_conv_gate(u, w.cpu())
    with pytest.raises(ValueError, match="gate must be"):
        ops.short_conv_gate(u, w, gate.float())
    assert short_conv.launch_counts() == after


# (shape, x dtype, g dtype): hyena-153m's and phi4-mini's rows, one row,
# D = 5, a 4-D input, the widest d_model of the registry (qwen2-72b)
RMSNORM_SHAPES = [
    ((4, 1024, 864), torch.bfloat16, torch.float32),
    ((4, 1024, 3072), torch.bfloat16, torch.float32),
    ((4, 1024, 864), torch.float32, torch.float32),
    ((1, 3072), torch.float32, torch.bfloat16),
    ((3, 7, 5), torch.bfloat16, torch.bfloat16),
    ((2, 3, 4, 864), torch.float32, torch.float32),
    ((3, 8192), torch.bfloat16, torch.float32),
    ((17, 1), torch.float32, torch.float32),
]
# (rtol, atol): the sum of squares is taken in another order; bf16 outputs
# may land one bf16 ulp (at most 2^-7 of the value) apart
RMSNORM_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2.0 ** -7, 2.0 ** -10)}


@pytest.mark.parametrize("shape,dtype,g_dtype", RMSNORM_SHAPES)
def test_rmsnorm_kernel_matches_plain(cuda, shape, dtype, g_dtype):
    gen = torch.Generator(device=cuda).manual_seed(sum(shape))
    x = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    x.view(-1, shape[-1])[0] = 0  # a row of zeros gives zeros
    g = (0.5 * torch.randn(shape[-1], generator=gen, device=cuda)).to(g_dtype)
    got = rmsnorm(x, g)
    rtol, atol = RMSNORM_TOL[dtype]
    torch.testing.assert_close(got.float(), rmsnorm_plain(x, g).float(), rtol=rtol, atol=atol)
    assert got.dtype == dtype and got.shape == x.shape
    assert not got.view(-1, shape[-1])[0].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [1, 5, 864, 3072, 8192])
def test_rmsnorm_row_instances_match_plain(cuda, dtype, D):
    """Contiguous rows and rows of a wider tensor read through their stride
    from elements 0 (16-byte loads where D allows) and 1 (element by
    element), at the widths whose chunk counts are fixed at compile time;
    a row of zeros gives zeros."""
    gen = torch.Generator(device=cuda).manual_seed(D)
    wide = torch.randn(4, 64, D + 136, generator=gen, device=cuda).to(dtype)
    g = (0.5 * torch.randn(D, generator=gen, device=cuda))
    rtol, atol = RMSNORM_TOL[dtype]
    for x in (wide[..., :D].contiguous(), wide[..., :D], wide[..., 1:D + 1]):
        x[0, 0] = 0
        got = rmsnorm(x, g)
        torch.testing.assert_close(got.float(), rmsnorm_plain(x.contiguous(), g).float(),
                                   rtol=rtol, atol=atol)
        assert not got[0, 0].any()


def test_rmsnorm_kernel_takes_views_counts_launches_and_refuses(cuda):
    """Rows of a wider tensor are read in place through their row stride,
    with 128-bit loads where the rows start 16-byte aligned and one element
    at a time where they do not; a call the kernel does not take raises
    before anything runs."""
    wide = torch.randn(4, 100, 1000, device=cuda)
    g = torch.randn(2 * 864, device=cuda)[::2]
    before = rmsnorm.launches
    for x in (wide[..., :864], wide[..., 1:865]):
        got = ops.rmsnorm(x, g, eps=1e-5)
        want = rmsnorm_plain(x.contiguous(), g.contiguous(), eps=1e-5)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert rmsnorm.launches == before + 2
    with pytest.raises(ValueError, match="fp32 or bf16 x"):
        ops.rmsnorm(x.half(), g)
    with pytest.raises(ValueError, match="fp32 or bf16 g"):
        ops.rmsnorm(x, g.half())
    with pytest.raises(ValueError, match="last dim"):
        ops.rmsnorm(x.transpose(1, 2), torch.randn(100, device=cuda))
    with pytest.raises(ValueError, match="g has shape"):
        ops.rmsnorm(x, g[:-1])
    assert rmsnorm.launches == before + 2


def test_no_model_path_launches_short_conv_or_rmsnorm(cuda):
    """The two kernels are reached only through kernels.ops: the served
    paths of both model families launch neither."""
    before = short_conv_gate.launches, rmsnorm.launches
    for arch in ("hyena-153m", "phi4-mini-3.8b"):
        cfg = get_config(arch).reduced()
        if arch.startswith("phi4"):
            cfg = dataclasses.replace(cfg, head_dim=64)
        params = lm.init_lm(cfg, seed=0, device=cuda)
        prompts = torch.randint(0, cfg.vocab_size, (2, 40), device=cuda,
                                generator=torch.Generator(device=cuda).manual_seed(1))
        generate(params, cfg, prompts, scfg=ServeConfig(max_len=64), max_new_tokens=3)
    assert (short_conv_gate.launches, rmsnorm.launches) == before


def test_generate_refuses_blockfft_overlap_past_the_kernel_range_before_any_launch(cuda):
    """An 8193-token prompt on the two-level backend raises from lm.prefill
    before the embedding: no kernel launches."""
    cfg = get_config("hyena-153m").reduced()
    params = lm.init_lm(cfg, seed=0, device=cuda)
    prompts = torch.randint(0, cfg.vocab_size, (1, 8193), device=cuda,
                            generator=torch.Generator(device=cuda).manual_seed(3))
    counts = lambda: (twolevel_fft_conv.launches, toeplitz_conv.launches,
                      flash_attention.launches, short_conv_gate.launches, rmsnorm.launches)
    before = counts()
    scfg = ServeConfig(max_len=8200, conv_backend="blockfft_overlap")
    with pytest.raises(ValueError, match="L <= 8192 on CUDA, got 8193"):
        generate(params, cfg, prompts, scfg=scfg, max_new_tokens=2)
    assert counts() == before
