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
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_plain
from repro_torch.kernels.short_conv import short_conv_gate, short_conv_gate_plain
from repro_torch.kernels.toeplitz_conv import toeplitz_conv, toeplitz_conv_plain
from repro_torch.kernels.twolevel_fft import launch_with_spectrum, twolevel_fft_conv
from repro_torch.serve.engine import ServeConfig, ServeEngine, generate
from repro_torch.models import lm

pytestmark = pytest.mark.cuda

# (rtol, atol): fp32 outputs differ by the order of the DFT sums; bf16
# outputs may land one bf16 ulp (2^-7 of the value) apart, plus the gate's
# own rounding
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
    """The kernel alone, given the spectrum, computes what the wrapper does
    (bit for bit), counts its launch, and refuses a spectrum that does not
    fit u."""
    u, h, skip, gate = _inputs(2, 1000, 33, torch.bfloat16, cuda)
    H = filter_spectrum(h, 2000, (40, 50))
    before = twolevel_fft_conv.launches
    got = launch_with_spectrum(u, H, skip, gate)
    assert twolevel_fft_conv.launches == before + 1
    assert torch.equal(got, twolevel_fft_conv(u, h, skip, gate, factors=(40, 50)))
    with pytest.raises(ValueError, match="complex64 spectrum"):
        launch_with_spectrum(u[:, :500], H, skip, gate[:, :500])  # N = 1000
    with pytest.raises(ValueError, match="complex64 spectrum"):
        launch_with_spectrum(u, H.real, skip, gate)


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
# and a call without the causal mask
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
]
# (rtol, atol): fp32 outputs differ by the order of the fp32 sums; bf16
# outputs may land one bf16 ulp (2^-7 of the value) apart
FLASH_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2.0 ** -6, 2.0 ** -10)}


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
    before = flash_attention.launches
    got = ops.flash_attention(q, k, v, q_offset=5, window=40)
    assert flash_attention.launches == before + 1
    want = flash_attention_plain(q.contiguous(), k.contiguous(), v.contiguous(),
                                 q_offset=5, window=40)
    torch.testing.assert_close(got.float(), want.float(), rtol=2.0 ** -6, atol=2.0 ** -10)
    with pytest.raises(ValueError, match="head dims"):
        flash_attention(*_qkv(1, 2, 1, 8, 8, 96, torch.bfloat16, cuda))
    with pytest.raises(ValueError, match="multiple of Hkv"):
        flash_attention(*_qkv(1, 3, 2, 8, 8, 64, torch.bfloat16, cuda))
    with pytest.raises(ValueError, match="fp32 or bf16"):
        flash_attention(*_qkv(1, 2, 1, 8, 8, 64, torch.float16, cuda))
    assert flash_attention.launches == before + 1


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


# (B, L, D, K, w dtype): hyena-153m's projection ((N+1)·D = 2592 channels,
# K = 3), K = 1, K = 4, K = 8 with L < K − 1, L = 1, a ragged D, a bf16 w
SHORT_CONV_SHAPES = [
    (4, 1024, 2592, 3, torch.float32), (2, 300, 2592, 1, torch.float32),
    (2, 300, 2592, 4, torch.float32), (2, 5, 64, 8, torch.bfloat16),
    (3, 1, 2592, 3, torch.float32), (2, 100, 33, 3, torch.bfloat16),
]
# (rtol, atol): the kernel's fp32 sums equal the plain version's bit for
# bit (the same products, rounded before each add, in the same order), so
# the bf16 downcast agrees too; the bound is one bf16 ulp
SHORT_CONV_TOL = {torch.float32: (1e-6, 1e-6), torch.bfloat16: (2.0 ** -7, 2.0 ** -10)}


def _short_conv_inputs(B, L, D, K, dtype, w_dtype, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    u = torch.randn(B, L, D, generator=g, device=device).to(dtype)
    w = torch.randn(D, K, generator=g, device=device).to(w_dtype)
    gate = torch.randn(B, L, D, generator=g, device=device).to(dtype)
    return u, w, gate


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,L,D,K,w_dtype", SHORT_CONV_SHAPES)
def test_short_conv_kernel_matches_plain(cuda, dtype, B, L, D, K, w_dtype):
    u, w, gate = _short_conv_inputs(B, L, D, K, dtype, w_dtype, cuda, seed=L + D + K)
    rtol, atol = SHORT_CONV_TOL[dtype]
    for g in (gate, None):
        got = short_conv_gate(u, w, g)
        torch.testing.assert_close(got.float(), short_conv_gate_plain(u, w, g).float(),
                                   rtol=rtol, atol=atol)
        assert got.dtype == dtype and got.shape == u.shape


def test_short_conv_kernel_takes_views_counts_launches_and_refuses(cuda):
    """Views of a wider projection and a transposed w are read in place; a
    call the kernel does not take raises before anything runs."""
    B, L, D, K = 2, 300, 40, 3
    z = torch.randn(B, L, 3 * D, device=cuda).bfloat16()
    u, gate = z[..., :D], z[..., D:2 * D]
    w = torch.randn(K, D, device=cuda).t()
    before = short_conv_gate.launches
    got = ops.short_conv_gate(u, w, gate)
    assert short_conv_gate.launches == before + 1
    want = short_conv_gate_plain(u.contiguous(), w.contiguous(), gate.contiguous())
    torch.testing.assert_close(got.float(), want.float(), rtol=2.0 ** -7, atol=2.0 ** -10)
    with pytest.raises(ValueError, match="fp32 or bf16 u"):
        ops.short_conv_gate(u.half(), w)
    with pytest.raises(ValueError, match="fp32 or bf16 w"):
        ops.short_conv_gate(u, w.half())
    with pytest.raises(ValueError, match="last dim"):
        ops.short_conv_gate(u.transpose(1, 2).contiguous().transpose(1, 2), w)
    with pytest.raises(ValueError, match="K <= 8"):
        ops.short_conv_gate(u, torch.randn(D, 9, device=cuda))
    with pytest.raises(ValueError, match="gate must be"):
        ops.short_conv_gate(u, w, gate.float())
    assert short_conv_gate.launches == before + 1


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
