"""The CUDA kernels of the PyTorch port against their plain versions, on
the card.  Every test here needs a CUDA device and skips without one; run
them on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/port/test_torch_cuda.py

This file imports no JAX, so it runs where only PyTorch is installed.
"""
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.blockfft import blockfft_causal_conv
from repro_torch.core.blockfft import filter_spectrum
from repro_torch.kernels.twolevel_fft import launch_with_spectrum, twolevel_fft_conv
from repro_torch.serve.engine import ServeConfig, generate
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
