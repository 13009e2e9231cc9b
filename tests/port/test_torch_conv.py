"""Conv and operator parity of the PyTorch port against the JAX package.

(b) The port's ``blockfft_overlap`` on CPU tensors (the plain four-step
version beside the CUDA kernel) against the JAX Pallas kernel body run in
interpret mode, on the shapes of the JAX kernel's own tail-block tests,
including a non-power-of-two (R, S) split and a D that the JAX kernel pads.
(c) Filters, the short conv and the decode step against JAX at fp32.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")  # the JAX package is the reference
import jax.numpy as jnp  # noqa: E402
import torch

from repro.core import filters as JF
from repro.core.blockfft import _factor as jax_factor
from repro.core.blockfft import factor_candidates as jax_factor_candidates
from repro.core.fftconv import direct_causal_conv as jax_direct
from repro.core.fftconv import next_fast_len as jax_next_fast_len
from repro.core.fftconv import short_causal_conv as jax_short_conv
from repro.core.operator import HyenaConfig as JHyenaConfig
from repro.core.operator import hyena_decode_step as jax_decode_step
from repro.core.operator import init_decode_cache as jax_init_cache
from repro.core.operator import init_hyena as jax_init_hyena
from repro.common.param import split_params
from repro.kernels.twolevel_fft import twolevel_fft_conv as jax_twolevel
from repro_torch.core import blockfft as TB
from repro_torch.core import filters as TF
from repro_torch.core.conv_api import ENV_VAR, get_conv_backend, resolve_conv_backend
from repro_torch.core.fftconv import next_fast_len, short_causal_conv
from repro_torch.core.operator import (
    HyenaConfig,
    hyena_decode_step,
    init_decode_cache,
    init_hyena,
    precompute_decode_filters,
)
from repro_torch.models.hyena import hyena_prefill
from repro_torch.kernels import twolevel_fft as TL
from repro_torch.kernels.twolevel_fft import launch_with_spectrum, twolevel_fft_conv

from torch_port_util import TORCH_THREADS, free_jax_programs, t, tf32  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    yield
    torch.set_num_threads(prev)


def _conv_inputs(B, L, D, seed):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((B, L, D)).astype(np.float32)
    h = (rng.standard_normal((D, L)) / L).astype(np.float32)
    skip = rng.standard_normal((D,)).astype(np.float32)
    gate = rng.standard_normal((B, L, D)).astype(np.float32)
    return u, h, skip, gate


def test_next_fast_len_and_factors_match_jax():
    for n in list(range(1, 300)) + [1999, 2047, 4095, 16383]:
        assert next_fast_len(n) == jax_next_fast_len(n)
    for N in (16, 200, 2000, 2048, 4096, 16384):
        assert TB._factor(N) == jax_factor(N)
        assert TB.factor_candidates(N) == jax_factor_candidates(N)
    assert TB._factor(2000) == (40, 50) and TB._factor(200) == (10, 20)


def test_factors_that_miss_n_are_refused():
    """The port keeps no stored plans, so a split that does not multiply to
    N is the caller's mistake: the plain version and the kernel's wrapper
    raise rather than fall back to the default split."""
    u, h, skip, gate = (t(a) for a in _conv_inputs(1, 100, 3, 0))  # N = 200
    assert TB.resolve_factors(200, None) == (10, 20)
    assert TB.resolve_factors(200, (20, 10)) == (20, 10)
    for conv in (TB.blockfft_causal_conv, twolevel_fft_conv):
        with pytest.raises(ValueError, match="do not multiply to N=200"):
            conv(u, h, skip, gate, factors=(16, 16))


def test_launch_with_spectrum_refuses_cpu_tensors():
    """The kernel alone has no plain version to run: on CPU tensors it
    raises before it reaches the CUDA library."""
    u, h, skip, gate = (t(a) for a in _conv_inputs(1, 100, 3, 0))
    H = TB.filter_spectrum(h, 200, (10, 20))
    with pytest.raises(ValueError, match="CUDA tensors"):
        launch_with_spectrum(u, H, skip, gate)


def _tf32_blockfft_causal_conv(u, h, skip, gate, factors):
    """The bf16 kernel's rounding on the CPU: blockfft_causal_conv with the
    operands of each of its four products, and of the two that transform
    the taps into H, rounded to TF32, the sums in fp32, and the twiddles,
    the product with H, the scale and the epilogue in fp32."""
    B, L, D = u.shape
    N = next_fast_len(2 * L - 1)
    R, S = factors
    FR, FS, TW = (m.clone() for m in TB.dft_tables(N, (R, S), "cpu"))
    FR, FS = tf32(FR), tf32(FS)

    def forward(x):  # (B', N, D) real -> stage 2's output (B', R, S, D)
        A = tf32(x.reshape(x.shape[0], R, S, D).to(torch.complex64))
        X = torch.einsum("kr,brsd->bksd", FR, A) * TW[None, :, :, None]
        return torch.einsum("bksd,sj->bkjd", tf32(X), FS)

    u32 = u.float()
    C = forward(torch.nn.functional.pad(u32, (0, 0, 0, N - L)))
    H = forward(torch.nn.functional.pad(h.float().T, (0, 0, 0, N - L))[None])
    Dm = torch.einsum("bkjd,sj->bksd", tf32(C * H), FS.conj()) * TW.conj()[None, :, :, None]
    y = torch.einsum("kr,bksd->brsd", FR.conj(), tf32(Dm)).real.reshape(B, N, D)[:, :L] / N
    if skip is not None:
        y = y + u32 * skip.float()
    y = y.to(u.dtype)
    return y if gate is None else y * gate


def test_twolevel_tolerance_states_the_tf32_bound():
    """TOLERANCE's values, and the rounding its derivation rests on: TF32
    by round-to-nearest (ties away) is off by at most 2^-11 of the value."""
    assert TL.TOLERANCE == {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2.0 ** -6, 2.0 ** -10)}
    x = torch.tensor([1 + 2.0 ** -11, 1 + 2.0 ** -12, -(1 + 2.0 ** -11), 3.0, 0.0])
    assert tf32(x).tolist() == [1 + 2.0 ** -10, 1.0, -(1 + 2.0 ** -10), 3.0, 0.0]
    r = torch.from_numpy(np.random.default_rng(0).standard_normal(10_000).astype(np.float32))
    assert ((tf32(r) - r).abs() <= 2.0 ** -11 * r.abs()).all()


@pytest.mark.parametrize("B,L,D,factors", [(2, 1024, 4, (64, 32)), (1, 37, 3, (5, 15)),
                                           (1, 1000, 3, (40, 50))])
def test_tf32_rounding_model_holds_the_bf16_gate(B, L, D, factors):
    """The bf16 kernel's TF32 products, modelled on the CPU, stay inside the
    unchanged bf16 gate against the plain version (TOLERANCE), with at
    least a fourfold margin on atol, gated with skip and bare."""
    rng = np.random.default_rng(L + D)
    u = torch.from_numpy(rng.standard_normal((B, L, D)).astype(np.float32)).bfloat16()
    h = torch.from_numpy((rng.standard_normal((D, L)) / L).astype(np.float32))
    skip = torch.from_numpy(rng.standard_normal(D).astype(np.float32))
    gate = torch.from_numpy(rng.standard_normal((B, L, D)).astype(np.float32)).bfloat16()
    rtol, atol = TL.TOLERANCE[torch.bfloat16]
    for sk, g in ((skip, gate), (None, None)):
        got = _tf32_blockfft_causal_conv(u, h, sk, g, factors).float()
        want = TB.blockfft_causal_conv(u, h, sk, g, factors=factors).float()
        excess = ((got - want).abs() - rtol * want.abs()).max().item()
        assert excess <= atol / 4, (sk is not None, g is not None, excess)


@pytest.mark.parametrize("factors", [(5, 15), (40, 50), (64, 32), (32, 64)])
def test_tensor_core_tables_are_the_dft_matrices_in_fragment_order(factors):
    """Read back through mma.m16n8k8's fragment layout (lane l: g = l // 4,
    q = l % 4; A holds (g, q), (g+8, q), (g, q+4), (g+8, q+4), B holds
    (q, g), (q+4, g), C holds (g, 2q), (g, 2q+1), (g+8, 2q), (g+8, 2q+1)),
    the kernel's tables are FR with its k columns in ``krow`` order, FS with
    k-slot q of step j on row 8j + 2q and q + 4 on 8j + 2q + 1 (the order
    in which a C fragment is the next stage's A fragment) and its negated
    imaginary part, and TW in C order, each zero past R and S."""
    R, S = factors
    N = R * S
    MT, NT, Rp = TL._tc_dims(R, S)
    Sp, KR = 8 * NT, 2 * MT
    _, _, FR, FS, TW = TB._dft_mats(N, factors)
    sizes = [2 * Rp * Rp, 128 * NT * NT, 64 * NT * NT, 256 * MT * NT]
    tab = TL._tc_tables(N, factors)
    assert tab.size == sum(sizes)
    fr, fs, fsn, tw = np.split(tab, np.cumsum(sizes)[:-1])
    lane = np.arange(32)
    g, q = lane >> 2, lane & 3

    def padded(m, rows, cols):
        out = np.zeros((rows, cols), np.complex64)
        out[: m.shape[0], : m.shape[1]] = m
        return out

    fr = fr.reshape(MT, KR, 2, 32, 4)
    got = np.full((Rp, Rp), np.nan, np.complex64)
    i = np.arange(KR)[:, None]
    for e, (dr, dk) in enumerate(((0, 0), (8, 0), (0, 4), (8, 4))):
        for mt in range(MT):
            got[16 * mt + g + dr, TL.krow(i, q + dk)] = fr[mt, :, 0, :, e] + 1j * fr[mt, :, 1, :, e]
    np.testing.assert_array_equal(got, padded(FR, Rp, Rp))

    fs, fsn = fs.reshape(NT, NT, 32, 4), fsn.reshape(NT, NT, 32, 2)
    got = np.full((Sp, Sp), np.nan, np.complex64)
    j = np.arange(NT)[:, None, None]
    jn = np.arange(NT)[None, :, None]
    for half in (0, 1):
        got[8 * j + 2 * q + half, 8 * jn + g] = fs[..., half] + 1j * fs[..., 2 + half]
        np.testing.assert_array_equal(fsn[..., half], -fs[..., 2 + half])
    np.testing.assert_array_equal(got, padded(FS, Sp, Sp))

    tw = tw.reshape(MT, NT, 2, 32, 4)
    got = np.full((Rp, Sp), np.nan, np.complex64)
    mt = np.arange(MT)[:, None, None]
    for e in range(4):
        got[16 * mt + g + 8 * (e >> 1), 8 * jn + 2 * q + (e & 1)] = (
            tw[:, :, 0, :, e] + 1j * tw[:, :, 1, :, e])
    np.testing.assert_array_equal(got, padded(TW, Rp, Sp))


def test_tensor_core_launch_shapes_fit_the_card():
    """Every split the tensor-core instance takes, at the served and small
    shapes, launches within its bounds; the served shape runs four teams,
    each computing H once per channel (all four batch rows)."""
    assert TL.tc_launch_shape(64, 32, 4, 1024, 864, 132)[::4] == (4, 4)
    for R in range(1, TL.TC_MAX_R + 1):
        for S in (1, 7, 8, 15, 27, 32, 33, 50, 64):
            L = (R * S + 1) // 2
            for B, D in ((4, 864), (1, 3)):
                teams, threads, smem, grid, bpu = TL.tc_launch_shape(R, S, B, L, D, 132)
                MT, NT, _ = TL._tc_dims(R, S)
                assert 1 <= teams <= min(TL.TC_MAX_TEAMS, D)
                assert threads == 32 * MT * teams <= (512 if NT <= 4 else 256)
                assert smem == TL.tc_smem_bytes(R, S, L, teams) <= TL.SMEM_PER_BLOCK
                assert 1 <= grid and 1 <= bpu <= B


# the shapes of tests/test_conv_backends_prop.py::test_twolevel_pallas_gated_tail_blocks
@pytest.mark.parametrize(
    "B,L,D,bd,ov", [(2, 100, 5, 4, 2), (1, 37, 3, 2, 4), (2, 64, 4, 4, 2)]
)
def test_blockfft_overlap_matches_jax_kernel_body(B, L, D, bd, ov):
    N = jax_next_fast_len(2 * L - 1)
    factors = jax_factor_candidates(N, limit=2)[0]  # e.g. (10, 20) at L=100
    u, h, skip, gate = _conv_inputs(B, L, D, L * 7 + D)
    backend = get_conv_backend("blockfft_overlap")
    for sk, g in ((skip, gate), (skip, None), (None, None), (None, gate)):
        want = np.asarray(jax_twolevel(
            jnp.asarray(u), jnp.asarray(h),
            None if sk is None else jnp.asarray(sk),
            None if g is None else jnp.asarray(g),
            factors=factors, block_d=bd, overlap=ov, interpret=True,
        ))
        tu, th = t(u), t(h)
        tsk = None if sk is None else t(sk)
        tg = None if g is None else t(g)
        got = twolevel_fft_conv(tu, th, tsk, tg, factors=factors).numpy()
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4,
                                   err_msg=f"skip={sk is not None} gate={g is not None}")
        # the registered backend (default split) computes the same conv
        np.testing.assert_allclose(backend(tu, th, tsk, tg).numpy(), want,
                                   rtol=2e-4, atol=2e-4)
    # DESIGN §7 within the port: gated == gate * ungated, bit for bit
    for dtype in (torch.float32, torch.bfloat16):
        tu, tg = t(u).to(dtype), t(gate).to(dtype)
        fused = twolevel_fft_conv(tu, t(h), t(skip), tg, factors=factors)
        two_pass = tg * twolevel_fft_conv(tu, t(h), t(skip), factors=factors)
        assert fused.dtype == dtype
        assert torch.equal(fused, two_pass)


@pytest.mark.parametrize("name", ["fft", "fft_local", "direct", "blockfft", "blockfft_overlap"])
@pytest.mark.parametrize("L", [1, 33, 100])
def test_conv_backends_match_jax_direct(name, L):
    u, h, skip, gate = _conv_inputs(2, L, 3, L)
    want = np.asarray(jax_direct(*(jnp.asarray(a) for a in (u, h, skip, gate))))
    got = get_conv_backend(name)(t(u), t(h), t(skip), t(gate)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


# ------------------------------------------------------------------ (c)

def _filter_cfgs(width, pos_dim, D=64, order=2):
    kw = dict(d_model=D, order=order, ffn_width=width, pos_dim=pos_dim)
    return JF.FilterConfig(**kw), TF.FilterConfig(**kw)


def test_positional_encoding_matches_jax():
    for L in (1, 2, 100, 256):
        for pos_dim in (9, 65):
            want = np.asarray(JF.positional_encoding(L, pos_dim))
            got = TF.positional_encoding(L, pos_dim, "cpu").numpy()
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
            np.testing.assert_array_equal(got[:, 0], want[:, 0])  # the t grid


def _filters_f64(values, cfg, L):
    """Algorithm 2 in float64 numpy on the same weights: an independent
    evaluation whose own rounding error is negligible at fp32 scale."""
    K = (cfg.pos_dim - 1) // 2
    t = np.linspace(0.0, 1.0, L)[:, None]
    ang = 2 * np.pi * np.arange(K)[None, :] * t
    h = np.concatenate([t, np.cos(ang), np.sin(ang)], axis=-1)
    for i, layer in enumerate(values["ffn"]):
        h = h @ np.asarray(layer["w"], np.float64) + np.asarray(layer["b"], np.float64)
        if i < len(values["ffn"]) - 1:
            h = np.sin(cfg.sine_freq * h)
    rate = np.exp(np.asarray(values["decay_log_rate"], np.float64))[None, :]
    bias = np.asarray(values["window_bias"], np.float64)[None, :]
    grid = np.arange(L)[:, None] / max(L, 1)
    h = h * (np.exp(-rate * grid * 8.0) + 0.1 / (1.0 + np.exp(-bias)))
    h = h.reshape(L, cfg.order, cfg.d_model).transpose(1, 2, 0)
    return h / (np.abs(h).sum(axis=-1, keepdims=True) + 1e-8)


@pytest.mark.parametrize("width,pos_dim", [(16, 9), (64, 65)])
@pytest.mark.parametrize("L", [64, 256])
def test_evaluate_filters_matches_jax(width, pos_dim, L):
    """Tolerance: 5e-4·max|h|.  The sine FFN (ω = 14, three sine layers)
    multiplies a last-bit difference between the two CPU GEMMs' summation
    orders by about 10³; measured up to 1.8e-4·max|h| at width 16.  That
    is the reference's own fp32 accuracy: JAX's filters differ from a
    float64 evaluation of the same weights by up to 1.5e-3·max|h|, and the
    port must be as close to it as JAX is (within 1.5×; measured 0.89–1.21×
    over 24 draws).  The positional basis, window and l1 normalisation
    alone agree to 1e-5 (test_positional_encoding_matches_jax,
    test_filter_window_matches_jax)."""
    jcfg, tcfg = _filter_cfgs(width, pos_dim)
    values, _ = split_params(JF.init_hyena_filter(jax.random.PRNGKey(L), jcfg))
    params = jax.tree_util.tree_map(t, values)
    want = np.asarray(JF.evaluate_filters(values, jcfg, L))
    got = TF.evaluate_filters(params, tcfg, L).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-4 * scale)
    exact = _filters_f64(jax.tree_util.tree_map(np.asarray, values), jcfg, L)
    jax_err = np.abs(want - exact).max()
    assert np.abs(got - exact).max() <= 1.5 * jax_err + 1e-6 * scale
    np.testing.assert_allclose(
        TF.filter_skip(params, tcfg).numpy(), np.asarray(JF.filter_skip(values, jcfg)),
        rtol=0, atol=0,
    )


def test_filter_window_matches_jax():
    """With a depth-2 FFN whose hidden layer is fed through exactly
    representable weights, evaluate_filters reduces to the basis, one sine,
    the window and the l1 normalisation: these match JAX at 1e-5."""
    jcfg, tcfg = _filter_cfgs(16, 9, D=8)
    jcfg = JF.FilterConfig(**{**jcfg.__dict__, "ffn_depth": 2})
    tcfg = TF.FilterConfig(**{**tcfg.__dict__, "ffn_depth": 2})
    rng = np.random.default_rng(0)
    values = {
        # one nonzero weight per column: each product is a single rounding
        "ffn": [
            {"w": np.eye(9, 16, dtype=np.float32) * 0.5, "b": np.zeros(16, np.float32)},
            {"w": np.eye(16, 16, dtype=np.float32) * 0.25, "b": np.full(16, 0.125, np.float32)},
        ],
        "decay_log_rate": rng.uniform(-1.2, 0.4, 16).astype(np.float32),
        "window_bias": rng.standard_normal(16).astype(np.float32),
        "skip": rng.standard_normal(16).astype(np.float32),
    }
    for L in (16, 200):
        want = np.asarray(JF.evaluate_filters(jax.tree_util.tree_map(jnp.asarray, values), jcfg, L))
        got = TF.evaluate_filters(jax.tree_util.tree_map(t, values), tcfg, L).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_short_causal_conv_matches_jax():
    rng = np.random.default_rng(1)
    u = rng.standard_normal((2, 50, 12)).astype(np.float32)
    w = rng.standard_normal((12, 3)).astype(np.float32)
    b = rng.standard_normal((12,)).astype(np.float32)
    for bias in (None, b):
        want = np.asarray(jax_short_conv(jnp.asarray(u), jnp.asarray(w),
                                         None if bias is None else jnp.asarray(bias)))
        got = short_causal_conv(t(u), t(w), None if bias is None else t(bias)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("order", [2, 3])
def test_decode_step_matches_jax(order):
    """A few decode steps from the same mid-sequence cache (random operand
    history, row cursors 5 and 9, taps given) agree with JAX at fp32."""
    D, B, Lc = 8, 2, 16
    fc = dict(d_model=D, order=order, ffn_width=16, pos_dim=9)
    jcfg = JHyenaConfig(d_model=D, order=order, filter=JF.FilterConfig(**fc))
    tcfg = HyenaConfig(d_model=D, order=order, filter=TF.FilterConfig(**fc))
    values, _ = split_params(jax_init_hyena(jax.random.PRNGKey(order), jcfg))
    params = jax.tree_util.tree_map(t, values)
    rng = np.random.default_rng(order)
    h = (rng.standard_normal((order, D, Lc)) / Lc).astype(np.float32)
    skip = rng.standard_normal((order, D)).astype(np.float32)
    cache = jax_init_cache(jcfg, B, Lc, jnp.float32)
    cache = {
        "short": rng.standard_normal(cache["short"].shape).astype(np.float32),
        "long": rng.standard_normal(cache["long"].shape).astype(np.float32),
        "t": np.array([5, 9], np.int32),
        "h": h,
        "skip": skip,
    }
    jc = {k: jnp.asarray(v) for k, v in cache.items()}
    tc = {k: t(v) for k, v in cache.items()}
    for step in range(3):
        u_t = rng.standard_normal((B, D)).astype(np.float32)
        jy, jc = jax_decode_step(values, jcfg, jnp.asarray(u_t), jc)
        ty, tc = hyena_decode_step(params, tcfg, t(u_t), tc)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5,
                                   err_msg=f"step {step}")
        for k in ("short", "long", "t"):
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), rtol=1e-5,
                                       atol=1e-5, err_msg=f"cache {k} step {step}")


def test_resolve_conv_backend(monkeypatch):
    monkeypatch.delenv(ENV_VAR, raising=False)
    assert resolve_conv_backend() == "fft"
    assert resolve_conv_backend("blockfft_overlap") == "blockfft_overlap"
    monkeypatch.setenv(ENV_VAR, "blockfft")
    assert resolve_conv_backend() == "blockfft"
    assert resolve_conv_backend("direct") == "direct"
    monkeypatch.setenv(ENV_VAR, "nope")
    with pytest.raises(ValueError, match=r"\$REPRO_CONV_BACKEND"):
        resolve_conv_backend()
    assert get_conv_backend("toeplitz").supports_gate
    with pytest.raises(ValueError, match="registered"):
        get_conv_backend("fft_sp")  # context parallelism: not ported yet


def test_blockfft_overlap_refuses_past_the_kernel_range_on_cuda_only():
    """On a CUDA device the backend's check refuses L past the two-level
    kernel's range (MAX_N // 2 = 8192), so a model refuses before any work;
    on the CPU, where the backend runs its plain version, it takes any L,
    as the JAX backend does."""
    backend = get_conv_backend("blockfft_overlap")
    assert backend.cuda_max_len == TL.MAX_N // 2 == 8192
    backend.validate_len(8192, torch.device("cuda"))
    with pytest.raises(ValueError, match="L <= 8192 on CUDA, got 8193"):
        backend.validate_len(8193, torch.device("cuda"))
    backend.validate_len(8193, torch.device("cpu"))
    backend.validate_len(8193)
    get_conv_backend("blockfft").validate_len(8193, torch.device("cuda"))


def test_prefill_checks_the_backend_length_before_the_embedding(monkeypatch):
    """lm.prefill checks the length against the backend that ctx resolves,
    before the embedding runs (here the CPU's one limited backend,
    ``direct``, L <= 4096)."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.models.mixer_api import ApplyContext

    cfg = get_config("hyena-153m").reduced()
    params = lm.init_lm(cfg, seed=0, device="cpu")

    def no_embed(*args, **kw):
        raise AssertionError("the embedding ran before the length check")

    monkeypatch.setattr(lm, "embed", no_embed)
    tokens = torch.zeros((1, 4097), dtype=torch.int64)
    with pytest.raises(ValueError, match="supports L <= 4096, got 4097"):
        lm.prefill(params, cfg, tokens, 4097, ctx=ApplyContext(conv_backend="direct"))


@pytest.mark.parametrize("order", [2, 3])
def test_decode_continues_prefill(order):
    """Within the port: decoding a sequence token by token from an empty
    cache with precomputed taps reproduces the teacher-forced prefill on
    the same max_len grid (fp32; the two sum the conv in different
    orders)."""
    D, B, L, max_len = 8, 2, 12, 16
    fc = TF.FilterConfig(d_model=D, order=order, ffn_width=16, pos_dim=9)
    cfg = HyenaConfig(d_model=D, order=order, filter=fc)
    gen = torch.Generator().manual_seed(order)
    params = init_hyena(cfg, gen, "cpu")
    x = torch.randn(B, L, D, generator=gen)
    want, _ = hyena_prefill(params, cfg, x, max_len, torch.float32, conv_backend="direct")
    cache = init_decode_cache(cfg, B, max_len, torch.float32, "cpu")
    cache = precompute_decode_filters(params, cfg, max_len, cache)
    for step in range(L):
        y, cache = hyena_decode_step(params, cfg, x[:, step], cache)
        torch.testing.assert_close(y, want[:, step], rtol=1e-4, atol=1e-4)
    assert cache["t"].tolist() == [L] * B


def test_decode_without_taps_evaluates_the_filters_once(monkeypatch):
    """Decoding from ``lm.init_caches`` (no taps in the cache) evaluates each
    layer's filters once over two steps, with the same logits as taps
    precomputed by hand; replacing a layer's filter tensors, or updating
    one in place, evaluates that layer's filters anew."""
    from repro_torch.common.tree import tree_map
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.models.mixer_api import get_mixer

    cfg = get_config("hyena-153m").reduced()
    params = lm.init_lm(cfg, seed=0, device="cpu")
    calls = []
    evaluate = TF.evaluate_filters

    def counted(p, fc, n):
        calls.append(n)
        return evaluate(p, fc, n)

    monkeypatch.setattr(TF, "evaluate_filters", counted)
    tok = torch.tensor([3, 7])

    def two_steps(caches):
        for _ in range(2):
            logits, caches = lm.decode_step(params, cfg, tok, caches, compute_dtype=torch.float32)
        return logits

    fresh = lambda: lm.init_caches(cfg, 2, 16, torch.float32, "cpu")
    got = two_steps(fresh())
    assert calls == [16] * cfg.n_layers
    mc = get_mixer("hyena").make_config(cfg)
    calls.clear()
    with_taps = [precompute_decode_filters(p["mixer"], mc, 16, c)
                 for p, c in zip(params["blocks"], fresh())]
    assert torch.equal(two_steps(with_taps), got)
    assert calls == [16] * cfg.n_layers  # precompute_decode_filters' own
    calls.clear()
    two_steps(fresh())
    assert calls == []  # memoized
    mixer0 = params["blocks"][0]["mixer"]
    mixer0["filters"] = tree_map(torch.clone, mixer0["filters"])
    assert torch.equal(two_steps(fresh()), got)
    assert calls == [16]  # the replaced tensors of layer 0
    with torch.no_grad():
        params["blocks"][1]["mixer"]["filters"]["decay_log_rate"].add_(0.0)
    two_steps(fresh())
    assert calls == [16, 16]  # the in-place update of layer 1
