"""The attention family of the PyTorch port against the JAX package: the
plain version of the flash kernel, RoPE, the four MLP kinds, the
attention and local-attention mixers, phi4-mini-3.8b ``.reduced()`` end to
end, and the port's ``ServeEngine`` on it.

Tolerances, with their reasons:

- fp32 attention outputs (plain version against the Pallas kernel in
  interpret mode, against ``ref.flash_attention`` and ``chunked_attention``,
  and the mixers against JAX): rtol = atol = 1e-5.  Both sides sum the
  same fp32 products in different orders; measured ≤ 1e-6.
- bf16 attention outputs: one bf16 ulp, 2^-7 of the magnitude, where the
  fp32 sums straddle a rounding boundary: rtol = 2^-7, atol = 2^-9.
- The bf16 CUDA kernel against the plain version: rtol = 2^-6, atol =
  2^-7 (``FA.TOLERANCE``, derived there: the kernel rounds p to bf16
  before p·v).  Here the plain version with p so rounded is held to it.
- RoPE and the MLPs at fp32: 1e-5 (sin/cos and pow of two libraries).
- phi4-mini reduced, fp32 prefill logits: 1e-4 on logits of magnitude ~4
  (measured 4.8e-6); greedy fp32 tokens identical.
- bf16 prefill logits: every bf16 rounding can land one ulp apart; over
  two layers and the head that is a few ulps of the logits: atol = 0.25
  and a mean absolute difference below 0.03.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")  # the JAX package is the reference
import jax.numpy as jnp  # noqa: E402
import torch

from repro.common.policy import BF16 as JAX_BF16
from repro.kernels import ref as jax_ref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import lm as jax_lm
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro.serve.engine import generate as jax_generate
from repro_torch.common.policy import BF16
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import lm
from repro_torch.serve.engine import ServeConfig, ServeEngine, generate

from torch_port_util import TORCH_THREADS, free_jax_programs, jax_and_torch_model, t  # noqa: F401

ARCH = "phi4-mini-3.8b"
B, L, MAX_LEN, NEW = 2, 40, 64, 8
TOL = {np.float32: (1e-5, 1e-5), "bfloat16": (2.0 ** -7, 2.0 ** -9)}  # (rtol, atol)

# the JAX references, jitted: one XLA program per shape compiles in ~0.15 s,
# where running them op by op compiles every op of every new shape (~1.3 s)
j_ref = jax.jit(jax_ref.flash_attention, static_argnames=("causal", "window", "scale"))
j_chunked = jax.jit(JA.chunked_attention, static_argnames=("window", "q_offset", "chunk_kv"))
j_rope = jax.jit(JL.apply_rope, static_argnums=2)
j_mlp = jax.jit(JL.apply_mlp, static_argnums=2)
j_apply = jax.jit(JA.apply_attention, static_argnums=1, static_argnames=("pos_offset",))
j_prefill = jax.jit(JA.attention_prefill, static_argnums=(1, 3, 4))
j_decode = jax.jit(JA.attention_decode_step, static_argnums=1)
j_lm_prefill = jax.jit(jax_lm.prefill, static_argnums=(1, 3), static_argnames=("dtype",))


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    yield
    torch.set_num_threads(prev)


def _qkv(Bq, H, Hkv, Lq, Lk, Dh, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((Bq, H, Lq, Dh)).astype(np.float32)
    k = rng.standard_normal((Bq, Hkv, Lk, Dh)).astype(np.float32)
    v = rng.standard_normal((Bq, Hkv, Lk, Dh)).astype(np.float32)
    return q, k, v


def _close(got, want, dtype=np.float32):
    rtol, atol = TOL[dtype]
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


# ------------------------------------------------ the kernel's plain version

# (H, Hkv, Lq, Lk, Dh, window): causal GQA over ragged 16-row blocks, a
# window, decode-like Lq < Lk, and Lq > Lk, whose first Lq - Lk rows see no
# key and must give 0 (the Pallas kernel's l == 0 guard)
PALLAS_CASES = [
    (4, 2, 40, 40, 16, None),
    (4, 2, 40, 40, 16, 12),
    (4, 1, 7, 40, 32, None),
    (2, 2, 40, 24, 16, None),
]


@pytest.mark.parametrize("H,Hkv,Lq,Lk,Dh,window", PALLAS_CASES)
def test_plain_matches_pallas_interpret(H, Hkv, Lq, Lk, Dh, window):
    q, k, v = _qkv(1, H, Hkv, Lq, Lk, Dh, seed=Lq + Lk + Dh)
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=window,
                                blk_q=16, blk_k=16, interpret=True))
    got = ops.flash_attention(t(q), t(k), t(v), window=window)
    _close(got.numpy(), want)
    if Lq > Lk:
        assert not got[:, :, : Lq - Lk].any()
        assert got[:, :, Lq - Lk:].abs().min() > 0


# (H, Hkv, Lq, Lk, Dh, causal, window, scale, dtype): MHA, MQA, non-causal,
# a window without the causal mask, an explicit scale, Dh 64, bf16
REF_CASES = [
    (4, 4, 33, 33, 16, True, None, None, np.float32),
    (4, 1, 33, 33, 16, True, 9, None, np.float32),
    (6, 2, 5, 33, 8, False, None, None, np.float32),
    (2, 1, 20, 20, 8, False, 6, 0.3, np.float32),
    (2, 2, 17, 17, 64, True, None, None, np.float32),
    (4, 2, 33, 33, 16, True, 9, None, "bfloat16"),
]


@pytest.mark.parametrize("H,Hkv,Lq,Lk,Dh,causal,window,scale,dtype", REF_CASES)
def test_plain_matches_ref(H, Hkv, Lq, Lk, Dh, causal, window, scale, dtype):
    q, k, v = _qkv(2, H, Hkv, Lq, Lk, Dh, seed=H + Lq + Dh)
    jd = jnp.float32 if dtype is np.float32 else jnp.bfloat16
    td = torch.float32 if dtype is np.float32 else torch.bfloat16
    want = j_ref(*(jnp.asarray(a, jd) for a in (q, k, v)),
                                   causal=causal, window=window, scale=scale)
    got = FA.flash_attention_plain(*(t(a).to(td) for a in (q, k, v)),
                                   causal=causal, window=window, scale=scale)
    assert got.dtype == td
    _close(got.float().numpy(), np.asarray(want.astype(jnp.float32)), dtype)


@pytest.mark.parametrize("q_offset,window", [(5, None), (-3, 4)])
def test_plain_q_offset_matches_chunked_attention(q_offset, window):
    """The query offset is free (JAX's ``chunked_attention(q_offset=...)``,
    here over three 8-key chunks of its online-softmax scan)."""
    q, k, v = _qkv(2, 4, 2, 20, 20, 8, seed=7)
    tr = lambda a: np.ascontiguousarray(a.transpose(0, 2, 1, 3))  # (B, L, H, Dh)
    want = j_chunked(*(jnp.asarray(tr(a)) for a in (q, k, v)), window=window,
                                q_offset=q_offset, chunk_kv=8)
    got = ops.flash_attention(t(q), t(k), t(v), window=window, q_offset=q_offset)
    _close(got.transpose(1, 2).numpy(), np.asarray(want))


def test_kernel_wrapper_refuses_on_the_cpu():
    q, k, v = (t(a) for a in _qkv(1, 3, 2, 4, 4, 16, seed=0))
    with pytest.raises(ValueError, match="multiple of Hkv"):
        ops.flash_attention(q, k, v)
    q, k, v = (t(a) for a in _qkv(1, 2, 1, 4, 4, 64, seed=0))
    with pytest.raises(ValueError, match="CUDA tensors"):
        FA.flash_attention(q, k, v)
    assert FA.flash_attention.launches == 0


def _plain_p_bf16(q, k, v, *, window=None, q_offset=None):
    """``flash_attention_plain`` (causal) with p rounded to bf16 before p·v,
    as the bf16 tensor-core kernel rounds it: a model of the kernel's one
    extra rounding, kept here and not in the port."""
    Bq, H, Lq, Dh = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    q_offset = Lk - Lq if q_offset is None else q_offset
    qg = (q.float() * Dh ** -0.5).reshape(Bq, Hkv, H // Hkv, Lq, Dh)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float())
    qpos = torch.arange(Lq)[:, None] + q_offset
    kpos = torch.arange(Lk)[None, :]
    mask = kpos <= qpos
    if window is not None:
        mask = mask & (kpos > qpos - window)
    s = torch.where(mask, s, FA.NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True)) * mask
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p.bfloat16().float(), v.float())
    return (o / torch.where(l == 0, 1.0, l)).reshape(Bq, H, Lq, Dh).to(q.dtype)


# (H, Hkv, Lq, Lk, Dh, window, q_offset): a first query block, whose rows
# see 1 to 64 keys; a window of 9; Lq < Lk at a free query offset
P_BF16_CASES = [
    (4, 2, 64, 64, 64, None, None),
    (4, 2, 96, 96, 64, 9, None),
    (4, 1, 24, 80, 128, None, 30),
]


@pytest.mark.parametrize("H,Hkv,Lq,Lk,Dh,window,q_offset", P_BF16_CASES)
def test_bf16_kernel_tolerance_covers_p_rounded_to_bf16(H, Hkv, Lq, Lk, Dh, window, q_offset):
    """The bf16 kernel's tolerance (``FA.TOLERANCE``) holds the one rounding
    it adds to the plain version's function: p in bf16 before p·v."""
    q, k, v = (t(a).bfloat16() for a in _qkv(2, H, Hkv, Lq, Lk, Dh, seed=Lq + Lk))
    got = _plain_p_bf16(q, k, v, window=window, q_offset=q_offset)
    want = FA.flash_attention_plain(q, k, v, window=window, q_offset=q_offset)
    assert not torch.equal(got, want)  # the rounding shows
    rtol, atol = FA.TOLERANCE[torch.bfloat16]
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), rtol=rtol, atol=atol)


def test_bf16_kernel_instance_follows_row_alignment():
    """The wrapper sends views whose rows start on 16 bytes to the
    ``cp.async`` instance and others, such as a split of a projection
    sliced past its first element, to the element-wise one."""
    H, Hkv, Dh = 6, 2, 64
    split = lambda z: [x.unflatten(-1, (-1, Dh)).transpose(1, 2)
                       for x in z.split([H * Dh, Hkv * Dh, Hkv * Dh], dim=-1)]
    width = (H + 2 * Hkv) * Dh
    assert FA.rows_aligned16(*split(torch.zeros(2, 10, width, dtype=torch.bfloat16)))
    assert not FA.rows_aligned16(*split(torch.zeros(2, 10, width + 1, dtype=torch.bfloat16)[..., 1:]))
    assert not FA.rows_aligned16(*split(torch.zeros(2, 10, width + 8, dtype=torch.bfloat16)[..., 1:-7]))


# ------------------------------------------------------- RoPE and the MLPs

@pytest.mark.parametrize("per_row,dtype", [(False, np.float32), (True, np.float32),
                                           (True, "bfloat16")])
def test_apply_rope_matches_jax(per_row, dtype):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 6, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 500, (2, 6)) if per_row else np.arange(6) + 11
    jd = jnp.float32 if dtype is np.float32 else jnp.bfloat16
    td = torch.float32 if dtype is np.float32 else torch.bfloat16
    want = j_rope(jnp.asarray(x, jd), jnp.asarray(pos, jnp.int32), 1e4)
    got = TL.apply_rope(t(x).to(td), t(pos), 1e4)
    assert got.dtype == td
    _close(got.float().numpy(), np.asarray(want.astype(jnp.float32)), dtype)


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu", "squared_relu"])
def test_mlp_matches_jax(kind):
    rng = np.random.default_rng(4)
    names = ("up", "gate", "down") if kind in ("swiglu", "geglu") else ("up", "down")
    values = {n: {"w": (rng.standard_normal((24, 16) if n == "down" else (16, 24)) / 4)
                  .astype(np.float32)} for n in names}
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    want = j_mlp(jax.tree_util.tree_map(jnp.asarray, values), jnp.asarray(x), kind)
    params = jax.tree_util.tree_map(t, values)
    _close(TL.apply_mlp(params, t(x), kind).numpy(), np.asarray(want))
    mine = TL.init_mlp(16, 24, torch.Generator().manual_seed(0), "cpu", kind)
    assert jax.tree_util.tree_structure(mine) == jax.tree_util.tree_structure(params)


# ------------------------------------------------------------------ mixers

D, H, HKV, DH = 32, 4, 2, 8


def _mixer(window, qkv_bias=True, seed=0):
    jcfg = JA.AttentionConfig(d_model=D, n_heads=H, n_kv_heads=HKV, head_dim=DH,
                              qkv_bias=qkv_bias, window=window)
    tcfg = TA.AttentionConfig(d_model=D, n_heads=H, n_kv_heads=HKV, head_dim=DH,
                              qkv_bias=qkv_bias, window=window)
    rng = np.random.default_rng(seed)
    values = {}
    for name, (d_in, d_out) in {"q": (D, H * DH), "k": (D, HKV * DH), "v": (D, HKV * DH),
                                "o": (H * DH, D)}.items():
        values[name] = {"w": (rng.standard_normal((d_in, d_out)) / np.sqrt(d_in)).astype(np.float32)}
        if qkv_bias and name != "o":  # non-zero, so that the biases are exercised
            values[name]["b"] = rng.standard_normal(d_out).astype(np.float32)
    mine = TA.init_attention(tcfg, torch.Generator().manual_seed(seed), "cpu")
    assert jax.tree_util.tree_structure(mine) == jax.tree_util.tree_structure(values)
    jp = jax.tree_util.tree_map(jnp.asarray, values)
    return jcfg, jp, tcfg, jax.tree_util.tree_map(t, values)


def test_apply_attention_with_pos_offset_matches_jax():
    jcfg, jp, tcfg, tp = _mixer(window=None)
    x = np.random.default_rng(5).standard_normal((B, 12, D)).astype(np.float32)
    for off in (0, 5):
        want = j_apply(jp, jcfg, jnp.asarray(x), pos_offset=off)
        _close(TA.apply_attention(tp, tcfg, t(x), pos_offset=off).numpy(), np.asarray(want))


@pytest.mark.parametrize("window", [None, 8])
def test_prefill_and_decode_match_jax(window):
    """Prefill of 20 tokens (a window of 8 wraps its ring buffer), then three
    decode steps with per-row cursors 20 and 13 against JAX, K/V and
    cursors included."""
    jcfg, jp, tcfg, tp = _mixer(window)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((B, 20, D)).astype(np.float32)
    jy, jc = j_prefill(jp, jcfg, jnp.asarray(x), 32, jnp.float32)
    ty, tc = TA.attention_prefill(tp, tcfg, t(x), 32, torch.float32)
    _close(ty.numpy(), np.asarray(jy))
    for key in ("k", "v", "t"):
        _close(tc[key].numpy(), np.asarray(jc[key]))
    cursors = np.array([20, 13], np.int32)
    jc = dict(jc, t=jnp.asarray(cursors))
    tc = dict(tc, t=t(cursors))
    for step in range(3):
        x_t = rng.standard_normal((B, D)).astype(np.float32)
        jy, jc = j_decode(jp, jcfg, jnp.asarray(x_t), jc)
        ty, tc = TA.attention_decode_step(tp, tcfg, t(x_t), tc)
        _close(ty.numpy(), np.asarray(jy))
        for key in ("k", "v", "t"):
            _close(tc[key].numpy(), np.asarray(jc[key]))


def test_decode_keeps_inactive_rows_bytes():
    """With ``active`` False a row's K/V slot keeps its bytes; the active
    row's output and K/V equal JAX's step."""
    jcfg, jp, tcfg, tp = _mixer(window=8)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((B, 11, D)).astype(np.float32)
    jy, jc = j_prefill(jp, jcfg, jnp.asarray(x), 32, jnp.float32)
    _, tc = TA.attention_prefill(tp, tcfg, t(x), 32, torch.float32)
    before = {k: v.clone() for k, v in tc.items()}
    x_t = rng.standard_normal((B, D)).astype(np.float32)
    jy, jc = j_decode(jp, jcfg, jnp.asarray(x_t), jc)
    ty, tc = TA.attention_decode_step(tp, tcfg, t(x_t), tc, torch.tensor([True, False]))
    _close(ty[0].numpy(), np.asarray(jy)[0])
    for key in ("k", "v"):
        assert torch.equal(tc[key][1], before[key][1])
        _close(tc[key][0].numpy(), np.asarray(jc[key])[0])


# ----------------------------------------------- phi4-mini reduced, end to end

@pytest.fixture(scope="module")
def model():
    jcfg, values, tcfg, params = jax_and_torch_model(ARCH)
    prompts = np.random.default_rng(1).integers(0, tcfg.vocab_size, (B, L))
    return jcfg, values, tcfg, params, prompts


def test_phi4_mini_prefill_logits(model):
    jcfg, values, tcfg, params, prompts = model
    for jd, td, policy, jpolicy in ((jnp.float32, torch.float32, None, None),
                                    (jnp.bfloat16, torch.bfloat16, BF16, JAX_BF16)):
        jv = values if jpolicy is None else jpolicy.cast_compute(values)
        tv = params if policy is None else policy.cast_compute(params)
        want, _ = j_lm_prefill(jv, jcfg, jnp.asarray(prompts, jnp.int32), MAX_LEN, dtype=jd)
        got, _ = lm.prefill(tv, tcfg, torch.from_numpy(prompts), MAX_LEN, dtype=td)
        got, want = got.numpy(), np.asarray(want)
        assert np.isfinite(got).all()
        if td is torch.float32:
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=0.25)
            assert np.abs(got - want).mean() < 0.03


def test_phi4_mini_greedy_tokens_identical_fp32(model):
    jcfg, values, tcfg, params, prompts = model
    want = np.asarray(jax_generate(
        values, jcfg, jnp.asarray(prompts, jnp.int32),
        scfg=JaxServeConfig(max_len=MAX_LEN, cache_dtype=jnp.float32), max_new_tokens=NEW,
    ))
    got = generate(params, tcfg, torch.from_numpy(prompts),
                   scfg=ServeConfig(max_len=MAX_LEN, cache_dtype=torch.float32),
                   max_new_tokens=NEW).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("pattern", ["attention", "local_attention"])
def test_phi4_mini_engine_equals_generate(model, pattern):
    """The port's ServeEngine on the reduced phi4-mini, with global attention
    and with every layer a 16-token sliding window (whose ring buffers wrap
    on the 40-token prompt): greedy tokens equal per-request generate(),
    every request completes, and every per-slot cache leaf is zero after the
    drain."""
    _, _, tcfg, params, _ = model
    tcfg = dataclasses.replace(tcfg, pattern=(pattern,), local_window=16)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, tcfg.vocab_size, n) for n in (5, 17, 40, 17)]
    horizons = (6, 3, 5, 4)
    scfg = ServeConfig(max_len=MAX_LEN, n_slots=2, decode_quantum=2, cache_dtype=torch.float32)
    eng = ServeEngine(params, tcfg, scfg)
    rids = [eng.submit(p, max_new_tokens=h) for p, h in zip(prompts, horizons)]
    out = eng.drain()
    assert {r.status for r in eng.request_results().values()} == {"completed"}
    for rid, p, h in zip(rids, prompts, horizons):
        want = generate(params, tcfg, torch.as_tensor(p)[None], scfg=scfg, max_new_tokens=h)
        assert out[rid].tolist() == want[0].tolist()
    for axes, layer in zip(lm.cache_slot_axes(tcfg, eng.pool), eng.pool):
        assert layer["k"].shape[1] == (16 if pattern == "local_attention" else MAX_LEN)
        assert all(not v.any() for k, v in layer.items() if axes[k] >= 0)
