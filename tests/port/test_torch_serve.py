"""The slice end to end: ``generate()`` of the PyTorch port against the JAX
package's on the reduced hyena-153m (order 2) and hyena-125m (order 3),
with ``conv_backend="blockfft_overlap"`` and the same bridged weights.

Tolerances, with their reasons:

- fp32 greedy tokens: identical.
- fp32 prefill logits, both packages evaluating their own filters:
  rtol = atol = 2e-3.  The implicit filters' sine FFN (ω = 14) amplifies
  last-bit GEMM differences by ~10³, so fp32 filters carry errors up to
  ~1e-3 of their scale against float64 in JAX itself (see
  test_torch_conv); the logits differ by up to 5.4e-4 (measured) on a
  magnitude of ~5.
- fp32 prefill logits with the filter taps that JAX evaluates: 1e-4.
  Everything else on the path agrees to ~1e-5 (measured 5e-6).
- bf16 prefill logits: every bf16 rounding (residual stream, projections,
  conv outputs, norm gains) can land one ulp apart, an ulp being 2^-7 of a
  value's magnitude; over two layers and the head that is a few ulps of
  the logits.  Held at atol = 0.25 on logits of magnitude ~5 (measured
  0.094), and a mean absolute difference below 0.03 (measured 0.009).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")  # the JAX package is the reference
import jax.numpy as jnp  # noqa: E402
import torch

from repro.common.policy import BF16 as JAX_BF16
from repro.core import filters as JF
from repro.models import lm as jax_lm
from repro.models.mixer_api import ApplyContext as JaxApplyContext
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro.serve.engine import generate as jax_generate
from repro_torch.common.policy import BF16
from repro_torch.core import filters as TF
from repro_torch.models import lm
from repro_torch.models.mixer_api import ApplyContext
from repro_torch.serve.engine import ServeConfig, generate

from torch_port_util import TORCH_THREADS, free_jax_programs, jax_and_torch_model, t  # noqa: F401

ARCHS = ["hyena-153m", "hyena-125m"]
B, L, MAX_LEN, NEW = 2, 100, 128, 8  # L=100 pads to N=200 = 10·20
BACKEND = "blockfft_overlap"


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    jcfg, values, tcfg, params = jax_and_torch_model(request.param)
    prompts = np.random.default_rng(1).integers(0, tcfg.vocab_size, (B, L))
    return jcfg, values, tcfg, params, prompts


def _jax_prefill(values, jcfg, prompts, dtype):
    logits, _ = jax_lm.prefill(
        values, jcfg, jnp.asarray(prompts, jnp.int32), MAX_LEN, dtype=dtype,
        ctx=JaxApplyContext(conv_backend=BACKEND),
    )
    return np.asarray(logits)


def _torch_prefill(params, tcfg, prompts, dtype):
    logits, _ = lm.prefill(
        params, tcfg, torch.from_numpy(prompts), MAX_LEN, dtype=dtype,
        ctx=ApplyContext(conv_backend=BACKEND),
    )
    return logits.numpy()


def test_greedy_tokens_identical_fp32(model):
    jcfg, values, tcfg, params, prompts = model
    want = np.asarray(jax_generate(
        values, jcfg, jnp.asarray(prompts, jnp.int32),
        scfg=JaxServeConfig(max_len=MAX_LEN, cache_dtype=jnp.float32,
                            conv_backend=BACKEND),
        max_new_tokens=NEW,
    ))
    got = generate(
        params, tcfg, torch.from_numpy(prompts),
        scfg=ServeConfig(max_len=MAX_LEN, cache_dtype=torch.float32,
                         conv_backend=BACKEND),
        max_new_tokens=NEW,
    ).numpy()
    np.testing.assert_array_equal(got, want)


def test_prefill_logits_fp32(model):
    jcfg, values, tcfg, params, prompts = model
    want = _jax_prefill(values, jcfg, prompts, jnp.float32)
    got = _torch_prefill(params, tcfg, prompts, torch.float32)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


def test_prefill_logits_fp32_same_filter_taps(model, monkeypatch):
    jcfg, values, tcfg, params, prompts = model

    def jax_taps(p, cfg, n):
        jp = jax.tree_util.tree_map(lambda x: jnp.asarray(x.numpy()), p)
        jfc = JF.FilterConfig(**cfg.__dict__)
        return t(JF.evaluate_filters(jp, jfc, n))

    want = _jax_prefill(values, jcfg, prompts, jnp.float32)
    monkeypatch.setattr(TF, "evaluate_filters", jax_taps)
    got = _torch_prefill(params, tcfg, prompts, torch.float32)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_prefill_logits_bf16(model):
    jcfg, values, tcfg, params, prompts = model
    want = _jax_prefill(JAX_BF16.cast_compute(values), jcfg, prompts, jnp.bfloat16)
    got = _torch_prefill(BF16.cast_compute(params), tcfg, prompts, torch.bfloat16)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=0.25)
    assert np.abs(got - want).mean() < 0.03


def test_generate_bf16_runs_and_sampling_is_seeded(model):
    """bf16 greedy decode runs through the policy-cast weights; sampled
    decode draws from the caller's torch.Generator (its tokens cannot match
    JAX's key streams), so the same seed gives the same tokens."""
    _, _, tcfg, params, prompts = model
    scfg = ServeConfig(max_len=MAX_LEN, conv_backend=BACKEND, temperature=0.8, top_k=5)
    runs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(7)
        runs.append(generate(params, tcfg, torch.from_numpy(prompts), scfg=scfg,
                             max_new_tokens=4, generator=gen))
    assert torch.equal(runs[0], runs[1])
    assert runs[0].shape == (B, 4)
    assert int(runs[0].min()) >= 0 and int(runs[0].max()) < tcfg.vocab_size
