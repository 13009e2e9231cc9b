"""The port's continuous-batching ``ServeEngine`` (``toeplitz`` backend) on
the CPU, against the JAX package and against the port's own ``generate()``.

(b) The copied scheduler and fault injector against JAX's (numpy only).
(c) Greedy tokens of the engine on the reduced hyena-153m at fp32 equal
    JAX's ``ServeEngine`` on the same bridged weights and the port's
    per-request ``generate()``, for decode quanta 1 and 3; free slots are
    zero after the drain.
(d) Sampled requests depend only on (seed, rid, token index): the same
    tokens for any pool width and quantum.
(e) The request lifecycle of ``tests/test_serve_engine.py``'s dense cases,
    held against the port's ``generate()``.
"""
import itertools
import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")  # the JAX package is the reference
import jax.numpy as jnp  # noqa: E402
import torch

from repro.serve import faults as jax_faults
from repro.serve import scheduler as jax_scheduler
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch.configs import get_config
from repro_torch.models import lm
from repro_torch.models.mixer_api import ApplyContext, get_mixer
from repro_torch.serve import faults, scheduler
from repro_torch.serve.engine import DrainExhausted, ServeConfig, ServeEngine, generate

from torch_port_util import TORCH_THREADS, free_jax_programs, jax_and_torch_model  # noqa: F401

ARCH = "hyena-153m"
MAX_LEN = 128
BACKEND = "toeplitz"
# at most three distinct prompt lengths: JAX compiles one prefill per length
LENS = (37, 64, 100, 37, 64)
HORIZONS = (3, 9, 5, 7, 4)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    yield
    torch.set_num_threads(prev)


def _prompts(vocab, lens=LENS, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n) for n in lens]


def _scfg(**kw):
    base = dict(max_len=MAX_LEN, n_slots=2, cache_dtype=torch.float32, conv_backend=BACKEND)
    return ServeConfig(**{**base, **kw})


def _serve(params, cfg, scfg, prompts, horizons, **submit_kw):
    eng = ServeEngine(params, cfg, scfg)
    rids = [eng.submit(p, max_new_tokens=h, **submit_kw) for p, h in zip(prompts, horizons)]
    out = eng.drain()
    return eng, [out[r] for r in rids]


def _reference(params, cfg, prompt, horizon):
    scfg = _scfg()
    return generate(params, cfg, torch.as_tensor(prompt)[None], scfg=scfg,
                    max_new_tokens=horizon)[0].numpy()


def _assert_pool_free(eng):
    """Every per-slot cache leaf is zero (scheduler invariant I3)."""
    for axes, layer in zip(lm.cache_slot_axes(eng.cfg, eng.pool), eng.pool):
        for k, leaf in layer.items():
            if axes[k] >= 0:
                assert not leaf.any(), f"per-slot leaf '{k}' is not zero"


@pytest.fixture(scope="module")
def model():
    jcfg, values, tcfg, params = jax_and_torch_model(ARCH)
    return jcfg, values, tcfg, params, _prompts(tcfg.vocab_size)


# ------------------------------------------------ (b) scheduler and faults

class _FakeBackend:
    """Tokens are a function of (rid, token index); some first admissions
    fail structurally."""

    def __init__(self, quantum):
        self.quantum = quantum
        self.resets = []

    @staticmethod
    def _tok(rid, index):
        return int(np.random.default_rng((rid, index)).integers(0, 12))

    def prefill_into_slot(self, slot, req):
        if req.rid % 5 == 3 and req.evictions == 0:
            return None
        return self._tok(req.rid, req.n_emitted)

    def decode_active(self, requests):
        return {
            slot: [self._tok(r.rid, r.n_emitted + i) for i in range(self.quantum)]
            for slot, r in requests.items()
        }

    def reset_slot(self, slot):
        self.resets.append(slot)


def _plan(seed, ticks=30):
    rng = np.random.default_rng(seed)
    plan, rid = [], 0
    for _ in range(ticks):
        arrive = []
        for _ in range(rng.integers(0, 3)):
            stops = tuple(int(t) for t in rng.integers(0, 12, rng.integers(0, 2)))
            arrive.append((rid, int(rng.integers(1, 6)), int(rng.integers(1, 8)), stops))
            rid += 1
        evict = [int(k) for k in rng.integers(0, 4, rng.integers(0, 2))]
        plan.append((arrive, evict))
    return plan


def _drive(mod, plan, quantum):
    sched, backend, events = mod.Scheduler(3), _FakeBackend(quantum), []
    step = lambda: events.extend((e.rid, e.token, e.done) for e in sched.step(backend))
    for arrive, evict in plan:
        for rid, L, M, stops in arrive:
            sched.submit(mod.Request(
                rid=rid, prompt=np.arange(L, dtype=np.int32),
                params=mod.SamplingParams(max_new_tokens=M, stop_tokens=stops),
            ))
        for k in evict:
            resident = sorted(r.rid for r in sched.slots.values())
            if resident:
                sched.evict(resident[k % len(resident)], backend)
        step()
    while not sched.idle:
        step()
    return events, backend.resets


@pytest.mark.parametrize("seed,quantum", [(0, 1), (1, 3), (2, 2)])
def test_scheduler_event_streams_equal_jax(seed, quantum):
    plan = _plan(seed)
    got = _drive(scheduler, plan, quantum)
    assert got == _drive(jax_scheduler, plan, quantum)
    assert len(got[0]) > 20


def test_fault_injector_coins_equal_jax():
    kw = dict(seed=11, nan_logit_rate=0.2, inf_logit_rate=0.1,
              poison_tokens=((3, 2, "nan"), (4, 0, "inf")), poison_attempts=2,
              step_error_rate=0.3, prefill_error_rate=0.25, alloc_fail_rate=0.2,
              slow_step_rate=0.5, slow_step_seconds=0.01)
    mine = faults.FaultInjector(faults.FaultPlan(**kw))
    ref = jax_faults.FaultInjector(jax_faults.FaultPlan(**kw))

    def outcome(fn, *args):
        try:
            return repr(fn(*args))  # nan != nan; repr compares
        except (faults.TransientStepError, jax_faults.TransientStepError) as e:
            return str(e)

    for rid, idx, attempt in itertools.product(range(6), range(6), range(3)):
        assert outcome(mine.poison_value, rid, idx, attempt) == outcome(ref.poison_value, rid, idx, attempt)
    for tick, a in itertools.product(range(12), range(3)):
        assert outcome(mine.check_step, tick, a) == outcome(ref.check_step, tick, a)
        assert outcome(mine.check_prefill, tick, a, a + 1) == outcome(ref.check_prefill, tick, a, a + 1)
        assert mine.alloc_fails(tick, a) == ref.alloc_fails(tick, a)
        assert mine.slow_step_seconds(tick) == ref.slow_step_seconds(tick)
    assert mine.fired == ref.fired and all(mine.fired.values())
    with pytest.raises(ValueError):
        faults.FaultPlan(nan_logit_rate=1.5)


# ----------------------------------------------- (c) greedy parity with JAX

@pytest.fixture(scope="module")
def jax_tokens(model):
    jcfg, values, _, _, prompts = model
    eng = JaxServeEngine(values, jcfg, JaxServeConfig(
        max_len=MAX_LEN, n_slots=2, cache_dtype=jnp.float32, conv_backend=BACKEND))
    rids = [eng.submit(p, max_new_tokens=h) for p, h in zip(prompts, HORIZONS)]
    out = eng.drain()
    return [np.asarray(out[r]) for r in rids]


@pytest.mark.parametrize("quantum", [1, 3])
def test_engine_greedy_equals_jax_engine_and_generate(model, jax_tokens, quantum):
    _, _, tcfg, params, prompts = model
    eng, got = _serve(params, tcfg, _scfg(decode_quantum=quantum), prompts, HORIZONS)
    for tokens, want, prompt, h in zip(got, jax_tokens, prompts, HORIZONS):
        np.testing.assert_array_equal(tokens, want)
        np.testing.assert_array_equal(tokens, _reference(params, tcfg, prompt, h))
    assert all(r.status == "completed" for r in eng.request_results().values())
    _assert_pool_free(eng)


def test_masked_step_leaves_inactive_slots_bit_for_bit(model):
    """The port's decode step writes the operand history in place; with an
    ``active`` mask the inactive slot's every cache byte stays put."""
    _, _, tcfg, params, prompts = model

    _, one = lm.prefill(params, tcfg, torch.as_tensor(prompts[0])[None], MAX_LEN,
                        dtype=torch.float32, ctx=ApplyContext(conv_backend=BACKEND))
    _, other = lm.prefill(params, tcfg, torch.as_tensor(prompts[1])[None], MAX_LEN,
                          dtype=torch.float32, ctx=ApplyContext(conv_backend=BACKEND))
    pool = lm.make_slot_pool(tcfg, one, 3)
    pool = lm.slot_insert(tcfg, pool, 0, one)
    pool = lm.slot_insert(tcfg, pool, 1, other)
    before = [{k: v.clone() for k, v in layer.items()} for layer in pool]
    active = torch.tensor([True, False, False])
    _, pool = lm.decode_step(params, tcfg, torch.tensor([5, 7, 0]), pool,
                             compute_dtype=torch.float32, active=active)
    hyena = get_mixer("hyena")
    mc = hyena.make_config(tcfg)
    for old, new in zip(before, pool):
        for s in (1, 2):
            got, want = hyena.cache_slice(mc, new, s), hyena.cache_slice(mc, old, s)
            assert all(torch.equal(got[k], want[k]) for k in want)
        assert not torch.equal(new["t"], old["t"])


# ------------------------------------------- (d) sampled, schedule-independent

@pytest.fixture(scope="module")
def port_model():
    cfg = get_config(ARCH).reduced()
    return cfg, lm.init_lm(cfg, seed=3, device="cpu"), _prompts(cfg.vocab_size, seed=4)


def test_sampled_requests_are_schedule_independent(port_model):
    cfg, params, prompts = port_model
    kinds = [dict(temperature=0.8, top_k=5), dict(temperature=1.0, top_k=0),
             dict(temperature=0.7, top_k=1), dict(), dict(temperature=1.2, top_k=3)]
    runs = []
    for n_slots, quantum in ((1, 1), (3, 1), (3, 2)):
        eng = ServeEngine(params, cfg, _scfg(n_slots=n_slots, decode_quantum=quantum), seed=9)
        rids = [eng.submit(p, max_new_tokens=h, **kw)
                for p, h, kw in zip(prompts, HORIZONS, kinds)]
        out = eng.drain()
        runs.append([out[r].tolist() for r in rids])
    assert runs[0] == runs[1] == runs[2]
    # top_k = 1 keeps only the argmax: the greedy tokens
    assert runs[0][2] == _reference(params, cfg, prompts[2], HORIZONS[2]).tolist()
    assert runs[0][0] != _reference(params, cfg, prompts[0], HORIZONS[0]).tolist()


# --------------------------------------------------------- (e) lifecycle

def test_cancel_mid_decode_frees_the_slot(port_model):
    cfg, params, prompts = port_model
    eng = ServeEngine(params, cfg, _scfg())
    a = eng.submit(prompts[0], max_new_tokens=9)
    b = eng.submit(prompts[1], max_new_tokens=6)
    eng.step()
    eng.step()
    assert eng.cancel(a) and not eng.cancel(a)
    res = eng.result(a)
    want = _reference(params, cfg, prompts[0], 9)
    assert res.status == "cancelled" and list(res.tokens) == want[: len(res.tokens)].tolist()
    assert len(eng.scheduler.slots) == 1
    out = eng.drain()
    np.testing.assert_array_equal(out[b], _reference(params, cfg, prompts[1], 6))
    _assert_pool_free(eng)


def test_deadline_gives_partial_tokens(port_model):
    cfg, params, prompts = port_model
    eng = ServeEngine(params, cfg, _scfg())
    late = eng.submit(prompts[2], max_new_tokens=9, deadline=3)
    ok = eng.submit(prompts[3], max_new_tokens=4)
    eng.step()
    expired = eng.submit(prompts[4], max_new_tokens=2, deadline=1)
    eng.drain()
    res = eng.result(late)
    assert res.status == "deadline_exceeded" and 0 < len(res.tokens) < 9
    assert list(res.tokens) == _reference(params, cfg, prompts[2], 9)[: len(res.tokens)].tolist()
    assert eng.result(ok).status == "completed"
    assert eng.result(expired) == scheduler.RequestResult(
        expired, "deadline_exceeded", (), "deadline 1 <= tick 1 at submit")
    _assert_pool_free(eng)


def test_dense_load_shedding_drops_the_newest(port_model):
    cfg, params, prompts = port_model
    eng = ServeEngine(params, cfg, _scfg(n_slots=1, overload_threshold=2))
    rids = [eng.submit(p, max_new_tokens=2) for p in prompts[:3]]
    assert [eng.result(r) for r in rids[:2]] == [None] * 2
    assert eng.result(rids[2]).status == "shed"
    eng.step()  # admits rids[0]; rids[1] waits
    rids += [eng.submit(p, max_new_tokens=2) for p in prompts[3:5]]
    assert eng.result(rids[3]) is None and eng.result(rids[4]).status == "shed"
    assert eng.health()["shed"] == 2
    out = eng.drain()
    for i in (0, 1, 3):
        np.testing.assert_array_equal(out[rids[i]], _reference(params, cfg, prompts[i], 2))


@pytest.mark.parametrize("where", ["prefill", "decode"])
def test_poisoned_logits_are_quarantined_and_replayed(port_model, where):
    cfg, params, prompts = port_model
    index = 0 if where == "prefill" else 3
    plan = faults.FaultPlan(poison_tokens=((1, index, "nan"),), poison_attempts=1)
    eng = ServeEngine(params, cfg, _scfg(decode_quantum=2),
                      injector=faults.FaultInjector(plan))
    rids = [eng.submit(p, max_new_tokens=h) for p, h in zip(prompts[:3], HORIZONS)]
    out = eng.drain()
    for r, p, h in zip(rids, prompts, HORIZONS):
        np.testing.assert_array_equal(out[r], _reference(params, cfg, p, h))
    assert eng.health()["quarantined"] == 1
    _assert_pool_free(eng)


def test_quarantine_strikes_out(port_model):
    cfg, params, prompts = port_model
    plan = faults.FaultPlan(poison_tokens=((0, 2, "inf"),), poison_attempts=10)
    eng = ServeEngine(params, cfg, _scfg(quarantine_strikes=2),
                      injector=faults.FaultInjector(plan))
    bad = eng.submit(prompts[0], max_new_tokens=6)
    good = eng.submit(prompts[1], max_new_tokens=5)
    out = eng.drain()
    res = eng.result(bad)
    assert res.status == "failed" and "2 quarantine strike" in res.detail
    assert list(res.tokens) == _reference(params, cfg, prompts[0], 6)[:2].tolist()
    np.testing.assert_array_equal(out[good], _reference(params, cfg, prompts[1], 5))
    _assert_pool_free(eng)


def test_transient_faults_are_absorbed_by_retry(port_model):
    cfg, params, prompts = port_model
    plan = faults.FaultPlan(seed=5, step_error_rate=0.4, prefill_error_rate=0.4)
    eng = ServeEngine(params, cfg, _scfg(step_retry_attempts=6),
                      injector=faults.FaultInjector(plan))
    rids = [eng.submit(p, max_new_tokens=h) for p, h in zip(prompts, HORIZONS)]
    out = eng.drain()
    for r, p, h in zip(rids, prompts, HORIZONS):
        np.testing.assert_array_equal(out[r], _reference(params, cfg, p, h))
    assert eng.health()["retried"] > 0


def test_evicted_request_resumes_token_identically(port_model):
    cfg, params, prompts = port_model
    eng = ServeEngine(params, cfg, _scfg(decode_quantum=2))
    rid = eng.submit(prompts[1], max_new_tokens=9)
    eng.submit(prompts[0], max_new_tokens=3)
    eng.step()
    assert eng.evict(rid) and not eng.evict(rid)
    out = eng.drain()
    np.testing.assert_array_equal(out[rid], _reference(params, cfg, prompts[1], 9))
    _assert_pool_free(eng)


def test_drain_budget_raises_with_partial_results(port_model, tmp_path):
    cfg, params, prompts = port_model
    beat = tmp_path / "beat"
    eng = ServeEngine(params, cfg, _scfg(heartbeat_path=str(beat)))
    seen = []
    rids = [eng.submit(p, max_new_tokens=8, stream=lambda *ev: seen.append(ev))
            for p in prompts[:3]]
    with pytest.raises(DrainExhausted) as info:
        eng.drain(max_steps=2)
    assert set(info.value.active) == set(rids)
    assert all(len(info.value.partial[r]) < 8 for r in rids)
    assert not eng.scheduler.slots  # residents evicted: the pool is free
    _assert_pool_free(eng)
    out = eng.drain()
    for r, p in zip(rids, prompts):
        np.testing.assert_array_equal(out[r], _reference(params, cfg, p, 8))
    assert [t for rid, t, _ in seen if rid == rids[0]] == out[rids[0]].tolist()
    assert float(beat.read_text()) > 0 and eng.health()["tick"] > 2
    assert eng.pop_result(rids[0]).tolist() == out[rids[0]].tolist()
    assert eng.result(rids[0]) is None


def test_submit_and_config_validation(port_model):
    cfg, params, prompts = port_model
    eng = ServeEngine(params, cfg, _scfg())
    with pytest.raises(ValueError, match="empty prompt"):
        eng.submit([], max_new_tokens=2)
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.submit(prompts[0], max_new_tokens=0)
    with pytest.raises(ValueError, match="exceeds max_len"):
        eng.submit(prompts[2], max_new_tokens=MAX_LEN)
    with pytest.raises(ValueError, match="prompt tokens"):
        eng.submit([cfg.vocab_size], max_new_tokens=1)
    for field in ("n_slots", "decode_quantum", "quarantine_strikes", "step_retry_attempts"):
        with pytest.raises(ValueError, match=field):
            _scfg(**{field: 0})
    with pytest.raises(ValueError, match="overload_threshold"):
        _scfg(overload_threshold=-1)
    with pytest.raises(ValueError, match="unknown conv backend"):
        _scfg(conv_backend="toeplitz_typo")
    assert math.isclose(eng.scfg.step_retry_base_delay, 0.0)
