"""Serving: the static batch and the continuous-batching engine
(counterpart of ``repro/serve/engine.py``).

Two tiers (DESIGN.md §4):

  * :func:`generate` — the static-batch path: every request of the batch
    shares one prompt length and one horizon.  It is the sequential
    reference semantics: the engine's greedy outputs are token-identical to
    it, request by request.
  * :class:`ServeEngine` — continuous batching: an admission queue feeds a
    fixed pool of cache *slots*; each step admits queued requests into free
    slots (one exact-length, batch-1 prefill each, copied into the pool
    through the mixer cache-slot contract) and runs one slot-masked decode
    quantum over the whole pool.  Requests carry their own sampling params,
    horizons, stop tokens, deadlines and streaming callbacks; the serve
    fault contract (DESIGN.md §13) gives every request one structured
    terminal :class:`RequestResult`.

The prompt's prefill runs the long convs on ``ServeConfig.conv_backend``
(``blockfft_overlap`` and ``toeplitz`` are CUDA kernels); each decode step
is cached dots.  The weights are cast once by the policy, every float leaf
included, as JAX does.

Left out of this port so far: the mesh arguments of the JAX engine
(``ectx``, ``param_axes``: tensor-parallel serving), the paged engine with
radix prefix reuse and SLO admission (``paged.py``, ``radix.py``,
``slo.py``), and the MoE branches (``check_supported`` refuses MoE).  JAX
fuses a decode quantum into one jitted ``lax.scan``; here it is a plain
loop of eager steps.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.common.ft import Heartbeat, StragglerMonitor, retry
from repro_torch.common.policy import Policy
from repro_torch.configs.base import ModelConfig, check_supported
from repro_torch.models import lm
from repro_torch.models.mixer_api import ApplyContext
from repro_torch.serve.faults import FaultInjector, TransientStepError
from repro_torch.serve.sampling import sample, sample_slots
from repro_torch.serve.scheduler import (
    Backend, Request, RequestResult, SamplingParams, Scheduler,
)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_len: int
    temperature: float = 0.0  # default for requests that don't override
    top_k: int = 0
    n_slots: int = 4  # continuous-batching slot-pool width
    # decode steps per scheduler tick; slots are admitted/released only at
    # quantum boundaries (a request finishing mid-quantum has its surplus
    # tokens discarded, so outputs stay token-identical to quantum=1)
    decode_quantum: int = 1
    cache_dtype: torch.dtype = torch.bfloat16
    # hyena long-conv backend for the prefill (None = registry default)
    conv_backend: Optional[str] = None
    # None derives Policy(compute_dtype=cache_dtype)
    policy: Optional[Policy] = None
    # --- failure-domain knobs (DESIGN.md §13)
    # NaN quarantine: a request whose logits go non-finite is evicted and
    # replayed from its last good token; after this many strikes it fails
    # structurally (status="failed") instead of replaying again
    quarantine_strikes: int = 2
    # bounded retry-with-backoff for transient step/prefill failures
    step_retry_attempts: int = 3
    step_retry_base_delay: float = 0.0  # 0 = retry immediately (tests)
    # load shedding: once queued work (queue + readmits) exceeds this, the
    # newest queued arrival is rejected with status="shed"; 0 disables
    overload_threshold: int = 0
    # liveness file, atomically rewritten once per step() when set
    heartbeat_path: Optional[str] = None

    def __post_init__(self):
        self.apply_context()  # unknown backend names fail here
        for name, least in (("n_slots", 1), ("decode_quantum", 1),
                            ("quarantine_strikes", 1), ("step_retry_attempts", 1),
                            ("overload_threshold", 0)):
            if getattr(self, name) < least:
                raise ValueError(f"{name} must be >= {least}, got {getattr(self, name)}")

    def apply_context(self) -> ApplyContext:
        return ApplyContext(conv_backend=self.conv_backend)

    def resolved_policy(self) -> Policy:
        return self.policy or Policy(compute_dtype=self.cache_dtype)


class DrainExhausted(RuntimeError):
    """``drain(max_steps)`` ran out of budget with requests still active.

    ``partial`` is the full rid -> tokens map (finished plus in-flight
    prefixes, same shape as ``results()``) and ``active`` the rids that were
    still queued or resident.  The engine is left consistent: stepping or
    draining again resumes where the budget cut off."""

    def __init__(self, max_steps: int, partial, active):
        super().__init__(
            f"drain exceeded {max_steps} steps with {len(active)} "
            f"request(s) still active: {list(active)}"
        )
        self.max_steps = max_steps
        self.partial = partial
        self.active = tuple(active)


# ------------------------------------------------------------- random streams
#
# Every request owns a deterministic stream indexed by (seed, rid, token
# index), so sampled outputs are a function of the request alone — not of
# the slot it landed in, the pool's composition or eviction timing.  Each
# draw takes a fresh torch.Generator seeded with request_token_seed.

_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    """SplitMix64's finaliser (Steele, Lea and Flood 2014) of x + its
    increment: a bijection of 64-bit integers with full avalanche."""
    z = (x + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def request_token_seed(seed: int, rid: int, token_index: int) -> int:
    """splitmix64(splitmix64(splitmix64(seed) ^ rid) ^ token_index): the
    seed of the generator that draws token ``token_index`` of request
    ``rid`` (the port's ``request_token_key``)."""
    return _splitmix64(_splitmix64(_splitmix64(seed) ^ rid) ^ token_index)


def request_generator(seed: int, rid: int, token_index: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        request_token_seed(seed, rid, token_index)
    )


@torch.no_grad()
def generate(
    params,
    cfg: ModelConfig,
    prompts: torch.Tensor,  # (B, L_prompt) integer tokens
    *,
    scfg: ServeConfig,
    max_new_tokens: int,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Greedy / sampled continuation on the device of ``params``.
    Returns (B, max_new_tokens) int64: the token sampled from the prefill's
    last logits, then one per decode step."""
    check_supported(cfg)
    if prompts.device != params["embed"]["table"].device:
        raise ValueError(
            f"prompts on {prompts.device}, params on "
            f"{params['embed']['table'].device}"
        )
    ctx = scfg.apply_context()
    policy = scfg.resolved_policy()
    params = policy.cast_compute(params)
    compute = policy.compute_dtype
    logits, caches = lm.prefill(
        params, cfg, prompts, scfg.max_len, dtype=scfg.cache_dtype,
        compute_dtype=compute, ctx=ctx,
    )
    draw = lambda lg: sample(
        lg, temperature=scfg.temperature, top_k=scfg.top_k, generator=generator
    )
    if max_new_tokens <= 0:
        return prompts.new_zeros((prompts.shape[0], 0), dtype=torch.int64)
    token = draw(logits[:, -1])
    out = [token]
    for _ in range(max_new_tokens - 1):
        lg, caches = lm.decode_step(params, cfg, token, caches, compute_dtype=compute)
        token = draw(lg)
        out.append(token)
    return torch.stack(out, dim=1)


# ------------------------------------------------------ continuous batching

@torch.no_grad()
def _prefill_and_sample(
    params, cfg: ModelConfig, prompt: torch.Tensor, req: Request, seed: int,
    poison: float, *, scfg: ServeConfig, ctx: ApplyContext,
):
    """Prefill one request (batch 1, its exact length) and sample its first
    token from the request's own stream.  Returns (token, ok, cache), where
    ``ok`` is the always-on finite guard over the last-token logits — the
    NaN-quarantine trigger of the admission prefill (DESIGN.md §13).  A
    non-zero ``poison`` (fault injection) is added to the logits first."""
    logits, cache = lm.prefill(
        params, cfg, prompt, scfg.max_len, dtype=scfg.cache_dtype,
        compute_dtype=scfg.resolved_policy().compute_dtype, ctx=ctx,
    )
    lg = logits[:, -1]
    if poison:
        lg = lg + poison
    ok = bool(torch.isfinite(lg).all())
    sp = req.params
    gen = (request_generator(seed, req.rid, req.n_emitted, lg.device)
           if sp.temperature > 0.0 else None)
    tok = sample_slots(lg, [sp.temperature], [sp.top_k], [gen])
    return int(tok[0]), ok, cache


@torch.no_grad()
def _decode_and_sample(
    params, cfg: ModelConfig, tokens: torch.Tensor, pool, active: np.ndarray,
    temps: np.ndarray, topks: np.ndarray, rids: np.ndarray, counts: np.ndarray,
    remaining: np.ndarray, poison: Optional[np.ndarray], seed: int, *,
    compute_dtype, quantum: int,
):
    """Up to ``quantum`` slot-masked decode steps over the whole pool, each
    with per-slot sampling.  Returns (tokens (q, S), finite (q, S), pool),
    the first two as numpy: ``finite`` is the per-slot NaN-quarantine guard
    (True where a slot did not run).

    Slot s runs step i while ``active[s]`` and ``i < remaining[s]`` (the
    tokens its request is still owed).  The masked step leaves every other
    slot's cache bytes as they were, so free slots stay at their reset
    state and no slot writes past ``max_len``; tokens past a request's
    horizon are surplus that the scheduler discards anyway, and the loop
    ends once no slot is owed a token.  Token i of slot s is drawn from the
    stream of (rid, counts[s] + i), so the tokens do not depend on the
    quantum or the pool's composition.  ``poison`` ((quantum, S), fault
    injection) is added to the logits after the cache update: it corrupts
    the token stream, never a neighbour's cache."""
    device = tokens.device
    owed = active[None, :] & (np.arange(quantum)[:, None] < remaining[None, :])
    steps = int(owed.any(axis=1).sum())
    owed_dev = torch.from_numpy(owed[:steps]).to(device)
    poison_dev = None if poison is None else torch.from_numpy(poison).to(device)
    toks, finite = [], []
    tok = tokens
    for i in range(steps):
        act = owed_dev[i]
        logits, pool = lm.decode_step(
            params, cfg, tok, pool, compute_dtype=compute_dtype, active=act
        )
        if poison_dev is not None:
            logits = logits + poison_dev[i][:, None]
        finite.append((~act) | torch.isfinite(logits).all(dim=-1))
        step_temps = np.where(owed[i], temps, 0.0)
        gens = [
            request_generator(seed, int(rids[s]), int(counts[s]) + i, device)
            if step_temps[s] > 0.0 else None
            for s in range(len(step_temps))
        ]
        nxt = sample_slots(logits, step_temps, topks, gens)
        tok = torch.where(act, nxt, torch.zeros_like(nxt))
        toks.append(tok)
    return torch.stack(toks).cpu().numpy(), torch.stack(finite).cpu().numpy(), pool


class ServeEngine(Backend):
    """Continuous-batching serve engine: ``submit() / step() / drain()``.

    One engine owns one slot pool on the device of ``params``.  ``submit``
    enqueues a request (FIFO); every ``step`` admits queued requests into
    free slots (one exact-length prefill each, copied into the pool) and
    runs one slot-masked decode quantum over all active slots.  Greedy
    outputs are token-identical to per-request sequential :func:`generate`
    at the same ``ServeConfig`` (given batch-independent logits: the CPU
    tests hold it at fp32); sampled requests are a deterministic function
    of ``(seed, rid, token index)``, never of slot placement or pool
    composition, and draw from other streams than ``generate``'s
    generator.

    ``stream`` callbacks fire per emitted token as ``cb(rid, token, done)``.
    ``injector`` arms the deterministic fault injection of
    :mod:`repro_torch.serve.faults`.
    """

    def __init__(self, params, cfg: ModelConfig, scfg: ServeConfig, *,
                 seed: int = 0, injector: Optional[FaultInjector] = None):
        check_supported(cfg)
        self.cfg = cfg
        self.scfg = scfg
        self.ctx = scfg.apply_context()
        policy = scfg.resolved_policy()
        self._compute = policy.compute_dtype
        self.params = policy.cast_compute(params)  # cast once
        self.device = self.params["embed"]["table"].device
        self._seed = int(seed)
        S = scfg.n_slots
        self.scheduler = Scheduler(S)
        self.pool = None  # built from the first prefill's cache
        self._last_tok = np.zeros((S,), np.int64)  # last emitted, per slot
        self._requests: Dict[int, Request] = {}  # queued + resident only
        self._final: Dict[int, RequestResult] = {}  # terminal outcomes
        self._next_rid = 0
        # --- failure-domain state (DESIGN.md §13)
        self.injector = injector
        self._faulty = injector is not None and injector.poisons
        self._tick = 0
        self._prefill_seq = 0  # monotone prefill-dispatch counter (coins)
        self._pending_quarantine: List[int] = []  # rids flagged this tick
        self.n_quarantined = 0
        self.n_retried = 0  # transient step/prefill errors absorbed
        self.n_shed = 0
        self._straggler = StragglerMonitor()
        self._heartbeat = None
        if scfg.heartbeat_path is not None:
            self._heartbeat = Heartbeat(scfg.heartbeat_path)
            self._heartbeat.beat()  # liveness file exists from construction

    # ------------------------------------------------------------- public
    def submit(
        self,
        prompt,
        *,
        max_new_tokens: int,
        temperature: Optional[float] = None,
        top_k: Optional[int] = None,
        stop_tokens: Sequence[int] = (),
        stream: Optional[Callable[[int, int, bool], None]] = None,
        deadline: Optional[int] = None,
    ) -> int:
        """Enqueue a request; returns its rid.  Generation starts at the
        next ``step()``.

        ``deadline`` is an absolute engine tick (``health()['tick']``): a
        request not finished by the end of that tick aborts with
        ``RequestResult(status="deadline_exceeded")`` and partial tokens.
        Under overload (``scfg.overload_threshold``) the newest queued
        arrival — possibly this one — is shed with status "shed"; check
        ``result(rid)``."""
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if prompt.size + max_new_tokens > self.scfg.max_len:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new_tokens "
                f"({max_new_tokens}) exceeds max_len {self.scfg.max_len}"
            )
        if prompt.min() < 0 or prompt.max() >= self.cfg.vocab_size:
            raise ValueError(f"prompt tokens must lie in [0, {self.cfg.vocab_size})")
        sp = SamplingParams(
            max_new_tokens=int(max_new_tokens),
            temperature=self.scfg.temperature if temperature is None
            else float(temperature),
            top_k=self.scfg.top_k if top_k is None else int(top_k),
            stop_tokens=tuple(int(t) for t in stop_tokens),
        )
        rid = self._next_rid
        self._next_rid += 1
        if deadline is not None and int(deadline) <= self._tick:
            # already expired at submission: structured abort, no residency
            self._final[rid] = RequestResult(
                rid, "deadline_exceeded", (),
                f"deadline {deadline} <= tick {self._tick} at submit",
            )
            return rid
        req = Request(rid=rid, prompt=prompt, params=sp, stream=stream,
                      deadline=None if deadline is None else int(deadline))
        self._requests[rid] = req
        self.scheduler.submit(req)
        self._shed_overload()
        return rid

    def step(self):
        """One scheduler tick (admissions + one pooled decode quantum).
        Returns the list of :class:`Event` emitted this step."""
        self._tick += 1
        t0 = time.perf_counter()
        if self.injector is not None:
            slow = self.injector.slow_step_seconds(self._tick)
            if slow:
                time.sleep(slow)
        self._enforce_deadlines()
        try:
            return self.scheduler.step(self)
        finally:
            # quarantine first (evicts poisoned residents back to the
            # readmit queue or finalizes them), then prune finished
            # requests, even when a stream callback raised
            self._process_quarantine()
            self._prune_finished()
            self._straggler.record(self._tick, time.perf_counter() - t0)
            if self._heartbeat is not None:
                self._heartbeat.beat()

    def _prune_finished(self) -> None:
        live = {r.rid for r in self.scheduler.queue}
        live |= {r.rid for r in self.scheduler.readmit}
        live |= {r.rid for r in self.scheduler.slots.values()}
        for rid in [r for r in self._requests if r not in live]:
            req = self._requests.pop(rid)
            self._finalize(req, "completed")

    # ------------------------------------------- lifecycle guards (§13)
    def _finalize(self, req: Request, status: str, detail: str = "") -> None:
        self._final[req.rid] = RequestResult(
            req.rid, status, tuple(req.tokens), detail
        )

    def _abort(self, rid: int, status: str, detail: str = "") -> bool:
        """Terminate a live (queued or resident) request with a structured
        status, releasing its slot if resident.  False if rid is unknown
        or already terminal."""
        req = self._requests.get(rid)
        if req is None:
            return False
        if req.slot >= 0:
            self.scheduler._release(req.slot, self)
            req.slot = -1
        else:
            for q in (self.scheduler.queue, self.scheduler.readmit):
                try:
                    q.remove(req)
                    break
                except ValueError:
                    pass
        del self._requests[rid]
        self._finalize(req, status, detail)
        return True

    def cancel(self, rid: int) -> bool:
        """End-to-end cancellation: queued, readmitted, or mid-decode, the
        request's slot state is released and it finalizes with partial
        tokens and ``status="cancelled"``.  False if unknown/finished."""
        return self._abort(rid, "cancelled")

    def _enforce_deadlines(self) -> None:
        expired = [
            rid for rid, req in self._requests.items()
            if req.deadline is not None and self._tick > req.deadline
        ]
        for rid in expired:
            dl = self._requests[rid].deadline
            self._abort(rid, "deadline_exceeded",
                        f"deadline tick {dl} < tick {self._tick}")

    def _queue_depth(self) -> int:
        return len(self.scheduler.queue) + len(self.scheduler.readmit)

    def _shed_overload(self) -> None:
        """Reject queued work past the overload threshold.  The queue is
        FIFO (no priority classes), so the weakest arrival is the newest;
        readmitted requests are never shed (their partial decode is work
        worth preserving)."""
        thr = self.scfg.overload_threshold
        if thr <= 0:
            return
        while self._queue_depth() > thr and self.scheduler.queue:
            victim = self.scheduler.queue[-1]
            self._abort(victim.rid, "shed",
                        f"queue depth {self._queue_depth()} > {thr}")
            self.n_shed += 1

    def _process_quarantine(self) -> None:
        """Handle slots whose decode-quantum logits went non-finite this
        tick: the request is evicted (slot state released) and replayed
        from its last good token via a continuation prefill — the
        ``(seed, rid, token_index)`` streams make the replay
        token-identical — or finalized ``status="failed"`` once it has
        struck out (``scfg.quarantine_strikes``)."""
        pending, self._pending_quarantine = self._pending_quarantine, []
        for rid in pending:
            req = self._requests.get(rid)
            if req is None or req.slot < 0:
                continue  # finished before the poisoned step — moot
            req.quarantines += 1
            self.n_quarantined += 1
            if req.quarantines >= self.scfg.quarantine_strikes:
                self._abort(rid, "failed",
                            f"non-finite logits after "
                            f"{req.quarantines} quarantine strike(s)")
            else:
                self.scheduler.evict(rid, self)  # replay from last-good

    def health(self) -> Dict[str, Any]:
        """Liveness/saturation surface for an external controller
        (DESIGN.md §13): queue depths, terminal counts, quarantine /
        retry / shed counters, and stuck-step detection (EWMA straggler
        monitor over step wall-times)."""
        return {
            "tick": self._tick,
            "queued": len(self.scheduler.queue),
            "readmit": len(self.scheduler.readmit),
            "resident": len(self.scheduler.slots),
            "finished": len(self._final),
            "quarantined": self.n_quarantined,
            "retried": self.n_retried,
            "shed": self.n_shed,
            "stragglers": self._straggler.stragglers,
            "last_straggler": self._straggler.last_report,
            "heartbeat": self.scfg.heartbeat_path,
        }

    def evict(self, rid: int) -> bool:
        """Preempt a resident request back to the admission queue (its slot
        is reset; generation resumes via a continuation prefill)."""
        return self.scheduler.evict(rid, self)

    def drain(self, max_steps: int = 100_000) -> Dict[int, np.ndarray]:
        """Step until queue and pool are empty; returns rid -> tokens.
        Raises :class:`DrainExhausted` — carrying the partial rid -> tokens
        map and the still-active rids — if the budget runs out first."""
        steps = 0
        while not self.scheduler.idle:
            self.step()
            steps += 1
            if steps > max_steps:
                active = sorted(
                    {r.rid for r in self.scheduler.queue}
                    | {r.rid for r in self.scheduler.readmit}
                    | {r.rid for r in self.scheduler.slots.values()}
                )
                partial = self.results()
                # release the unfinished residents' slot state before
                # raising, so an abandoning caller does not leak the pool:
                # eviction resets each slot and readmits the request, so
                # the engine stays resumable
                for rid in [r.rid for r in self.scheduler.slots.values()]:
                    self.scheduler.evict(rid, self)
                raise DrainExhausted(max_steps, partial, active)
        return self.results()

    def results(self) -> Dict[int, np.ndarray]:
        """Finished outputs plus the partial tokens of in-flight requests."""
        out = {
            rid: np.asarray(res.tokens, np.int64)
            for rid, res in self._final.items()
        }
        out.update({
            rid: np.asarray(req.tokens, np.int64)
            for rid, req in self._requests.items()
        })
        return out

    def pop_result(self, rid: int) -> np.ndarray:
        """Take (and forget) a finished request's tokens — the retention
        valve for servers that run one engine indefinitely."""
        return np.asarray(self._final.pop(rid).tokens, np.int64)

    def result(self, rid: int) -> Optional[RequestResult]:
        """The structured terminal outcome of ``rid`` (None while live)."""
        return self._final.get(rid)

    def request_results(self) -> Dict[int, RequestResult]:
        """All terminal outcomes so far (rid -> :class:`RequestResult`)."""
        return dict(self._final)

    # ----------------------------------------------- scheduler Backend API
    def prefill_into_slot(self, slot: int, req: Request) -> Optional[int]:
        prompt = torch.as_tensor(req.resume_prompt, device=self.device)[None, :]
        while True:
            attempt = [0]

            def dispatch():
                attempt[0] += 1
                if self.injector is not None:
                    # coins keyed by a monotone dispatch counter, so the
                    # readmit path after retry exhaustion draws fresh coins
                    self._prefill_seq += 1
                    self.injector.check_prefill(
                        self._tick, req.rid, self._prefill_seq
                    )
                poison = (
                    self.injector.poison_value(
                        req.rid, req.n_emitted, req.quarantines
                    ) if self._faulty else 0.0
                )
                return _prefill_and_sample(
                    self.params, self.cfg, prompt, req, self._seed, poison,
                    scfg=self.scfg, ctx=self.ctx,
                )

            try:
                tok, ok, cache = retry(
                    dispatch, attempts=self.scfg.step_retry_attempts,
                    base_delay=self.scfg.step_retry_base_delay,
                    exceptions=(TransientStepError,),
                )
            except TransientStepError:
                # a transient failure survived every retry: requeue ahead
                # of arrivals and hand the slot back (the scheduler's None
                # contract); the next admission draws fresh coins
                self.n_retried += attempt[0] - 1
                self.scheduler.readmit.append(req)
                return None
            self.n_retried += attempt[0] - 1
            if ok:
                break
            # non-finite prefill logits: a quarantine strike.  Replay is
            # re-prefilling the same resume prompt (fresh poison coins via
            # the bumped attempt), or structured failure on strike-out.
            req.quarantines += 1
            self.n_quarantined += 1
            if req.quarantines >= self.scfg.quarantine_strikes:
                self._requests.pop(req.rid, None)
                self._finalize(
                    req, "failed",
                    f"non-finite prefill logits after "
                    f"{req.quarantines} quarantine strike(s)",
                )
                return None
        if self.pool is None:
            self.pool = lm.make_slot_pool(self.cfg, cache, self.scfg.n_slots)
        self.pool = lm.slot_insert(self.cfg, self.pool, slot, cache)
        self._last_tok[slot] = tok
        return tok

    def decode_active(self, requests: Dict[int, Request]):
        S = self.scfg.n_slots
        quantum = self.scfg.decode_quantum
        active = np.zeros((S,), bool)
        temps = np.zeros((S,), np.float32)
        topks = np.zeros((S,), np.int64)
        rids = np.zeros((S,), np.int64)
        counts = np.zeros((S,), np.int64)
        remaining = np.zeros((S,), np.int64)
        for slot, req in requests.items():
            active[slot] = True
            temps[slot] = req.params.temperature
            topks[slot] = req.params.top_k
            rids[slot] = req.rid
            counts[slot] = req.n_emitted  # index of the token sampled now
            remaining[slot] = req.params.max_new_tokens - req.n_emitted
        poison = None
        if self._faulty:
            poison = np.zeros((quantum, S), np.float32)
            for slot, req in requests.items():
                for i in range(quantum):
                    poison[i, slot] = self.injector.poison_value(
                        req.rid, req.n_emitted + i, req.quarantines
                    )
        attempt = [0]

        def dispatch():
            a = attempt[0]
            attempt[0] += 1
            if self.injector is not None:
                # raises before the step touches the pool
                self.injector.check_step(self._tick, a)
            return _decode_and_sample(
                self.params, self.cfg,
                torch.from_numpy(self._last_tok).to(self.device), self.pool,
                active, temps, topks, rids, counts, remaining, poison,
                self._seed, compute_dtype=self._compute, quantum=quantum,
            )

        toks, finite, self.pool = retry(
            dispatch, attempts=self.scfg.step_retry_attempts,
            base_delay=self.scfg.step_retry_base_delay,
            exceptions=(TransientStepError,),
        )
        self.n_retried += attempt[0] - 1
        out: Dict[int, list] = {}
        for slot, req in requests.items():
            self._last_tok[slot] = int(toks[-1, slot])
            col = finite[:, slot]
            if col.all():
                out[slot] = [int(t) for t in toks[:, slot]]
            else:
                # truncate at the first non-finite step: everything before
                # it is good (kept; replay resumes after it), everything
                # from it on is poisoned
                good = int(np.argmax(~col))
                out[slot] = [int(t) for t in toks[:good, slot]]
                self._pending_quarantine.append(req.rid)
        return out

    def reset_slot(self, slot: int) -> None:
        if self.pool is not None:
            self.pool = lm.slot_reset(self.cfg, self.pool, slot)
