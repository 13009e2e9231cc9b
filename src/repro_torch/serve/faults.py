"""Deterministic fault injection for the serve engine (a copy of the
numpy-only ``repro/serve/faults.py``; DESIGN.md §13).

The chaos harness (tests/serve_parity.py) proves the serve fault contract
— every admitted request either completes token-identical to the fault-
free reference or terminates with a structured ``RequestResult`` status —
by *injecting* the failure modes the contract covers:

  * **NaN/Inf logits** into chosen slots of the decode quantum (and the
    dense engine's admission prefill), exercising the NaN quarantine:
    per-slot finite guard -> quarantine -> deterministic replay -> N-strike
    structured failure.
  * **Transient step/prefill errors** (:class:`TransientStepError`),
    raised at the host boundary *before* the jitted call dispatches (so
    donated pool buffers are never consumed by a failed step), exercising
    the bounded retry-with-backoff path.
  * **Allocator exhaustion** in the paged engine's block-allocation path,
    exercising the stall-and-retry quantum (adv = 0).
  * **Slow steps** (injected sleeps), exercising the straggler/stuck-step
    detection surfaced by ``engine.health()``.

Every decision is a pure function of ``(seed, kind, *key)`` — the same
schedule-keyed determinism as the engines' ``(seed, rid, token_index)``
sampling streams — so a failing chaos seed replays exactly.  Logit poison
keys additionally include the request's quarantine *attempt*: a replayed
request draws fresh coins, which is what lets a transiently poisoned
request complete token-identical after replay, while ``poison_attempts``
(or rate draws that keep firing) exercises the strike-out path.

Off by default: engines built without an injector skip every hook, and the
always-on finite guard is the only addition to the jitted decode program
(one ``isfinite`` reduce over the per-slot logits).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import numpy as np


class TransientStepError(RuntimeError):
    """A transient, retryable failure in a serve step or prefill (the
    injected stand-in for device hiccups / collective timeouts).  Raised
    before the jitted call dispatches, so engine state is never torn."""


_KINDS = ("nan", "inf", "step", "prefill", "alloc", "slow")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Seeded, deterministic fault schedule.  All rates are per-decision
    probabilities in [0, 1]; explicit schedules compose with the rates."""

    seed: int = 0
    # --- logit poisoning (per (rid, token_index, attempt) emission)
    nan_logit_rate: float = 0.0
    inf_logit_rate: float = 0.0
    # explicit targets: (rid, token_index, "nan"|"inf") — fired on
    # attempts < poison_attempts, so poison_attempts=1 tests clean replay
    # and a large value tests the N-strike structured failure
    poison_tokens: Tuple[Tuple[int, int, str], ...] = ()
    poison_attempts: int = 1
    # --- transient failures (per (tick, attempt) / (tick, rid, attempt))
    step_error_rate: float = 0.0
    prefill_error_rate: float = 0.0
    # --- paged allocator exhaustion (per (tick, slot))
    alloc_fail_rate: float = 0.0
    # --- slow steps (per tick)
    slow_step_rate: float = 0.0
    slow_step_seconds: float = 0.0

    def __post_init__(self):
        for f in ("nan_logit_rate", "inf_logit_rate", "step_error_rate",
                  "prefill_error_rate", "alloc_fail_rate", "slow_step_rate"):
            v = getattr(self, f)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{f} must be in [0, 1], got {v}")
        for rid, tix, kind in self.poison_tokens:
            if kind not in ("nan", "inf"):
                raise ValueError(f"poison kind must be nan|inf, got {kind!r}")
            if rid < 0 or tix < 0:
                raise ValueError("poison_tokens entries must be >= 0")

    @property
    def poisons(self) -> bool:
        return bool(self.nan_logit_rate or self.inf_logit_rate
                    or self.poison_tokens)


class FaultInjector:
    """Evaluates a :class:`FaultPlan` deterministically and counts what it
    fired (the counters feed the chaos harness's assertions)."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.fired: Dict[str, int] = {k: 0 for k in _KINDS}
        self._targets = {
            (int(rid), int(tix)): kind
            for rid, tix, kind in plan.poison_tokens
        }

    # ------------------------------------------------------ deterministic
    def _coin(self, kind: str, *key: int) -> float:
        """Uniform [0, 1) draw, a pure function of (seed, kind, key)."""
        seq = (self.plan.seed, _KINDS.index(kind)) + tuple(
            int(k) for k in key
        )
        return float(np.random.default_rng(seq).random())

    # ------------------------------------------------------------- logits
    def poison_value(self, rid: int, token_index: int,
                     attempt: int) -> float:
        """0.0 (clean), NaN, or +Inf to add to the slot's logits row for
        the emission at ``token_index``.  ``attempt`` is the request's
        quarantine count: replays draw fresh coins, and explicit targets
        stop firing once ``attempt >= poison_attempts``."""
        kind = self._targets.get((int(rid), int(token_index)))
        if kind is not None and attempt < self.plan.poison_attempts:
            self.fired[kind] += 1
            return math.nan if kind == "nan" else math.inf
        p = self.plan
        if p.nan_logit_rate and self._coin(
                "nan", rid, token_index, attempt) < p.nan_logit_rate:
            self.fired["nan"] += 1
            return math.nan
        if p.inf_logit_rate and self._coin(
                "inf", rid, token_index, attempt) < p.inf_logit_rate:
            self.fired["inf"] += 1
            return math.inf
        return 0.0

    @property
    def poisons(self) -> bool:
        return self.plan.poisons

    # --------------------------------------------------------- transients
    def check_step(self, tick: int, attempt: int) -> None:
        """Raise :class:`TransientStepError` for this (tick, attempt) per
        ``step_error_rate`` — called before the decode quantum dispatches,
        once per retry attempt, so bounded retries can succeed."""
        p = self.plan
        if p.step_error_rate and self._coin(
                "step", tick, attempt) < p.step_error_rate:
            self.fired["step"] += 1
            raise TransientStepError(
                f"injected transient step error (tick {tick}, "
                f"attempt {attempt})"
            )

    def check_prefill(self, tick: int, rid: int, attempt: int) -> None:
        p = self.plan
        if p.prefill_error_rate and self._coin(
                "prefill", tick, rid, attempt) < p.prefill_error_rate:
            self.fired["prefill"] += 1
            raise TransientStepError(
                f"injected transient prefill error (tick {tick}, "
                f"rid {rid}, attempt {attempt})"
            )

    # ---------------------------------------------------------- allocator
    def alloc_fails(self, tick: int, slot: int) -> bool:
        """Transient allocator exhaustion for (tick, slot): the paged
        engine stalls the slot this quantum and retries next tick."""
        p = self.plan
        if p.alloc_fail_rate and self._coin(
                "alloc", tick, slot) < p.alloc_fail_rate:
            self.fired["alloc"] += 1
            return True
        return False

    # -------------------------------------------------------- slow steps
    def slow_step_seconds(self, tick: int) -> float:
        """Seconds this tick should stall (0.0 = no fault) — feeds the
        straggler monitor behind ``engine.health()``."""
        p = self.plan
        if p.slow_step_rate and p.slow_step_seconds and self._coin(
                "slow", tick) < p.slow_step_rate:
            self.fired["slow"] += 1
            return float(p.slow_step_seconds)
        return 0.0
