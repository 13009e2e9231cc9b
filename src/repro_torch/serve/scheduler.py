"""Continuous-batching scheduler: admission queue + fixed slot pool (a copy
of the numpy-only ``repro/serve/scheduler.py``; DESIGN.md §4).

The scheduler owns *request bookkeeping only* — which request sits in which
slot, what it has emitted, when it stops — and drives a model-agnostic
:class:`Backend` through one step loop:

    step():  admit queued requests into free slots (one prefill each,
             scattered into the pool), then run ONE slot-masked decode
             quantum over the whole pool and dispatch each active slot's
             new tokens.

Invariants (asserted by the randomized-schedule property harness):

  I1  a slot is owned by at most one request at a time; admission order is
      FIFO over the queue, except that evicted requests readmit AHEAD of
      queued arrivals (starvation-freedom under sustained load).
  I2  per-request outputs are schedule-independent: whatever the arrival /
      eviction interleaving, a greedy request r emits exactly the tokens
      the sequential ``generate()`` of r would (token-identical serving);
      sampled requests are a deterministic function of (seed, rid,
      token index), never of slot placement or pool composition.
  I3  a released slot's per-slot state is reset to zeros before reuse — an
      evicted request's cache cannot leak into its successor.

Eviction is preemption-with-continuation: the slot is reset and the request
re-enters the queue with ``prompt + emitted`` as its new prompt, so a
readmission prefill reconstructs exactly the state the uninterrupted decode
would have had (the prefill/decode-parity contract every registered
TokenMixer is conformance-tested on).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling controls (one slot = one request = one set)."""

    max_new_tokens: int
    temperature: float = 0.0
    top_k: int = 0
    stop_tokens: Tuple[int, ...] = ()


@dataclasses.dataclass
class Request:
    """One serving request plus its mutable schedule state."""

    rid: int
    prompt: np.ndarray  # (L,) int32 original prompt
    params: SamplingParams
    stream: Optional[Callable[[int, int, bool], None]] = None  # (rid, tok, done)
    # tick deadline for the WHOLE request (DESIGN.md §13): if it hasn't
    # finished by this scheduler tick it aborts with status
    # "deadline_exceeded" and partial tokens.  None = no deadline.
    deadline: Optional[int] = None
    # --- schedule state
    tokens: List[int] = dataclasses.field(default_factory=list)  # emitted
    slot: int = -1  # -1 = not resident
    evictions: int = 0
    quarantines: int = 0  # NaN-quarantine strikes (replays) so far

    @property
    def n_emitted(self) -> int:
        return len(self.tokens)

    @property
    def resume_prompt(self) -> np.ndarray:
        """Prompt for (re)admission: original prompt + everything emitted."""
        if not self.tokens:
            return self.prompt
        return np.concatenate(
            [self.prompt, np.asarray(self.tokens, np.int32)]
        )

    def finished(self, token: int) -> bool:
        return (
            token in self.params.stop_tokens
            or self.n_emitted >= self.params.max_new_tokens
        )


@dataclasses.dataclass(frozen=True)
class RequestResult:
    """Terminal outcome of one request (the serve fault contract,
    DESIGN.md §13).  ``tokens`` always carries whatever the request
    emitted before the terminal event — partial output on aborts."""

    rid: int
    status: str  # completed|failed|deadline_exceeded|cancelled|shed
    tokens: Tuple[int, ...]
    detail: str = ""

    @property
    def ok(self) -> bool:
        return self.status == "completed"


TERMINAL_STATUSES = (
    "completed", "failed", "deadline_exceeded", "cancelled", "shed",
)


class Backend:
    """What the scheduler needs from the model side (implemented by
    :class:`repro_torch.serve.engine.ServeEngine`)."""

    def prefill_into_slot(self, slot: int, req: Request) -> Optional[int]:
        """Prefill ``req.resume_prompt``, scatter the cache into ``slot``,
        and return the first sampled token — or None if the backend failed
        the admission structurally (e.g. NaN-quarantine strike-out during
        prefill); the scheduler then releases the slot and the backend
        owns finalizing the request."""
        raise NotImplementedError

    def decode_active(self, requests: Dict[int, Request]) -> Dict[int, list]:
        """One decode *quantum* (>= 1 steps) over the pool;
        returns slot -> [tokens] for every active slot.  Tokens past a
        request's stop condition are surplus and will be discarded."""
        raise NotImplementedError

    def reset_slot(self, slot: int) -> None:
        """Zero a slot's per-slot cache state (pure-function reset)."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Event:
    """One emitted token (streamed to the caller in step order)."""

    rid: int
    token: int
    done: bool


class Scheduler:
    """Admission queue + fixed slot pool + the continuous step loop."""

    def __init__(self, n_slots: int):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        self.n_slots = n_slots
        self.queue: deque[Request] = deque()
        # evicted requests re-enter HERE, drained before the arrival queue:
        # under sustained arrivals a FIFO requeue starves preempted requests
        # indefinitely (each readmission attempt lines up behind every
        # arrival that landed during its residency)
        self.readmit: deque[Request] = deque()
        self.slots: Dict[int, Request] = {}  # slot -> resident request
        self._free: List[int] = list(range(n_slots))[::-1]  # pop() -> slot 0 first

    # ------------------------------------------------------------- queries
    @property
    def active(self) -> Dict[int, Request]:
        return dict(self.slots)

    @property
    def idle(self) -> bool:
        return not self.queue and not self.readmit and not self.slots

    # ------------------------------------------------------------ mutation
    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def evict(self, rid: int, backend: Backend) -> bool:
        """Preempt a resident request: reset its slot and requeue it with
        ``prompt + emitted`` as the continuation prompt.  Returns False if
        ``rid`` is not resident (queued / finished requests are no-ops)."""
        for slot, req in list(self.slots.items()):
            if req.rid == rid:
                self._release(slot, backend)
                req.slot = -1
                req.evictions += 1
                self.readmit.append(req)  # ahead of every queued arrival
                return True
        return False

    def _release(self, slot: int, backend: Backend) -> None:
        backend.reset_slot(slot)
        del self.slots[slot]
        self._free.append(slot)

    def _emit(
        self, req: Request, token: int, backend: Backend,
        events: List[Event],
    ) -> None:
        req.tokens.append(int(token))
        done = req.finished(int(token))
        if done:
            self._release(req.slot, backend)
            req.slot = -1
        events.append(Event(req.rid, int(token), done))

    def _dispatch_streams(self, events: List[Event], by_rid) -> None:
        """Fire stream callbacks AFTER all bookkeeping for the tick: a
        raising callback leaves every request's tokens/slots/caches
        consistent (the exception propagates to the step() caller, who can
        still recover full outputs via drain()/results())."""
        for ev in events:
            req = by_rid.get(ev.rid)
            if req is not None and req.stream is not None:
                req.stream(ev.rid, ev.token, ev.done)

    # ----------------------------------------------------------- step loop
    def step(self, backend: Backend) -> List[Event]:
        """One scheduler tick: fill free slots from the queue (one prefill
        per admission), then a single decode quantum over the pool."""
        events: List[Event] = []
        by_rid: Dict[int, Request] = {}
        # 1. admission: prefill-into-free-slots — readmitted (previously
        # evicted) requests first, then FIFO over new arrivals
        while (self.readmit or self.queue) and self._free:
            req = (self.readmit.popleft() if self.readmit
                   else self.queue.popleft())
            slot = self._free.pop()
            self.slots[slot] = req
            req.slot = slot
            by_rid[req.rid] = req
            first = backend.prefill_into_slot(slot, req)
            if first is None:
                # structural admission failure (e.g. prefill NaN-quarantine
                # strike-out): free the slot; the backend finalizes the
                # request with its structured RequestResult
                self._release(slot, backend)
                req.slot = -1
                continue
            self._emit(req, first, backend, events)
        # 2. one decode quantum over every active slot; a request that hits
        # its stop condition mid-quantum keeps tokens up to (and including)
        # the stop and discards the surplus — outputs are identical for
        # every quantum size
        if self.slots:
            snapshot = dict(self.slots)
            produced = backend.decode_active(snapshot)
            for slot, tokens in sorted(produced.items()):
                req = snapshot[slot]
                by_rid[req.rid] = req
                for token in tokens:
                    self._emit(req, token, backend, events)
                    if req.slot == -1:  # finished (slot already released)
                        break
        self._dispatch_streams(events, by_rid)
        return events
