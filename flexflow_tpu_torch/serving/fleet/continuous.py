"""Iteration-level continuous batching for autoregressive decode.

The port of ``flexflow_tpu/serving/fleet/continuous.py``. The classic
serving loss with static batching is convoy latency: a 4-token
completion admitted next to a 512-token one waits out the whole batch.
Orca-style iteration-level scheduling fixes that by making the decode
loop, not the request, the batching unit: every ``decode_segment``
tokens (the lock-release boundary of the segmented greedy path)
finished sequences leave the batch and waiting sequences take their
slots.

The engine keeps a fixed pool of KV-cache *slots* sized from the
serving plan's ``kv_cache_bytes`` envelope (``kv_slot_capacity``).
Every iteration is one ``FFModel.generate`` call on a full
``(capacity, L)`` batch with per-row ragged prompt lengths, free slots
running as 1-token dummy rows: one prefill (one flash-attention launch
per attention layer under ``attention:flash``) and ``step`` decode
steps.

Bit-exactness contract: each admitted sequence's output row equals
``session.generate(row[None], plen, max_new_tokens, temperature=0.0,
eos_token_id=eos)[0]`` no matter which neighbors shared its
iterations. This rests on row-independence under causal attention —
the same invariant ``InferenceSession._generate_segmented`` relies on
for its host-side eos forcing, pinned by the bucket-boundary tests —
plus the engine replicating that exact forcing per row.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import numpy as np

from ...obs.metrics_registry import REGISTRY

_REQS = REGISTRY.counter(
    "ff_cb_requests_total",
    "continuous-batching sequences accepted, by outcome")
_ADMITTED_MIDFLIGHT = REGISTRY.counter(
    "ff_cb_admitted_midflight_total",
    "sequences admitted while other sequences were already decoding")
_EVICTED_EARLY = REGISTRY.counter(
    "ff_cb_evicted_early_total",
    "sequences evicted at a segment boundary before max_new_tokens "
    "(eos emitted); their freed iterations went to other sequences")
_ACTIVE = REGISTRY.gauge(
    "ff_cb_active_slots", "decode slots occupied this iteration")


class EngineClosedError(RuntimeError):
    """Submitted to (or pending in) an engine that has shut down."""


class SequenceError(ValueError):
    """A sequence's ids/prompt_len/max_new_tokens cannot be served."""


def kv_slot_capacity(ff, kv_cache_bytes_budget: int,
                     max_seq: Optional[int] = None,
                     hard_cap: int = 64) -> int:
    """Decode slots that fit the serving plan's KV envelope: the
    per-sequence resident K+V bytes at full context length, divided
    into ``kv_cache_bytes_budget``. Clamped to [1, hard_cap] — one
    slot always exists (the envelope gate that would reject even one
    sequence lives in the plan verifier, not here)."""
    from ...search.serving_plan import kv_cache_bytes
    if max_seq is None:
        t = next(t for t in ff.graph_inputs if t.name == "input_ids")
        max_seq = int(t.shape[1])
    per_seq = sum(kv_cache_bytes(l, 1, int(max_seq)) for l in ff.layers)
    if per_seq <= 0:
        return int(hard_cap)
    return max(1, min(int(hard_cap),
                      int(kv_cache_bytes_budget) // per_seq))


class _Sequence:
    """One admitted decode request: its full-width ids row, progress,
    and the completion event its submitter blocks on."""

    __slots__ = ("ids", "plen", "max_new", "emitted", "done_eos",
                 "slot", "event", "result", "error", "t_submit",
                 "deadline", "admitted_midflight")

    def __init__(self, ids: np.ndarray, plen: int, max_new: int,
                 deadline: Optional[float]):
        self.ids = ids
        self.plen = plen
        self.max_new = max_new
        self.emitted = 0
        self.done_eos = False
        self.slot = -1
        self.event = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None
        self.t_submit = time.monotonic()
        self.deadline = deadline
        self.admitted_midflight = False

    def wait(self, timeout_s: Optional[float] = None) -> np.ndarray:
        """Block until the engine finishes (or fails) this sequence;
        returns the full-width output row."""
        if not self.event.wait(timeout=600.0 if timeout_s is None
                               else timeout_s):
            raise TimeoutError("sequence did not complete in time")
        if self.error is not None:
            raise self.error
        if self.result is None:  # unreachable except on engine bugs
            raise EngineClosedError(
                "sequence completed without a result")
        return self.result


class ContinuousBatcher:
    """Iteration-level decode engine over one serving session.

    ``session`` is an ``InferenceSession`` or ``ServingPlanSession``;
    for a plan session the engine pins the bucket instance that covers
    ``capacity`` (``session_for``) and shares its dispatch lock, so
    direct ``infer``/``generate`` callers on the same instance
    interleave with the engine at segment boundaries exactly as they
    do with the sequential segmented path.

    ``admission`` selects the scheduling policy:

    * ``"continuous"`` (default): waiting sequences join at every
      segment boundary; finished ones are evicted.
    * ``"static"``: new sequences are admitted only when the in-flight
      batch is EMPTY — the whole batch runs to completion of its
      slowest member. Same engine, same device calls: the paired
      baseline that isolates the scheduling policy.

    Greedy-only (``temperature=0``): that is the regime where segment
    boundaries exist at all (sampling keys its random stream to one
    decode loop, so it keeps the single lock hold and cannot be
    re-batched).
    """

    def __init__(self, session, capacity: Optional[int] = None,
                 kv_cache_bytes_budget: Optional[int] = None,
                 eos_token_id: Optional[int] = None,
                 decode_segment: Optional[int] = None,
                 admission: str = "continuous"):
        if admission not in ("continuous", "static"):
            raise ValueError(f"admission must be 'continuous' or "
                             f"'static', got {admission!r}")
        self.admission = admission
        self.eos_token_id = (None if eos_token_id is None
                             else int(eos_token_id))
        if capacity is None:
            if kv_cache_bytes_budget is not None:
                capacity = kv_slot_capacity(session.ff,
                                            kv_cache_bytes_budget)
            else:
                capacity = session.buckets[-1]
        self.capacity = int(capacity)
        if self.capacity < 1:
            raise ValueError("capacity must be >= 1")
        # pin ONE bucket instance: the engine always dispatches full
        # (capacity, L) batches, so bucket routing is decided once
        sess = session.session_for(self.capacity) \
            if hasattr(session, "session_for") else session
        self._sess = sess
        t = next(t for t in sess.ff.graph_inputs
                 if t.name == "input_ids")
        self._seq_len = int(t.shape[1])
        seg = int(decode_segment if decode_segment is not None
                  else getattr(sess, "decode_segment", 0) or 0)
        if not 1 <= seg <= self._seq_len - 1:
            raise ValueError(
                f"decode_segment must be in [1, {self._seq_len - 1}] "
                f"(dummy slots decode the segment from position 1), "
                f"got {seg}")
        self.decode_segment = seg
        self._lock = threading.Lock()
        # guarded by _lock:
        self._waiting: List[_Sequence] = []
        self._slots: List[Optional[_Sequence]] = \
            [None] * self.capacity
        self._closed = False
        self._stats = {"completed": 0, "expired": 0,
                       "evicted_early": 0, "iterations": 0}
        self._arrival = threading.Event()
        self._stop = threading.Event()
        self._worker = threading.Thread(
            target=self._run, name="ff-continuous-batcher", daemon=True)
        self._worker.start()

    # -- client side -----------------------------------------------

    def submit(self, input_ids: np.ndarray, prompt_len: int,
               max_new_tokens: int,
               timeout_s: Optional[float] = None) -> "_Sequence":
        """Enqueue one sequence; returns a handle whose ``wait()``
        blocks for the full output row. ``input_ids`` is a 1-D prompt
        of length <= the model's sequence width (zero-padded to it)."""
        ids = np.asarray(input_ids, np.int32).reshape(-1)
        plen = int(prompt_len)
        max_new = int(max_new_tokens)
        if ids.shape[0] > self._seq_len:
            raise SequenceError(
                f"prompt row length {ids.shape[0]} exceeds model "
                f"sequence width {self._seq_len}")
        if not 1 <= plen <= ids.shape[0]:
            raise SequenceError(
                f"prompt_len {plen} out of range [1, {ids.shape[0]}]")
        if max_new < 1 or plen + max_new > self._seq_len:
            raise SequenceError(
                f"prompt_len {plen} + max_new_tokens {max_new} "
                f"exceeds sequence width {self._seq_len}")
        row = np.zeros(self._seq_len, np.int32)
        row[:ids.shape[0]] = ids
        deadline = (None if timeout_s is None
                    else time.monotonic() + float(timeout_s))
        seq = _Sequence(row, plen, max_new, deadline)
        with self._lock:
            if self._closed:
                raise EngineClosedError("engine is closed")
            self._waiting.append(seq)
        self._arrival.set()
        return seq

    def generate(self, input_ids: np.ndarray, prompt_len: int,
                 max_new_tokens: int,
                 timeout_s: Optional[float] = None) -> np.ndarray:
        """Blocking convenience: submit one sequence and wait."""
        return self.submit(input_ids, prompt_len, max_new_tokens,
                           timeout_s=timeout_s).wait(
                               None if timeout_s is None
                               else timeout_s + 120.0)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            out = dict(self._stats)
            out["waiting"] = len(self._waiting)
            out["active"] = sum(1 for s in self._slots
                                if s is not None)
            out["capacity"] = self.capacity
        return out

    def close(self, timeout_s: float = 30.0) -> None:
        """Stop admitting, finish nothing further: pending (waiting
        AND in-flight) sequences fail with ``EngineClosedError``.
        Graceful completion is the caller's job (stop submitting,
        wait on outstanding handles, then close)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            pending = self._waiting + [s for s in self._slots
                                       if s is not None]
            self._waiting = []
            self._slots = [None] * self.capacity
        self._stop.set()
        self._arrival.set()
        for seq in pending:
            seq.error = EngineClosedError("engine closed")
            seq.event.set()
        self._worker.join(timeout=timeout_s)

    # -- engine side -----------------------------------------------

    def _run(self) -> None:
        while not self._stop.is_set():
            active = self._admit()
            if not active:
                # bounded nap between polls; submit() sets _arrival
                self._arrival.wait(timeout=0.05)
                self._arrival.clear()
                continue
            try:
                self._iterate(active)
            except Exception as exc:  # noqa: BLE001 — the engine
                # thread must not die silently; fail the batch instead
                self._fail_active(active, exc)

    def _admit(self) -> List[_Sequence]:
        """Fill free slots from the waiting queue (continuous), or
        only when the batch is empty (static). Expired waiters fail
        here without ever touching the device."""
        now = time.monotonic()
        admitted: List[_Sequence] = []
        expired: List[_Sequence] = []
        with self._lock:
            if self._closed:
                return []
            active = [s for s in self._slots if s is not None]
            allow = self.capacity - len(active) \
                if self.admission == "continuous" \
                else (self.capacity if not active else 0)
            keep: List[_Sequence] = []
            for seq in self._waiting:
                if seq.deadline is not None and now > seq.deadline:
                    expired.append(seq)
                elif allow > 0:
                    admitted.append(seq)
                    allow -= 1
                else:
                    keep.append(seq)
            self._waiting = keep
            for seq in admitted:
                slot = self._slots.index(None)
                seq.slot = slot
                self._slots[slot] = seq
                seq.admitted_midflight = bool(active)
            self._stats["expired"] += len(expired)
            active = [s for s in self._slots if s is not None]
        for seq in expired:
            seq.error = TimeoutError(
                "sequence expired before admission")
            seq.event.set()
            _REQS.inc(outcome="expired")
        for seq in admitted:
            if seq.admitted_midflight:
                _ADMITTED_MIDFLIGHT.inc()
        return active

    def _iterate(self, active: List[_Sequence]) -> None:
        """One decode iteration: a full-capacity ragged batch advances
        every active sequence by one segment (bounded by the shortest
        remaining budget, so no row oversteps its max_new_tokens)."""
        cap, L = self.capacity, self._seq_len
        eos = self.eos_token_id
        ids = np.zeros((cap, L), np.int32)
        cur = np.ones(cap, np.int32)  # free slots: 1-token dummy rows
        for seq in active:
            ids[seq.slot] = seq.ids
            cur[seq.slot] = seq.plen + seq.emitted
        step = min(self.decode_segment,
                   min(s.max_new - s.emitted for s in active))
        _ACTIVE.set(len(active))
        with self._sess._lock:
            out = self._sess.ff.generate(
                ids, cur, step, temperature=0.0, eos_token_id=eos)
        # a host copy: the eos forcing below writes into the rows
        out = np.array(out.cpu() if hasattr(out, "cpu") else out)
        finished: List[_Sequence] = []
        for seq in active:
            row = out[seq.slot]
            start = seq.plen + seq.emitted
            if eos is not None:
                # mirror _generate_segmented's host-side forcing: a row
                # that latched eos in an EARLIER segment reads eos for
                # this segment's columns too (generate's done-mask only
                # covers one call)
                if seq.done_eos:
                    row[start:start + step] = eos
                else:
                    seq.done_eos = bool(
                        (row[start:start + step] == eos).any())
            seq.ids = row
            seq.emitted += step
            if seq.emitted >= seq.max_new or seq.done_eos:
                if seq.done_eos and seq.emitted < seq.max_new:
                    # evict early; the columns the sequential oracle
                    # would spend real iterations forcing to eos are
                    # forced here for free — bit-identical output, and
                    # the slot goes to a waiting sequence instead
                    row[seq.plen + seq.emitted:
                        seq.plen + seq.max_new] = eos
                    self._note_early_eviction()
                seq.result = row
                finished.append(seq)
        with self._lock:
            self._stats["iterations"] += 1
            self._stats["completed"] += len(finished)
            for seq in finished:
                if self._slots[seq.slot] is seq:
                    self._slots[seq.slot] = None
        for seq in finished:
            seq.event.set()
            _REQS.inc(outcome="completed")

    def _note_early_eviction(self) -> None:
        with self._lock:
            self._stats["evicted_early"] += 1
        _EVICTED_EARLY.inc()

    def _fail_active(self, active: List[_Sequence], exc) -> None:
        with self._lock:
            for seq in active:
                if 0 <= seq.slot < self.capacity \
                        and self._slots[seq.slot] is seq:
                    self._slots[seq.slot] = None
        for seq in active:
            if not seq.event.is_set():
                seq.error = exc
                seq.event.set()
                _REQS.inc(outcome="failed")
