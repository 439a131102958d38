"""Serving over a world of ranks: the rank-0 request relay.

The JAX package drives every device of its mesh from one process, so a
serving front's call on a sharded session is the whole mesh's call. In
the port each rank is a process that drives one device, and every rank
must make every device call of a batch (the prefill, each decode step, a
forward) in the same order, or their collectives pair up wrongly.

:class:`WorldRelay` carries the calls. Rank 0 owns the session's callers
(a :class:`~.scheduler.BatchScheduler`'s workers, a front, direct
``generate`` calls, on any threads): it wraps the session, duck-typed as
one, and each call it takes is checked on the caller's thread (a request
the session would refuse never leaves it) and queued. Every rank runs
:meth:`WorldRelay.run` on its main thread, the one that made the
world's earlier collectives: on rank 0 it takes the queued calls in
order, broadcasts each with its host payload (the op, the ids, the
prompt lengths, the sampling arguments) over a CPU gloo group of the
world (``parallel.distributed.relay_group``) and makes it; on the other
ranks it makes each call it receives. So two callers' broadcasts and
collectives never interleave, and every rank's collectives come from
one thread (gloo's all-gather of CUDA tensors from another thread than
the one that made the earlier collectives hung on the H100, both ranks
inside it). ``stop()`` ends ``run`` on every rank. A peer that dies
surfaces as the coordinator's :class:`~..resilience.coord.RankFailure`
(``coord.as_rank_failure``): on rank 0 to the caller and out of
``run``, on a follower out of ``run``.

Usage, on every rank, after the session's model compiled over the world::

    relay = WorldRelay(session)
    if relay.rank == 0:
        threading.Thread(target=serve_then_stop, args=(relay,)).start()
    relay.run()        # rank 0 until relay.stop(); the others follow
"""
from __future__ import annotations

import logging
import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Tuple

from ..obs import request_trace
from ..parallel.distributed import (broadcast_object, process_count,
                                    process_index, relay_group)

log = logging.getLogger("flexflow_tpu_torch")

#: the session calls the relay carries
OPS = ("infer", "generate")
_STOP = "stop"


class WorldRelay:
    """Rank 0's front on a session that a world of ranks serves, and the
    loop every rank runs (see the module docstring). Building one is
    collective (it makes the relay's process group): every rank builds
    its relay at the same point.

    ``calls`` counts the relayed calls this rank ran, ``log`` holds each
    one's op and payload digest in order (the ranks' logs are equal when
    every rank ran every call), ``errors`` the calls that raised, and
    ``host_s`` the host seconds this rank spent in the relay's
    broadcasts."""

    def __init__(self, session, group=None):
        self.session = session
        self.rank = process_index()
        self.world = process_count()
        self._group = group if group is not None else relay_group()
        self.calls = 0
        self.host_s = 0.0
        self.log: List[Tuple[str, int]] = []
        self.errors: List[Tuple[str, str]] = []
        self._q: "queue.Queue" = queue.Queue()
        # taking a call and stopping are one step each under the lock, so
        # no call is queued behind the stop
        self._lock = threading.Lock()
        self._stopped = False

    # -- the session's interface on rank 0 -------------------------------
    @property
    def ff(self):
        return self.session.ff

    @property
    def buckets(self):
        return self.session.buckets

    @property
    def input_names(self):
        return self.session.input_names

    @property
    def input_signature(self):
        return self.session.input_signature

    def clone(self) -> "WorldRelay":
        """The relay itself: one loop makes every instance's calls in
        order, which a world needs."""
        return self

    def infer(self, inputs: Dict[str, Any]):
        self.session.check_infer(inputs)
        return self._submit("infer", (dict(inputs),), {})

    def generate(self, input_ids, prompt_len, max_new_tokens: int,
                 **kwargs):
        self.session.check_generate(input_ids, prompt_len, max_new_tokens,
                                    kwargs.get("num_beams", 1))
        return self._submit("generate", (input_ids, prompt_len,
                                         max_new_tokens), kwargs)

    def stop(self) -> None:
        """Rank 0, any thread: end ``run`` on every rank after the calls
        already taken. Idempotent."""
        if self.rank != 0:
            return
        with self._lock:
            if self._stopped:
                return
            self._stopped = True
            self._q.put((_STOP, (), {}, None, Future()))

    def _submit(self, op: str, args: tuple, kwargs: dict):
        if self.rank != 0:
            raise RuntimeError(
                "only rank 0 takes the session's calls; the other ranks "
                "run WorldRelay.run()")
        done: Future = Future()
        with self._lock:
            if self._stopped:
                raise RuntimeError("the world relay has stopped")
            self._q.put((op, args, kwargs, request_trace.current(), done))
        return done.result()

    # -- every rank --------------------------------------------------------
    def run(self) -> int:
        """Make the relayed calls on this thread until rank 0 stops the
        relay; returns the count of calls. Rank 0 takes its callers'
        calls in order, each answered through its caller's future; the
        other ranks make each call rank 0 sends. A call that raises on a
        follower raised on rank 0 too (every rank runs the same code on
        the same payload): it is recorded in ``errors`` and the loop goes
        on. A dead peer raises the coordinator's ``RankFailure``."""
        return self._lead() if self.rank == 0 else self._follow()

    def _lead(self) -> int:
        while True:
            op, args, kwargs, trace, done = self._q.get()
            try:
                self._broadcast((op, args, kwargs))
                if op == _STOP:
                    done.set_result(None)
                    return self.calls
                with request_trace.activate(trace):
                    out = self._run(op, args, kwargs)
            except BaseException as e:  # noqa: BLE001 — to the caller
                err = self._failure(e)
                done.set_exception(err)
                if op == _STOP or _is_rank_failure(err):
                    with self._lock:
                        self._stopped = True
                        self._fail_pending(err)
                    raise err from e
            else:
                done.set_result(out)

    def _follow(self) -> int:
        while True:
            try:
                op, args, kwargs = self._broadcast(None)
            except Exception as e:
                raise self._failure(e) from e
            if op == _STOP:
                return self.calls
            try:
                self._run(op, args, kwargs)
            except Exception as e:  # noqa: BLE001 — rank 0 reports it
                err = self._failure(e)
                if _is_rank_failure(err):
                    raise err from e
                log.warning("world relay: %s raised on rank %d: %r", op,
                            self.rank, e)

    def _fail_pending(self, err: BaseException) -> None:
        while True:
            try:
                *_, done = self._q.get_nowait()
            except queue.Empty:
                return
            done.set_exception(RuntimeError(
                f"the world relay stopped: {err}"))

    def _broadcast(self, msg):
        t0 = time.perf_counter()
        try:
            return broadcast_object(msg, self._group)
        finally:
            self.host_s += time.perf_counter() - t0

    def _run(self, op: str, args: tuple, kwargs: dict):
        if op not in OPS:
            raise ValueError(f"the relay carries {OPS}, not {op!r}")
        self.calls += 1
        self.log.append((op, _digest(args, kwargs)))
        try:
            return getattr(self.session, op)(*args, **kwargs)
        except Exception as e:
            self.errors.append((op, repr(e)[:200]))
            raise

    @staticmethod
    def _failure(err: BaseException) -> BaseException:
        """The coordinator's ``RankFailure`` behind ``err`` where a peer
        went away, else ``err``."""
        from ..resilience import coord
        f = coord.as_rank_failure(err) if isinstance(err, Exception) \
            else None
        return f if f is not None else err


def _is_rank_failure(err: BaseException) -> bool:
    from ..resilience.coord import RankFailure
    return isinstance(err, RankFailure)


def _digest(args: tuple, kwargs: dict) -> int:
    """A digest of a call's payload that every rank computes alike."""
    import hashlib
    import pickle
    return int.from_bytes(hashlib.sha256(pickle.dumps(
        (args, sorted(kwargs.items())))).digest()[:8], "little")
