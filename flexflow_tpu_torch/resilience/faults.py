"""Deterministic fault injection for resilience testing.

The port of ``flexflow_tpu/resilience/faults.py``: the same plan
grammar, every kind's parser and the same one-shot semantics. The
firing sites of ``crash``, ``nan``, ``inf``, ``corrupt_ckpt``,
``truncate_ckpt``, ``infer_fail``, ``infer_crash`` and ``lose_device``
are live; the rank-scoped kinds fire where their rank matches this
process's (``torch.distributed.get_rank()``, 0 without a process group),
``corrupt_shard`` and ``crash_after_stage`` in the multi-host checkpoint
writer (``runtime/checkpoint.py``); ``FF_FAULT_PLAN_EPOCH0`` arms a plan
in world epoch 0 only; ``degrade_link`` and ``workload_shift`` parse and
record, and their consumers (the cost model, the replan controller)
come with the ports of the search and of replanning.

The reference has no fault-tolerance story (SURVEY.md §5: "failure
detection / elastic recovery: absent"); this harness makes failures a
*first-class, reproducible input* so the recovery paths (supervisor
restarts, checkpoint fallback, elastic re-plan) are exercised by normal
tests and CI instead of waiting for a real preemption.

Fault plan grammar (``FF_FAULT_PLAN`` env var or :func:`install`)::

    plan   := clause (';' clause)*          # ',' also accepted
    clause := kind '@' step (':' arg)*
    kind   := crash | nan | inf | corrupt_ckpt | truncate_ckpt
              | lose_device | infer_fail     # aliases: nan_grad, corrupt,
              | rank_crash | rank_hang       # truncate, lose, infer
              | corrupt_shard | crash_after_stage
              | infer_crash                  # hard replica death on the
                                             # N-th inference call
              | degrade_link                 # tier bandwidth drill
              | workload_shift               # live batch-shape drill

Examples::

    FF_FAULT_PLAN="crash@2"                  # raise SimulatedCrash before
                                             # global step 2 executes
    FF_FAULT_PLAN="nan@5"                    # poison params + loss with NaN
                                             # after step 5 runs
    FF_FAULT_PLAN="corrupt_ckpt@3"           # flip bytes in the step-3
                                             # checkpoint right after its save
    FF_FAULT_PLAN="truncate_ckpt@3"          # truncate its meta.json instead
    FF_FAULT_PLAN="lose_device@4:2"          # virtual loss of 2 devices
                                             # before step 4
    FF_FAULT_PLAN="crash@2;nan@6;lose@9"     # compose freely

Rank-scoped kinds (multi-process worlds) take the target rank
as the arg and fire ONLY in the process whose rank
matches (every rank parses the same plan; non-matching ranks simply
never consume the clause)::

    FF_FAULT_PLAN="rank_crash@3:1"           # rank 1 hard-exits (os._exit,
                                             # no cleanup) before step 3
    FF_FAULT_PLAN="rank_hang@3:1"            # rank 1 SIGSTOPs itself —
                                             # heartbeats stop, survivors
                                             # attribute it
    FF_FAULT_PLAN="corrupt_shard@2:1"        # flip bytes in rank 1's shard
                                             # of the committed step-2
                                             # multi-host checkpoint
    FF_FAULT_PLAN="crash_after_stage@2:1"    # rank 1 dies BETWEEN staging
                                             # its step-2 shard and the
                                             # manifest commit (torn-
                                             # checkpoint drill)

Closed-loop adaptation drills — the chaos inputs the
``ReplanController`` (resilience/replan.py) heals. ``degrade_link``
scales a fabric tier's modeled bandwidth mid-run (the CPU-sim timing
path scales measured collective seconds by the factor, since a virtual
mesh has no physical link to slow), so prediction-vs-reality drift
fires deterministically; ``workload_shift`` changes the live global
batch shape. Both are one-shot and rank-scopable via a trailing rank
arg::

    FF_FAULT_PLAN="degrade_link@3:dcn:4"     # before step 3 the dcn tier
                                             # runs 4x slower (factor >= 1)
    FF_FAULT_PLAN="degrade_link@3:dcn:4:1"   # ...only in rank 1's process
    FF_FAULT_PLAN="workload_shift@5:16"      # before step 5 the live
                                             # global batch becomes 16
    FF_FAULT_PLAN="workload_shift@5:16:0"    # ...only in rank 0's process

Semantics:

  - steps are the **global** train-step counter (``FFModel._step``:
    number of completed optimizer steps, so "``crash@k``" fires before
    the k-th step runs and after checkpoint ``k`` — if any — was saved);
  - every clause fires **exactly once per process**: an in-process
    restart (the supervisor's recovery loop) does not re-fire it, which
    is what makes crash-and-resume runs terminate deterministically;
  - injection sites are the train-step driver (``FFModel.
    _run_train_step``) and the checkpoint writer
    (``CheckpointManager``); both check :func:`active` first, so a run
    with no plan pays one cached attribute read per step.

Every firing is counted in :mod:`.status` (always on) and as an
``obs.events`` instant + counter (when tracing is enabled).
"""
from __future__ import annotations

import dataclasses
import itertools
import os
import re
from typing import List, Optional

from ..obs import events as obs_events
from ..obs.trace_export import _rank
from . import status

ENV_VAR = "FF_FAULT_PLAN"

#: alias -> canonical kind
_KINDS = {
    "crash": "crash",
    "nan": "nan", "nan_grad": "nan",
    "inf": "inf",
    "corrupt_ckpt": "corrupt_ckpt", "corrupt": "corrupt_ckpt",
    "truncate_ckpt": "truncate_ckpt", "truncate": "truncate_ckpt",
    "lose_device": "lose_device", "lose": "lose_device",
    "infer_fail": "infer_fail", "infer": "infer_fail",
    "infer_crash": "infer_crash",
    "rank_crash": "rank_crash",
    "rank_hang": "rank_hang",
    "corrupt_shard": "corrupt_shard",
    "crash_after_stage": "crash_after_stage",
    "degrade_link": "degrade_link", "degrade": "degrade_link",
    "workload_shift": "workload_shift", "shift": "workload_shift",
}

#: exit code of an injected hard rank crash (``rank_crash`` /
#: ``crash_after_stage``): ``os._exit`` with no cleanup, so to the rest
#: of the world it is indistinguishable from a SIGKILL'd process.
RANK_CRASH_EXIT = 13

#: multi-arg clauses (``degrade_link@N:tier:factor[:rank]``) extend the
#: original single-arg grammar; ``.`` is an arg char so float factors
#: parse. ``Fault.arg`` stays the FIRST arg for back-compat.
_CLAUSE_RE = re.compile(r"^([a-z_]+)@(\d+)((?::[A-Za-z0-9_.]+)*)$")


class FaultError(RuntimeError):
    """Base of all injected failures."""


class SimulatedCrash(FaultError):
    """Injected process crash (``crash@N``)."""

    def __init__(self, step: int):
        super().__init__(f"injected crash before step {step}")
        self.step = step


class DeviceLoss(FaultError):
    """Injected loss of ``n_lost`` devices (``lose_device@N:k``) — the
    supervisor's elastic path catches this and re-plans for the
    shrunken mesh."""

    def __init__(self, step: int, n_lost: int = 1):
        super().__init__(
            f"injected loss of {n_lost} device(s) before step {step}")
        self.step = step
        self.n_lost = n_lost


@dataclasses.dataclass
class Fault:
    kind: str
    step: int
    arg: Optional[str] = None
    fired: bool = False
    #: full arg tuple of a multi-arg clause; synced with ``arg`` (the
    #: first element) so hand-built single-arg faults keep working
    args: tuple = ()

    def __post_init__(self):
        if not self.args and self.arg is not None:
            self.args = (self.arg,)
        elif self.args and self.arg is None:
            self.arg = self.args[0]


class FaultPlan:
    """An ordered list of one-shot fault clauses."""

    def __init__(self, faults: Optional[List[Fault]] = None):
        self.faults = list(faults or [])

    @classmethod
    def parse(cls, text: str) -> "FaultPlan":
        faults = []
        for raw in re.split(r"[;,]", text or ""):
            raw = raw.strip()
            if not raw:
                continue
            m = _CLAUSE_RE.match(raw)
            if m is None:
                raise ValueError(
                    f"bad fault clause {raw!r} (grammar: "
                    f"kind@step[:arg]*, "
                    f"kinds: {sorted(set(_KINDS.values()))})")
            kind = _KINDS.get(m.group(1))
            if kind is None:
                raise ValueError(
                    f"unknown fault kind {m.group(1)!r} in {raw!r} "
                    f"(known: {sorted(_KINDS)})")
            args = tuple(m.group(3).split(":")[1:]) if m.group(3) else ()
            faults.append(Fault(kind, int(m.group(2)), args=args))
        return cls(faults)

    @classmethod
    def from_env(cls) -> "FaultPlan":
        """``FF_FAULT_PLAN`` plus — only in world epoch 0 —
        ``FF_FAULT_PLAN_EPOCH0``. The epoch-gated variant is how a
        world-supervised run injects a rank fault exactly once: clauses
        fire once per *process*, so a relaunched world (fresh processes,
        same environment) would re-fire a plain ``FF_FAULT_PLAN`` clause
        forever; the epoch-0 plan dies with the epoch it wounded."""
        parts = [os.environ.get(ENV_VAR, "")]
        if int(os.environ.get("FF_WORLD_EPOCH", "0") or 0) == 0:
            parts.append(os.environ.get(ENV_VAR + "_EPOCH0", ""))
        return cls.parse(";".join(p for p in parts if p))

    # ------------------------------------------------------------------
    def unfired(self) -> int:
        return sum(1 for f in self.faults if not f.fired)

    def fire(self, kind: str, step: int,
             rank: Optional[int] = None,
             rank_index: int = 0) -> Optional[Fault]:
        """Consume and return the first unfired clause of ``kind`` due
        at ``step``; None otherwise. ``rank`` (rank-scoped kinds: the
        caller's process index) must match the clause's rank arg — the
        arg at ``rank_index`` (0 for the classic single-arg kinds; the
        trailing position for multi-arg kinds like ``degrade_link``) —
        a clause targeting another rank is left unfired for THAT rank's
        process to consume."""
        for f in self.faults:
            if f.fired or f.kind != kind or f.step != step:
                continue
            if rank is not None:
                a = f.args[rank_index] \
                    if len(f.args) > rank_index else None
                if a is not None and int(a) != rank:
                    continue
            f.fired = True
            status.record_fault(kind, step)
            obs_events.counter(f"resilience.fault.{kind}")
            obs_events.instant("resilience.fault_injected",
                               kind=kind, step=step, arg=f.arg)
            return f
        return None


# ---------------------------------------------------------------------------
# process-wide plan
# ---------------------------------------------------------------------------
_plan: Optional[FaultPlan] = None


def get_plan() -> FaultPlan:
    global _plan
    if _plan is None:
        _plan = FaultPlan.from_env()
    return _plan


def install(plan) -> FaultPlan:
    """Set the process-wide plan (a :class:`FaultPlan` or a grammar
    string); the API analog of the ``FF_FAULT_PLAN`` env var. The
    inference-call counter restarts at 0 so ``infer_fail@N`` indices in
    the new plan count from ITS installation, not from whatever calls a
    previous plan saw."""
    global _plan, _infer_calls
    _plan = FaultPlan.parse(plan) if isinstance(plan, str) else plan
    _infer_calls = itertools.count()
    return _plan


def clear() -> None:
    """Drop the installed plan; the env var is re-read on next use.
    Also restarts the inference-call counter (see :func:`install`) and
    heals any registered link degradation / pending workload shift."""
    global _plan, _infer_calls, _workload_shift
    _plan = None
    _infer_calls = itertools.count()
    _link_degradation.clear()
    _workload_shift = None


def active() -> bool:
    """Cheap per-step check: does any unfired clause remain?"""
    return get_plan().unfired() > 0


# ---------------------------------------------------------------------------
# closed-loop adaptation drills: link degradation + workload
# shift state the replan controller and the CPU-sim timing path consult
# ---------------------------------------------------------------------------

#: tier name -> slowdown factor (>= 1.0); empty = healthy fabric
_link_degradation: dict = {}

#: global batch size requested by a fired workload_shift clause, until
#: a reader consumes it via :func:`pending_workload_shift`
_workload_shift: Optional[int] = None


def set_link_degradation(tier: str, factor: float) -> None:
    """Register (or heal, with ``factor <= 1``) a modeled bandwidth
    slowdown for one fabric tier (``"ici"`` / ``"dcn"`` / ``"host"``).
    Consulted by the analytic cost model's tier pricing and by the
    calibration microbenches, so predictions AND fresh measurements
    both see the degraded link."""
    f = float(factor)
    if f <= 1.0:
        _link_degradation.pop(tier, None)
    else:
        _link_degradation[tier] = f


def link_degradation(tier: str) -> float:
    """Current slowdown factor of one tier (1.0 = healthy)."""
    return _link_degradation.get(tier, 1.0)


def degraded_links() -> dict:
    """``{tier: factor}`` of every currently degraded tier."""
    return dict(_link_degradation)


def pending_workload_shift() -> Optional[int]:
    """The new global batch size requested by a fired
    ``workload_shift`` clause; consumed (cleared) by the read — the
    replan controller treats it as a live-shape trigger."""
    global _workload_shift
    b, _workload_shift = _workload_shift, None
    return b


def maybe_degrade(step: int) -> Optional[tuple]:
    """``degrade_link@N:tier:factor[:rank]`` clauses due before ``step``
    executes: register the tier slowdown and return ``(tier, factor)``
    (None = no clause due). One-shot like every clause; the degradation
    itself persists until :func:`clear` or a healing
    :func:`set_link_degradation` call."""
    f = get_plan().fire("degrade_link", step, rank=_rank(),
                        rank_index=2)
    if f is None:
        return None
    tier = (f.args[0] if len(f.args) > 0 else "") or "dcn"
    factor = float(f.args[1]) if len(f.args) > 1 and f.args[1] else 2.0
    set_link_degradation(tier, factor)
    return (tier, factor)


def maybe_workload_shift(step: int) -> Optional[int]:
    """``workload_shift@N[:batch][:rank]`` clauses due before ``step``
    executes: record the requested global batch size (default: double
    the unknown current one, encoded as 0 for 'caller decides') and
    return it (None = no clause due)."""
    global _workload_shift
    f = get_plan().fire("workload_shift", step, rank=_rank(),
                        rank_index=1)
    if f is None:
        return None
    b = int(f.args[0]) if len(f.args) > 0 and f.args[0] else 0
    _workload_shift = b
    return b


def raise_pending(step: int) -> None:
    """Crash / device-loss / rank-scoped clauses due before ``step``
    executes. The non-raising adaptation drills (``degrade_link`` /
    ``workload_shift``) fire here too — one injection site in the
    train-step driver covers every step-indexed kind."""
    maybe_degrade(step)
    maybe_workload_shift(step)
    plan = get_plan()
    if plan.fire("crash", step) is not None:
        raise SimulatedCrash(step)
    f = plan.fire("lose_device", step)
    if f is not None:
        raise DeviceLoss(step, n_lost=int(f.arg or 1))
    if plan.fire("rank_crash", step, rank=_rank()) is not None:
        # hard death — no atexit, no finally, heartbeats just stop;
        # the surviving world must notice via resilience/coord.py
        os._exit(RANK_CRASH_EXIT)
    if plan.fire("rank_hang", step, rank=_rank()) is not None:
        # freeze the WHOLE process (heartbeat thread included): the
        # truthful simulation of a wedged rank. SIGKILL still works on
        # a stopped process — the world supervisor reaps it.
        import signal
        os.kill(os.getpid(), signal.SIGSTOP)


#: process-wide inference-call counter for ``infer_fail@N`` clauses.
#: Advances only while a plan is active (``InferenceSession.infer``
#: gates on :func:`active` first), so call indices are deterministic
#: for a plan installed before serving starts. ``itertools.count`` is
#: safe under the serving workers' concurrency in CPython.
_infer_calls = itertools.count()


def raise_infer_fault() -> None:
    """Inference-path clauses (``infer_fail@N``): the N-th
    ``InferenceSession.infer`` call made while a plan is active raises
    :class:`FaultError` — the serving chaos harness for circuit-breaker
    and batch-poison paths. Each clause is one-shot like every other
    kind; compose K consecutive clauses to trip a breaker with
    threshold K."""
    step = next(_infer_calls)
    if get_plan().fire("infer_fail", step) is not None:
        raise FaultError(f"injected inference failure at call {step}")
    if get_plan().fire("infer_crash", step) is not None:
        # hard death of a serving REPLICA mid-request (``infer_crash@N``):
        # no drain, no socket close — the fleet router must notice via
        # its health poll / transport errors and reroute. Same exit
        # code as a rank crash: to everything else it is a SIGKILL.
        os._exit(RANK_CRASH_EXIT)


def poison_value(step: int) -> Optional[float]:
    """NaN/Inf gradient-corruption clauses due after ``step`` ran:
    returns the poison value, or None."""
    plan = get_plan()
    if plan.fire("nan", step) is not None:
        return float("nan")
    if plan.fire("inf", step) is not None:
        return float("inf")
    return None


def _pick_state_file(step_dir: str) -> Optional[str]:
    """The checkpoint payload file to corrupt: the pickle when present,
    else the largest file under the orbax state dir."""
    pkl = os.path.join(step_dir, "state.pkl")
    if os.path.exists(pkl):
        return pkl
    sdir = os.path.join(step_dir, "state")
    best, best_sz = None, -1
    for root, _, files in os.walk(sdir):
        for fn in files:
            p = os.path.join(root, fn)
            sz = os.path.getsize(p)
            if sz > best_sz:
                best, best_sz = p, sz
    return best


def _flip_bytes(path: str) -> None:
    with open(path, "r+b") as f:
        f.seek(0, os.SEEK_END)
        size = f.tell()
        off = size // 2
        n = min(64, max(1, size - off))
        f.seek(off)
        chunk = f.read(n)
        f.seek(off)
        f.write(bytes(b ^ 0xFF for b in chunk))


def maybe_corrupt_checkpoint(step: int, step_dir: str) -> None:
    """Checkpoint-corruption clauses, applied right after the save of
    ``step`` lands (called by ``CheckpointManager``)."""
    plan = get_plan()
    if plan.fire("corrupt_ckpt", step) is not None:
        target = _pick_state_file(step_dir)
        if target is not None:
            _flip_bytes(target)
    if plan.fire("truncate_ckpt", step) is not None:
        meta = os.path.join(step_dir, "meta.json")
        if os.path.exists(meta):
            with open(meta, "r+b") as f:
                f.truncate(max(1, os.path.getsize(meta) // 2))


def maybe_crash_after_stage(step: int) -> None:
    """``crash_after_stage@N:r``: die between staging this rank's shard
    (fsynced, debris-only) and the manifest commit — the torn-multi-host-
    checkpoint drill. Called by the two-phase writer right after the
    shard fsync."""
    if get_plan().fire("crash_after_stage", step, rank=_rank()) \
            is not None:
        os._exit(RANK_CRASH_EXIT)


def maybe_corrupt_shard(step: int, shard_path: str) -> None:
    """``corrupt_shard@N:r``: flip bytes in THIS rank's shard of the
    committed multi-host checkpoint ``step`` — quorum restore must rule
    the step out on every rank."""
    if get_plan().fire("corrupt_shard", step, rank=_rank()) is not None:
        if os.path.exists(shard_path):
            _flip_bytes(shard_path)
