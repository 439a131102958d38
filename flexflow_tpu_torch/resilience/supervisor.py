"""Resilient training driver: bounded restarts, exact resume, rollback.

The port of ``flexflow_tpu/resilience/supervisor.py``'s in-process
:class:`Supervisor` and :func:`run_supervised`. ``FFModel.fit`` assumes
the process, the data pipeline and the machine survive the whole run;
:class:`Supervisor` drops that assumption. It drives the same per-step
machinery (``ff._run_train_step`` over a ``SingleDataLoader``) inside a
recovery loop:

  - **auto-resume**: on start, the newest *valid* checkpoint in the
    directory is restored — model state copied into the live tensors by
    ``restore_model_checkpoint``, dataloader position (rng state, epoch,
    batch index) from the checkpoint metadata — so a resumed run replays
    the exact remaining batches. Dropout masks are keyed by (seed + 1,
    step, layer), so restoring the step restores the masks too;
  - **bounded restarts**: any step failure (a real exception or an
    injected :class:`~flexflow_tpu_torch.resilience.faults.SimulatedCrash`)
    consumes one unit of the restart budget, sleeps an exponential
    backoff with jitter, restores, and continues; budget exhausted →
    the last error propagates;
  - **NaN rollback**: a non-finite loss never reaches a checkpoint —
    the step is detected before the periodic save, the run rolls back
    to the last good checkpoint, and the rollback is counted (a
    non-finite loss that recurs after its rollback stops the run);
  - **device loss**: an injected
    :class:`~flexflow_tpu_torch.resilience.faults.DeviceLoss` propagates
    with ``elastic=False``, as in the JAX package; ``elastic=True``
    raises :class:`NotImplementedError`: the in-process elastic re-plan
    (``elastic.replan_on_device_loss``) moves one process's mesh onto
    fewer of its own devices, and a port process drives one device, so
    it waits for a mesh described larger than the world (ROADMAP queue
    1, item 4.1's leftover). A lost RANK is the world's business;
  - **peer failure**: a
    :class:`~flexflow_tpu_torch.resilience.coord.RankFailure` (a dead
    PEER, detected by the coordinator's heartbeats or barriers, or a
    collective's error that the coordinator attributes) propagates and
    never consumes the restart budget: every in-process restore is a
    collective with the dead rank. :func:`run_world_member` turns it
    into the exit code :data:`~.coord.EXIT_RANK_FAILURE`.

:class:`WorldSupervisor` is the launcher-side half: it runs the world's
processes, and on a failed epoch re-forms the world (relaunch at full
size under a budget, else shrink) at a fresh port and world epoch; the
members resume from the last committed multi-host checkpoint.
Everything reports into ``obs``: restart/rollback counters, a
time-since-last-checkpoint gauge, save/restore spans, and the always-on
:mod:`.status` block.
"""
from __future__ import annotations

import logging
import os
import random
import time
from typing import Dict, List, Optional

from ..obs import events as obs_events
from ..obs.metrics_registry import REGISTRY
from ..runtime.metrics_buffer import MetricsBuffer, NonFiniteMetrics
from . import coord, status
from .coord import EXIT_RANK_FAILURE, RankFailure
from .faults import DeviceLoss, SimulatedCrash  # noqa: F401 (re-export)

log = logging.getLogger("flexflow_tpu_torch")


class RestartBudgetExceeded(RuntimeError):
    """The supervisor ran out of restarts; the cause is ``__cause__``."""


class Supervisor:
    """Wraps a compiled :class:`FFModel` in a crash/corruption tolerant
    train loop. See the module docstring for semantics.

    ``checkpoint_every`` is in optimizer steps; ``max_restarts`` bounds
    recoveries of EVERY kind (crash, NaN rollback) across the whole
    run."""

    def __init__(self, ff, directory: str, *,
                 checkpoint_every: int = 1, max_to_keep: int = 3,
                 max_restarts: int = 3, backoff_base_s: float = 0.05,
                 backoff_max_s: float = 2.0, backoff_jitter: float = 0.25,
                 async_save: bool = False, elastic: bool = True,
                 verbose: bool = False):
        from ..runtime.checkpoint import CheckpointManager
        self.ff = ff
        self.directory = directory
        self.checkpoint_every = max(1, checkpoint_every)
        self.max_restarts = max_restarts
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self.backoff_jitter = backoff_jitter
        self.async_save = async_save
        self.elastic = elastic
        self.verbose = verbose
        self.restarts = 0
        self.nan_rollbacks = 0
        self.elastic_replans = 0
        self._mgr = CheckpointManager(directory, max_to_keep=max_to_keep,
                                      async_save=async_save)
        self._since_ckpt = 0
        self._last_save_t: Optional[float] = None
        self._nan_steps: set = set()
        # live deferred-metrics buffer while _run_epoch is driving
        # steps; _save flushes + NaN-screens through it so a poisoned
        # state can never reach a checkpoint
        self._buffer: Optional[MetricsBuffer] = None

    # ------------------------------------------------------------------
    def run(self, x=None, y=None, epochs: Optional[int] = None,
            batch_size: Optional[int] = None, shuffle: bool = True,
            callbacks=None) -> List[Dict[str, float]]:
        """Train to completion (the resilient ``fit``); returns the
        per-epoch history. Resumes automatically from the newest valid
        checkpoint in ``directory`` when one exists. ``callbacks`` get
        the same per-epoch ``on_epoch_end(epoch, logs, model)`` contract
        as ``fit`` (a stop request ends the run after the epoch's
        checkpoint)."""
        ff = self.ff
        if ff.executor is None:
            raise ValueError("call compile() first")
        from ..obs import flight
        flight.install_excepthook()  # unhandled crash -> flight record
        epochs = epochs or ff.config.epochs
        loader = ff._combined_loader(x, y, batch_size, shuffle=shuffle)
        if not self._try_resume(loader):
            loader.reset()
            loader.epoch = 0
            self._save(loader)  # step-0 restore point: recovery always
            #                     has somewhere to land, even pre-ckpt-1
        history: List[Dict[str, float]] = []
        while loader.epoch < epochs:
            try:
                rep = self._run_epoch(loader)
                epoch_done = loader.epoch
                loader.epoch += 1
                if loader.epoch < epochs:
                    loader.reset()
                # epoch-boundary save so a later resume lands in the
                # right epoch with the fresh shuffle order; history is
                # appended only AFTER it succeeds — a failed save
                # triggers recovery, which replays the tail and must
                # not find the epoch already recorded
                self._save(loader)
                if rep is not None:
                    history.append(rep)
                    if callbacks:
                        # same contract as fit(); runs after the
                        # boundary save so a callback crash never
                        # loses the epoch
                        stop = False
                        for cb in callbacks:
                            cb.on_epoch_end(epoch_done, rep, ff)
                            stop = stop or getattr(cb, "stop_requested",
                                                   False)
                        if stop:
                            break
            except NonFiniteMetrics as e:
                if e.step in self._nan_steps:
                    # the rollback replays the exact same batch into the
                    # exact same params (that is what makes injected-
                    # fault recovery deterministic) — so a GENUINE
                    # divergence recurs identically; fail now instead of
                    # burning the remaining budget on doomed replays
                    raise RestartBudgetExceeded(
                        f"non-finite loss at step {e.step} recurred "
                        f"after rollback (deterministic divergence, not "
                        f"a transient)") from e
                self._nan_steps.add(e.step)
                self.nan_rollbacks += 1
                status.record("nan_rollbacks")
                flight.dump_flight_record("nan_rollback", exc=e)
                self._recover(loader, reason="nan_loss", err=e)
            except DeviceLoss as e:
                self._device_loss(e)
            except RankFailure:
                # a dead PEER rank: no in-process restore can reform the
                # world (every restore is a collective with the corpse).
                # Propagate so the world supervisor can relaunch/shrink;
                # the restart budget is for THIS process's failures.
                raise
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception as e:  # noqa: BLE001 — that's the job
                # a collective that failed because a peer died is the
                # world's failure, not this process's: once the
                # coordinator attributes it, it propagates as above
                rf = coord.as_rank_failure(e)
                if rf is not None:
                    raise rf from e
                self._recover(loader, reason=type(e).__name__, err=e)
        self._mgr.wait(timeout_s=self._mgr.WAIT_TIMEOUT_S)
        ff._current_metrics = history[-1] if history else {}
        if getattr(ff.config, "trace_export_file", ""):
            # same end-of-training export hook as fit()
            from ..obs.trace_export import export_chrome_trace
            if obs_events.enabled():
                export_chrome_trace(ff.config.trace_export_file)
        ff._end_of_training_telemetry()   # rank dump
        return history

    # ------------------------------------------------------------------
    def _run_epoch(self, loader) -> Optional[Dict[str, float]]:
        from ..runtime.metrics import PerfMetrics
        ff = self.ff
        step_fn = ff.executor.make_train_step()
        pm = PerfMetrics()
        buf = MetricsBuffer.for_config(ff.config, pm=pm)
        self._buffer = buf
        ff._metrics_buffer = buf  # ff.save_checkpoint screens through it
        t0 = time.perf_counter()
        nb = 0
        try:
            while True:
                batch = loader.next_batch()
                if batch is None:
                    break
                bm = ff._run_train_step(step_fn, batch)
                bsz = next(iter(batch.values())).shape[0]
                # deferred accumulation: metrics stay on the device; the
                # NaN screen is the step's all_finite flag checked at
                # flush points (every save below, print_freq, epoch
                # end)
                buf.push(ff._step - 1, bm, bsz)
                buf.raise_if_poisoned()
                nb += 1
                self._since_ckpt += 1
                if self._since_ckpt >= self.checkpoint_every:
                    # _save flushes + screens the pending window first
                    self._save(loader)
                self._update_ckpt_age_gauge()
                pf = ff.config.print_freq
                if self.verbose and pf > 0 and nb % pf == 0:
                    buf.flush()
                    buf.raise_if_poisoned()
                    rep = pm.report()
                    msg = " ".join(f"{k}={v:.4f}" for k, v in rep.items())
                    print(f"epoch {loader.epoch} iter {nb}/"
                          f"{loader.num_batches} {msg}")
            buf.flush()
            buf.raise_if_poisoned()
        finally:
            self._buffer = None
            ff._metrics_buffer = None
        if nb == 0:
            # resumed from a checkpoint taken at the epoch's last batch
            # (killed before the boundary save overwrote it): nothing
            # left to run — report None so a metric-less {} never lands
            # in history (consumers index history[-1]["loss"])
            return None
        dt = time.perf_counter() - t0
        rep = pm.report()
        rep["epoch_time_s"] = dt
        rep["samples_per_sec"] = pm.train_all / dt if dt > 0 else 0.0
        obs_events.record_span("supervisor.epoch", t0, dt,
                               epoch=loader.epoch, batches=nb)
        REGISTRY.gauge(
            "ff_train_samples_per_sec",
            "Training throughput of the last completed epoch"
        ).set(rep["samples_per_sec"])
        return rep

    # ------------------------------------------------------------------
    def _save(self, loader) -> None:
        from ..runtime.checkpoint import save_model_checkpoint
        if self._buffer is not None:
            # the deferred NaN screen ALWAYS runs immediately before a
            # checkpoint save: flush the in-flight window and raise on
            # the first non-finite step — the rollback happens INSTEAD
            # of the save, so a poisoned state never lands on disk
            self._buffer.flush()
            self._buffer.raise_if_poisoned()
        t0 = time.perf_counter()
        save_model_checkpoint(
            self.ff, self.directory, manager=self._mgr,
            extra_metadata={"loader": loader.state_dict(),
                            "supervisor": {"restarts": self.restarts}},
            blocking=not self.async_save)
        self._since_ckpt = 0
        self._last_save_t = time.monotonic()
        self._update_ckpt_age_gauge()
        obs_events.record_span("supervisor.save", t0,
                               time.perf_counter() - t0,
                               step=self.ff._step,
                               blocking=not self.async_save)

    def _try_resume(self, loader) -> bool:
        if self._mgr.latest_step() is None:
            return False
        try:
            self._restore(loader)
        except FileNotFoundError:
            return False  # every step corrupt: start fresh
        log.info("supervisor: resumed from checkpoint step %d "
                 "(epoch %d, batch %d)", self.ff._step, loader.epoch,
                 loader.idx)
        return True

    def _restore(self, loader) -> None:
        from ..runtime.checkpoint import restore_model_checkpoint
        self._mgr.wait(timeout_s=self._mgr.WAIT_TIMEOUT_S)
        step, meta = restore_model_checkpoint(self.ff, self.directory,
                                              with_meta=True)
        ld = meta.get("loader")
        if ld is not None:
            loader.load_state_dict(ld)   # drops the prefetched batches
        else:
            loader.reset()
        self._since_ckpt = 0

    # ------------------------------------------------------------------
    def _consume_restart(self, reason: str, err: BaseException) -> None:
        self.restarts += 1
        status.record("restarts")
        REGISTRY.counter("ff_resilience_restarts_total",
                         "Supervisor recoveries, any cause"
                         ).inc(reason=reason)
        obs_events.counter("resilience.restart")
        obs_events.instant("resilience.restart", reason=reason,
                           step=self.ff._step, attempt=self.restarts)
        if self.restarts > self.max_restarts:
            raise RestartBudgetExceeded(
                f"restart budget ({self.max_restarts}) exhausted; "
                f"last failure: {reason}: {err}") from err
        log.warning("supervisor: recovering from %s at step %d "
                    "(restart %d/%d): %s", reason, self.ff._step,
                    self.restarts, self.max_restarts, err)

    def _backoff(self) -> None:
        delay = min(self.backoff_max_s,
                    self.backoff_base_s * (2 ** (self.restarts - 1)))
        delay *= 1.0 + self.backoff_jitter * random.random()
        time.sleep(delay)

    def _recover(self, loader, reason: str, err: BaseException) -> None:
        self._consume_restart(reason, err)
        self._backoff()
        self._restore(loader)

    def _device_loss(self, err: DeviceLoss) -> None:
        """A lost device: propagated without ``elastic``, as in the JAX
        package; with it, refused, since the elastic path re-plans the
        strategy for a shrunken mesh of this process's own devices, and
        a port process drives one."""
        if not self.elastic:
            raise err
        raise NotImplementedError(
            f"elastic recovery from a device loss ({err}) re-plans one "
            f"process's mesh onto fewer of its own devices "
            f"(elastic.replan_on_device_loss); a port process drives one "
            f"device, so the re-plan waits for a mesh described larger "
            f"than the world (ROADMAP queue 1, item 4.1's leftover). A "
            f"lost rank is re-formed by WorldSupervisor; pass "
            f"elastic=False to let the DeviceLoss propagate") from err

    # ------------------------------------------------------------------
    def _update_ckpt_age_gauge(self) -> None:
        if self._last_save_t is not None:
            REGISTRY.gauge(
                "ff_time_since_last_checkpoint_seconds",
                "Age of the newest completed checkpoint"
            ).set(time.monotonic() - self._last_save_t)


def run_world_member(fn, *args, **kwargs):
    """Run a worker-main under world-supervision exit semantics: a
    :class:`~flexflow_tpu_torch.resilience.coord.RankFailure` (a dead
    PEER), or an error of a collective that the coordinator attributes
    to one, exits with :data:`EXIT_RANK_FAILURE` so the
    :class:`WorldSupervisor` can tell "I detected a corpse" apart from
    "I am the corpse". Every other exception propagates normally."""
    try:
        return fn(*args, **kwargs)
    except Exception as e:  # noqa: BLE001 — re-raised unless attributed
        rf = coord.as_rank_failure(e)
        if rf is None:
            raise
        log.error("world member exiting for re-formation: %s", rf)
        # os._exit, not sys.exit: the process may hold wedged device
        # state; skip atexit/process-group teardown that could hang
        os._exit(EXIT_RANK_FAILURE)


class WorldFailure(RuntimeError):
    """The world could not be re-formed within the restart/shrink
    policy; per-rank exit details ride in ``.report``."""

    def __init__(self, msg: str, report=None):
        super().__init__(msg)
        self.report = report or []


class WorldSupervisor:
    """Launcher-side supervisor of an N-process world of ranks — the
    cross-process half of the resilience story (the per-process
    :class:`Supervisor` handles everything that does not kill a rank).

    Workers detect a dead peer via ``resilience/coord.py`` (missed
    heartbeats, bounded barriers, attributed collective errors) and exit
    ``EXIT_RANK_FAILURE``; dead ranks just die (or hang and are killed
    here). On any failed epoch the WorldSupervisor kills the remnants,
    bumps the **world epoch**, and re-forms the world at a fresh
    coordinator port:

      - while the restart budget lasts: **relaunch** at full size — the
        dead rank comes back and every rank resumes bit-exact from the
        last committed multi-host checkpoint step (quorum restore);
      - budget exhausted (or ``policy="shrink"``): **shrink** — drop to
        the largest batch-divisible world below the current size and
        keep going; the restored state is placed onto the smaller world
        block by block, as every restore places it.

    ``worker_cmd`` is either a callable ``(rank, nprocs, port, epoch)
    -> argv list`` or an argv template whose ``{rank}``/``{nprocs}``/
    ``{port}``/``{epoch}`` placeholders are substituted. Workers
    inherit the environment plus the ``FF_*`` world variables that the
    port's rendezvous reads (``FF_COORDINATOR_ADDRESS``,
    ``FF_NUM_PROCESSES``, ``FF_PROCESS_ID``), the world epoch
    (``FF_WORLD_EPOCH``) and ``FF_WORLD_SUPERVISED=1``.

    Every wait is bounded: a world that neither finishes nor fails
    within ``world_timeout_s`` is killed and treated as failed
    (unattributed hang). When a rank exits with the detector's code,
    the ranks still running are killed at once, as in the JAX package.
    When a rank dies any other way, the survivors get the coordinator's
    detection bound (:meth:`_detection_bound_s`) to name it and exit
    with the detector's code on their own before they are killed, so
    the report carries the detector's exit and flight record (the JAX
    package kills them at once)."""

    def __init__(self, worker_cmd, nprocs: int, *,
                 max_world_restarts: int = 1, policy: str = "auto",
                 min_world: int = 1, batch_size: int = 0,
                 devices_per_rank: int = 1,
                 world_timeout_s: float = 300.0,
                 poll_interval_s: float = 0.1, env=None):
        if policy not in ("auto", "relaunch", "shrink"):
            raise ValueError(f"policy must be 'auto', 'relaunch', or "
                             f"'shrink', got {policy!r}")
        self.worker_cmd = worker_cmd
        self.nprocs = int(nprocs)
        self.max_world_restarts = max_world_restarts
        self.policy = policy
        self.min_world = max(1, min_world)
        self.batch_size = batch_size
        self.devices_per_rank = max(1, devices_per_rank)
        self.world_timeout_s = world_timeout_s
        self.poll_interval_s = poll_interval_s
        self.env = dict(env) if env else None
        self.epoch = int(os.environ.get("FF_WORLD_EPOCH", "0"))
        self.world_restarts = 0
        self.shrinks = 0
        self.report: List[Dict] = []

    # -- helpers -------------------------------------------------------
    def _argv(self, rank: int, port: int) -> List[str]:
        if callable(self.worker_cmd):
            return list(self.worker_cmd(rank, self.nprocs, port,
                                        self.epoch))
        subst = {"{rank}": str(rank), "{nprocs}": str(self.nprocs),
                 "{port}": str(port), "{epoch}": str(self.epoch)}
        out = []
        for a in self.worker_cmd:
            for k, v in subst.items():  # embedded forms too: --rank={rank}
                a = a.replace(k, v)
            out.append(a)
        return out

    @staticmethod
    def _detection_bound_s(env) -> float:
        """How long a survivor may take to exit with the detector's code
        after a peer died, under the heartbeat bounds in the workers'
        environment ``env``: its coordinator names the peer within
        ``FF_HB_TIMEOUT_S`` (to within two beats), and, if the main
        thread does not surface the failure, hard-exits one
        ``FF_HB_TIMEOUT_S`` (and two beats) later."""
        hb = float(env.get("FF_HB_TIMEOUT_S", coord.HB_TIMEOUT_S))
        beat = float(env.get("FF_HB_INTERVAL_S", coord.HB_INTERVAL_S))
        return 2 * (hb + 2 * beat)

    @staticmethod
    def _free_port() -> int:
        import socket
        with socket.socket() as s:
            s.bind(("localhost", 0))
            return s.getsockname()[1]

    # -- one epoch -----------------------------------------------------
    def _launch_epoch(self) -> List[Dict]:
        """Spawn the world, wait bounded, reap everything; returns the
        per-rank records (rank, rc, killed, out, err)."""
        import signal
        import subprocess
        import tempfile
        port = self._free_port()
        base_env = dict(os.environ)
        if self.env:
            base_env.update(self.env)
        procs = []
        deadline = time.monotonic() + self.world_timeout_s
        grace_end = None   # set at the first failure
        grace_s = self._detection_bound_s(base_env)
        try:
            # spawning INSIDE the try: a Popen failure on a later rank
            # (EMFILE, bad argv) must still reap the ranks already
            # launched — they would otherwise block in rendezvous forever
            for r in range(self.nprocs):
                env = dict(base_env)
                env.update({
                    "FF_COORDINATOR_ADDRESS": f"localhost:{port}",
                    "FF_NUM_PROCESSES": str(self.nprocs),
                    "FF_PROCESS_ID": str(r),
                    "FF_WORLD_EPOCH": str(self.epoch),
                    "FF_WORLD_SUPERVISED": "1",
                })
                # files, not pipes: a chatty worker must never deadlock
                # the launcher on a full pipe while we wait on a sibling
                out_f = tempfile.TemporaryFile(mode="w+")
                err_f = tempfile.TemporaryFile(mode="w+")
                p = subprocess.Popen(self._argv(r, port), env=env,
                                     stdout=out_f, stderr=err_f,
                                     text=True, start_new_session=True)
                procs.append({"rank": r, "proc": p, "out_f": out_f,
                              "err_f": err_f, "rc": None})
            while True:
                alive = 0
                failed = []
                for rec in procs:
                    if rec["rc"] is None:
                        rc = rec["proc"].poll()
                        if rc is None:
                            alive += 1
                        else:
                            rec["rc"] = rc
                            if rc != 0:
                                failed.append(rc)
                now = time.monotonic()
                if failed and grace_end is None:
                    # a detector's exit: the ranks left are the suspects
                    grace_end = now + (
                        0.0 if EXIT_RANK_FAILURE in failed else grace_s)
                if alive == 0 or now > deadline or (
                        grace_end is not None and now >= grace_end):
                    break
                time.sleep(self.poll_interval_s)
        finally:
            for rec in procs:
                if rec["proc"].poll() is None:
                    # SIGKILL the whole group: a SIGSTOP'd (hung-fault)
                    # worker ignores anything milder
                    rec["killed"] = True
                    try:
                        os.killpg(rec["proc"].pid, signal.SIGKILL)
                    except OSError:
                        pass
            out = []
            for rec in procs:
                try:
                    # the group was SIGKILLed above; a reap that still
                    # blocks means the kernel is wedged on the process
                    # (e.g. uninterruptible I/O) - give up loudly
                    rec["proc"].wait(timeout=30.0)
                except subprocess.TimeoutExpired:
                    log.error("supervisor: rank %s unreaped 30s after "
                              "SIGKILL; abandoning the zombie",
                              rec.get("rank"))
                rec["rc"] = rec["proc"].returncode
                rec.setdefault("killed", False)
                for key in ("out_f", "err_f"):
                    f = rec.pop(key)
                    f.seek(0)
                    rec[key[:3]] = f.read()
                    f.close()
                rec.pop("proc")
                out.append(rec)
        return out

    @staticmethod
    def _flight_records(epoch: int) -> List[str]:
        """Flight-recorder dumps the workers of world-epoch ``epoch``
        left behind (obs/flight.py — written at RankFailure/NaN/crash
        sites): attached to the per-epoch report so a failed epoch's
        post-mortem starts from the black boxes, not a stderr tail."""
        import glob
        from ..obs import flight
        try:
            return sorted(glob.glob(flight.flight_path("*", epoch)))
        except Exception:  # noqa: BLE001
            return []

    @staticmethod
    def _suspects(records) -> List[int]:
        """Ranks believed dead/hung on their own: died hard without our
        SIGKILL, or — ONLY when no rank died hard — still running
        (wedged) when a peer exited with the detector code and we
        reaped them. A hard death explains the epoch's failure, and the
        reaped survivors were healthy ranks we killed ourselves;
        counting them too would over-shrink worlds larger than 2."""
        detectors = [r["rank"] for r in records
                     if r["rc"] == EXIT_RANK_FAILURE]
        out = [r["rank"] for r in records
               if r["rc"] not in (0, EXIT_RANK_FAILURE)
               and not r["killed"]]
        if not out and detectors:
            out = [r["rank"] for r in records if r["killed"]]
        return sorted(out)

    def _classify(self, records) -> str:
        detectors = [r["rank"] for r in records
                     if r["rc"] == EXIT_RANK_FAILURE]
        return (f"suspect ranks {self._suspects(records)} (exit codes "
                f"{[r['rc'] for r in records]}), detected by ranks "
                f"{detectors}")

    # -- the loop ------------------------------------------------------
    def run(self) -> List[Dict]:
        """Drive the world to a successful epoch; returns the per-rank
        records (with stdout/stderr) of that epoch. Raises
        :class:`WorldFailure` when the policy is exhausted."""
        from .elastic import shrunken_world_size
        while True:
            log.info("world supervisor: launching epoch %d with %d "
                     "process(es)", self.epoch, self.nprocs)
            records = self._launch_epoch()
            flights = self._flight_records(self.epoch)
            for rec in records:
                rec["flight_records"] = [
                    p for p in flights
                    if f"flight_rank{rec['rank']}_" in
                    os.path.basename(p)]
            self.report.append({"epoch": self.epoch,
                                "nprocs": self.nprocs,
                                "rcs": [r["rc"] for r in records],
                                "flight_records": flights})
            if all(r["rc"] == 0 for r in records):
                status.set_value("world_epoch", self.epoch)
                return records
            why = self._classify(records)
            REGISTRY.counter(
                "ff_world_restarts_total",
                "World re-formations by the world supervisor").inc()
            obs_events.instant("resilience.world_restart",
                               epoch=self.epoch, nprocs=self.nprocs,
                               why=why)
            # launcher-side flight record: a hard-crashed rank leaves
            # nothing (os._exit), and the supervisor reaps survivors
            # before their detection window — the launcher is the one
            # process guaranteed to witness the failed epoch, so it
            # records the black box (rank="launcher" can never collide
            # with a worker rank's file)
            from ..obs import flight
            fpath = flight.dump_flight_record(
                "world_restart", rank="launcher", epoch=self.epoch,
                extra={"why": why,
                       "rcs": {str(r["rank"]): r["rc"]
                               for r in records}})
            if fpath and self.report:
                self.report[-1].setdefault("flight_records",
                                           []).append(fpath)
            self.epoch += 1
            relaunch_ok = (self.policy in ("auto", "relaunch")
                           and self.world_restarts
                           < self.max_world_restarts)
            if relaunch_ok:
                self.world_restarts += 1
                status.record("restarts")
                log.warning("world supervisor: %s — relaunching epoch "
                            "%d at full size %d (restart %d/%d)", why,
                            self.epoch, self.nprocs,
                            self.world_restarts,
                            self.max_world_restarts)
                continue
            n_failed = len(self._suspects(records)) or 1
            new_n = 0
            if self.policy in ("auto", "shrink") \
                    and self.nprocs - n_failed >= self.min_world:
                new_n = shrunken_world_size(
                    self.nprocs - n_failed, self.batch_size,
                    self.devices_per_rank)
            if new_n >= self.min_world and new_n > 0:
                log.warning("world supervisor: %s — shrinking world "
                            "%d -> %d for epoch %d", why, self.nprocs,
                            new_n, self.epoch)
                self.nprocs = new_n
                self.shrinks += 1
                status.record("elastic_replans")
                obs_events.counter("resilience.world_shrink")
                continue
            tails = "; ".join(
                f"rank {r['rank']} rc={r['rc']}: "
                f"{(r['err'] or '')[-500:]}" for r in records
                if r["rc"] != 0)
            raise WorldFailure(
                f"world unrecoverable after {self.world_restarts} "
                f"restart(s) and {self.shrinks} shrink(s): {why}\n"
                f"{tails}", report=self.report)


def run_supervised(ff, directory: str, x=None, y=None,
                   epochs: Optional[int] = None,
                   batch_size: Optional[int] = None,
                   shuffle: bool = True, callbacks=None,
                   **supervisor_kwargs) -> List[Dict[str, float]]:
    """One-call resilient training: ``fit`` semantics under a
    :class:`Supervisor` (auto-resume + bounded restarts + rollback).
    ``run()``'s loop options are explicit parameters;
    ``supervisor_kwargs`` configure the :class:`Supervisor` itself."""
    sup = Supervisor(ff, directory, **supervisor_kwargs)
    return sup.run(x=x, y=y, epochs=epochs, batch_size=batch_size,
                   shuffle=shuffle, callbacks=callbacks)
