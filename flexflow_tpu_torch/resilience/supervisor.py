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
    raises :class:`NotImplementedError`, because the elastic re-plan
    needs the strategy search (ROADMAP queue 1, items 4-5) and a
    restart without re-planning would resume on a lost device.

The multi-process ``WorldSupervisor`` and ``run_world_member`` come with
the parallel lowering (ROADMAP queue 1, item 4). Everything reports into
``obs``: restart/rollback counters, a time-since-last-checkpoint gauge,
save/restore spans, and the always-on :mod:`.status` block.
"""
from __future__ import annotations

import logging
import random
import time
from typing import Dict, List, Optional

from ..obs import events as obs_events
from ..obs.metrics_registry import REGISTRY
from ..runtime.metrics_buffer import MetricsBuffer, NonFiniteMetrics
from . import status
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
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception as e:  # noqa: BLE001 — that's the job
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
        strategy for the shrunken mesh and reshards onto it, and neither
        the search nor the reshard is ported yet."""
        if not self.elastic:
            raise err
        raise NotImplementedError(
            f"elastic recovery from a device loss ({err}) re-plans the "
            f"strategy for the surviving devices "
            f"(elastic.replan_on_device_loss), which needs the parallel "
            f"lowering and the strategy search (ROADMAP queue 1, items "
            f"4-5); pass elastic=False to let the DeviceLoss propagate"
        ) from err

    # ------------------------------------------------------------------
    def _update_ckpt_age_gauge(self) -> None:
        if self._last_save_t is not None:
            REGISTRY.gauge(
                "ff_time_since_last_checkpoint_seconds",
                "Age of the newest completed checkpoint"
            ).set(time.monotonic() - self._last_save_t)


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
