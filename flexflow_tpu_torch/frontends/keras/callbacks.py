"""Keras callbacks (reference ``python/flexflow/keras/callbacks.py``):
Callback base, LearningRateScheduler, VerifyMetrics, EarlyStopping. The
port of ``flexflow_tpu/frontends/keras/callbacks.py``."""
from __future__ import annotations

from typing import Optional


class Callback:
    def set_model(self, model):
        self.model = model

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass


class LearningRateScheduler(Callback):
    """Adjusts the optimizer lr per epoch (reference parity)."""

    def __init__(self, schedule):
        self.schedule = schedule

    def on_epoch_end(self, epoch, logs=None):
        opt = self.model.ffmodel.optimizer
        new_lr = self.schedule(epoch + 1)
        # Adam's rate is ``alpha`` (its ``lr`` is a read-only view of it);
        # SGD's is ``lr``. Every step reads the rate from the optimizer
        # (Adam's alpha_t, fused or not, is computed from it per step);
        # the cached step is dropped all the same, as the JAX package
        # drops its jitted one
        if hasattr(opt, "alpha"):
            opt.alpha = new_lr
        else:
            opt.lr = new_lr
        self.model.ffmodel.executor._train_step = None


class VerifyMetrics(Callback):
    """Asserts the final metric meets a threshold — the reference CI's
    accuracy assertion (``examples/python/keras/accuracy.py``)."""

    def __init__(self, metric: str = "accuracy", threshold: float = 0.9):
        self.metric = metric
        self.threshold = threshold
        self.last = None

    def on_epoch_end(self, epoch, logs=None):
        if logs and self.metric in logs:
            self.last = logs[self.metric]

    def on_train_end(self, logs=None):
        if self.last is None:
            raise ValueError(f"metric {self.metric} never reported")
        if self.last < self.threshold:
            raise ValueError(f"{self.metric}={self.last} < threshold "
                             f"{self.threshold}")


class EarlyStopping(Callback):
    def __init__(self, monitor: str = "loss", patience: int = 3,
                 min_delta: float = 0.0):
        self.monitor = monitor
        self.patience = patience
        self.min_delta = min_delta
        self.best: Optional[float] = None
        self.wait = 0
        self.stopped_epoch: Optional[int] = None

    def on_epoch_end(self, epoch, logs=None):
        cur = (logs or {}).get(self.monitor)
        if cur is None:
            return
        if self.best is None or cur < self.best - self.min_delta:
            self.best = cur
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.stopped_epoch = epoch
