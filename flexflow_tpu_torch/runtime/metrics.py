"""Metrics: per-batch metrics on the device and their host accumulator.

The port of ``flexflow_tpu/runtime/metrics.py``: ``compute_batch_metrics``
runs inside the train/eval step on device tensors, and ``PerfMetrics``
folds the fetched values on the host.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import torch

from ..ffconst import LossType, MetricsType

# batch-metric keys that are COUNTS over samples (vs per-sample means):
# gradient accumulation SUMS these across micro-batches, never averages
COUNT_KEYS = frozenset({"accuracy_correct"})

# keys that are sqrt-of-a-mean: composing across micro-batches averages
# the SQUARES and takes one sqrt at the end
RMS_KEYS = frozenset({"rmse_loss"})


@dataclasses.dataclass
class PerfMetrics:
    """Host-side accumulator (reference ``PerfMetrics`` struct parity)."""
    train_all: int = 0
    train_correct: int = 0
    cce_loss: float = 0.0
    sparse_cce_loss: float = 0.0
    mse_loss: float = 0.0
    rmse_loss: float = 0.0
    mae_loss: float = 0.0
    loss: float = 0.0

    _KEYS = ("cce_loss", "sparse_cce_loss", "mse_loss", "rmse_loss",
             "mae_loss", "loss")

    def update(self, batch_metrics: Dict[str, float], batch_size: int):
        self.train_all += batch_size
        if "accuracy_correct" in batch_metrics:
            self.train_correct += int(batch_metrics["accuracy_correct"])
        for k in self._KEYS:
            if k in batch_metrics:
                setattr(self, k, getattr(self, k)
                        + float(batch_metrics[k]) * batch_size)

    def report(self) -> Dict[str, float]:
        n = max(self.train_all, 1)
        out = {}
        if self.train_correct or self.train_all:
            out["accuracy"] = self.train_correct / n
        for k in self._KEYS:
            v = getattr(self, k)
            if v:
                out[k] = v / n
        return out


def compute_batch_metrics(metrics: Sequence[MetricsType], pred, label,
                          loss_type: LossType) -> Dict[str, torch.Tensor]:
    """Per-batch metrics as 0-dim f32 device tensors (reference
    ``Metrics::compute_task``)."""
    out: Dict[str, torch.Tensor] = {}
    pf = pred.float()
    sparse = LossType(loss_type) == \
        LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY
    for m in metrics:
        m = MetricsType(m)
        if m == MetricsType.METRICS_ACCURACY:
            yhat = torch.argmax(pf, dim=-1)
            if sparse:
                y = label.reshape(yhat.shape + (-1,))[..., 0].long()
            else:
                y = torch.argmax(label, dim=-1)
            out["accuracy_correct"] = (yhat == y).sum().float()
        elif m == MetricsType.METRICS_CATEGORICAL_CROSSENTROPY:
            logp = torch.log(torch.clamp(pf, 1e-10, 1.0))
            batch = pf.numel() // pf.shape[-1]
            out["cce_loss"] = -(label.float() * logp).sum() / batch
        elif m == MetricsType.METRICS_SPARSE_CATEGORICAL_CROSSENTROPY:
            y = label.reshape(pf.shape[:-1] + (-1,))[..., 0].long()
            logp = torch.log(torch.clamp(pf, 1e-10, 1.0))
            nll = -torch.gather(logp, -1, y[..., None])
            out["sparse_cce_loss"] = nll.mean()
        elif m == MetricsType.METRICS_MEAN_SQUARED_ERROR:
            d = pf - label.float()
            out["mse_loss"] = (d * d).sum(dim=-1).mean()
        elif m == MetricsType.METRICS_ROOT_MEAN_SQUARED_ERROR:
            d = pf - label.float()
            out["rmse_loss"] = torch.sqrt((d * d).sum(dim=-1).mean())
        elif m == MetricsType.METRICS_MEAN_ABSOLUTE_ERROR:
            d = torch.abs(pf - label.float())
            out["mae_loss"] = d.sum(dim=-1).mean()
    return out
