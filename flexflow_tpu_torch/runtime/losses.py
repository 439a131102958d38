"""Loss functions.

The port of ``flexflow_tpu/runtime/losses.py``: mean-reduced scalar
losses differentiated by autograd. When the graph ends in Softmax and the
loss is a cross-entropy, the executor passes the logits here and the
stable log-softmax form is used (its gradient is the reference's
(probs - labels) / batch).
"""
from __future__ import annotations

import torch

from ..ffconst import LossType


def compute_loss(loss_type: LossType, pred, label, *, logits: bool = False):
    """Mean-reduced scalar loss. ``pred`` is the final op's output (or the
    pre-softmax logits when ``logits=True`` and the loss is a
    cross-entropy)."""
    loss_type = LossType(loss_type)
    pred = pred.float()

    if loss_type == LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY:
        label = label.reshape(pred.shape[:-1] + (-1,))[..., 0].long()
        if logits:
            logp = torch.log_softmax(pred, dim=-1)
        else:
            logp = torch.log(torch.clamp(pred, 1e-10, 1.0))
        nll = -torch.gather(logp, -1, label[..., None])[..., 0]
        return nll.mean()

    if loss_type == LossType.LOSS_CATEGORICAL_CROSSENTROPY:
        label = label.float()
        if logits:
            logp = torch.log_softmax(pred, dim=-1)
        else:
            logp = torch.log(torch.clamp(pred, 1e-10, 1.0))
        # mean over batch rows, sum over classes (reference scale 1/batch)
        batch = pred.numel() // pred.shape[-1]
        return -(label * logp).sum() / batch

    if loss_type == LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE:
        d = pred - label.float()
        return (d * d).mean()

    if loss_type == LossType.LOSS_MEAN_SQUARED_ERROR_SUM_REDUCE:
        d = pred - label.float()
        return 0.5 * (d * d).sum() / d.shape[0]

    if loss_type == LossType.LOSS_IDENTITY:
        return pred.mean()

    raise ValueError(loss_type)


_CE_LOSSES = (LossType.LOSS_CATEGORICAL_CROSSENTROPY,
              LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)


def wants_logits(loss_type: LossType) -> bool:
    return LossType(loss_type) in _CE_LOSSES
