"""FFModel.fit callbacks (signature: ``on_epoch_end(epoch, logs, model)``).

The port of ``flexflow_tpu/runtime/callbacks.py``, on ``fit``'s epoch
hook. ``PeriodicCheckpoint`` + ``FFModel.restore_checkpoint`` give
preemption-safe training.
"""
from __future__ import annotations


class PeriodicCheckpoint:
    """Save params/optimizer/state every N epochs, with retention (align
    ``every_epochs`` with the total epoch count to capture the final
    epoch). Resume with ``FFModel.restore_checkpoint(directory)``; the
    files restore into either package's model of the same graph.
    """

    def __init__(self, directory: str, every_epochs: int = 1,
                 max_to_keep: int = 3):
        self.directory = directory
        self.every = max(1, every_epochs)
        self.max_to_keep = max_to_keep
        self.saved_steps = []

    def on_epoch_end(self, epoch: int, logs=None, model=None):
        if model is None or (epoch + 1) % self.every:
            return
        model.save_checkpoint(self.directory,
                              max_to_keep=self.max_to_keep)
        self.saved_steps.append(model._step)
