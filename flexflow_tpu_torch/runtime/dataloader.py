"""Data loading: host numpy datasets -> device batches.

The port of ``flexflow_tpu/runtime/dataloader.py``'s ``SingleDataLoader``
on one device: the dataset stays in host memory; each ``next_batch``
gathers the batch's rows in numpy and copies them to the device (from
pinned memory, without blocking, on the card), keeping up to ``prefetch``
following batches' copies in flight. The shuffle order comes from the same
numpy generator, seeded the same way, so a shuffled ``fit`` sees the same
batches as the JAX package's; ``state_dict``/``load_state_dict`` resume a
loader exactly, every later epoch's shuffle included.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, Iterator, Optional

import numpy as np
import torch


class SingleDataLoader:
    """One loader per (input, label) array set, full-dataset resident."""

    def __init__(self, arrays: Dict[str, np.ndarray], batch_size: int,
                 device=None, shuffle: bool = False, seed: int = 0,
                 drop_remainder: bool = True, prefetch: int = 2):
        sizes = {k: v.shape[0] for k, v in arrays.items()}
        if len(set(sizes.values())) != 1:
            raise ValueError(f"ragged dataset: {sizes}")
        self.arrays = arrays
        self.num_samples = next(iter(sizes.values()))
        self.batch_size = batch_size
        self.device = torch.device(device or "cpu")
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.drop_remainder = drop_remainder
        self.idx = 0
        # which epoch this loader position belongs to, kept by the
        # training loop that resumes it; plain fit() leaves it at 0
        self.epoch = 0
        self._order = np.arange(self.num_samples)
        # rng state as of the start of the current epoch (BEFORE its
        # shuffle) + whether that shuffle was applied: together they
        # re-derive `_order`, so state_dict stays O(1)
        self._epoch_rng_state = self.rng.bit_generator.state
        self._shuffled = False
        # device batches for indices idx..idx+len-1, copied ahead of use;
        # prefetching reads only `_order`, never the rng
        self.prefetch = max(0, int(prefetch))
        self._prefetched: deque = deque()

    @property
    def num_batches(self) -> int:
        if self.drop_remainder:
            return self.num_samples // self.batch_size
        return -(-self.num_samples // self.batch_size)

    def reset(self):
        self.idx = 0
        self._prefetched.clear()
        # a fresh permutation of arange: the order is a pure function of
        # (_epoch_rng_state, shuffle)
        self._epoch_rng_state = self.rng.bit_generator.state
        self._order = np.arange(self.num_samples)
        self._shuffled = False
        if self.shuffle:
            self.rng.shuffle(self._order)
            self._shuffled = True

    def state_dict(self):
        """JSON-serializable loader position: rng state (as of epoch
        start), epoch and batch position, never the permutation."""
        return {
            "idx": int(self.idx),
            "epoch": int(self.epoch),
            "num_samples": int(self.num_samples),
            "batch_size": int(self.batch_size),
            "rng_state": self._epoch_rng_state,
            "shuffled": bool(self._shuffled),
        }

    def load_state_dict(self, sd) -> None:
        if sd.get("num_samples", self.num_samples) != self.num_samples:
            raise ValueError(
                f"loader state for {sd.get('num_samples')} samples "
                f"restored into a {self.num_samples}-sample dataset")
        # idx counts BATCHES: another batch size would reposition the
        # sample stream
        if sd.get("batch_size", self.batch_size) != self.batch_size:
            raise ValueError(
                f"loader state saved with batch_size "
                f"{sd.get('batch_size')} restored into a loader with "
                f"batch_size {self.batch_size}")
        self.idx = int(sd["idx"])
        self.epoch = int(sd.get("epoch", 0))
        self.rng.bit_generator.state = sd["rng_state"]
        self._epoch_rng_state = sd["rng_state"]
        self._order = np.arange(self.num_samples)
        self._shuffled = False
        if sd.get("shuffled"):
            self.rng.shuffle(self._order)  # rng lands post-shuffle
            self._shuffled = True
        self._prefetched.clear()

    def _to_device(self, batch: Dict[str, np.ndarray]):
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[k] = t
        return out

    def _host_batch(self, i: int) -> Optional[Dict[str, np.ndarray]]:
        lo = i * self.batch_size
        hi = lo + self.batch_size
        if hi > self.num_samples:
            if self.drop_remainder or lo >= self.num_samples:
                return None
            hi = self.num_samples
        sel = self._order[lo:hi]
        return {k: v[sel] for k, v in self.arrays.items()}

    def next_batch(self):
        """The next batch as a dict of device tensors, or None at the end
        of the epoch."""
        if self._prefetched:
            batch = self._prefetched.popleft()
        else:
            hb = self._host_batch(self.idx)
            if hb is None:
                return None
            batch = self._to_device(hb)
        self.idx += 1
        while len(self._prefetched) < self.prefetch:
            nb = self._host_batch(self.idx + len(self._prefetched))
            if nb is None:
                break
            self._prefetched.append(self._to_device(nb))
        return batch

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        self.reset()
        while True:
            b = self.next_batch()
            if b is None:
                return
            yield b
