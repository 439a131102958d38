"""Which change moves the port's Mixtral training history, on one GPU.

    python3 tools/torch_mixtral_train_ab.py [--steps 4]

Builds one layer at Mixtral-8x7B width (seeded random weights) through
the port's FFModel at 2 x 1024, as chip_smoke.py's mixtral phase does,
and trains it from the same weights on the same batch, one step per
epoch, through each of: flash attention + the fused Adam, flash + the
unfused Adam, plain attention + the unfused Adam, plain + fused; at Adam
epsilon 1e-8 and 1e-4. Prints each loss history and each one's largest
distance from plain attention + the unfused Adam: the fused update
against the unfused one, and the flash path against the plain one, at
each epsilon. Imports only the port, never JAX.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from flexflow_tpu_torch import AdamOptimizer  # noqa: E402

IMPLS = ("attention:flash,opt_update:fused", "attention:flash",
         "attention:xla", "attention:xla,opt_update:fused")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=4)
    args = ap.parse_args()
    _, smi = cs.phase_device()
    seq, b = cs.LLAMA_SEQ, 2
    ids = np.random.default_rng(43).integers(
        0, 32000, (b, seq + 1)).astype(np.int32)
    x, y = ids[:, :seq], ids[:, 1:]
    first, hist = None, {}
    for eps in (1e-8, 1e-4):
        for impl in IMPLS:
            m, _ = cs.mixtral_model(impl, 1, b, seq, optimizer=AdamOptimizer(
                1e-4, epsilon=eps))
            if first is None:
                first = {ln: {wn: t.clone() for wn, t in ws.items()}
                         for ln, ws in m.params.items()}
            else:
                m.params = {ln: {wn: t.clone() for wn, t in ws.items()}
                            for ln, ws in first.items()}
            hist[(eps, impl)] = [r["loss"] for r in m.fit(
                [x], y, epochs=args.steps, verbose=False)]
            print(f"epsilon {eps:g} {impl}: {hist[(eps, impl)]}")
            del m
            cs.free_cuda()
    for eps in (1e-8, 1e-4):
        ref = np.array(hist[(eps, "attention:xla")])
        for impl in IMPLS:
            d = np.abs(np.array(hist[(eps, impl)]) - ref)
            print(f"epsilon {eps:g} {impl} vs attention:xla: max|diff| "
                  f"{d.max():.3e}, per step {d.tolist()}; {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
