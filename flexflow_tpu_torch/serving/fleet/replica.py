"""Replica worker: one serving process behind the fleet router.

The port of ``flexflow_tpu/serving/fleet/replica.py``. Launched by
:class:`.router.FleetRouter.spawn` (or by hand)::

    python -m flexflow_tpu_torch.serving.fleet.replica --port 8101 \
        --model gpt2-tiny [--device cpu]

Builds a model repository on ``--device`` ("cuda" by default; with no
CUDA device and no ``--device cpu`` it raises), starts the threaded HTTP
front (``serve_http(block=False)``), and then watches **stdin** for the
drain protocol: a ``drain`` line (or EOF, the router closing the pipe)
triggers the graceful-drain path (readiness 503, finish in-flight work,
close schedulers) and exits 0. Hard faults injected via
``FF_FAULT_PLAN=infer_crash@N`` kill the process mid-request with no
drain, the failure mode the router's failover must absorb.

Two model kinds:

* ``synthetic``: a fixed-latency session (``--synthetic-ms`` per device
  step), scheduler/router policy measurement decoupled from the model;
* ``gpt2-tiny``: a real tiny GPT-2 (vocab 64, hidden 32, 2 layers, 4
  heads) compiled on the device.

The JAX replica's ``--compile-cache`` (XLA's persistent compile cache)
has no counterpart here and is refused as an unknown argument: the
port's compiled artefacts are its kernels, built once into
``build/kernels/``.
"""
from __future__ import annotations

import argparse
import sys
import threading
import time

import numpy as np


def _build_repo(args):
    from ..session import InferenceSession, ModelRepository

    repo = ModelRepository()
    if args.model == "synthetic":
        step_s = args.synthetic_ms / 1e3

        class SyntheticSession:
            """Fixed-latency device-step stand-in: one batched step
            costs ``--synthetic-ms`` regardless of rows (up to the
            scheduler's max_batch)."""
            input_names = ["x"]

            def infer(self, inputs):
                time.sleep(step_s)
                return np.zeros((int(inputs["x"].shape[0]), 1),
                                np.float32)

            def clone(self):
                return self

        repo.register(args.model_name, SyntheticSession(),
                      instances=args.instances)
        return repo
    from ... import FFConfig, FFModel, SGDOptimizer
    from ...models.nlp import GPTConfig, build_gpt2
    cfg = FFConfig()
    cfg.batch_size = args.bucket
    cfg.only_data_parallel = True
    cfg.device = args.device
    g = GPTConfig(vocab_size=64, hidden_size=32, num_layers=2,
                  num_heads=4, max_position=args.seq_len, dropout=0.0)
    ff = FFModel(cfg)
    ff._model_name = args.model_name  # before compile: labels the
    # ff_model_compiles_total increment
    out = build_gpt2(ff, args.bucket, args.seq_len, g)
    ff.compile(SGDOptimizer(0.0), "identity", [], output_tensor=out)
    sess = InferenceSession(ff, batch_buckets=(args.bucket,),
                            decode_segment=args.decode_segment)
    repo.register(args.model_name, sess, instances=args.instances)
    return repo


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--name", default=None,
                   help="replica display name (the router substitutes "
                        "{name} in its spawn template); logging only")
    p.add_argument("--model", default="gpt2-tiny",
                   choices=["gpt2-tiny", "synthetic"])
    p.add_argument("--model-name", default=None,
                   help="served model name (default: --model)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the model runs (default cuda; no "
                        "fallback to the CPU)")
    p.add_argument("--instances", type=int, default=1)
    p.add_argument("--synthetic-ms", type=float, default=40.0)
    p.add_argument("--bucket", type=int, default=4)
    p.add_argument("--seq-len", type=int, default=32)
    p.add_argument("--decode-segment", type=int, default=4)
    p.add_argument("--max-batch", type=int, default=4)
    p.add_argument("--max-delay-ms", type=float, default=2.0)
    p.add_argument("--max-queue", type=int, default=256)
    p.add_argument("--default-deadline-ms", type=float, default=None)
    p.add_argument("--breaker-threshold", type=int, default=5)
    p.add_argument("--breaker-cooldown-s", type=float, default=5.0)
    p.add_argument("--admission-estimate", default="completion",
                   choices=["wait", "completion"],
                   help="deadline-shed predictor (default "
                        "'completion': replicas behind a deadline-"
                        "routing front shed on predicted request "
                        "latency, not just queue wait)")
    p.add_argument("--drain-deadline-s", type=float, default=10.0)
    args = p.parse_args(argv)
    if args.model_name is None:
        args.model_name = args.model
    from ...model import resolve_device
    resolve_device(args.device)   # no CUDA and no --device cpu: raise

    from ..http_server import serve_http
    repo = _build_repo(args)
    handle = serve_http(repo, host=args.host, port=args.port,
                        block=False, max_batch=args.max_batch,
                        max_delay_ms=args.max_delay_ms,
                        max_queue=args.max_queue,
                        default_deadline_ms=args.default_deadline_ms,
                        breaker_threshold=args.breaker_threshold,
                        breaker_cooldown_s=args.breaker_cooldown_s,
                        admission_estimate=args.admission_estimate)
    print(f"READY name={args.name or '-'} port={args.port} "
          f"model={args.model_name} device={args.device}", flush=True)

    done = threading.Event()

    def _stdin_watch():
        # the router's drain protocol: a "drain" line or EOF (the
        # router closing our stdin / dying) -> graceful drain + exit
        try:
            for line in sys.stdin:
                if line.strip() in ("drain", "stop", "quit"):
                    break
        except (ValueError, OSError):
            pass
        done.set()

    t = threading.Thread(target=_stdin_watch, name="ff-replica-stdin",
                         daemon=True)
    t.start()
    while not done.wait(timeout=0.5):
        pass
    handle.drain(deadline_s=args.drain_deadline_s)
    handle.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
