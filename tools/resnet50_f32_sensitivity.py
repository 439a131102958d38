"""How far f32 rounding alone moves ResNet-50's training at initialisation,
in the JAX package, on the CPU.

    JAX_PLATFORMS=cpu python tools/resnet50_f32_sensitivity.py

Builds ``build_resnet50`` at 32x32 with seeded weights and batches, then
prints (1) the largest difference between the gradients of one training
forward computed eagerly and under ``jax.jit``, per leaf relative to that
leaf's largest gradient (conv biases, whose true gradient is 0 under
BatchNorm, left out), and (2) the per-step loss of three Adam steps from
the weights and from the weights moved by one ulp. Both are differences
of summation order only, so they bound how closely any second
implementation (such as the PyTorch port) can follow a free-running loss
history of this model.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from flexflow_tpu import AdamOptimizer, FFConfig, FFModel  # noqa: E402
from flexflow_tpu.models import build_resnet50  # noqa: E402


def model(batch: int, hw: int, alpha: float):
    cfg = FFConfig()
    cfg.batch_size = batch
    cfg.only_data_parallel = True
    cfg.use_bf16_compute = False
    ff = FFModel(cfg)
    build_resnet50(ff, batch, image_hw=hw)
    ff.compile(AdamOptimizer(alpha=alpha, epsilon=1e-4),
               "sparse_categorical_crossentropy", [])
    return ff


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--image", type=int, default=32)
    ap.add_argument("--alpha", type=float, default=1e-3)
    args = ap.parse_args()
    ff = model(args.batch, args.image, args.alpha)
    rng = np.random.default_rng(5)
    batches = [{"input": np.random.default_rng(10 + i).standard_normal(
                    (args.batch, 3, args.image, args.image)).astype(
                    np.float32),
                "label": rng.integers(0, 10, (args.batch, 1)).astype(
                    np.int32)} for i in range(3)]
    ex = ff.executor

    def loss_fn(p):
        outs, new_state, aux, cap = ex._forward(p, ff.state, batches[0],
                                                True, 0)
        return ex._loss_and_metrics(outs, cap, batches[0]["label"],
                                    aux)[0], new_state

    g_eager = jax.device_get(jax.grad(loss_fn, has_aux=True)(ff.params)[0])
    g_jit = jax.device_get(jax.jit(jax.grad(loss_fn, has_aux=True))(
        ff.params)[0])
    worst = max(
        float(np.abs(np.asarray(g_eager[ln][wn]) - np.asarray(g)).max()
              / max(float(np.abs(np.asarray(g)).max()), 1e-30))
        for ln, ws in g_jit.items() for wn, g in ws.items()
        if not (wn == "bias" and ln.startswith("op_conv2d")))
    print(f"eager vs jit gradients: max |diff| / max |grad| over leaves = "
          f"{worst:.4f}")

    p0, s0, o0 = (jax.device_get(t) for t in (ff.params, ff.state,
                                              ff.opt_state))

    def history(params):
        ff.params, ff.state, ff.opt_state = params, s0, o0
        ff._step = 0
        step = ex.make_train_step()
        return [float(np.asarray(ff._run_train_step(step, b)["loss"]))
                for b in batches]

    a = history(p0)
    b = history(jax.tree_util.tree_map(
        lambda w: jnp.asarray(np.nextafter(np.asarray(w), np.inf)
                              .astype(np.float32)), p0))
    print(f"Adam {args.alpha}, batch {args.batch}, {args.image}x"
          f"{args.image}: loss history {a}; from weights one ulp up {b}; "
          f"|diff| {[abs(x - y) for x, y in zip(a, b)]}")


if __name__ == "__main__":
    main()
