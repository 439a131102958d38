"""Optimizers: the hyper-parameters of SGD (+momentum/nesterov) and Adam.

The port of ``flexflow_tpu/runtime/optimizers.py`` as far as the serving
slice needs it: ``FFModel.compile`` takes an optimizer, and these classes
hold the same hyper-parameters under the same names. The update rules
(and the fused Adam kernel) come with the training slice, so ``update``
raises until then.
"""
from __future__ import annotations


class Optimizer:
    def init_state(self, params):
        return {}

    def update(self, params, grads, state, step):
        raise NotImplementedError(
            "optimizer updates come with the training slice of the port")

    def next(self):
        pass


class SGDOptimizer(Optimizer):
    """grad += wd*w;  v = momentum*v + grad;  (nesterov: grad +=
    momentum*v);  w -= lr * (grad or v)."""

    def __init__(self, lr: float = 0.01, momentum: float = 0.0,
                 nesterov: bool = False, weight_decay: float = 0.0):
        self.lr = lr
        self.momentum = momentum
        self.nesterov = nesterov
        self.weight_decay = weight_decay


class AdamOptimizer(Optimizer):
    """Bias-corrected alpha_t, weight decay folded into the gradient."""

    def __init__(self, alpha: float = 0.001, beta1: float = 0.9,
                 beta2: float = 0.999, weight_decay: float = 0.0,
                 epsilon: float = 1e-8):
        self.alpha = alpha
        self.beta1 = beta1
        self.beta2 = beta2
        self.weight_decay = weight_decay
        self.epsilon = epsilon

    @property
    def lr(self):
        return self.alpha
