"""LAMB as a ``torch.optim.Optimizer``, reference-faithful.

Counterpart of ``semantic_abstraction_tpu/models/lamb.py`` (the reference's
vendored Lamb, arm/optim/lamb.py:26-127), not of the LAMB paper's variant:

- no debiasing of the Adam moments;
- weight_norm = ||p||_2 clamped to [0, clamp_weight_norm];
- adam_step = m / (sqrt(v) + eps) + weight_decay * p (the decay sits
  inside the trust-ratio numerator, it is not decoupled);
- trust_ratio = weight_norm / adam_norm, and 1 when either norm is 0;
  p -= lr * trust_ratio * adam_step.

The learning rate of an update is ``lr * schedule(count)`` with ``count``
already incremented, so the first update uses ``schedule(1)`` (as the
optax form does; a stock ``LambdaLR`` would use ``schedule(0)``). Every
quantity stays on the parameters' device: a step reads nothing back.

A parameter without a gradient (``p.grad is None``, e.g. a module the
forward never reads) takes a zero gradient, as ``jax.value_and_grad``
gives it in the JAX package: its moments decay, its step is counted, and
the weight decay still moves it. (The reference's torch Lamb skips such a
parameter.)
"""
from __future__ import annotations

from typing import Callable, Optional

import torch


class Lamb(torch.optim.Optimizer):
    def __init__(self, params, lr: float = 1e-3,
                 schedule: Optional[Callable[[int], float]] = None,
                 betas=(0.9, 0.999), eps: float = 1e-6,
                 weight_decay: float = 0.0,
                 clamp_weight_norm: float = 10.0):
        defaults = dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay,
                        clamp_weight_norm=clamp_weight_norm)
        super().__init__(params, defaults)
        self.schedule = schedule

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["exp_avg"] = torch.zeros_like(p)
                    state["exp_avg_sq"] = torch.zeros_like(p)
                mu = b1 * state["exp_avg"] + (1 - b1) * g
                nu = b2 * state["exp_avg_sq"] + (1 - b2) * g * g
                state["exp_avg"], state["exp_avg_sq"] = mu, nu
                state["step"] += 1
                lr = group["lr"]
                if self.schedule is not None:
                    lr = lr * self.schedule(state["step"])
                adam_step = mu / (torch.sqrt(nu) + group["eps"])
                if group["weight_decay"] != 0.0:
                    adam_step = adam_step + group["weight_decay"] * p
                weight_norm = torch.linalg.vector_norm(p).clamp(
                    0.0, group["clamp_weight_norm"])
                adam_norm = torch.linalg.vector_norm(adam_step)
                trust = torch.where(
                    (weight_norm == 0.0) | (adam_norm == 0.0),
                    torch.ones_like(weight_norm),
                    weight_norm / adam_norm.clamp_min(1e-30))
                p.add_((-lr * trust) * adam_step)
        return loss
