"""LAMB as a ``torch.optim.Optimizer``, reference-faithful, with the
gradient clip to a global norm that precedes it in the train step.

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

``clip_grad_norm_(max_norm)`` returns the global norm of the gradients
(optax ``clip_by_global_norm``'s, before clipping); the next ``step()``
first scales every ``p.grad`` in place by ``max_norm / norm`` where
``norm >= max_norm``. Both go through ``ops.lamb_update``: on the card one
multi-tensor launch for the norm and two a param group for the step,
whatever the number of parameters; on the CPU its plain version. The
moments are updated in place; ``state[p]`` keeps ``step``, ``exp_avg``
and ``exp_avg_sq``.

A parameter without a gradient (``p.grad is None``, e.g. a module the
forward never reads) takes a zero gradient, as ``jax.value_and_grad``
gives it in the JAX package: its moments decay, its step is counted, and
the weight decay still moves it. (The reference's torch Lamb skips such a
parameter.)
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..ops import lamb_update


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
        self._clip = None  # (leaves, norm, max_norm) for the next step

    def _tensors(self):
        """(params, grads, exp_avgs, exp_avg_sqs, group ranges) of every
        group, the state made on a parameter's first step."""
        params, grads, exp_avgs, exp_avg_sqs, groups = [], [], [], [], []
        for group in self.param_groups:
            start = len(params)
            for p in group["params"]:
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["exp_avg"] = torch.zeros_like(p)
                    state["exp_avg_sq"] = torch.zeros_like(p)
                params.append(p)
                grads.append(p.grad)
                exp_avgs.append(state["exp_avg"])
                exp_avg_sqs.append(state["exp_avg_sq"])
            groups.append((start, len(params)))
        return params, grads, exp_avgs, exp_avg_sqs, groups

    @torch.no_grad()
    def clip_grad_norm_(self, max_norm: float) -> torch.Tensor:
        """The global norm of every gradient, a 0-dim tensor on the
        parameters' device; the next ``step()`` clips to ``max_norm``."""
        leaves = lamb_update.Leaves(*self._tensors())
        norm = lamb_update.global_grad_norm(leaves)
        self._clip = (leaves, norm, max_norm)
        return norm

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        tensors = self._tensors()
        leaves, norm, max_norm = self._clip or (None, None, None)
        self._clip = None
        if leaves is None or not leaves.holds(*tensors[:4]):
            leaves = lamb_update.Leaves(*tensors)
        for i, group in enumerate(self.param_groups):
            steps = set()
            for p in group["params"]:
                self.state[p]["step"] += 1
                steps.add(self.state[p]["step"])
            if len(steps) > 1:
                raise ValueError(f"Lamb: the parameters of group {i} are at different steps "
                                 f"{sorted(steps)}; a group steps as one")
            lr = group["lr"]
            if self.schedule is not None and steps:
                lr = lr * self.schedule(steps.pop())
            lamb_update.lamb_update_(
                leaves, i, lr=lr, betas=group["betas"], eps=group["eps"],
                weight_decay=group["weight_decay"],
                clamp_weight_norm=group["clamp_weight_norm"], norm=norm, max_norm=max_norm)
        return loss
