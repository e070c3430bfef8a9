"""Parameter containers of the nets.

The forward passes are plain functions over these modules (as in the JAX
package, where they are functions over a pytree); the modules only hold
f32 parameters under the names of the reference's state dict, so that a
reference checkpoint loads key for key.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Params(nn.Module):
    """A named set of parameters, e.g. ``Params(weight=(o, i), bias=(o,))``."""

    def __init__(self, **shapes):
        super().__init__()
        for name, shape in shapes.items():
            self.register_parameter(name, nn.Parameter(torch.empty(shape)))


def linear_params(d_in: int, d_out: int) -> Params:
    """A Linear layer's parameters in torch layout: weight (out, in), bias."""
    return Params(weight=(d_out, d_in), bias=(d_out,))


def init_linear_(p: Params, generator: torch.Generator) -> None:
    """torch Linear's default init, U(-1/sqrt(in), 1/sqrt(in)) for both."""
    bound = p.weight.shape[1] ** -0.5
    with torch.no_grad():
        p.weight.uniform_(-bound, bound, generator=generator)
        p.bias.uniform_(-bound, bound, generator=generator)


def linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    """``x @ w.T + b`` in x's dtype (the weights are cast to it)."""
    return F.linear(x, p.weight.to(x.dtype), p.bias.to(x.dtype))
