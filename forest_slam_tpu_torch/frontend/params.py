"""Float32 master parameters in the Flax layout, and their working copies.

The Flax modules keep float32 parameters and cast them to bf16 where they
use them. The port does the same: :class:`Dense` and :class:`LayerNorm` hold
a Flax ``Dense``'s ``kernel`` (in, out) and ``bias`` and a ``LayerNorm``'s
``scale`` and ``bias`` as float32 parameters, under the Flax names, so a
module's ``named_parameters()`` maps one to one onto the Flax subtree.

:func:`cached_copy` gives a module's low-precision working copies of its
masters. Under autograd, with a master that requires grad, it builds them
afresh on every call so the graph reaches the masters; otherwise it builds
them once per parameter version (an in-place update such as an optimizer
step, or a move to another device, makes a new one) and reuses them, so
inference pays no cast per forward.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn


class Dense(nn.Module):
    """A Flax ``Dense``'s parameters: ``kernel`` (in, out), ``bias`` (out,)."""

    def __init__(self, n_in: int, n_out: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(n_in, n_out))
        self.bias = nn.Parameter(torch.zeros(n_out))


class LayerNorm(nn.Module):
    """A Flax ``LayerNorm``'s parameters: ``scale`` (ones), ``bias`` (zeros)."""

    def __init__(self, n: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))


def cached_copy(module: nn.Module, build: Callable[[], object]):
    """``build()`` (working copies of ``module``'s parameters): fresh under
    autograd when a parameter requires grad, else cached on the module and
    rebuilt only when a parameter's device, storage or version counter
    changed."""
    params = list(module.parameters())
    if torch.is_grad_enabled() and any(p.requires_grad for p in params):
        return build()
    key = tuple((p.device, p.data_ptr(), p._version) for p in params)
    if getattr(module, "_copy_key", None) != key:
        with torch.no_grad():
            module._copy_value = _detached(build())
        module._copy_key = key
    return module._copy_value


def _detached(x):
    """``x`` with every tensor detached (a copy that is a view of a master
    would otherwise carry its requires_grad)."""
    if isinstance(x, torch.Tensor):
        return x.detach()
    if isinstance(x, dict):
        return {k: _detached(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_detached(v) for v in x)
    return x
