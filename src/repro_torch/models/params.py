"""Parameter trees: declarative specs -> init / abstract (``meta``) tensors.

Params are plain nested dicts of tensors with the JAX package's layout
(einsum-shaped leaves such as ``wq [d, h, hd]``; per-layer leaves stacked
on a leading ``layers`` axis), so a tree carries across between the two
packages leaf for leaf (``params_from_jax``).  Random init draws from an
explicit ``torch.Generator``; it cannot reproduce the JAX package's random
bits, so parity tests carry the reference's params across instead.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class P:
    """Param leaf spec: shape + logical axes + init scale."""

    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "normal"          # normal | zeros | ones
    scale: float | None = None    # None -> 1/sqrt(fan_in)

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape/axes rank mismatch: {self}")


def _fan_in(shape: tuple[int, ...]) -> int:
    # convention: last dim is fan-out, everything before contributes fan-in
    return int(np.prod(shape[:-1])) if len(shape) > 1 else shape[0]


def _map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree: Any) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    return [tree]


def init_leaf(spec: P, gen: torch.Generator, dtype, device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    # the JAX package's scale, fan-in taken over the whole (stacked) shape
    scale = spec.scale if spec.scale is not None \
        else 1.0 / math.sqrt(max(1, _fan_in(spec.shape)))
    out = torch.empty(spec.shape, dtype=dtype, device=device)
    # draw in f32 one layer at a time: the f32 scratch stays one layer big
    parts = out if spec.axes[0] == "layers" else out[None]
    for part in parts:
        tmp = torch.empty(part.shape, dtype=torch.float32, device=device)
        tmp.normal_(generator=gen).mul_(scale)
        part.copy_(tmp)
    return out


def init_tree(specs: Any, gen: torch.Generator, dtype, device) -> Any:
    """Materialize a param tree from a spec tree."""
    return _map(lambda s: init_leaf(s, gen, dtype, device), specs)


def abstract_tree(specs: Any, dtype) -> Any:
    """``meta`` tensors of the right shapes — no allocation."""
    return _map(lambda s: torch.empty(s.shape, dtype=dtype, device="meta"),
                specs)


def count_params(specs: Any) -> int:
    return sum(int(np.prod(s.shape)) for s in _leaves(specs))


def stacked(spec_fn: Callable[[], dict], n: int,
            axis_name: str = "layers") -> dict:
    """Stack a per-layer spec dict along a leading 'layers' dim."""
    return _map(lambda s: P((n,) + s.shape, (axis_name,) + s.axes, s.init,
                            s.scale), spec_fn())


def params_from_jax(tree: Any, cfg, device, dtype=None) -> Any:
    """Carry the JAX package's param tree (numpy leaves, e.g. from
    ``jax.device_get``) across: same nesting, same leaf layouts, in
    ``dtype`` (default ``cfg.param_dtype``) on ``device``."""
    dt = getattr(torch, dtype or cfg.param_dtype)
    return _map(
        lambda a: torch.from_numpy(np.array(a, np.float32)).to(device, dt),
        tree)
