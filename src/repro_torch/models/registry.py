"""Model registry: the uniform ``Arch`` facade the serving code uses.

The dense family (``models/transformer.py``) is the one this slice ports;
the other families of the JAX package's registry come with their slices.
"""
from __future__ import annotations

import dataclasses

import torch

from . import params as params_lib
from . import transformer
from .spec import ModelConfig

FAMILY_MODULES = {"dense": transformer}


@dataclasses.dataclass(frozen=True)
class Arch:
    cfg: ModelConfig

    @property
    def module(self):
        if self.cfg.family not in FAMILY_MODULES:
            raise NotImplementedError(
                f"family {self.cfg.family!r} is not ported yet; have "
                f"{sorted(FAMILY_MODULES)}")
        return FAMILY_MODULES[self.cfg.family]

    def param_specs(self):
        return self.module.specs(self.cfg)

    def init(self, gen: torch.Generator, device="cuda"):
        """Random params drawn from ``gen`` (a generator on ``device``)."""
        return params_lib.init_tree(
            self.param_specs(), gen, getattr(torch, self.cfg.param_dtype),
            device)

    def abstract_params(self):
        """The param tree as ``meta`` tensors (shapes only)."""
        return params_lib.abstract_tree(
            self.param_specs(), getattr(torch, self.cfg.param_dtype))

    def n_params(self) -> int:
        return params_lib.count_params(self.param_specs())

    def prefill(self, params, batch, cache_len: int):
        return self.module.prefill(self.cfg, params, batch["tokens"],
                                   cache_len)

    def decode_step(self, params, cache, tokens):
        return self.module.decode_step(self.cfg, params, cache, tokens)
