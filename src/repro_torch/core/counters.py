"""Counter state and runtime monitor parameters (the dynamic half).

``CounterState`` is the accumulated counter memory in the padded
``[n_scopes, max_slots]`` view.  ``MonitorParams`` is the runtime knob set:
which scopes are monitored (mask), which slots within a scope are live
(slot_mask) and the call-count multiplex period.

The PyTorch program runs eagerly, so every knob is read on the host when a
probe decides what to compute: the masks and periods are host tensors whose
numpy views (``MonitorParams.host``) the probe path reads without touching
the device.  Interception counts (``calls``) and sample counts (``samples``)
are host facts too — they depend only on which scopes ran and which knobs
were set — so they live on the host; only the event ``values`` are computed
from device tensors and stay on the device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .context import MonitorSpec


@dataclasses.dataclass
class CounterState:
    """Accumulated counters, shaped by the compile-time MonitorSpec.

    calls   [n_scopes]            i32 host   — times each scope was intercepted
    values  [n_scopes, max_slots] f32 device — accumulated event values
    samples [n_scopes, max_slots] i32 host   — calls on which each slot ran
    """

    calls: torch.Tensor
    values: torch.Tensor
    samples: torch.Tensor

    @staticmethod
    def zeros(spec: MonitorSpec, device="cuda") -> "CounterState":
        n, m = spec.n_scopes, spec.max_slots
        return CounterState(
            calls=torch.zeros((n,), dtype=torch.int32),
            values=torch.zeros((n, m), dtype=torch.float32, device=device),
            samples=torch.zeros((n, m), dtype=torch.int32),
        )


@dataclasses.dataclass(frozen=True)
class MonitorParams:
    """Runtime-mutable monitoring controls, held on the host.

    scope_mask [n_scopes]            f32 — 1.0: monitor, 0.0: intercept only
    slot_mask  [n_scopes, max_slots] f32 — per-slot enable within a scope
    period     [n_scopes]            i32 — multiplex period (calls per set)

    Updates are functional: each returns a new MonitorParams, so a state
    that captured the old knobs keeps them.
    """

    scope_mask: torch.Tensor
    slot_mask: torch.Tensor
    period: torch.Tensor

    @property
    def host(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(scope_mask, slot_mask, period) as numpy views — what the eager
        probe path reads; no device is involved."""
        return (self.scope_mask.numpy(), self.slot_mask.numpy(),
                self.period.numpy())

    @staticmethod
    def all_on(spec: MonitorSpec) -> "MonitorParams":
        n, m = spec.n_scopes, spec.max_slots
        period = [max(1, c.default_period) for c in spec.contexts]
        return MonitorParams(
            scope_mask=torch.ones((n,), dtype=torch.float32),
            slot_mask=torch.ones((n, m), dtype=torch.float32),
            period=torch.tensor(period, dtype=torch.int32).reshape(n),
        )

    # -- functional updates (host side, between steps) -------------------
    def enable(self, spec: MonitorSpec, scope: str, on: bool = True):
        mask = self.scope_mask.clone()
        mask[spec.scope_index(scope)] = 1.0 if on else 0.0
        return dataclasses.replace(self, scope_mask=mask)

    def set_slot(self, spec: MonitorSpec, scope: str, slot_id: str, on: bool):
        sm = self.slot_mask.clone()
        sm[spec.scope_index(scope), spec.slot_index(scope, slot_id)] = (
            1.0 if on else 0.0
        )
        return dataclasses.replace(self, slot_mask=sm)

    def set_period(self, spec: MonitorSpec, scope: str, period: int):
        p = self.period.clone()
        p[spec.scope_index(scope)] = max(1, int(period))
        return dataclasses.replace(self, period=p)
