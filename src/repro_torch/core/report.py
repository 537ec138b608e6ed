"""Reporting: turn raw CounterState into per-scope counter reports.

Reproduces the paper's reporting semantics: results are the function (scope)
name, the events and their counter values (§3.3), written to stdout on
termination by default, with the multiplexed→exhaustive estimate used in the
case study (Fig. 4): an event monitored on ``samples`` of ``calls`` calls is
scaled to an exhaustive estimate by ``calls/samples`` if EXTENSIVE (counts)
or reported as the per-call mean ``value/samples`` if INTENSIVE.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import events as events_lib
from .context import MonitorSpec


@dataclasses.dataclass
class SlotReport:
    slot_id: str
    kind: str
    raw: float          # accumulated value
    samples: int        # calls on which the slot was computed
    calls: int          # total interceptions of the scope
    estimate: float     # exhaustive estimate (extensive) or per-call mean

    @property
    def coverage(self) -> float:
        return self.samples / self.calls if self.calls else 0.0


@dataclasses.dataclass
class ScopeReport:
    scope: str
    calls: int
    slots: list[SlotReport]


def _host(x) -> np.ndarray:
    """A counter lane as a host numpy array (waits for the device)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def build(spec: MonitorSpec, state) -> list[ScopeReport]:
    """Per-scope reports from any counter carrier.

    Accepts the legacy padded ``CounterState`` ([n_scopes, max_slots]
    values) or any compact dense-layout carrier — ``plan.CompactDelta``,
    ``MonitorState`` — whose flat
    ``values``/``samples`` lanes are read DIRECTLY through the spec's
    ``SlotLayout``: no expansion to the padded block anywhere on the
    reporting path.
    """
    calls, values, samples = (_host(state.calls), _host(state.values),
                              _host(state.samples))
    offsets = None
    if values.ndim == 1:  # compact dense layout
        from . import plan as plan_lib

        offsets = plan_lib.spec_layout(spec).offsets
    out: list[ScopeReport] = []
    for si, ctx in enumerate(spec.contexts):
        srs: list[SlotReport] = []
        for i, slot in enumerate(ctx.slots):
            kind = events_lib.kind_of(slot)
            if offsets is not None:
                raw = float(values[offsets[si] + i])
                smp = int(samples[offsets[si] + i])
            else:
                raw = float(values[si, i])
                smp = int(samples[si, i])
            c = int(calls[si])
            if smp == 0:
                est = float("nan")
            elif kind == events_lib.EXTENSIVE:
                est = raw * (c / smp)
            else:
                est = raw / smp
            srs.append(
                SlotReport(
                    slot_id=slot.slot_id, kind=kind, raw=raw,
                    samples=smp, calls=c, estimate=est,
                )
            )
        out.append(ScopeReport(scope=ctx.scope, calls=int(calls[si]), slots=srs))
    return out


def format_text(reports: list[ScopeReport], title: str = "ScALPEL report") -> str:
    lines = [f"=== {title} ==="]
    for r in reports:
        lines.append(f"[{r.scope}] calls={r.calls}")
        for s in r.slots:
            lines.append(
                f"  {s.slot_id:<32s} {s.kind:<9s} est={s.estimate:.6e} "
                f"raw={s.raw:.6e} samples={s.samples} "
                f"coverage={s.coverage:.2%}"
            )
    return "\n".join(lines)


def estimates(spec: MonitorSpec, state) -> dict[str, dict[str, float]]:
    """{scope: {slot_id: exhaustive estimate}} — handy for assertions.
    ``state``: any carrier ``build`` accepts (padded or compact)."""
    return {
        r.scope: {s.slot_id: s.estimate for s in r.slots}
        for r in build(spec, state)
    }
