"""Functional ``Monitor`` transformation — one state object, compact counters.

``mon = Monitor(spec, params)`` and ``step = mon.wrap(fn)`` turn an ordinary
step function into ``step(mstate, *args) -> (out, mstate')``: ``fn`` runs
under a collector (its ``scalpel.function``/``probe`` calls land in the
counters), and the step's delta folds into the compact counters of ONE
``MonitorState``.  Counters stay in the spec-wide dense layout
(``plan.SlotLayout`` lanes) end to end; reports read them directly.

PyTorch runs eagerly, so ``jit`` is an identity boundary here (a later
change may put a CUDA graph behind it), and the state carries no
cross-device reduction: this is the single-device slice of the JAX
package's ``repro.core.monitor``.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import torch

from . import plan as plan_lib
from . import report as report_lib
from .context import MonitorSpec
from .counters import MonitorParams
from .instrument import Collector, collecting_region


@dataclasses.dataclass
class MonitorState:
    """The one object a wrapped step threads.

    calls    [n_scopes] i32 host   — interception counts (also the
             multiplex schedule base)
    values   [total]    f32 device — accumulated event values, SlotLayout
    samples  [total]    i32 host   — monitored-call counts, SlotLayout
    step     int                   — wrapped-step stamp
    params   MonitorParams         — runtime masks/periods
    fingerprint str                — hash of the compiled probe plans
    """

    calls: torch.Tensor
    values: torch.Tensor
    samples: torch.Tensor
    step: int
    params: MonitorParams
    fingerprint: str = ""

    @property
    def counters(self) -> plan_lib.CompactDelta:
        """The cumulative counters as a compact (dense-layout) carrier."""
        return plan_lib.CompactDelta(
            calls=self.calls, values=self.values, samples=self.samples
        )


class Monitor:
    """The functional monitoring transformation over a compile-time spec.

    ``device``: where the event values accumulate (the device the probed
    tensors live on).
    """

    def __init__(self, spec: MonitorSpec, params: MonitorParams | None = None,
                 *, device="cuda"):
        self.spec = spec
        self.params = params if params is not None \
            else MonitorParams.all_on(spec)
        self.device = torch.device(device)

    def init(self) -> MonitorState:
        """A fresh MonitorState (zero counters)."""
        z = plan_lib.CompactDelta.zeros(self.spec, self.device)
        return MonitorState(
            calls=z.calls, values=z.values, samples=z.samples,
            step=0, params=self.params,
            fingerprint=self.spec.fingerprint,
        )

    def sync(self, mstate: MonitorState, params: MonitorParams | None = None,
             runtime=None) -> MonitorState:
        """Swap in new runtime knobs (explicit ``params``, else a
        ``ScalpelRuntime``'s live ones)."""
        if params is None and runtime is not None:
            params = runtime.params
        if params is None or params is mstate.params:
            return mstate
        return dataclasses.replace(mstate, params=params)

    @contextlib.contextmanager
    def open(self, params: MonitorParams | None = None, calls_base=None):
        """Open a collection region; yields the Collector.  Callers that
        thread counters themselves fold ``col.compact_delta()`` through
        ``commit``."""
        col = Collector(
            self.spec, params if params is not None else self.params,
            calls_base=None if calls_base is None else calls_base.numpy(),
            device=self.device,
        )
        with collecting_region(col):
            yield col

    def commit(self, mstate: MonitorState,
               delta: plan_lib.CompactDelta) -> MonitorState:
        """Fold a region's compact delta into the state and advance the
        step stamp."""
        return dataclasses.replace(
            mstate,
            calls=mstate.calls + delta.calls,
            values=mstate.values + delta.values,
            samples=mstate.samples + delta.samples,
            step=mstate.step + 1,
        )

    def wrap(self, fn: Callable) -> Callable:
        """``fn(*args, **kw) -> out``  ⟶  ``(mstate, *args, **kw) -> (out,
        mstate')`` — the functional monitored step."""

        def wrapped(mstate: MonitorState, *args, **kwargs):
            with self.open(mstate.params, calls_base=mstate.calls) as col:
                out = fn(*args, **kwargs)
            return out, self.commit(mstate, col.compact_delta())

        wrapped.__name__ = f"scalpel_monitor[{getattr(fn, '__name__', 'fn')}]"
        wrapped.monitor = self
        return wrapped

    def jit(self, fn: Callable) -> Callable:
        """``wrap(fn)`` behind the compile boundary of the JAX package's
        ``Monitor.jit`` — an identity boundary in eager PyTorch."""
        return self.wrap(fn)

    # -- views / reporting -------------------------------------------------
    def reports(self, mstate) -> list[report_lib.ScopeReport]:
        return report_lib.build(self.spec, mstate)

    def report(self, mstate, title: str = "ScALPEL report") -> str:
        return report_lib.format_text(self.reports(mstate), title=title)

    def estimates(self, mstate) -> dict[str, dict[str, float]]:
        return report_lib.estimates(self.spec, mstate)
