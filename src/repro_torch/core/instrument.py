"""Scope instrumentation — the paper's compiler-directed callbacks, eager.

Model code names its scopes (``with scalpel.function("attn")``) and probes
tensors (``scalpel.probe(out=y)``); which events run, for which scopes, with
which multiplex schedule is decided by the MonitorSpec/MonitorParams, not
by the model.

Execution model (the JAX package traces these decisions into the graph;
PyTorch runs eagerly, so they are made on the host as the program runs):

* ``monitor.Monitor.wrap`` opens a root ``Collector`` for a step.
* ``function(name)`` pushes a scope; entering a scope in the compile-time
  set increments its call count (interception — a host integer).
* ``probe(**tensors)`` evaluates the current scope's context: nothing when
  the scope mask is off; otherwise the event set ``(calls // period) %
  n_sets`` — call-count multiplexing, with ``calls`` the scope's count
  before this call — runs its compiled ``MomentPlan`` (core/plan.py):
  exactly the channels that set finalizes from, swept once per probed
  tensor (kernels/ops.tensor_moments: the CUDA kernel on the card), then
  the stage-2 finalizers, added into the step's device-side value lanes.
  The mask, the period and the set index are host values: the probe never
  reads the device and never waits for it.
* ``scan_with_counters`` is a Python loop over stacked layer parameters;
  the collector's running call counts keep the multiplex phase exact
  across iterations.

When no collector is active every call here is a no-op.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, Sequence

import numpy as np
import torch

from ..kernels import ops
from . import events as events_lib
from . import plan as plan_lib
from .context import EventSpec, MonitorSpec, ScopeContext
from .counters import MonitorParams

_TLS = threading.local()


def _stack() -> list:
    if not hasattr(_TLS, "stack"):
        _TLS.stack = []
    return _TLS.stack


def current_collector():
    st = _stack()
    return st[-1] if st else None


SEP = "/"


class Collector:
    """Accumulates one region's counter delta while the region runs.

    ``calls_base`` (host ints, [n_scopes]) is the interception count before
    this region — it carries the multiplex schedule across steps.  Values
    accumulate into one f32 lane vector on ``device`` in call order; calls
    and samples are host integers.
    """

    def __init__(self, spec: MonitorSpec, params: MonitorParams,
                 calls_base=None, device="cuda"):
        self.spec = spec
        self.params = params
        n = spec.n_scopes
        self.calls_base = (np.zeros((n,), np.int64) if calls_base is None
                           else np.asarray(calls_base, np.int64))
        self.scope_path: list[str] = []
        self._extended: list[bool] = []
        self._layout = plan_lib.spec_layout(spec)
        self._scope_mask, self._slot_mask, self._period = params.host
        self._counts = np.zeros((n,), np.int64)
        self._samples = np.zeros((self._layout.total,), np.int64)
        self._values = torch.zeros((self._layout.total,), dtype=torch.float32,
                                   device=device)

    # -- scope management -------------------------------------------------
    def push(self, name: str) -> str:
        # Paper §3.3: the context is retained across recursive calls — direct
        # re-entry does not open a new scope path.
        if self.scope_path and self.scope_path[-1] == name:
            self._extended.append(False)
            return SEP.join(self.scope_path)
        self.scope_path.append(name)
        self._extended.append(True)
        return SEP.join(self.scope_path)

    def pop(self) -> None:
        if self._extended.pop():
            self.scope_path.pop()

    @property
    def current_scope(self) -> str:
        return SEP.join(self.scope_path)

    # -- counter updates ----------------------------------------------------
    def intercept(self, scope: str) -> None:
        """Count a call of ``scope`` (always on; a host increment)."""
        if scope in self.spec:
            self._counts[self.spec.scope_index(scope)] += 1

    def probe(self, scope: str, tensors: dict[str, Any]) -> None:
        if scope not in self.spec:
            return
        idx = self.spec.scope_index(scope)
        ctx = self.spec.context(scope)
        if not ctx.slots or self._scope_mask[idx] <= 0:
            return
        plans = plan_lib.compile_scope_plans(ctx, frozenset(tensors))
        if not plans.any_live:
            return
        if ctx.n_sets == 1:
            set_idx = 0
        else:
            # call count *before* this call was intercepted
            c = int(self._counts[idx])
            calls_here = int(self.calls_base[idx]) + (c - 1 if c else 0)
            set_idx = (calls_here // max(int(self._period[idx]), 1)) \
                % ctx.n_sets
        pl = plans.plans[set_idx]
        if not pl.slots:
            return
        tensors = {k: t.detach() for k, t in tensors.items()}
        moms = {
            sw.tensor: ops.tensor_moments(tensors[sw.tensor], sw.channels)
            for sw in pl.sweeps
        }
        dev = self._values.device
        off = self._layout.offsets[idx]
        for s in pl.slots:
            slot = ctx.slots[s.index]
            if s.fused:
                v = events_lib.finalize_event(slot, moms[s.tensor], dev)
            else:
                v = events_lib.compute(slot, tensors)
            sm = float(self._slot_mask[idx, s.index])
            if sm != 1.0:  # x * 1.0 == x exactly, NaN and Inf included
                v = v * sm
            self._values[off + s.index].add_(v)
            self._samples[off + s.index] += int(sm > 0)

    # -- finalization -------------------------------------------------------
    def compact_delta(self) -> plan_lib.CompactDelta:
        """The region's delta in the dense slot layout."""
        return plan_lib.CompactDelta(
            calls=torch.from_numpy(self._counts.astype(np.int32)),
            values=self._values,
            samples=torch.from_numpy(self._samples.astype(np.int32)),
        )


class DiscoveryCollector:
    """Records scope/probe structure without computing anything — run on
    ``meta`` tensors it enumerates the compile-time set."""

    def __init__(self):
        self.scope_path: list[str] = []
        self._extended: list[bool] = []
        self.seen: dict[str, tuple[str, ...]] = {}

    def push(self, name: str) -> str:
        if self.scope_path and self.scope_path[-1] == name:
            self._extended.append(False)
        else:
            self.scope_path.append(name)
            self._extended.append(True)
        scope = SEP.join(self.scope_path)
        self.seen.setdefault(scope, ())
        return scope

    def pop(self) -> None:
        if self._extended.pop():
            self.scope_path.pop()

    @property
    def current_scope(self) -> str:
        return SEP.join(self.scope_path)

    def intercept(self, scope: str) -> None:
        self.seen.setdefault(scope, ())

    def probe(self, scope: str, tensors: dict[str, Any]) -> None:
        old = self.seen.get(scope, ())
        self.seen[scope] = tuple(dict.fromkeys(list(old) + sorted(tensors)))


# --------------------------------------------------------------------------
# Public API used by model / application code.
# --------------------------------------------------------------------------

@contextlib.contextmanager
def collecting_region(col):
    """Make ``col`` the ambient collector for the duration of the block."""
    _stack().append(col)
    try:
        yield col
    finally:
        _stack().pop()


@contextlib.contextmanager
def function(name: str):
    """Scope context manager — the entry/exit callback pair (paper C1).
    Entering counts one interception of the full scope path."""
    col = current_collector()
    if col is None:
        yield None
        return
    scope = col.push(name)
    try:
        col.intercept(scope)
        yield scope
    finally:
        col.pop()


def probe(**tensors) -> None:
    """Evaluate the current scope's monitoring context on named tensors."""
    col = current_collector()
    if col is None:
        return
    col.probe(col.current_scope, tensors)


def _tree_index(xs, i):
    if isinstance(xs, torch.Tensor):
        return xs[i]
    if isinstance(xs, dict):
        return {k: _tree_index(v, i) for k, v in xs.items()}
    if isinstance(xs, (tuple, list)):
        return type(xs)(_tree_index(v, i) for v in xs)
    raise TypeError(f"cannot index scan input of type {type(xs)}")


def _tree_len(xs) -> int:
    if isinstance(xs, torch.Tensor):
        return xs.shape[0]
    if isinstance(xs, dict):
        return _tree_len(next(iter(xs.values())))
    return _tree_len(xs[0])


def _tree_stack(ys):
    y0 = ys[0]
    if y0 is None:
        return None
    if isinstance(y0, torch.Tensor):
        return torch.stack(ys)
    if isinstance(y0, dict):
        return {k: _tree_stack([y[k] for y in ys]) for k in y0}
    return type(y0)(_tree_stack([y[j] for y in ys]) for j in range(len(y0)))


def scan_with_counters(body: Callable, init, xs):
    """``body(carry, x) -> (carry, y)`` over the leading axis of ``xs`` (a
    tensor or a dict/tuple of stacked tensors), as a Python loop.  Counters
    from every iteration land in the ambient collector in call order.
    Returns ``(carry, ys)`` with ``ys`` stacked (None if the body yields
    None)."""
    carry, ys = init, []
    for i in range(_tree_len(xs)):
        carry, y = body(carry, _tree_index(xs, i))
        ys.append(y)
    return carry, (_tree_stack(ys) if ys else None)


# --------------------------------------------------------------------------
# Discovery — build the compile-time set by running the program on `meta`.
# --------------------------------------------------------------------------

def discover(fn: Callable, *args, **kwargs) -> dict[str, tuple[str, ...]]:
    """Run ``fn`` under a discovery collector and return {scope: probed
    tensor names}.  Pass ``meta`` tensors to walk the program without
    allocating or computing anything."""
    col = DiscoveryCollector()
    with collecting_region(col), torch.no_grad():
        fn(*args, **kwargs)
    return dict(col.seen)


DEFAULT_TENSOR_EVENTS = ("ACT_RMS", "ACT_MEAN_ABS")


def spec_from_discovery(
    seen: dict[str, tuple[str, ...]],
    tensor_events: Sequence[str] = DEFAULT_TENSOR_EVENTS,
    include: Callable[[str], bool] | None = None,
) -> MonitorSpec:
    """Auto-build a MonitorSpec: every discovered scope becomes
    interceptable, every probed tensor gets the generic ``tensor_events``."""
    ctxs = []
    for scope, tnames in sorted(seen.items()):
        if include is not None and not include(scope):
            continue
        slots = [
            EventSpec(event=ev, tensor=t)
            for t in tnames
            for ev in tensor_events
        ]
        ctxs.append(ScopeContext.exhaustive(scope, slots))
    return MonitorSpec.of(ctxs)
