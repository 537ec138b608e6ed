"""Monitoring contexts — the static ("compile-time set") half of ScALPEL.

The paper defines a *context* per monitored function: the function name, its
events and subevents (Table 1).  Here a "function" is a named scope of the
PyTorch program and a context enumerates the event *slots* computed for
that scope plus their grouping into multiplexed *event sets* (§3.2/§4.2 of
the paper: event sets are cycled every N calls of the scope).

Everything in this module is static/hashable: it fixes the compiled probe
plans.  The runtime-mutable half (masks, periods) lives in
``counters.MonitorParams`` and changes without recompiling any plan — the
paper's compile-time-set / runtime-subset split (C2).  The classes are the
same as the JAX package's, so one spec drives both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence


@dataclasses.dataclass(frozen=True)
class EventSpec:
    """One event slot: an event id plus optional subevent qualifier.

    ``event`` names an entry in the event registry (events.py).  ``tensor``
    optionally names the probe tensor the event applies to (the paper's
    events are bound to whatever the counter hardware observes; ours bind to
    a named intermediate tensor).  ``subevent`` selects a component for
    multi-valued events (paper's [SUBEVENT] blocks).
    """

    event: str
    tensor: str = ""
    subevent: str = ""

    @property
    def slot_id(self) -> str:
        sid = self.event
        if self.tensor:
            sid += f":{self.tensor}"
        if self.subevent:
            sid += f"/{self.subevent}"
        return sid

    @staticmethod
    def parse(slot_id: str) -> "EventSpec":
        sub = ""
        if "/" in slot_id:
            slot_id, sub = slot_id.split("/", 1)
        tensor = ""
        if ":" in slot_id:
            slot_id, tensor = slot_id.split(":", 1)
        return EventSpec(event=slot_id, tensor=tensor, subevent=sub)


@dataclasses.dataclass(frozen=True)
class ScopeContext:
    """Per-scope monitoring context (paper: [FUNCTION] block).

    ``event_sets`` partitions the slots for call-count multiplexing; a scope
    with a single event set is monitored exhaustively.  ``default_period`` is
    only the initial multiplex period — the live period is runtime-mutable
    (MonitorParams.period).
    """

    scope: str
    slots: tuple[EventSpec, ...]
    event_sets: tuple[tuple[int, ...], ...]  # indices into ``slots``
    default_period: int = 1

    def __post_init__(self):
        seen: set[int] = set()
        for s in self.event_sets:
            for i in s:
                if i >= len(self.slots) or i < 0:
                    raise ValueError(
                        f"event set index {i} out of range for scope {self.scope}"
                    )
                if i in seen:
                    raise ValueError(
                        f"slot {i} appears in more than one event set "
                        f"(scope {self.scope})"
                    )
                seen.add(i)
        if len(seen) != len(self.slots):
            raise ValueError(
                f"event sets must cover every slot exactly once (scope {self.scope})"
            )

    @property
    def n_sets(self) -> int:
        return len(self.event_sets)

    @property
    def slot_ids(self) -> tuple[str, ...]:
        return tuple(s.slot_id for s in self.slots)

    @staticmethod
    def exhaustive(scope: str, slots: Sequence[EventSpec]) -> "ScopeContext":
        slots = tuple(slots)
        return ScopeContext(
            scope=scope,
            slots=slots,
            event_sets=(tuple(range(len(slots))),) if slots else ((),),
        )

    @staticmethod
    def multiplexed(
        scope: str,
        sets: Sequence[Sequence[EventSpec]],
        period: int = 1,
    ) -> "ScopeContext":
        flat: list[EventSpec] = []
        idx_sets: list[tuple[int, ...]] = []
        for s in sets:
            idxs = []
            for ev in s:
                idxs.append(len(flat))
                flat.append(ev)
            idx_sets.append(tuple(idxs))
        return ScopeContext(
            scope=scope,
            slots=tuple(flat),
            event_sets=tuple(idx_sets),
            default_period=period,
        )


@dataclasses.dataclass(frozen=True)
class MonitorSpec:
    """The compile-time monitoring set: every interceptable scope + context.

    A scope listed here with an empty context is *intercepted* (calls are
    counted — the paper's "all" mode) but computes no events until a context
    says otherwise.  Scopes not listed here are invisible; adding them
    requires a new spec — exactly the paper's "new functions can be added as
    long as they are from the set specified at compile time".
    """

    contexts: tuple[ScopeContext, ...]

    def __post_init__(self):
        names = [c.scope for c in self.contexts]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate scope names in spec: {names}")

    # -- lookups ---------------------------------------------------------
    @property
    def scopes(self) -> tuple[str, ...]:
        return tuple(c.scope for c in self.contexts)

    @property
    def n_scopes(self) -> int:
        return len(self.contexts)

    @property
    def max_slots(self) -> int:
        return max((len(c.slots) for c in self.contexts), default=0) or 1

    def scope_index(self, scope: str) -> int:
        try:
            return self.scopes.index(scope)
        except ValueError:
            raise KeyError(
                f"scope {scope!r} is not in the compile-time set {self.scopes}"
            ) from None

    def context(self, scope: str) -> ScopeContext:
        return self.contexts[self.scope_index(scope)]

    def __contains__(self, scope: str) -> bool:
        return scope in self.scopes

    def slot_index(self, scope: str, slot_id: str) -> int:
        ctx = self.context(scope)
        try:
            return ctx.slot_ids.index(slot_id)
        except ValueError:
            raise KeyError(f"slot {slot_id!r} not in scope {scope!r}") from None

    # -- construction helpers -------------------------------------------
    @staticmethod
    def of(contexts: Sequence[ScopeContext]) -> "MonitorSpec":
        return MonitorSpec(contexts=tuple(contexts))

    def with_context(self, ctx: ScopeContext) -> "MonitorSpec":
        """Replace (or append) the context for ``ctx.scope``."""
        out = [c for c in self.contexts if c.scope != ctx.scope]
        out.append(ctx)
        return MonitorSpec(contexts=tuple(out))

    @property
    def layout(self):
        """The spec-wide dense slot layout (plan.SlotLayout) — the lane
        order every compact counter carrier (MonitorState, CompactDelta,
        compact telemetry rings) uses."""
        from . import plan as plan_lib  # lazy: plan imports this module

        return plan_lib.spec_layout(self)

    def slot_lane(self, scope: str, slot_id: str) -> int:
        """Flat dense-layout lane of one slot — index straight into a
        compact carrier's ``values``/``samples`` vectors."""
        si = self.scope_index(scope)
        return self.layout.offsets[si] + self.slot_index(scope, slot_id)

    @property
    def fingerprint(self) -> str:
        """Stable hash over this spec's compiled probe plans (plan.py).

        Two specs with equal fingerprints compile identical probe plans;
        runtime mask/period swaps never change it — the attestation that a
        config hot-swap re-selected plans without recompiling any.
        """
        from . import plan as plan_lib  # lazy: plan imports this module

        return plan_lib.spec_fingerprint(self)

    def describe(self) -> str:
        lines = []
        for c in self.contexts:
            lines.append(
                f"{c.scope}: {len(c.slots)} slots, {c.n_sets} event set(s), "
                f"period {c.default_period}"
            )
            for k, s in enumerate(c.event_sets):
                ids = ", ".join(c.slots[i].slot_id for i in s)
                lines.append(f"  set {k}: [{ids}]")
        return "\n".join(lines)


def spec_from_mapping(
    mapping: Mapping[str, Sequence[Sequence[str]] | Sequence[str]],
    periods: Mapping[str, int] | None = None,
) -> MonitorSpec:
    """Build a MonitorSpec from ``{scope: [slot_ids...]}`` (exhaustive) or
    ``{scope: [[set0 ids...], [set1 ids...]]}`` (multiplexed)."""
    periods = dict(periods or {})
    ctxs = []
    for scope, spec in mapping.items():
        spec = list(spec)
        if spec and isinstance(spec[0], (list, tuple)):
            sets = [[EventSpec.parse(s) for s in group] for group in spec]
            ctxs.append(
                ScopeContext.multiplexed(scope, sets, period=periods.get(scope, 1))
            )
        else:
            ctxs.append(
                ScopeContext.exhaustive(scope, [EventSpec.parse(s) for s in spec])
            )
    return MonitorSpec.of(ctxs)
