"""Probe-plan compiler — per-(scope, event set) moment plans.

The JAX package's ``repro.core.plan`` in PyTorch: for each (scope, event
set) a ``MomentPlan`` names exactly the channels that set's slots finalize
from, swept once per probed tensor, so a sparse active set never pays for
the union across sets.  ``SlotLayout`` packs every scope's slots into one
flat lane vector (the compact counter layout), and ``spec_fingerprint`` is a
sha1 of the ``describe_plans`` text — byte-equal to the JAX package's for
the same spec, so a counter stream from either package is attributable to
the same plan.

The plans, the layout and the fingerprint are pure Python; only
``CompactDelta`` holds tensors: ``calls``/``samples`` on the host (they are
decided on the host, see counters.py), ``values`` on the device.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib

import numpy as np
import torch

from . import events as events_lib
from .context import MonitorSpec, ScopeContext
from .counters import CounterState


@dataclasses.dataclass(frozen=True)
class PlanSlot:
    """One live slot of a plan: where it scatters and how it is evaluated.

    ``tensor``: the probe tensor a fused slot finalizes from ("" for bespoke
    slots, which receive the full probe-tensor dict).
    """

    index: int          # slot index within the scope context
    tensor: str
    fused: bool         # True: finalizer over the channel sweep


@dataclasses.dataclass(frozen=True)
class TensorSweep:
    """One probed tensor and the exact channels this event set sweeps."""

    tensor: str
    channels: tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class MomentPlan:
    """The compiled probe work of ONE (scope, event set) pair."""

    scope: str
    set_index: int
    slots: tuple[PlanSlot, ...]      # live slots, ascending index
    sweeps: tuple[TensorSweep, ...]  # per-tensor exact channel requirements

    def describe(self) -> str:
        slots = ", ".join(
            ("~" if not s.fused else "") + str(s.index) for s in self.slots
        )
        sweeps = "; ".join(
            f"{sw.tensor or '<probe>'}:[{','.join(sw.channels)}]"
            for sw in self.sweeps
        )
        return f"set {self.set_index}: slots [{slots}] sweeps {sweeps or '-'}"


@dataclasses.dataclass(frozen=True)
class ScopePlans:
    """Per-scope bundle: one MomentPlan per event set.

    ``bodies``/``branch_index``: sets whose plans do identical work (same
    slot events, same sweeps; only the scatter lanes differ) share one body.
    The eager probe path runs each set's own plan; the dedup table is kept
    because it is part of the plan text the fingerprint hashes.
    """

    scope: str
    plans: tuple[MomentPlan, ...]
    bodies: tuple[MomentPlan, ...] = ()
    branch_index: tuple[int, ...] = ()

    @property
    def n_sets(self) -> int:
        return len(self.plans)

    @property
    def n_branches(self) -> int:
        return len(self.bodies)

    @property
    def plans_deduped(self) -> int:
        """Event sets that reuse another set's branch body."""
        return self.n_sets - self.n_branches

    @property
    def any_live(self) -> bool:
        return any(p.slots for p in self.plans)


def _bind_tensor(spec, avail: frozenset | None) -> str:
    """The probe tensor a per-tensor slot binds to (static describe mode
    binds unqualified slots to the anonymous '<probe>' tensor '')."""
    if spec.tensor:
        return spec.tensor
    if avail is None:
        return ""
    (name,) = tuple(avail)
    return name


@functools.lru_cache(maxsize=None)
def compile_scope_plans(ctx: ScopeContext,
                        avail: frozenset | None = None) -> ScopePlans:
    """Compile one MomentPlan per event set of ``ctx``.

    ``avail``: the probe tensor names this probe call provides (only the
    slots those tensors satisfy are live).  ``None`` = static mode: every
    slot computable — used for fingerprints and description.
    """
    def live(i) -> bool:
        if avail is None:
            return True
        return events_lib.computable(ctx.slots[i], avail)

    plans = []
    for k, members in enumerate(ctx.event_sets):
        slots: list[PlanSlot] = []
        set_by_tensor: dict[str, list] = {}
        for i in sorted(members):
            if not live(i):
                continue
            s = ctx.slots[i]
            if events_lib.moment_based(s):
                t = _bind_tensor(s, avail)
                slots.append(PlanSlot(index=i, tensor=t, fused=True))
                set_by_tensor.setdefault(t, []).append(s)
            else:
                slots.append(PlanSlot(index=i, tensor="", fused=False))
        sweeps = tuple(
            TensorSweep(tensor=t, channels=events_lib.channels_for(ss))
            for t, ss in sorted(set_by_tensor.items())
        )
        plans.append(
            MomentPlan(scope=ctx.scope, set_index=k, slots=tuple(slots),
                       sweeps=sweeps)
        )
    bodies: list[MomentPlan] = []
    body_of: dict = {}
    branch_index: list[int] = []
    for p in plans:
        key = (
            tuple((ctx.slots[s.index], s.tensor, s.fused) for s in p.slots),
            p.sweeps,
        )
        j = body_of.get(key)
        if j is None:
            j = len(bodies)
            body_of[key] = j
            bodies.append(p)
        branch_index.append(j)
    return ScopePlans(
        scope=ctx.scope, plans=tuple(plans),
        bodies=tuple(bodies), branch_index=tuple(branch_index),
    )


# ---------------------------------------------------------------------------
# Spec-wide dense slot layout + compact counters
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SlotLayout:
    """Dense slot layout of a MonitorSpec: scope ``i``'s slots occupy
    ``[offsets[i], offsets[i] + widths[i])`` of a flat ``total``-lane
    vector."""

    offsets: tuple[int, ...]
    widths: tuple[int, ...]
    total: int

    @functools.cached_property
    def scatter_indices(self) -> tuple[np.ndarray, np.ndarray]:
        """(scope_ids, slot_ids) mapping flat lanes to [n_scopes, max_slots]."""
        scope_ids = np.concatenate(
            [np.full((w,), i, np.int64) for i, w in enumerate(self.widths)]
        ) if self.total else np.zeros((0,), np.int64)
        slot_ids = np.concatenate(
            [np.arange(w, dtype=np.int64) for w in self.widths]
        ) if self.total else np.zeros((0,), np.int64)
        return scope_ids, slot_ids


@functools.lru_cache(maxsize=None)
def spec_layout(spec: MonitorSpec) -> SlotLayout:
    """The spec's dense lane layout: lanes run in ``spec.contexts`` order,
    each scope contributing its slots in ``ctx.slots`` order (the same wire
    contract as the JAX package's)."""
    widths = tuple(len(c.slots) for c in spec.contexts)
    offsets, off = [], 0
    for w in widths:
        offsets.append(off)
        off += w
    return SlotLayout(offsets=tuple(offsets), widths=widths, total=off)


@dataclasses.dataclass
class CompactDelta:
    """Counters in the dense slot layout.

    calls    [n_scopes]  i32 host
    values   [total]     f32 device  (SlotLayout order)
    samples  [total]     i32 host
    """

    calls: torch.Tensor
    values: torch.Tensor
    samples: torch.Tensor

    @staticmethod
    def zeros(spec: MonitorSpec, device="cuda") -> "CompactDelta":
        lay = spec_layout(spec)
        return CompactDelta(
            calls=torch.zeros((spec.n_scopes,), dtype=torch.int32),
            values=torch.zeros((lay.total,), dtype=torch.float32,
                               device=device),
            samples=torch.zeros((lay.total,), dtype=torch.int32),
        )

    def expand(self, spec: MonitorSpec) -> CounterState:
        """Scatter the flat lanes back into the padded CounterState view."""
        lay = spec_layout(spec)
        n, m = spec.n_scopes, spec.max_slots
        values = torch.zeros((n, m), dtype=torch.float32,
                             device=self.values.device)
        samples = torch.zeros((n, m), dtype=torch.int32)
        if lay.total:
            sids, slids = (torch.from_numpy(a) for a in lay.scatter_indices)
            samples[sids, slids] = self.samples
            dev = self.values.device
            values[sids.to(dev), slids.to(dev)] = self.values
        return CounterState(calls=self.calls.clone(), values=values,
                            samples=samples)

    @staticmethod
    def compress(spec: MonitorSpec, state: CounterState) -> "CompactDelta":
        """Gather a padded CounterState into the dense layout."""
        lay = spec_layout(spec)
        sids, slids = (torch.from_numpy(a) for a in lay.scatter_indices)
        dev = state.values.device
        return CompactDelta(
            calls=state.calls.clone(),
            values=state.values[sids.to(dev), slids.to(dev)],
            samples=state.samples[sids, slids],
        )


# ---------------------------------------------------------------------------
# Spec fingerprint — plans are part of the spec's identity
# ---------------------------------------------------------------------------

def describe_plans(spec: MonitorSpec) -> str:
    """Human-readable plan table: scope → per-set slots + exact sweeps.
    The fingerprint hashes this text; it is byte-equal to the JAX package's
    ``describe_plans`` for the same spec."""
    lay = spec_layout(spec)
    lines = []
    deduped = 0
    for i, ctx in enumerate(spec.contexts):
        sp = compile_scope_plans(ctx, None)
        deduped += sp.plans_deduped
        ids = ", ".join(ctx.slot_ids)
        lines.append(
            f"{ctx.scope}: width {len(ctx.slots)}, {sp.n_sets} set(s), "
            f"{sp.n_branches} branch bodies, "
            f"footprint [{lay.offsets[i]}:{lay.offsets[i] + lay.widths[i]}]"
            f" slots [{ids}]"
        )
        for k, p in enumerate(sp.plans):
            lines.append(f"  {p.describe()} [body {sp.branch_index[k]}]")
    lines.append(f"total live footprint: {lay.total} slot(s)")
    lines.append(f"plans_deduped: {deduped}")
    return "\n".join(lines)


@functools.lru_cache(maxsize=None)
def spec_fingerprint(spec: MonitorSpec) -> str:
    """sha1 of ``describe_plans`` — anything that changes the compiled
    probe plans changes it; runtime mask/period swaps do not."""
    return hashlib.sha1(describe_plans(spec).encode()).hexdigest()
