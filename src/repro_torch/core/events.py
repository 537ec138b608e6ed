"""Event library — two-stage: raw moments, then scalar finalizers.

The registry of the JAX package's ``repro.core.events``, in PyTorch, with
the same event names — including the case-study names ``HBM_BYTES``,
``VMEM_TILE_REFILLS`` and ``MXU_PASSES`` — so one config file drives both
packages.  On Hopper those three read as: bytes moved between device
memory and shared memory, tile fetches into shared memory, and
tensor-core passes of the schedule, each supplied by the scope as a scalar
probe.

Most events are statistics of ONE probed tensor and are cheap scalar
functions of the shared channel vector (stage 1: one fused sweep,
kernels/probe_reduce.py; stage 2: a *finalizer* here, e.g.
``ACT_RMS = sqrt(sum_sq / numel)``).  Events that are not channel functions
(MOE_LOAD, SSM_STATE_RMS) keep their bespoke ``fn`` path.  Every event keeps
a direct implementation ``fn`` — the numerical reference the planned path is
checked against.

Events are tagged EXTENSIVE (summed across calls: counts, bytes, flops) or
INTENSIVE (a mean across monitored calls: rms, entropy, fractions); report.py
uses the tag to turn multiplexed samples back into exhaustive estimates.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Mapping

import torch

from .context import EventSpec

EXTENSIVE = "extensive"
INTENSIVE = "intensive"

# Canonical channel vocabulary (kernels/probe_reduce mirrors it).
SWEEP_CHANNELS = (
    "sum",
    "sum_sq",
    "sum_abs",
    "max_abs",
    "zero_count",
    "nan_count",
    "inf_count",
    "ent_sum",
)
STATIC_CHANNELS = ("numel", "rows")
CHANNELS = SWEEP_CHANNELS + STATIC_CHANNELS


@dataclasses.dataclass(frozen=True)
class EventDef:
    name: str
    kind: str  # EXTENSIVE | INTENSIVE
    fn: Callable  # (tensor) or (tensors-dict, subevent) — see wants_dict
    wants_dict: bool = False
    subevents: tuple[str, ...] = ()
    requires: tuple[str, ...] = ()  # probe tensor names a dict-event needs
    moments: tuple[str, ...] = ()   # channels stage 1 must provide
    finalize: Callable[[Mapping], object] | None = None
    doc: str = ""


_REGISTRY: dict[str, EventDef] = {}


def register(
    name: str,
    kind: str,
    *,
    wants_dict: bool = False,
    subevents: tuple[str, ...] = (),
    requires: tuple[str, ...] = (),
    moments: tuple[str, ...] = (),
    finalize: Callable[[Mapping], object] | None = None,
    doc: str = "",
):
    unknown = set(moments) - set(CHANNELS)
    if unknown:
        raise ValueError(f"event {name!r}: unknown channels {sorted(unknown)}")
    if bool(moments) != (finalize is not None):
        raise ValueError(
            f"event {name!r}: moments and finalize must be given together"
        )
    if moments and wants_dict:
        raise ValueError(f"event {name!r}: dict events cannot be moment-derived")

    def deco(fn):
        if name in _REGISTRY:
            raise ValueError(f"event {name!r} already registered")
        _REGISTRY[name] = EventDef(
            name=name, kind=kind, fn=fn, wants_dict=wants_dict,
            subevents=subevents, requires=requires, moments=moments,
            finalize=finalize, doc=doc,
        )
        return fn

    return deco


def computable(spec: EventSpec, tensor_names) -> bool:
    """Can this slot be evaluated from a probe call providing
    ``tensor_names``?  (A scope may probe several times per invocation.)"""
    ev = lookup(spec.event)
    names = set(tensor_names)
    if ev.wants_dict:
        return all(r in names for r in ev.requires)
    if spec.tensor:
        return spec.tensor in names
    return len(names) == 1


def lookup(name: str) -> EventDef:
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown event {name!r}; known: {sorted(_REGISTRY)}"
        )
    return _REGISTRY[name]


def registered() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def kind_of(spec: EventSpec) -> str:
    return lookup(spec.event).kind


def _as_f32(val, device) -> torch.Tensor:
    """An event value as an f32 scalar tensor on ``device``.  A python
    number (a finalizer over static channels only) is filled on the device,
    never copied from the host."""
    if isinstance(val, torch.Tensor):
        return val.to(torch.float32)
    return torch.full((), float(val), dtype=torch.float32, device=device)


def compute(spec: EventSpec, tensors: dict) -> torch.Tensor:
    """Evaluate one event slot on the probed tensors (direct path)."""
    ev = lookup(spec.event)
    device = next(iter(tensors.values())).device
    if ev.wants_dict:
        return _as_f32(ev.fn(tensors, spec.subevent), device)
    if spec.tensor:
        if spec.tensor not in tensors:
            raise KeyError(
                f"event {spec.slot_id}: probe tensor {spec.tensor!r} not "
                f"provided (have {sorted(tensors)})"
            )
        x = tensors[spec.tensor]
    else:
        if len(tensors) != 1:
            raise KeyError(
                f"event {spec.event} needs an explicit ':tensor' qualifier "
                f"when the scope probes multiple tensors {sorted(tensors)}"
            )
        (x,) = tensors.values()
    return _as_f32(ev.fn(x), x.device)


# --------------------------------------------------------------------------
# Two-stage evaluation helpers (core/plan.py, instrument.Collector.probe)
# --------------------------------------------------------------------------

def moment_based(spec: EventSpec) -> bool:
    """Is this slot a stage-2 finalizer over the shared channel sweep?"""
    ev = lookup(spec.event)
    return ev.finalize is not None and not ev.wants_dict


def slot_channels(spec: EventSpec) -> tuple[str, ...]:
    """The raw channels ONE slot needs (empty for bespoke events)."""
    return lookup(spec.event).moments


def channels_for(specs) -> tuple[str, ...]:
    """Exact channels the given slot group needs, in canonical order."""
    need: set[str] = set()
    for s in specs:
        need.update(lookup(s.event).moments)
    return tuple(m for m in CHANNELS if m in need)


def finalize_event(spec: EventSpec, moments: Mapping, device) -> torch.Tensor:
    """Stage 2: one event value from the shared moment dict."""
    ev = lookup(spec.event)
    if ev.finalize is None:
        raise TypeError(f"event {spec.event!r} is not moment-derived")
    missing = [m for m in ev.moments if m not in moments]
    if missing:
        raise KeyError(
            f"event {spec.event}: moments {missing} not provided "
            f"(have {sorted(moments)})"
        )
    return _as_f32(ev.finalize(moments), device)


# --------------------------------------------------------------------------
# Generic per-tensor events (apply to any probed tensor via "NAME:tensor").
# --------------------------------------------------------------------------

def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


@register(
    "ACT_RMS", INTENSIVE, moments=("sum_sq", "numel"),
    finalize=lambda m: torch.sqrt(m["sum_sq"] / m["numel"] + 1e-30),
    doc="root-mean-square of the tensor",
)
def _act_rms(x):
    return torch.sqrt(torch.mean(torch.square(_f32(x))) + 1e-30)


@register(
    "ACT_MEAN_ABS", INTENSIVE, moments=("sum_abs", "numel"),
    finalize=lambda m: m["sum_abs"] / m["numel"],
    doc="mean |x|",
)
def _act_mean_abs(x):
    return torch.mean(torch.abs(_f32(x)))


@register(
    "ACT_MAX_ABS", INTENSIVE, moments=("max_abs",),
    finalize=lambda m: m["max_abs"],
    doc="max |x| (overflow watch)",
)
def _act_max_abs(x):
    return torch.max(torch.abs(_f32(x)))


@register(
    "ACT_ZERO_FRAC", INTENSIVE, moments=("zero_count", "numel"),
    finalize=lambda m: m["zero_count"] / m["numel"],
    doc="fraction of exact zeros (sparsity)",
)
def _act_zero_frac(x):
    return torch.mean((x == 0).to(torch.float32))


@register(
    "NAN_COUNT", EXTENSIVE, moments=("nan_count",),
    finalize=lambda m: m["nan_count"],
    doc="number of NaN entries",
)
def _nan_count(x):
    return torch.sum(torch.isnan(_f32(x)).to(torch.float32))


@register(
    "INF_COUNT", EXTENSIVE, moments=("inf_count",),
    finalize=lambda m: m["inf_count"],
    doc="number of +-Inf entries",
)
def _inf_count(x):
    return torch.sum(torch.isinf(_f32(x)).to(torch.float32))


@register(
    "NUMEL", EXTENSIVE, moments=("numel",),
    finalize=lambda m: m["numel"],
    doc="number of elements seen (token/elt count)",
)
def _numel(x):
    return float(math.prod(x.shape))


@register(
    "L2NORM", INTENSIVE, moments=("sum_sq",),
    finalize=lambda m: torch.sqrt(m["sum_sq"] + 1e-30),
    doc="L2 norm of the tensor",
)
def _l2norm(x):
    return torch.sqrt(torch.sum(torch.square(_f32(x))) + 1e-30)


@register(
    "MEAN", INTENSIVE, moments=("sum", "numel"),
    finalize=lambda m: m["sum"] / m["numel"],
    doc="mean value",
)
def _mean(x):
    return torch.mean(_f32(x))


# --------------------------------------------------------------------------
# Specialized events (bind to specific probe names).
# --------------------------------------------------------------------------

@register(
    "ATTN_ENTROPY", INTENSIVE, moments=("ent_sum", "rows"),
    finalize=lambda m: -m["ent_sum"] / m["rows"],
    doc="mean entropy (nats) of attention rows; probe tensor = probabilities "
        "over the last axis.  Fused: rides the sweep's optional ent_sum "
        "channel (sum of p*log(p+eps)) divided by the static row count",
)
def _attn_entropy(p):
    p = _f32(p)
    return torch.mean(-torch.sum(p * torch.log(p + 1e-9), dim=-1))


@register(
    "MOE_LOAD", INTENSIVE, wants_dict=True,
    subevents=("MAX_FRAC", "MIN_FRAC", "CV", "AUX_LOSS"),
    requires=("router_probs",),
    doc="expert load statistics; needs probe 'router_probs' "
        "[tokens, experts] and optionally 'expert_mask' [tokens, experts]",
)
def _moe_load(tensors, subevent):
    probs = _f32(tensors["router_probs"])  # [tokens, experts]
    if "expert_mask" in tensors:
        load = torch.mean(_f32(tensors["expert_mask"]), dim=0)
    else:
        load = torch.mean(probs, dim=0)
    n_e = load.shape[-1]
    if subevent == "MAX_FRAC":
        return torch.max(load) * n_e  # 1.0 == perfectly balanced
    if subevent == "MIN_FRAC":
        return torch.min(load) * n_e
    if subevent == "CV":
        return torch.std(load, unbiased=False) / (torch.mean(load) + 1e-9)
    if subevent == "AUX_LOSS":
        importance = torch.mean(probs, dim=0)
        return float(n_e) * torch.sum(load * importance)
    raise KeyError(f"MOE_LOAD subevent {subevent!r}")


@register(
    "SSM_STATE_RMS", INTENSIVE,
    doc="RMS of the recurrent state (probe 'state')",
)
def _ssm_state_rms(x):
    return torch.sqrt(torch.mean(torch.square(_f32(x))) + 1e-30)


@register(
    "GRAD_GLOBAL_NORM", INTENSIVE, moments=("sum_sq",),
    finalize=lambda m: torch.sqrt(m["sum_sq"] + 1e-30),
    doc="global norm of a gradient tensor (probe per-group flattened grads)",
)
def _grad_global_norm(x):
    return torch.sqrt(torch.sum(torch.square(_f32(x))) + 1e-30)


# --------------------------------------------------------------------------
# Static "cost-model" events: per-call constants supplied by the scope at
# probe time (e.g. a kernel reporting its schedule's traffic) — the cause
# metrics of a kernel schedule, the analogue of the paper's Table-2 counters.
# --------------------------------------------------------------------------

def _sum_finalizer(m):
    return m["sum"]


@register("FLOPS", EXTENSIVE, moments=("sum",), finalize=_sum_finalizer,
          doc="floating-point ops (probe provides scalar)")
def _flops(x):
    return torch.sum(_f32(x))


@register("HBM_BYTES", EXTENSIVE, moments=("sum",), finalize=_sum_finalizer,
          doc="bytes moved between device memory and on-chip memory by the "
              "schedule (scalar probe) — analogue of L2_LINES_IN")
def _hbm_bytes(x):
    return torch.sum(_f32(x))


@register("VMEM_TILE_REFILLS", EXTENSIVE, moments=("sum",),
          finalize=_sum_finalizer,
          doc="number of tile fetches into on-chip memory (shared memory on "
              "Hopper) — analogue of DTLB_MISSES")
def _vmem_refills(x):
    return torch.sum(_f32(x))


@register("MXU_PASSES", EXTENSIVE, moments=("sum",), finalize=_sum_finalizer,
          doc="number of 128^3 tile products (the TPU's matrix-unit pass; "
              "no Hopper instruction) — analogue of SIMD_INST_RETIRED")
def _mxu_passes(x):
    return torch.sum(_f32(x))


@register("EST_STALL_CYCLES", EXTENSIVE, moments=("sum",),
          finalize=_sum_finalizer,
          doc="estimated memory-stall cycles (max(0, mem_time-compute_time) "
              "* clock) — analogue of RESOURCE_STALLS")
def _stall_cycles(x):
    return torch.sum(_f32(x))
