"""Paper §4.2 case study (Table 2 / Fig. 4) on the card: two GEMM
implementations compared through ScALPEL counters, with call-count event
multiplexing.

    PYTHONPATH=src python -m repro_torch.case_study                     # the card
    PYTHONPATH=src python -m repro_torch.case_study --device cpu --fast

The port of the JAX package's ``benchmarks/case_study.py``.  LINPACK's
dominant kernel is DGEMM; the paper instruments ATLAS's ``ATL_dgemm`` and
GotoBLAS's ``dgemm_`` and cycles through five event sets every 100 calls,
showing that (a) the sampled counters match five exhaustive runs within a
marginal error and (b) the counters explain why one implementation is
faster.  Here the implementations are the two hand-written GEMM schedules
(``kernels/gemm.py``: cache_blocked ≙ ATLAS, panel_streaming ≙ GotoBLAS)
and the counters are the schedule's cost events

    VMEM_TILE_REFILLS ≙ DTLB_MISSES     HBM_BYTES ≙ L2_LINES_IN
    MXU_PASSES        ≙ SIMD_INST_RETIRED  FLOPS  ≙ INST_RETIRED
    EST_STALL_CYCLES  ≙ RESOURCE_STALLS

plus ACT_RMS / L2NORM / NUMEL of C, which need the live tensor.

On the card C = A @ B is 16384 x 16384 x 256 in f32: the trailing-matrix
update of an HPL factorisation at block size NB = 256, LINPACK's dominant
DGEMM.  On the CPU it is the reference's 256 x 256 x 256.  The blockings are
the card's (``IMPLS``); ``atlas_full`` is not the reference's 256^3, which
does not fit an SM.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from . import core as scalpel
from .core.context import EventSpec, MonitorSpec, ScopeContext
from .core.monitor import Monitor
from .kernels import ops

# the five multiplexed event sets (paper: five sets, one per exhaustive run)
EVENT_SETS = [
    ["VMEM_TILE_REFILLS:refills", "HBM_BYTES:hbm"],
    ["MXU_PASSES:mxu", "FLOPS:flops"],
    ["EST_STALL_CYCLES:stalls"],
    ["ACT_RMS:out", "L2NORM:out"],
    ["NUMEL:out"],
]

IMPLS = {
    "atlas_default": dict(schedule="cache_blocked", bm=128, bn=128, bk=128),
    "atlas_full": dict(schedule="cache_blocked", bm=256, bn=128, bk=64),
    "goto": dict(schedule="panel_streaming", bm=128, bn=256),
}

# (m, n, k) by device type
SIZES = {"cuda": (16384, 16384, 256), "cpu": (256, 256, 256)}
# (calls per run, multiplexing period) by ``fast``: period 20 still gives
# two full cycles over the five sets
RUNS = {False: (500, 100), True: (200, 20)}

# probe name -> cost key of the analytic scalars
_SCALARS = {"refills": "VMEM_TILE_REFILLS", "hbm": "HBM_BYTES",
            "mxu": "MXU_PASSES", "flops": "FLOPS",
            "stalls": "EST_STALL_CYCLES"}


def spec(multiplexed: bool, period: int = 100) -> MonitorSpec:
    sets = [[EventSpec.parse(s) for s in group] for group in EVENT_SETS]
    if multiplexed:
        ctx = ScopeContext.multiplexed("dgemm", sets, period=period)
    else:
        ctx = ScopeContext.exhaustive("dgemm", [e for g in sets for e in g])
    return MonitorSpec.of([ctx])


def dgemm_step(impl_cfg: dict, m: int, n: int, k: int, spec: MonitorSpec,
               device):
    """One instrumented DGEMM call, ``step(a, b, mstate) -> (c, mstate')``
    (its ``Monitor`` is ``step.monitor``), and the schedule's analytic cost.

    The cost is the reference's ``ops.matmul_cost`` with its default
    ``dtype_bytes=2``, so HBM_BYTES counts A and B at two bytes although the
    operands are f32 (kept for parity).  The five analytic scalars become
    device tensors here, once: a Python float made a CUDA tensor inside the
    loop would be a synchronous copy per call.
    """
    cost = ops.matmul_cost(
        impl_cfg["schedule"], m, n, k,
        bm=impl_cfg.get("bm", 256), bn=impl_cfg.get("bn", 256),
        bk=impl_cfg.get("bk", 256),
    )
    kw = {kk: vv for kk, vv in impl_cfg.items() if kk != "schedule"}
    scalars = {name: torch.tensor(cost[key], dtype=torch.float32,
                                  device=device)
               for name, key in _SCALARS.items()}
    mon = Monitor(spec, device=device)

    def step(a, b, mstate):
        with mon.open(mstate.params, calls_base=mstate.calls) as col:
            with scalpel.function("dgemm"):
                c = ops.matmul(a, b, impl_cfg["schedule"], **kw)
                scalpel.probe(out=c, **scalars)
        return c, mon.commit(mstate, col.compact_delta())

    step.monitor = mon
    return step, cost


def run_impl(impl: str, n_calls: int, m: int, n: int, k: int,
             multiplexed: bool, period: int = 100, device="cuda") -> dict:
    device = torch.device(device)
    sp = spec(multiplexed, period)
    step, cost = dgemm_step(IMPLS[impl], m, n, k, sp, device)
    mstate = step.monitor.init()
    gen = torch.Generator(device=device)
    a = torch.randn((m, k), generator=gen.manual_seed(0), device=device)
    b = torch.randn((k, n), generator=gen.manual_seed(1), device=device)
    # per-call input drift (LINPACK's DGEMM calls see varying panels):
    # deterministic scale so the sampled subset differs from the full set —
    # the data-dependent events then exercise the Fig. 4 error claim.
    t0 = time.perf_counter()
    for i in range(n_calls):
        scale = float(np.float32(1.0 + 0.1 * np.sin(0.37 * i)))
        c, mstate = step(a * scale, b, mstate)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    return {
        "impl": impl,
        "mode": "sampling" if multiplexed else "exhaustive",
        "device": _device_name(device),
        "calls": n_calls,
        "wall_s": round(wall, 3),
        "estimates": step.monitor.estimates(mstate)["dgemm"],
        "analytic": cost,
    }


def _device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def fmt_table(rows: list[dict], cols: list[str], title: str = "") -> str:
    if not rows:
        return f"== {title} ==\n(no rows)" if title else "(no rows)"
    w = {c: max(len(c), *(len(str(r.get(c, ""))) for r in rows)) for c in cols}
    lines = [f"== {title} =="] if title else []
    lines.append(" | ".join(c.ljust(w[c]) for c in cols))
    lines.append("-+-".join("-" * w[c] for c in cols))
    for r in rows:
        lines.append(" | ".join(str(r.get(c, "")).ljust(w[c]) for c in cols))
    return "\n".join(lines)


def _pick(results, impl, mode):
    return next(r for r in results if r["impl"] == impl and r["mode"] == mode)


def main(fast: bool = False, device="cuda") -> list[dict]:
    device = torch.device(device)
    m, n, k = SIZES[device.type]
    n_calls, period = RUNS[fast]
    print(f"case study: C = A @ B at {m}x{n}x{k} f32 on "
          f"{_device_name(device)}, {n_calls} calls per run", flush=True)
    results = [run_impl(impl, n_calls, m, n, k, multiplexed, period, device)
               for impl in IMPLS for multiplexed in (False, True)]
    report(results, period)
    return results


def report(results: list[dict], period: int) -> float:
    """Print the Table 2 and Fig. 4 analogues and the goto-vs-atlas_default
    conclusion of one exhaustive and one multiplexed run per implementation;
    return the maximum sampling error in percent."""
    # ---- Table 2: counter values per impl (sampling run) -----------------
    slot_ids = [s for g in EVENT_SETS for s in g]
    rows = []
    for sid in slot_ids:
        row = {"event": sid}
        for impl in IMPLS:
            row[impl] = f"{_pick(results, impl, 'sampling')['estimates'][sid]:.3e}"
        rows.append(row)
    print(fmt_table(rows, ["event"] + list(IMPLS),
                    title="Table 2 analogue: per-call counters, "
                          f"multiplexed sampling run (period={period})"))

    # ---- Fig. 4: sampling vs exhaustive error ------------------------------
    err_rows = []
    for impl in IMPLS:
        ex = _pick(results, impl, "exhaustive")["estimates"]
        sa = _pick(results, impl, "sampling")["estimates"]
        for sid in slot_ids:
            e, s = ex[sid], sa[sid]
            if not np.isfinite(e) or e == 0:
                continue
            err_rows.append({
                "impl": impl, "event": sid,
                "exhaustive": f"{e:.4e}", "sampled": f"{s:.4e}",
                "err_pct": round(100 * abs(s - e) / abs(e), 3),
            })
    print()
    print(fmt_table(err_rows,
                    ["impl", "event", "exhaustive", "sampled", "err_pct"],
                    title="Fig. 4 analogue: multiplexed sampling vs "
                          "exhaustive (error should be marginal)"))
    max_err = max(r["err_pct"] for r in err_rows)
    print(f"\nmax sampling error: {max_err:.3f}% "
          f"(paper: 'the error introduced by sampling is marginal')")

    # ---- the case-study argument: counters explain the trade-off ----------
    g = _pick(results, "goto", "sampling")["estimates"]
    a0 = _pick(results, "atlas_default", "sampling")["estimates"]
    print("\ncase-study conclusion (goto vs atlas_default):")
    print(f"  HBM_BYTES        (≙L2_LINES_IN):   "
          f"{100 * (g['HBM_BYTES:hbm'] / a0['HBM_BYTES:hbm'] - 1):+.1f}%")
    print(f"  VMEM_TILE_REFILLS(≙DTLB_MISSES):   "
          f"{100 * (g['VMEM_TILE_REFILLS:refills'] / a0['VMEM_TILE_REFILLS:refills'] - 1):+.1f}%")
    gs, a0s = g["EST_STALL_CYCLES:stalls"], a0["EST_STALL_CYCLES:stalls"]
    print(f"  EST_STALL_CYCLES (≙RESOURCE_STALLS): "
          + (f"{100 * (gs / max(a0s, 1e-9) - 1):+.1f}%" if gs or a0s
             else "0 in both (compute-bound at the card's f32 rate)"))
    print(f"  FLOPS identical: "
          f"{g['FLOPS:flops'] == a0['FLOPS:flops']}", flush=True)
    return max_err


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (the card, 16384x16384x256) or cpu (256^3)")
    p.add_argument("--fast", action="store_true",
                   help="200 calls per run, period 20 (the reference's "
                        "--fast)")
    args = p.parse_args()
    main(fast=args.fast, device=args.device)
