"""The port's GEMM slice against the JAX package's, on the CPU.

The same numpy inputs go through both packages:

* ``ops.matmul`` (the reference's Pallas kernels in interpret mode, the
  port's plain version) over GEMM_SHAPES x both schedules x {f32, bf16},
  with the reference's tolerances (tests/test_kernels.py: TOL, atol
  TOL * sqrt(k));
* ``schedule_cost`` exactly, but for EST_STALL_CYCLES, which is held to the
  reference's formula with the H100's constants;
* the case study's monitored DGEMM step (the reference's
  ``benchmarks.case_study._dgemm_step`` at the port's blockings): every
  (scope, event) estimate within rtol 1e-4 (f32 sums in another order)
  but EST_STALL_CYCLES, which the card's constants make 0 here; calls and
  samples exact, plan text and fingerprint byte-equal.
"""
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as ref_scalpel
from repro.core import counters as ref_counters
from repro.core import plan as ref_plan
from repro.kernels import ops as ref_ops
from repro_torch import case_study as cs
from repro_torch.core import plan as plan_lib
from repro_torch.core import report as report_lib
from repro_torch.kernels import gemm
from repro_torch.kernels import ops

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from benchmarks import case_study as ref_cs  # noqa: E402

GEMM_SHAPES = [  # tests/test_kernels.py
    (128, 128, 128),
    (256, 128, 384),
    (512, 256, 128),
    (128, 512, 256),
]
TOL = {"float32": 2e-4, "bfloat16": 2e-1}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
_CPU_SIZE = cs.SIZES["cpu"]


def _pair(shape, seed, dtype):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    jd, td = DTYPES[dtype]
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("m,n,k", GEMM_SHAPES)
@pytest.mark.parametrize("schedule", gemm.SCHEDULES)
def test_matmul_matches_reference(schedule, m, n, k, dtype):
    ja, ta = _pair((m, k), 0, dtype)
    jb, tb = _pair((k, n), 1, dtype)
    want = np.asarray(ref_ops.matmul(ja, jb, schedule, bm=128, bn=128,
                                     bk=128))
    got = ops.matmul(ta, tb, schedule, bm=128, bn=128, bk=128)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL[dtype],
                               atol=TOL[dtype] * np.sqrt(k))


COST_CASES = [
    # schedule, (m, n, k), (bm, bn, bk)
    ("cache_blocked", (16384, 16384, 256), (128, 128, 128)),
    ("cache_blocked", (16384, 16384, 256), (256, 128, 64)),
    ("panel_streaming", (16384, 16384, 256), (128, 256, 256)),
    ("cache_blocked", (256, 256, 256), (256, 128, 64)),
    ("panel_streaming", (256, 256, 256), (128, 256, 256)),
    ("cache_blocked", (2048, 2048, 2048), (256, 256, 256)),
    ("panel_streaming", (2048, 2048, 2048), (256, 256, 256)),
    # a thin K: memory-bound at the card's rates, so the stall term is live
    ("cache_blocked", (2048, 2048, 32), (128, 128, 32)),
    ("panel_streaming", (2048, 2048, 32), (128, 128, 32)),
]


@pytest.mark.parametrize("schedule,shape,blk", COST_CASES)
def test_schedule_cost_matches_reference(schedule, shape, blk):
    m, n, k = shape
    bm, bn, bk = blk
    want = ref_ops.matmul_cost(schedule, m, n, k, bm=bm, bn=bn, bk=bk)
    got = ops.matmul_cost(schedule, m, n, k, bm=bm, bn=bn, bk=bk)
    assert set(got) == set(want)
    for key in want:
        if key != "EST_STALL_CYCLES":
            assert got[key] == want[key], key
    t_mem, t_ops = got["HBM_BYTES"] / 3.35e12, got["FLOPS"] / 67e12
    assert got["EST_STALL_CYCLES"] == max(0.0, t_mem - t_ops) * 1.98e9
    if k == 32:
        assert got["EST_STALL_CYCLES"] > 0


def _ref_step_estimates(impl, multiplexed, a_np, b_np, n_calls, period):
    spec = ref_cs._spec(multiplexed, period)
    step, cost = ref_cs._dgemm_step(cs.IMPLS[impl], *_CPU_SIZE, spec)
    state = ref_counters.CounterState.zeros(spec)
    mp = ref_counters.MonitorParams.all_on(spec)
    a, b = jnp.asarray(a_np), jnp.asarray(b_np)
    for i in range(n_calls):
        scale = 1.0 + 0.1 * np.sin(0.37 * i)
        _, state = step(a * np.float32(scale), b, state, mp)
    return spec, cost, ref_scalpel.build(spec, state)


def _port_step_estimates(impl, multiplexed, a_np, b_np, n_calls, period):
    spec = cs.spec(multiplexed, period)
    step, cost = cs.dgemm_step(cs.IMPLS[impl], *_CPU_SIZE, spec, "cpu")
    mstate = step.monitor.init()
    a, b = torch.from_numpy(a_np), torch.from_numpy(b_np)
    for i in range(n_calls):
        scale = float(np.float32(1.0 + 0.1 * np.sin(0.37 * i)))
        _, mstate = step(a * scale, b, mstate)
    return spec, cost, report_lib.build(spec, mstate)


@pytest.mark.filterwarnings("ignore::DeprecationWarning")  # ref's collecting
@pytest.mark.parametrize("multiplexed", [False, True])
@pytest.mark.parametrize("impl", list(cs.IMPLS))
def test_case_study_step_matches_reference(impl, multiplexed):
    m, n, k = _CPU_SIZE
    rng = np.random.default_rng(7)
    a_np = rng.normal(size=(m, k)).astype(np.float32)
    b_np = rng.normal(size=(k, n)).astype(np.float32)
    rs, rcost, want = _ref_step_estimates(impl, multiplexed, a_np, b_np, 10, 2)
    ps, pcost, got = _port_step_estimates(impl, multiplexed, a_np, b_np, 10, 2)
    assert plan_lib.describe_plans(ps) == ref_plan.describe_plans(rs)
    assert plan_lib.spec_fingerprint(ps) == ref_plan.spec_fingerprint(rs)
    for key in rcost:
        if key != "EST_STALL_CYCLES":
            assert pcost[key] == rcost[key], key
    assert [r.scope for r in got] == [r.scope for r in want] == ["dgemm"]
    assert got[0].calls == want[0].calls == 10
    for g, w in zip(got[0].slots, want[0].slots, strict=True):
        assert (g.slot_id, g.samples, g.calls) == (w.slot_id, w.samples,
                                                   w.calls)
        # multiplexed at period 2, each of the 5 sets runs on 2 of 10 calls
        assert g.samples == (2 if multiplexed else 10)
        if g.slot_id == "EST_STALL_CYCLES:stalls":
            assert g.estimate == 0.0  # compute-bound at the card's rates
            continue
        np.testing.assert_allclose(g.estimate, w.estimate, rtol=1e-4)


def test_case_study_main_on_cpu(capsys):
    results = cs.main(fast=True, device="cpu")
    out = capsys.readouterr().out
    assert len(results) == 2 * len(cs.IMPLS)
    assert {(r["impl"], r["mode"]) for r in results} == {
        (i, mode) for i in cs.IMPLS for mode in ("exhaustive", "sampling")}
    for r in results:
        assert r["device"] == "cpu" and r["calls"] == 200
        assert all(np.isfinite(v) for v in r["estimates"].values())
    g = next(r for r in results if r["impl"] == "goto")["estimates"]
    a0 = next(r for r in results if r["impl"] == "atlas_default")["estimates"]
    assert g["HBM_BYTES:hbm"] < a0["HBM_BYTES:hbm"]
    assert g["VMEM_TILE_REFILLS:refills"] < a0["VMEM_TILE_REFILLS:refills"]
    assert g["FLOPS:flops"] == a0["FLOPS:flops"]
    assert "FLOPS identical: True" in out
    assert "max sampling error" in out


def test_panel_streaming_refuses_a_panel_over_shared_memory():
    """Goto's trade-off: the resident panel bm*K (padded) plus the B stage
    must fit 227 KB; bf16 halves the panel."""
    a, b = torch.zeros(128, 384), torch.zeros(384, 256)
    with pytest.raises(ValueError, match="shared memory"):
        gemm.panel_streaming_matmul(a, b, bm=128, bn=256)
    with pytest.raises(ValueError, match="shared memory"):
        ops.matmul(a, b, "panel_streaming", bm=128, bn=256)
    assert gemm.smem_bytes("panel_streaming", 384, 128, 256, None, 4) > \
        gemm.MAX_SMEM_BYTES
    assert gemm.smem_bytes("panel_streaming", 352, 128, 256, None, 4) <= \
        gemm.MAX_SMEM_BYTES
    # the panel fits at K=352, and in bf16 at K=384: the wrapper then asks
    # for CUDA tensors
    for x, y in ((torch.zeros(128, 352), torch.zeros(352, 256)),
                 (a.bfloat16(), b.bfloat16())):
        with pytest.raises(ValueError, match="CUDA"):
            gemm.panel_streaming_matmul(x, y, bm=128, bn=256)


def test_blockings_the_card_cannot_run_are_refused():
    a, b = torch.zeros(256, 256), torch.zeros(256, 256)
    # the reference's atlas_full: a 256 x 256 f32 accumulator per block
    with pytest.raises(ValueError, match="no kernel for blocking"):
        ops.matmul(a, b, "cache_blocked", bm=256, bn=256, bk=256)
    with pytest.raises(ValueError, match="not a multiple"):
        ops.matmul(torch.zeros(192, 256), b, "cache_blocked", bm=128, bn=128,
                   bk=128)
    with pytest.raises(KeyError):
        ops.matmul(a, b, "strassen", bm=128, bn=128, bk=128)
    with pytest.raises(TypeError):
        gemm.cache_blocked_matmul(a.half(), b.half(), bm=128, bn=128, bk=128)
