"""The port's spec/plan layer and eager monitor against the JAX package's.

``describe_plans`` text and ``spec_fingerprint`` must be byte-equal for the
specs of tests/test_plan.py; the per-set plans, the slot layout and the
counters of a multiplexed, masked monitored loop must match the
reference's (values rtol 1e-5: f32 sums in another order; calls and
samples exact).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as ref_scalpel
from repro.core import context as ref_ctx
from repro.core import counters as ref_counters
from repro.core import plan as ref_plan
from repro_torch import core as scalpel
from repro_torch.core import context as ctx_lib
from repro_torch.core import counters as counters_lib
from repro_torch.core import plan as plan_lib

SIX = ("ACT_RMS", "ACT_MEAN_ABS", "ACT_MAX_ABS", "ACT_ZERO_FRAC",
       "NAN_COUNT", "INF_COUNT")


def _sparse_ctx(m, scope="hot", period=1):
    return m.ScopeContext.multiplexed(scope, [
        [m.EventSpec("ACT_MAX_ABS", "x")],
        [m.EventSpec("ACT_ZERO_FRAC", "x")],
        [m.EventSpec("ACT_RMS", "x"), m.EventSpec("MEAN", "x")],
    ], period=period)


def _specs(m):
    """The specs of tests/test_plan.py, built from one package's classes."""
    E, C, S = m.EventSpec, m.ScopeContext, m.MonitorSpec
    return {
        "sparse": S.of([_sparse_ctx(m)]),
        "sparse_p5": S.of([_sparse_ctx(m, period=5)]),
        "swapped": S.of([_sparse_ctx(m)]).with_context(
            C.exhaustive("hot", [E("MEAN", "x")])),
        "uneven": S.of([
            C.exhaustive("wide", [E(e, "x") for e in SIX]),
            C.exhaustive("narrow", [E("MEAN", "x")]),
            C.exhaustive("dark", []),
        ]),
        "bespoke_a": S.of([C.exhaustive("s", [E("SSM_STATE_RMS", "h")])]),
        "bespoke_b": S.of([C.exhaustive("s", [E("MOE_LOAD", subevent="CV")])]),
        "hot_cold": S.of([_sparse_ctx(m),
                          C.exhaustive("cold", [E("MEAN", "x")])]),
        "fused_split": S.of([C.exhaustive("g", [
            E("ACT_RMS", "y"), E("ATTN_ENTROPY", "p"),
            E("MOE_LOAD", subevent="CV")])]),
        "dedup": S.of([C.multiplexed("d", [
            [E("ACT_RMS", "a")], [E("ACT_RMS", "b")], [E("MEAN", "a")]])]),
        "mapping": m.spec_from_mapping(
            {"f": [["ACT_RMS:x", "NUMEL:x"], ["L2NORM:x"]], "g": ["MEAN"]},
            periods={"f": 3}),
    }


@pytest.mark.parametrize("name", sorted(_specs(ctx_lib)))
def test_describe_plans_and_fingerprint_byte_equal(name):
    spec, rspec = _specs(ctx_lib)[name], _specs(ref_ctx)[name]
    assert plan_lib.describe_plans(spec) == ref_plan.describe_plans(rspec)
    assert plan_lib.spec_fingerprint(spec) == ref_plan.spec_fingerprint(rspec)
    assert spec.fingerprint == rspec.fingerprint


def test_fingerprint_stable_and_plan_sensitive():
    s = _specs(ctx_lib)
    assert s["sparse"].fingerprint == s["sparse_p5"].fingerprint
    assert s["sparse"].fingerprint != s["swapped"].fingerprint
    assert s["bespoke_a"].fingerprint != s["bespoke_b"].fingerprint


@pytest.mark.parametrize("avail", [{"x"}, {"other"}, {"y", "p", "router_probs"},
                                   {"a"}, {"a", "b"}])
def test_scope_plans_match_reference(avail):
    for name, spec in _specs(ctx_lib).items():
        rspec = _specs(ref_ctx)[name]
        for c, rc in zip(spec.contexts, rspec.contexts):
            sp = plan_lib.compile_scope_plans(c, frozenset(avail))
            rsp = ref_plan.compile_scope_plans(rc, frozenset(avail))
            assert [p.describe() for p in sp.plans] == \
                [p.describe() for p in rsp.plans]
            assert sp.branch_index == rsp.branch_index
            assert sp.any_live == rsp.any_live


def test_slot_layout_and_compact_roundtrip():
    spec = _specs(ctx_lib)["uneven"]
    lay = plan_lib.spec_layout(spec)
    rlay = ref_plan.spec_layout(_specs(ref_ctx)["uneven"])
    assert (lay.offsets, lay.widths, lay.total) == \
        (rlay.offsets, rlay.widths, rlay.total)
    state = counters_lib.CounterState.zeros(spec, "cpu")
    state.calls[0] = 3
    state.values[0, 2], state.values[1, 0] = 5.0, 7.0
    state.samples[0, 2], state.samples[1, 0] = 2, 1
    compact = plan_lib.CompactDelta.compress(spec, state)
    assert tuple(compact.values.shape) == (7,)
    back = compact.expand(spec)
    for a, b in ((back.calls, state.calls), (back.values, state.values),
                 (back.samples, state.samples)):
        torch.testing.assert_close(a, b)


def _mux_spec(m):
    E, C = m.EventSpec, m.ScopeContext
    return m.MonitorSpec.of([
        _sparse_ctx(m, "layer/hot", period=2),
        C.exhaustive("layer/wide", [E(e, "x") for e in SIX]),
        C.exhaustive("layer", []),
        C.exhaustive("head", [E("ACT_RMS", "y"), E("ATTN_ENTROPY", "p")]),
    ])


def _mux_params(params_cls, spec):
    p = params_cls.all_on(spec).set_period(spec, "layer/hot", 2)
    return p.set_slot(spec, "layer/wide", "ACT_ZERO_FRAC:x", False)


def _run_ref(xs, steps):
    spec = _mux_spec(ref_ctx)
    params = _mux_params(ref_counters.MonitorParams, spec)
    mon = ref_scalpel.Monitor(spec, params, counter_axes=())

    def step(xs):
        def body(c, x):
            with ref_scalpel.function("layer"):
                with ref_scalpel.function("hot"):
                    ref_scalpel.probe(x=x + c)
                with ref_scalpel.function("wide"):
                    ref_scalpel.probe(x=x * 2.0)
            return c + 1.0, None

        ref_scalpel.scan_with_counters(body, jnp.zeros(()), xs)
        with ref_scalpel.function("head"):
            p = jax.nn.softmax(xs[0].reshape(4, -1), axis=-1)
            ref_scalpel.probe(y=xs[1], p=p)

    wrapped = mon.wrap(step)
    ms = mon.init()
    for i in range(steps):
        if i == steps - 1:  # a runtime swap: mask the head scope off
            ms = mon.sync(ms, params=ms.params.enable(spec, "head", False))
        _, ms = wrapped(ms, jnp.asarray(xs[i]))
    return ms


def _run_port(xs, steps):
    spec = _mux_spec(ctx_lib)
    params = _mux_params(counters_lib.MonitorParams, spec)
    mon = scalpel.Monitor(spec, params, device="cpu")

    def step(xs):
        def body(c, x):
            with scalpel.function("layer"):
                with scalpel.function("hot"):
                    scalpel.probe(x=x + c)
                with scalpel.function("wide"):
                    scalpel.probe(x=x * 2.0)
            return c + 1.0, None

        scalpel.scan_with_counters(body, torch.zeros(()), xs)
        with scalpel.function("head"):
            p = torch.softmax(xs[0].reshape(4, -1), dim=-1)
            scalpel.probe(y=xs[1], p=p)

    wrapped = mon.wrap(step)
    ms = mon.init()
    for i in range(steps):
        if i == steps - 1:
            ms = mon.sync(ms, params=ms.params.enable(spec, "head", False))
        _, ms = wrapped(ms, torch.from_numpy(xs[i]))
    return ms, mon


def test_multiplexed_monitor_counters_match_reference():
    rng = np.random.default_rng(0)
    steps = 5
    xs = rng.normal(size=(steps, 3, 64)).astype(np.float32)
    xs[:, :, :7] = 0.0
    rms = _run_ref(xs, steps)
    pms, mon = _run_port(xs, steps)
    np.testing.assert_array_equal(pms.calls.numpy(), np.asarray(rms.calls))
    np.testing.assert_array_equal(pms.samples.numpy(),
                                  np.asarray(rms.samples))
    np.testing.assert_allclose(pms.values.numpy(), np.asarray(rms.values),
                               rtol=1e-5, atol=1e-6)
    assert pms.step == int(rms.step) == steps
    # every event set of the multiplexed scope was sampled
    hot = [pms.samples[mon.spec.slot_lane("layer/hot", sid)].item()
           for sid in mon.spec.context("layer/hot").slot_ids]
    assert min(hot) > 0
    est = mon.estimates(pms)
    assert est["layer/wide"]["ACT_ZERO_FRAC:x"] != est["layer/wide"][
        "ACT_ZERO_FRAC:x"]  # slot masked off: never sampled (nan estimate)


def test_runtime_keeps_references_and_reports():
    spec = _specs(ctx_lib)["hot_cold"]
    rt = scalpel.ScalpelRuntime(spec, device="cpu")
    mon = scalpel.Monitor(spec, rt.params, device="cpu")

    def f(x):
        with scalpel.function("hot"):
            scalpel.probe(x=x)
        with scalpel.function("cold"):
            scalpel.probe(x=x)

    ms = mon.init()
    step = mon.wrap(f)
    for _ in range(3):
        _, ms = step(mon.sync(ms, runtime=rt), torch.full((8,), 2.0))
        rt.on_step(ms.counters)
    assert rt.state is not None and rt.steps == 3
    rt.set_params(rt.params.enable(spec, "cold", False))
    _, ms = step(mon.sync(ms, runtime=rt), torch.full((8,), 2.0))
    rt.observe(ms.counters)
    assert rt.plan_fingerprint == spec.fingerprint
    assert "total live footprint" in rt.describe_plans()
    est = rt.estimates()
    assert est["cold"]["MEAN:x"] == pytest.approx(2.0)
    assert est["hot"]["ACT_MAX_ABS:x"] == pytest.approx(2.0)
    text = rt.report()
    assert "[cold] calls=4" in text and "samples=3" in text
