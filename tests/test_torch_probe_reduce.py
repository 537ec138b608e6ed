"""The port's probe-moment contract against the JAX package's.

The plain version (``moments_plain``) is held against the reference's
unfused oracle (``moments_ref``) and its Pallas kernel in interpret mode on
the cases of tests/test_probe_reduce.py: rtol 1e-5 (f32 sums taken in
another order; atol 1e-5 for sums near zero).  The CUDA kernel is held
against the plain version on the card (tests/test_torch_gpu.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import events as ref_events
from repro.core.context import EventSpec as RefEventSpec
from repro.kernels import ops as ref_ops
from repro.kernels import probe_reduce as ref_pr
from repro_torch.core import events
from repro_torch.core.context import EventSpec
from repro_torch.kernels import ops
from repro_torch.kernels import probe_reduce as pr

SHAPES = [(1024,), (1000,), (64, 129), (7, 33, 65), (1, 1)]
DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]
MOMENT_EVENTS = (
    "ACT_RMS", "ACT_MEAN_ABS", "ACT_MAX_ABS", "ACT_ZERO_FRAC",
    "NAN_COUNT", "INF_COUNT", "NUMEL", "L2NORM", "MEAN",
)


def _case(shape, seed=None):
    rng = np.random.default_rng(hash(shape) % 2**32 if seed is None else seed)
    x = rng.normal(size=shape).astype(np.float32)
    x.flat[:: max(1, x.size // 17)] = 0.0  # some exact zeros
    return x


def test_contract_matches_reference():
    assert pr.MOMENTS == ref_pr.MOMENTS
    assert pr.MOMENTS_ENT == ref_pr.MOMENTS_ENT
    assert pr.STATIC_CHANNELS == ref_pr.STATIC_CHANNELS
    assert pr.ENT_EPS == ref_pr.ENT_EPS
    assert events.CHANNELS == ref_events.CHANNELS
    assert events.registered() == ref_events.registered()
    for name in events.registered():
        a, b = events.lookup(name), ref_events.lookup(name)
        assert (a.kind, a.moments, a.wants_dict, a.subevents, a.requires) \
            == (b.kind, b.moments, b.wants_dict, b.subevents, b.requires)


@pytest.mark.parametrize("jdt,tdt", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_moments_plain_match_reference(shape, jdt, tdt):
    x = _case(shape)
    xj = jnp.asarray(x).astype(jdt)
    got = pr.moments_plain(torch.from_numpy(x).to(tdt)).numpy()
    want = np.asarray(ref_pr.moments_ref(xj))
    pallas = np.asarray(ref_ops.probe_moments(xj, block_rows=8,
                                              interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)
    assert got[pr.M_NUMEL] == x.size
    assert got[pr.M_ZERO] == want[pr.M_ZERO]


@pytest.mark.parametrize("shape", [(128,), (5, 33), (3, 7, 17)])
def test_entropy_channel_matches_reference(shape):
    rng = np.random.default_rng(11)
    z = rng.normal(size=shape).astype(np.float32)
    p = np.exp(z - z.max(-1, keepdims=True))
    p = (p / p.sum(-1, keepdims=True)).astype(np.float32)
    got = pr.moments_plain(torch.from_numpy(p), with_entropy=True).numpy()
    want = np.asarray(ref_pr.moments_ref(jnp.asarray(p), with_entropy=True))
    assert got.shape == (len(pr.MOMENTS_ENT),)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_nan_inf_propagation_matches_reference():
    a = np.array([np.nan, 1.5, np.inf, -np.inf, 0.0] * 64, np.float32)
    got = pr.moments_plain(torch.from_numpy(a)).numpy()
    want = np.asarray(ref_pr.moments_ref(jnp.asarray(a)))
    np.testing.assert_allclose(got, want, equal_nan=True)
    assert np.isnan(got[pr.M_MAX_ABS])  # max_abs propagates NaN too
    assert got[pr.M_NAN] == 64 and got[pr.M_INF] == 128


def test_named_moments_subset_and_static_channels():
    x = np.random.default_rng(3).normal(size=(513,)).astype(np.float32)
    want = np.asarray(ref_pr.moments_ref(jnp.asarray(x)))
    d = ops.tensor_moments(torch.from_numpy(x),
                           ("sum_sq", "max_abs", "zero_count"))
    for name in ("sum_sq", "max_abs", "zero_count", "numel"):
        np.testing.assert_allclose(float(d[name]),
                                   want[pr.MOMENTS.index(name)], rtol=1e-5)
    assert "sum_abs" not in d  # only the plan's channels on the CPU
    assert d["rows"] == 1.0
    d2 = ops.tensor_moments(torch.ones((4, 5, 8)), ("sum",))
    assert d2["rows"] == 20.0 and d2["numel"] == 160.0
    # empty tensors give the zero vector, as the reference's do
    np.testing.assert_array_equal(
        pr.moments_plain(torch.zeros((0, 3))).numpy(),
        np.asarray(ref_pr.moments_ref(jnp.zeros((0, 3)))))


@pytest.mark.parametrize("name", MOMENT_EVENTS + ("ATTN_ENTROPY",))
def test_finalizers_match_reference_events(name):
    rng = np.random.default_rng(5)
    z = rng.normal(size=(6, 40)).astype(np.float32)
    z[0, :5] = 0.0
    if name == "ATTN_ENTROPY":
        z = np.exp(z) / np.exp(z).sum(-1, keepdims=True)
    x = torch.from_numpy(z)
    spec = EventSpec(name, "x")
    want = float(ref_events.compute(RefEventSpec(name, "x"),
                                    {"x": jnp.asarray(z)}))
    moms = ops.tensor_moments(x, events.slot_channels(spec))
    fused = float(events.finalize_event(spec, moms, x.device))
    direct = float(events.compute(spec, {"x": x}))
    np.testing.assert_allclose(fused, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(direct, want, rtol=1e-5, atol=1e-6)


def test_kernel_wrapper_refuses_cpu_and_unknown_devices():
    with pytest.raises(ValueError, match="CUDA tensor"):
        pr.probe_moments(torch.ones(4))
    with pytest.raises(ValueError, match="no kernel or plain version"):
        ops.tensor_moments(torch.ones(4, device="meta"), ("sum",))
