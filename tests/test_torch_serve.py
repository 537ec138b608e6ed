"""The port's monitored serving slice against the JAX package's, end to end.

qwen3-14b SMOKE in f32 with ``attn_impl="pallas"``: the reference's
params carry across with ``params_from_jax``; a 288-token prompt takes the
flash route (the reference's Pallas kernel in interpret mode, the port's
plain version on the CPU) and a 32-token one the materialized-probs route.
Greedy tokens must be equal, logits within atol 1e-4 (f32, sums in another
order), every (scope, event) counter within rtol 1e-4, and the ``calls``
lanes exact.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import model_config as ref_model_config
from repro.core.plan import describe_plans as ref_describe_plans
from repro.models.registry import Arch as RefArch
from repro.serve.engine import Engine as RefEngine
from repro.serve.engine import ServeConfig as RefServeConfig
from repro.serve.engine import _discover_spec as ref_discover_spec
from repro_torch.configs import model_config
from repro_torch.core.plan import describe_plans
from repro_torch.models import Arch
from repro_torch.models.params import params_from_jax
from repro_torch.serve.engine import Engine, ServeConfig, _discover_spec

SERVE_FINGERPRINT = "67589f4aeabd570eb71efa15b70b83fce04c9587"
CACHE_LEN = 320
MAX_NEW = 4


@pytest.fixture(scope="module")
def engines():
    rcfg = ref_model_config("qwen3_14b", smoke=True, attn_impl="pallas")
    rarch = RefArch(rcfg)
    rparams = rarch.init(jax.random.PRNGKey(0))
    ref = RefEngine(rarch, rparams,
                    RefServeConfig(cache_len=CACHE_LEN, max_new_tokens=MAX_NEW))
    cfg = model_config("qwen3_14b", smoke=True)
    arch = Arch(cfg)
    params = params_from_jax(jax.device_get(rparams), cfg, "cpu")
    port = Engine(arch, params, ServeConfig(cache_len=CACHE_LEN,
                                            max_new_tokens=MAX_NEW))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=(2, 288)),
               rng.integers(0, cfg.vocab, size=(2, 32))]
    outs = []
    for p in prompts:
        r, _ = ref.generate({"tokens": jax.numpy.asarray(p, np.int32)})
        t, _ = port.generate({"tokens": torch.from_numpy(p)})
        outs.append((np.asarray(r), t.numpy()))
    yield {"ref": ref, "port": port, "rarch": rarch, "rparams": rparams,
           "arch": arch, "params": params, "prompts": prompts, "outs": outs}
    ref.runtime.close()


def test_serve_spec_fingerprint_matches_reference():
    for smoke in (True, False):
        scfg = ServeConfig()
        spec = _discover_spec(Arch(model_config("qwen3_14b", smoke=smoke)),
                              scfg)
        rspec = ref_discover_spec(
            RefArch(ref_model_config("qwen3_14b", smoke=smoke)),
            RefServeConfig())
        assert describe_plans(spec) == ref_describe_plans(rspec)
        assert spec.fingerprint == rspec.fingerprint == SERVE_FINGERPRINT


def test_serve_greedy_tokens_equal_reference(engines):
    for r, t in engines["outs"]:
        assert t.shape == r.shape == (2, MAX_NEW)
        np.testing.assert_array_equal(t, r)


def test_serve_counters_match_reference(engines):
    ref, port = engines["ref"], engines["port"]
    rm, pm = ref.mstate, port.mstate
    np.testing.assert_array_equal(pm.calls.numpy(), np.asarray(rm.calls))
    np.testing.assert_array_equal(pm.samples.numpy(), np.asarray(rm.samples))
    np.testing.assert_allclose(pm.values.numpy(), np.asarray(rm.values),
                               rtol=1e-4)
    assert pm.step == int(rm.step) == 2 * (1 + MAX_NEW)
    # the flash route never materializes probs, so only the short prompt's
    # prefill sampled them — in both packages
    lane = port.spec.slot_lane("layer/attn", "ACT_RMS:probs")
    assert pm.samples[lane] == 2  # 2 layers x 1 prefill
    assert "ScALPEL serving report" in port.report()


def test_prefill_and_decode_logits_match_reference(engines):
    rarch, rparams = engines["rarch"], engines["rparams"]
    arch, params = engines["arch"], engines["params"]
    for p in engines["prompts"]:
        rcache, rlog = rarch.prefill(rparams, {"tokens": jax.numpy.asarray(
            p, np.int32)}, cache_len=CACHE_LEN)
        with torch.inference_mode():
            cache, log = arch.prefill(params, {"tokens": torch.from_numpy(p)},
                                      cache_len=CACHE_LEN)
        np.testing.assert_allclose(log.numpy(), np.asarray(rlog), atol=1e-4)
        tok = np.argmax(np.asarray(rlog)[:, -1], axis=-1)[:, None]
        rlog2, _ = rarch.decode_step(rparams, rcache,
                                     jax.numpy.asarray(tok, np.int32))
        with torch.inference_mode():
            log2, cache2 = arch.decode_step(params, cache,
                                            torch.from_numpy(tok))
        np.testing.assert_allclose(log2.numpy(), np.asarray(rlog2), atol=1e-4)
        assert cache2["pos"] == p.shape[1] + 1


def test_serve_seeded_sampling_is_reproducible(engines):
    port = engines["port"]
    p = torch.from_numpy(engines["prompts"][1])
    port.cfg.temperature = 0.8
    try:
        a, _ = port.generate({"tokens": p}, seed=7)
        port.generate({"tokens": p})  # unseeded traffic in between
        b, _ = port.generate({"tokens": p}, seed=7)
    finally:
        port.cfg.temperature = 0.0
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    empty, _ = port.generate({"tokens": p}, max_new=0)
    assert tuple(empty.shape) == (2, 0)


def test_port_imports_no_jax():
    """The port and chip_smoke.py import neither JAX nor the JAX package."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys, runpy\n"
        "import repro_torch.serve.engine, repro_torch.kernels.ops\n"
        f"runpy.run_path({os.path.join(root, 'chip_smoke.py')!r})\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)
