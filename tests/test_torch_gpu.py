"""The port's CUDA kernels against their plain versions, on the card.

Every test is marked ``gpu`` and skips itself (inside the ``cuda``
fixture) where no CUDA device is present.  The file imports neither JAX nor
the JAX package, so it also runs on a machine that has only PyTorch:

    python -m pytest -q --noconftest tests/test_torch_gpu.py

(``--noconftest``: the suite's conftest imports JAX.)  Tolerances: f32
sums in another order (probe moments: rtol 1e-5, atol 1e-4; attention:
atol 2e-5; GEMM: the reference's f32 tolerance, rtol 2e-4 and atol
2e-4 * sqrt(k), for bf16 operands too, whose products are exact in f32),
bf16 attention output within 2e-2 (a few bf16 ulps at 1.0).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import context, monitor
from repro_torch.kernels import flash_attn as fa
from repro_torch.kernels import gemm
from repro_torch.kernels import ops
from repro_torch.kernels import probe_reduce as pr

pytestmark = pytest.mark.gpu

SHAPES = [(1,), (1000,), (1024,), (64, 129), (7, 33, 65), (4, 1, 5120),
          (3, 77777)]
FA_CASES = [
    # b, sq, sk, h, kvh, d, causal, window
    (2, 128, 128, 4, 4, 64, True, 0),
    (2, 128, 128, 4, 2, 64, True, 0),
    (1, 256, 256, 2, 1, 32, True, 0),
    (1, 128, 384, 2, 2, 64, True, 0),
    (2, 128, 128, 4, 4, 64, False, 0),
    (1, 256, 256, 2, 2, 64, True, 64),
    (1, 64, 192, 1, 1, 128, True, 0),
    (1, 200, 200, 4, 2, 64, True, 0),
    (2, 77, 301, 2, 1, 128, True, 48),
    (1, 33, 20, 2, 2, 16, True, 0),
]
GEMM_CASES = [
    # schedule, (m, n, k), blocking: tests/test_kernels.py GEMM_SHAPES at
    # 128, then one non-square shape per schedule at the case study's
    # blockings
    *[(s, shape, (128, 128, 128)) for s in gemm.SCHEDULES
      for shape in ((128, 128, 128), (256, 128, 384), (512, 256, 128),
                    (128, 512, 256))],
    ("cache_blocked", (512, 384, 192), (256, 128, 64)),
    ("panel_streaming", (384, 768, 160), (128, 256, 256)),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device for the hand-written kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _normal(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    x.flat[:: max(1, x.size // 17)] = 0.0
    return torch.from_numpy(x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("shape", SHAPES)
def test_probe_moments_matches_plain(cuda, shape, dtype):
    x = _normal(shape).to(cuda, dtype)
    for ent in (False, True):
        xe = x.abs() if ent else x
        got = pr.probe_moments(xe, with_entropy=ent).cpu()
        want = pr.moments_plain(xe, with_entropy=ent).cpu()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


def test_probe_moments_nan_inf_strided_and_empty(cuda):
    a = torch.tensor([float("nan"), 1.5, float("inf"), float("-inf"), 0.0]
                     * 64, device=cuda)
    got = pr.probe_moments(a).cpu().numpy()
    np.testing.assert_allclose(got, pr.moments_plain(a).cpu().numpy(),
                               equal_nan=True)
    assert np.isnan(got[pr.M_MAX_ABS])
    before = pr.probe_moments.copies
    xt = _normal((64, 300)).to(cuda).t()
    torch.testing.assert_close(pr.probe_moments(xt).cpu(),
                               pr.moments_plain(xt).cpu(), rtol=1e-5,
                               atol=1e-4)
    assert pr.probe_moments.copies == before + 1
    launches = pr.probe_moments.launches
    assert not pr.probe_moments(torch.zeros((0, 4), device=cuda)).any()
    assert pr.probe_moments.launches == launches  # empty: no launch
    with pytest.raises(TypeError):
        pr.probe_moments(torch.ones(4, dtype=torch.int32, device=cuda))


def test_tensor_moments_uses_the_kernel_at_every_size(cuda):
    for n in (1, 5120, 1 << 20):
        before = pr.probe_moments.launches
        d = ops.tensor_moments(torch.ones(n, device=cuda), ("sum",))
        assert pr.probe_moments.launches == before + 1
        assert float(d["sum"]) == n and d["numel"] == n
    before = pr.probe_moments.launches
    d = ops.tensor_moments(torch.ones(1 << 20, device=cuda), ("numel",))
    assert pr.probe_moments.launches == before  # nothing to sweep
    assert d["numel"] == 1 << 20


@pytest.mark.parametrize("b,sq,sk,h,kvh,d,causal,win", FA_CASES)
def test_flash_attention_matches_plain(cuda, b, sq, sk, h, kvh, d, causal,
                                       win):
    q = _normal((b, sq, h, d), 1).to(cuda)
    k = _normal((b, sk, kvh, d), 2).to(cuda)
    v = _normal((b, sk, kvh, d), 3).to(cuda)
    got = fa.flash_attention(q, k, v, causal=causal, window=win)
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=win)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=0)


def test_flash_attention_bf16_and_strided(cuda):
    q = _normal((2, 384, 8, 128), 1).to(cuda, torch.bfloat16)
    k = _normal((2, 384, 2, 128), 2).to(cuda, torch.bfloat16)
    v = _normal((2, 384, 2, 128), 3).to(cuda, torch.bfloat16)
    got = fa.flash_attention(q, k, v)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(),
                               fa.flash_attention_plain(q, k, v).float(),
                               atol=2e-2, rtol=0)
    qs = q.transpose(1, 2).contiguous().transpose(1, 2)  # strided, no copy
    before = fa.flash_attention.copies
    torch.testing.assert_close(fa.flash_attention(qs, k, v), got)
    assert fa.flash_attention.copies == before


def test_monitor_on_card_matches_cpu(cuda):
    spec = context.spec_from_mapping(
        {"f": [["ACT_RMS:x", "NUMEL:x"], ["ACT_MAX_ABS:x", "NAN_COUNT:x"]],
         "g": ["MEAN:y", "ATTN_ENTROPY:p"]})
    xs = [_normal((3, 1000), i) for i in range(4)]

    def run(dev):
        mon = monitor.Monitor(spec, device=dev)
        ms = mon.init()

        def f(x):
            from repro_torch import core as scalpel

            with scalpel.function("f"):
                scalpel.probe(x=x)
            with scalpel.function("g"):
                scalpel.probe(y=x * 2, p=torch.softmax(x, -1))

        step = mon.wrap(f)
        for x in xs:
            _, ms = step(ms, x.to(dev))
        return ms

    a, b = run(torch.device("cpu")), run(cuda)
    assert torch.equal(a.calls, b.calls) and torch.equal(a.samples, b.samples)
    torch.testing.assert_close(a.values, b.values.cpu(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("schedule,shape,blk", GEMM_CASES)
def test_gemm_kernels_match_plain(cuda, schedule, shape, blk, dtype):
    m, n, k = shape
    bm, bn, bk = blk
    a = _normal((m, k), 4).to(cuda, dtype)
    b = _normal((k, n), 5).to(cuda, dtype)
    kernel = (gemm.cache_blocked_matmul if schedule == "cache_blocked"
              else gemm.panel_streaming_matmul)
    before = kernel.launches
    got = ops.matmul(a, b, schedule, bm=bm, bn=bn, bk=bk)
    assert kernel.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (m, n)
    torch.testing.assert_close(got, gemm.matmul_plain(a, b), rtol=2e-4,
                               atol=2e-4 * np.sqrt(k))


def test_gemm_schedules_agree(cuda):
    a = _normal((256, 256), 6).to(cuda)
    b = _normal((256, 256), 7).to(cuda)
    c1 = ops.matmul(a, b, "cache_blocked", bm=128, bn=128, bk=128)
    c2 = ops.matmul(a, b, "panel_streaming", bm=128, bn=128)
    torch.testing.assert_close(c1, c2, rtol=0, atol=2e-4)


def test_gemm_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    a = _normal((256, 256), 8).to(cuda)
    with pytest.raises(ValueError, match="contiguous"):
        gemm.cache_blocked_matmul(a.t(), a, bm=128, bn=128, bk=128)
    with pytest.raises(ValueError, match="shared memory"):
        gemm.panel_streaming_matmul(torch.zeros(128, 384, device=cuda),
                                    torch.zeros(384, 256, device=cuda),
                                    bm=128, bn=256)
    with pytest.raises(TypeError):
        gemm.cache_blocked_matmul(a, a.bfloat16(), bm=128, bn=128, bk=128)
