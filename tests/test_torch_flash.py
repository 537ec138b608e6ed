"""The port's flash attention against the JAX package's.

``flash_attention_plain`` is held against the reference's Pallas kernel in
interpret mode (``repro.kernels.ops.flash_attention``) on FA_CASES of
tests/test_kernels.py, atol 2e-5 (f32, sums in another order).  Ragged
shapes, which the Pallas kernel does not take, are held against the
reference's materialized oracle ``repro.kernels.ref.attention``.  The CUDA
kernel is held against the plain version on the card (tests/test_torch_gpu.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_oracle
from repro_torch.kernels import flash_attn as fa
from repro_torch.kernels import ops

FA_CASES = [
    # b, sq, sk, h, kvh, d, causal, window
    (2, 128, 128, 4, 4, 64, True, 0),
    (2, 128, 128, 4, 2, 64, True, 0),      # GQA
    (1, 256, 256, 2, 1, 32, True, 0),      # MQA
    (1, 128, 384, 2, 2, 64, True, 0),      # kv prefix (prefill-with-cache)
    (2, 128, 128, 4, 4, 64, False, 0),     # bidirectional (encoder)
    (1, 256, 256, 2, 2, 64, True, 64),     # sliding window
    (1, 64, 192, 1, 1, 128, True, 0),      # single head, tall kv
]
RAGGED = [
    (1, 200, 200, 4, 2, 64, True, 0),
    (2, 77, 301, 2, 1, 128, True, 48),
    (1, 33, 20, 2, 2, 16, True, 0),        # sk < sq: leading rows see nothing
]


def _inputs(b, sq, sk, h, kvh, d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, sq, h, d)).astype(np.float32)
    k = rng.normal(size=(b, sk, kvh, d)).astype(np.float32)
    v = rng.normal(size=(b, sk, kvh, d)).astype(np.float32)
    return q, k, v


def _ref_oracle(q, k, v, causal, win):
    rep = q.shape[2] // k.shape[2]
    out = ref_oracle.attention(jnp.asarray(q), jnp.repeat(k, rep, axis=2),
                               jnp.repeat(v, rep, axis=2), causal=causal,
                               window=win)
    return np.asarray(out)


@pytest.mark.parametrize("b,sq,sk,h,kvh,d,causal,win", FA_CASES)
def test_plain_matches_reference_pallas(b, sq, sk, h, kvh, d, causal, win):
    q, k, v = _inputs(b, sq, sk, h, kvh, d)
    want = np.asarray(ref_ops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=win, block_q=64, block_kv=64, interpret=True))
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal, window=win)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


@pytest.mark.parametrize("b,sq,sk,h,kvh,d,causal,win", RAGGED)
def test_plain_ragged_matches_reference_oracle(b, sq, sk, h, kvh, d, causal,
                                               win):
    q, k, v = _inputs(b, sq, sk, h, kvh, d, seed=1)
    got = fa.flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal=causal,
                                   window=win).numpy()
    want = _ref_oracle(q, k, v, causal, win)
    np.testing.assert_allclose(got, want, atol=2e-5)
    if sk < sq:
        assert not got[:, : sq - sk].any()  # rows with no visible key


def test_plain_bf16_keeps_dtype():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _inputs(1, 64, 64, 2, 1, 32))
    out = fa.flash_attention_plain(q, k, v)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape


def test_kernel_wrapper_checks_inputs():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 8, 8, 2, 1, 16))
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="multiple of kvh"):
        fa.flash_attention_plain(q, k[:, :, :1].expand(1, 8, 3, 16).clone(),
                                 v[:, :, :1].expand(1, 8, 3, 16).clone())
