"""Dispatch between the hand-written kernels and their plain versions.

The rule is the device of the tensor: a CUDA tensor goes to its kernel (or
the kernel's wrapper raises), a CPU tensor goes to the plain PyTorch
version.  There is no size threshold and no fallback: on the card every
probed float tensor, every flash-attention call and every GEMM runs the
kernel.
"""
from __future__ import annotations

import torch

from . import flash_attn as _fa
from . import gemm as _gemm
from . import probe_reduce as _pr


def _on_cpu(x: torch.Tensor) -> bool:
    if x.device.type == "cpu":
        return True
    if x.device.type == "cuda":
        return False
    raise ValueError(f"no kernel or plain version for device {x.device}")


def tensor_moments(x: torch.Tensor, names) -> dict:
    """{channel: f32 scalar} for the probe path — the ONE sweep per tensor.

    ``names`` is the exact channel tuple a MomentPlan (core/plan.py)
    compiled for the active event set.  On the card the kernel sweeps every
    channel in one pass (the entropy lane only when a plan asks for it); on
    the CPU the plain version computes just the requested channels.  The
    static channels ``numel``/``rows`` are python floats either way, and a
    plan that asks for nothing else (NUMEL alone) sweeps nothing.
    """
    if set(names) <= set(_pr.STATIC_CHANNELS):
        return _pr.static_channel_values(tuple(x.shape))
    if _on_cpu(x):
        return _pr.named_moments_plain(x, names)
    with_entropy = "ent_sum" in set(names)
    vec = _pr.probe_moments(x, with_entropy=with_entropy)
    chans = _pr.MOMENTS_ENT if with_entropy else _pr.MOMENTS
    out = {c: vec[i] for i, c in enumerate(chans)}
    out.update(_pr.static_channel_values(tuple(x.shape)))
    return out


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """Model-layer convention: q [b,sq,h,d]; k,v [b,sk,kvh,d] (GQA ok)."""
    if _on_cpu(q):
        return _fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    return _fa.flash_attention(q, k, v, causal=causal, window=window)


def matmul(a, b, schedule: str, *, bm: int, bn: int, bk: int = 256):
    """C = A @ B (f32 out) by the named schedule's kernel; ``bk`` is used by
    cache_blocked only.  A CPU pair takes the plain version, after the same
    blocking checks the kernel's wrapper makes."""
    if _on_cpu(a):
        m, k = a.shape
        _gemm.blocking(schedule, m, b.shape[-1], k, bm, bn, bk,
                       a.element_size())
        return _gemm.matmul_plain(a, b)
    if schedule == "cache_blocked":
        return _gemm.cache_blocked_matmul(a, b, bm=bm, bn=bn, bk=bk)
    if schedule == "panel_streaming":
        return _gemm.panel_streaming_matmul(a, b, bm=bm, bn=bn)
    raise KeyError(f"unknown schedule {schedule!r}; have {_gemm.SCHEDULES}")


def matmul_cost(schedule: str, m: int, n: int, k: int, *, bm: int, bn: int,
                bk: int, dtype_bytes: int = 2) -> dict:
    """Analytical counters for one matmul call (the case-study events), the
    blocking clamped to the shape as the reference's ``ops.matmul_cost``."""
    bm, bn, bk = min(bm, m), min(bn, n), min(bk, k)
    return _gemm.schedule_cost(schedule, m, n, k, bm, bn, bk, dtype_bytes)
