"""Dispatch between the hand-written kernels and their plain versions.

The rule is the device of the tensor: a CUDA tensor goes to its kernel (or
the kernel's wrapper raises), a CPU tensor goes to the plain PyTorch
version.  There is no size threshold and no fallback: on the card every
probed float tensor and every flash-attention call runs the kernel.
"""
from __future__ import annotations

import torch

from . import flash_attn as _fa
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
    static channels ``numel``/``rows`` are python floats either way.
    """
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
