"""Forward flash attention: the hand-written CUDA kernel and its plain
version, in the model layout q [b, sq, h, d], k and v [b, sk, kvh, d].

The function is the JAX package's ``repro.kernels.flash_attn`` forward:
online-softmax attention with f32 accumulation and output in q's dtype,
causal with the diagonal at ``sk - sq`` (a KV prefix), an optional sliding
window, and fully masked tiles skipped.  Unlike the TPU kernel it takes
grouped-query heads directly (query head ``i`` reads KV head
``i // (h // kvh)``), ragged ``sq``/``sk``, and any head dim up to 128.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128
NEG_INF = -1e30


def _check_shapes(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"want q [b,sq,h,d] and k, v [b,sk,kvh,d]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree "
                         f"on batch or head dim, or h is not a multiple of kvh")


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0):
    """Plain PyTorch version: materialized f32 scores and softmax; a row
    with no visible key gives zeros, as the kernel's does."""
    _check_shapes(q, k, v)
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(d)
    rep = h // kvh
    kf = k.to(torch.float32).repeat_interleave(rep, dim=2)
    vf = v.to(torch.float32).repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32), kf) * scale
    qpos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True)) * mask
    p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vf)
    return out.to(q.dtype)


def _declare(lib: ctypes.CDLL) -> None:
    lib.flash_attention.restype = ctypes.c_int
    lib.flash_attention.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong),
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """Attention of CUDA tensors through the CUDA kernel; out [b,sq,h,d]
    contiguous in q's dtype.

    Takes float32 and bfloat16 with a contiguous head dimension
    (any other layout is copied first, counted in
    ``flash_attention.copies``).  Every launch adds one to
    ``flash_attention.launches``.
    """
    _check_shapes(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention takes CUDA tensors, got {q.device}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_attention takes float32 or bfloat16 for q, "
                        f"k and v; got {q.dtype}, {k.dtype}, {v.dtype}")
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} > {MAX_HEAD_DIM}")
    ins = []
    for t in (q, k, v):
        if t.stride(3) != 1:
            t = t.contiguous()
            flash_attention.copies += 1
        ins.append(t)
    q, k, v = ins
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    if sk == 0:
        return out.zero_()
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    lib = build.load("flash_attn", _declare)
    err = lib.flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _DTYPE_CODE[q.dtype], b, sq, sk, h, kvh, d, strides, 1.0 / math.sqrt(d),
        int(causal), int(window),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(lib, err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
flash_attention.copies = 0
