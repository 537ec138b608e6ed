"""Fused single-pass probe reduction — the monitoring hot path's kernel.

The contract is the JAX package's (``repro.kernels.probe_reduce``), kept as
a copy here because the port imports nothing of that package: one sweep over
a probed tensor gives the raw *moment vector*

    [sum, sum_sq, sum_abs, max_abs, zero_count, nan_count, inf_count, numel]

plus the optional ``ent_sum`` channel (sum of x*log(x+eps), the raw
accumulator behind ATTN_ENTROPY) appended when a probe plan asks for it.
Every moment-derived event is then a scalar finalizer over this vector
(events.py stage 2).

``probe_moments`` launches the hand-written CUDA kernel
(``csrc/probe_reduce.cu``) on a CUDA tensor and raises on anything it does
not take; ``moments_plain``/``named_moments_plain`` are the plain PyTorch
versions of the same function, which the wrapper's caller uses only for a
tensor that lies on the CPU.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build

# Canonical moment order — the contract between the kernel, the plain
# version and the event finalizers in core/events.py.
MOMENTS = (
    "sum",
    "sum_sq",
    "sum_abs",
    "max_abs",
    "zero_count",
    "nan_count",
    "inf_count",
    "numel",
)
(
    M_SUM,
    M_SUM_SQ,
    M_SUM_ABS,
    M_MAX_ABS,
    M_ZERO,
    M_NAN,
    M_INF,
    M_NUMEL,
) = range(len(MOMENTS))

# Optional fused channel, appended AFTER the base vector so every M_* index
# above stays valid whether or not a plan requests entropy.
ENT_EPS = 1e-9
MOMENTS_ENT = MOMENTS + ("ent_sum",)
M_ENT = len(MOMENTS)

# Shape constants the sweep never has to compute: element count and
# last-axis row count (the divisor of a row-mean such as attention entropy).
STATIC_CHANNELS = ("numel", "rows")

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_THREADS = 256          # csrc/probe_reduce.cu THREADS
_MAX_BLOCKS = 132 * 8   # eight blocks per SM of an H100
_LOADS_PER_THREAD = 4   # 16-byte loads each thread makes before the grid caps


def static_channel_values(shape) -> dict:
    """{static channel: f32-rounded python float} for a tensor of ``shape``."""
    numel = int(np.prod(shape)) if len(shape) else 1
    last = shape[-1] if len(shape) else 1
    rows = numel // last if last else 0
    return {"numel": float(np.float32(numel)), "rows": float(np.float32(rows))}


def moments_plain(x: torch.Tensor, *, with_entropy: bool = False):
    """Plain PyTorch version: the moment vector from unfused reductions."""
    xf = x.to(torch.float32).reshape(-1)
    ax = xf.abs()
    n = xf.numel()
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    chans = [
        xf.sum(),
        (xf * xf).sum(),
        ax.sum(),
        ax.max() if n else zero,
        (xf == 0).to(torch.float32).sum(),
        torch.isnan(xf).to(torch.float32).sum(),
        torch.isinf(xf).to(torch.float32).sum(),
        zero + float(np.float32(n)),
    ]
    if with_entropy:
        chans.append((xf * torch.log(xf + ENT_EPS)).sum())
    return torch.stack(chans)


def named_moments_plain(x: torch.Tensor, names) -> dict:
    """Only the requested sweep channels, as ``{name: f32 scalar tensor}``,
    plus the free static channels (python floats)."""
    out: dict = dict(static_channel_values(tuple(x.shape)))
    sweep = MOMENTS_ENT[:M_NUMEL] + ("ent_sum",)
    need = [n for n in sweep if n in set(names)]
    if not need:
        return out
    vec = moments_plain(x, with_entropy="ent_sum" in need)
    out.update((n, vec[MOMENTS_ENT.index(n)]) for n in need)
    return out


def _declare(lib: ctypes.CDLL) -> None:
    lib.probe_moments.restype = ctypes.c_int
    lib.probe_moments.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p,
    ]


def grid_blocks(numel: int, itemsize: int) -> int:
    """Blocks of the first pass for ``numel`` elements of ``itemsize`` bytes
    (a function of the size alone, so the sum order is reproducible)."""
    per_block = _THREADS * (16 // itemsize) * _LOADS_PER_THREAD
    return max(1, min(_MAX_BLOCKS, -(-numel // per_block)))


def probe_moments(x: torch.Tensor, *, with_entropy: bool = False):
    """Moment vector f32[8] (f32[9] with ``with_entropy``) of a CUDA tensor
    in one pass of the CUDA kernel.

    Takes float32, bfloat16 and float16 at any size; an empty tensor gives
    the zero vector without a launch.  A non-contiguous tensor is copied to
    a contiguous one first (counted in ``probe_moments.copies``).  Every
    launch adds one to ``probe_moments.launches``.
    """
    if x.device.type != "cuda":
        raise ValueError(f"probe_moments takes a CUDA tensor, got {x.device}")
    code = _DTYPE_CODE.get(x.dtype)
    if code is None:
        raise TypeError(f"probe_moments takes float32/bfloat16/float16, "
                        f"got {x.dtype}")
    n_out = len(MOMENTS_ENT) if with_entropy else len(MOMENTS)
    out = torch.empty((n_out,), dtype=torch.float32, device=x.device)
    n = x.numel()
    if n == 0:
        return out.zero_()
    if not x.is_contiguous():
        x = x.contiguous()
        probe_moments.copies += 1
    lib = build.load("probe_reduce", _declare)
    n_blocks = grid_blocks(n, x.element_size())
    partials = torch.empty((n_blocks * len(MOMENTS_ENT),), dtype=torch.float32,
                           device=x.device)
    err = lib.probe_moments(
        x.data_ptr(), code, n, float(np.float32(n)), int(with_entropy),
        partials.data_ptr(), n_blocks, out.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(lib, err, "probe_moments")
    probe_moments.launches += 1
    return out


probe_moments.launches = 0
probe_moments.copies = 0
