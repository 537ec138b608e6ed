"""The two GEMM schedules of the paper's case study: hand-written CUDA
kernels (``csrc/gemm.cu``), their plain version and their cost model.

The contract is the JAX package's ``repro.kernels.gemm``: C = A @ B with
A [M,K], B [K,N] float32 or bfloat16, f32 accumulation and f32 out, by one
of two schedules that do the same FLOPs and move different bytes.

cache_blocked (ATLAS-like, B3)
    one block per (bm, bn) output tile, K walked in bk steps; each step
    copies A[bm,bk] and B[bk,bn] into shared memory once.
panel_streaming (GotoBLAS-like, B4)
    one block per A panel [bm, K], copied into shared memory once; B is
    streamed through it in [K, bn] tiles.  The panel must fit a block's
    shared memory, which bounds K: Goto's trade-off.

The TPU's blockings do not all fit an SM (a 256 x 256 f32 accumulator is a
whole register file), so the kernels are instantiated for the blockings in
``BLOCKINGS`` and the wrappers refuse others.  ``schedule_cost`` is the
reference's counter model, term for term, with the H100's constants.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

SCHEDULES = ("cache_blocked", "panel_streaming")

# (bm, bn, bk) instantiated in csrc/gemm.cu; bk is unused by panel_streaming
BLOCKINGS = {
    "cache_blocked": ((128, 128, 128), (256, 128, 64)),
    "panel_streaming": ((128, 128, None), (128, 256, None)),
}
PAD = 4                   # csrc/gemm.cu PAD: row padding of the A tile
STAGE_K = 32              # csrc/gemm.cu STAGE_K: rows of B per stage
MAX_SMEM_BYTES = 232448   # 227 KB, one block's dynamic shared memory

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# H100 SXM5 80GB HBM3 at 700 W, NVIDIA's data sheet: f32 FMA on the CUDA
# cores (the math these kernels run), device-memory bandwidth, maximum SM
# clock.  A tensor-core kernel moves PEAK_FLOPS with it.
PEAK_FLOPS = 67e12
HBM_BW = 3.35e12
CLOCK_HZ = 1.98e9
# MXU_PASSES keeps the reference's name and counts 128^3 tile products (the
# TPU's matrix-unit pass), not any Hopper instruction, so that plans and
# fingerprints stay byte-equal to the reference's.
MXU_DIM = 128


def matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: C = A @ B in f32 (``repro.kernels.ref.matmul``)."""
    return torch.matmul(a.to(torch.float32), b.to(torch.float32))


def smem_bytes(schedule: str, k: int, bm: int, bn: int, bk: int,
               itemsize: int) -> int:
    """Shared memory of one block of the kernel: the transposed, padded A
    tile (cache_blocked) or panel (panel_streaming) plus the B tile or
    stage."""
    if schedule == "cache_blocked":
        return (bk * (bm + PAD) + bk * bn) * itemsize
    return (k * (bm + PAD) + STAGE_K * bn) * itemsize


def blocking(schedule: str, m: int, n: int, k: int, bm: int, bn: int,
             bk: int | None, itemsize: int) -> tuple[int, int, int | None]:
    """The blocking the kernel runs for this shape: clamped to the shape
    and checked for divisibility as the reference does
    (``repro.kernels.gemm``), then against the instantiated blockings and a
    block's shared memory.  Raises ValueError on what the kernel does not
    take."""
    if schedule not in SCHEDULES:
        raise KeyError(f"unknown schedule {schedule!r}; have {SCHEDULES}")
    bm, bn = min(bm, m), min(bn, n)
    if schedule == "cache_blocked":
        bk = min(bk, k)
        if m % bm or n % bn or k % bk:
            raise ValueError(f"{(m, n, k)} is not a multiple of {(bm, bn, bk)}")
    else:
        bk = None
        if m % bm or n % bn or k % STAGE_K:
            raise ValueError(f"{(m, n, k)} is not a multiple of "
                             f"{(bm, bn, STAGE_K)}")
    if (bm, bn, bk) not in BLOCKINGS[schedule]:
        raise ValueError(f"{schedule}: no kernel for blocking {(bm, bn, bk)}; "
                         f"have {BLOCKINGS[schedule]}")
    smem = smem_bytes(schedule, k, bm, bn, bk, itemsize)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"{schedule} at k={k}, bm={bm}, bn={bn}: {smem} bytes of shared "
            f"memory per block pass the {MAX_SMEM_BYTES} a block may have")
    return bm, bn, bk


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gemm_cache_blocked.restype = i
    lib.gemm_cache_blocked.argtypes = [p, p, p, i, i, i, i, i, i, i, p]
    lib.gemm_panel_streaming.restype = i
    lib.gemm_panel_streaming.argtypes = [p, p, p, i, i, i, i, i, i, p]


def _operands(a, b, what):
    """(m, n, k, dtype code) of operands the kernels take."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"{what}: want a [m,k] and b [k,n], got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in _DTYPE_CODE:
        raise TypeError(f"{what} takes float32 or bfloat16 operands of one "
                        f"dtype, got {a.dtype} and {b.dtype}")
    return a.shape[0], b.shape[1], a.shape[1], _DTYPE_CODE[a.dtype]


def _on_card(a, b, what):
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"{what} takes CUDA tensors on one device, got "
                         f"{a.device} and {b.device}")
    for x in (a, b):
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{what} takes contiguous operands on 16-byte "
                             f"boundaries")


def cache_blocked_matmul(a: torch.Tensor, b: torch.Tensor, *, bm: int,
                         bn: int, bk: int) -> torch.Tensor:
    """ATLAS-like blocked GEMM on the card (B3): f32 C [m, n].  Every launch
    adds one to ``cache_blocked_matmul.launches``."""
    m, n, k, code = _operands(a, b, "cache_blocked_matmul")
    bm, bn, bk = blocking("cache_blocked", m, n, k, bm, bn, bk,
                          a.element_size())
    _on_card(a, b, "cache_blocked_matmul")
    c = torch.empty((m, n), dtype=torch.float32, device=a.device)
    lib = build.load("gemm", _declare)
    err = lib.gemm_cache_blocked(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), code, m, n, k, bm, bn, bk,
        torch.cuda.current_stream(a.device).cuda_stream)
    build.check(lib, err, "cache_blocked_matmul")
    cache_blocked_matmul.launches += 1
    return c


def panel_streaming_matmul(a: torch.Tensor, b: torch.Tensor, *, bm: int,
                           bn: int) -> torch.Tensor:
    """GotoBLAS-like GEMM on the card (B4): one block per A panel [bm, k],
    resident in shared memory; f32 C [m, n].  Every launch adds one to
    ``panel_streaming_matmul.launches``."""
    m, n, k, code = _operands(a, b, "panel_streaming_matmul")
    bm, bn, _ = blocking("panel_streaming", m, n, k, bm, bn, None,
                         a.element_size())
    _on_card(a, b, "panel_streaming_matmul")
    c = torch.empty((m, n), dtype=torch.float32, device=a.device)
    lib = build.load("gemm", _declare)
    err = lib.gemm_panel_streaming(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), code, m, n, k, bm, bn,
        torch.cuda.current_stream(a.device).cuda_stream)
    build.check(lib, err, "panel_streaming_matmul")
    panel_streaming_matmul.launches += 1
    return c


cache_blocked_matmul.launches = 0
panel_streaming_matmul.launches = 0


def schedule_cost(schedule: str, m: int, n: int, k: int,
                  bm: int, bn: int, bk: int, dtype_bytes: int = 2) -> dict:
    """Analytical per-call counters of a GEMM schedule — the reference's
    formula (``repro.kernels.gemm.schedule_cost``) term for term:

      FLOPS             2*M*N*K (identical across schedules)
      HBM_BYTES         device memory -> on-chip traffic (≙ L2_LINES_IN)
      VMEM_TILE_REFILLS tile copies into on-chip memory (≙ DTLB_MISSES)
      MXU_PASSES        128^3 tile products (≙ SIMD_INST_RETIRED)
      EST_STALL_CYCLES  max(0, mem_time - compute_time) * clock, with the
                        H100's constants above (≙ RESOURCE_STALLS)
    """
    flops = 2.0 * m * n * k
    gm, gn = m // bm, n // bn
    if schedule == "cache_blocked":
        gk = k // bk
        a_bytes = gm * gk * (bm * bk) * gn * dtype_bytes   # A refetched per j
        b_bytes = gk * gn * (bk * bn) * gm * dtype_bytes   # B refetched per i
        refills = gm * gn * gk * 2
    elif schedule == "panel_streaming":
        a_bytes = m * k * dtype_bytes                      # A once (resident)
        b_bytes = k * n * gm * dtype_bytes                 # B per A panel
        refills = gm + gm * gn                             # A panels + B tiles
    else:
        raise KeyError(schedule)
    c_bytes = m * n * 4  # f32 out written once by both schedules
    hbm = a_bytes + b_bytes + c_bytes
    mxu = (
        ((m + MXU_DIM - 1) // MXU_DIM)
        * ((n + MXU_DIM - 1) // MXU_DIM)
        * ((k + MXU_DIM - 1) // MXU_DIM)
    )
    t_compute = flops / PEAK_FLOPS
    t_mem = hbm / HBM_BW
    stall = max(0.0, t_mem - t_compute) * CLOCK_HZ
    return {
        "FLOPS": flops,
        "HBM_BYTES": float(hbm),
        "VMEM_TILE_REFILLS": float(refills),
        "MXU_PASSES": float(mxu),
        "EST_STALL_CYCLES": stall,
        "vmem_working_set_bytes": float(
            (bm * bk + bk * bn + bm * bn * 2) * dtype_bytes
            if schedule == "cache_blocked"
            else (bm * k + k * bn + bm * bn * 2) * dtype_bytes
        ),
        "arithmetic_intensity": flops / hbm,
    }
