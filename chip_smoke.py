#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout, one CUDA card

Phases, each printing its own ``[phase]`` lines; any failure raises and the
script exits non-zero without a result line:

1. card   — name, power limit, torch/CUDA versions; TF32 off for every f32
            comparison.
2. build  — ``nvcc`` for every kernel source at once, with ptxas's
            registers, shared memory and spills (none allowed in the GEMMs).
3. B1     — the probe-moment kernel against its plain version (ragged
            sizes, one element, NaN/Inf, entropy, the main path's shapes).
4. B2     — the flash-attention kernel against its plain version (the
            reference's FA_CASES, ragged shapes, the main path's shapes).
4b. gemm  — the cache-blocked (B3) and panel-streaming (B4) GEMM kernels
            against their plain version: the reference's GEMM_SHAPES in
            f32 and bf16, a non-square shape per schedule, and the case
            study's 16384 x 16384 x 256 f32 at each of its blockings.
5. main   — qwen3-14b at full width (40 layers, bf16, random weights from
            a seed) served by ``Engine.generate`` at 4 x 512 and 1 x 384
            prompts, 32 new tokens each: launch counts asserted against
            the compiled plans, the decode steps run in sync-error mode,
            the plan fingerprint must equal the JAX package's.
6. smoke  — the SMOKE config in f32 on the card against the same on the
            CPU: tokens equal, counters and logits close.
7. case   — the second path: the paper's GEMM case study
            (``repro_torch.case_study.main``) at 16384 x 16384 x 256 f32,
            three implementations, exhaustive and multiplexed, 500 calls
            each: B3/B4 launches per run equal the calls, B1 launches equal
            what the compiled plans give; then a profiler trace of one
            monitored call per implementation (device time, idle share).
8. timing — each kernel at its path's shapes beside its bound, its plain
            version and, where one exists, the PyTorch call that computes
            the same (SDPA, ``torch.matmul``): device time per call from
            profiler traces (inputs rotated through more than the L2
            cache), and the kernel's time per call from Python (CUDA
            events); the device's idle share in prefill and decode.

The last three lines are the kernels' JSON record, the card's name and
power limit as nvidia-smi prints them, and ``{"ok": true, ...}``.
"""
from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

FINGERPRINT = "67589f4aeabd570eb71efa15b70b83fce04c9587"
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
BF16_FLOPS = 989e12             # dense tensor-core bf16
F32_FLOPS = 67e12               # f32 outside the tensor cores
L2_BYTES = 50 * 2**20
SOURCES = {"probe_moments": "src/repro_torch/csrc/probe_reduce.cu",
           "flash_attention": "src/repro_torch/csrc/flash_attn.cu",
           "cache_blocked_matmul": "src/repro_torch/csrc/gemm.cu",
           "panel_streaming_matmul": "src/repro_torch/csrc/gemm.cu"}
REPLACES = {"probe_moments": "src/repro/kernels/probe_reduce.py:89",
            "flash_attention": "src/repro/kernels/flash_attn.py:29",
            "cache_blocked_matmul": "src/repro/kernels/gemm.py:42",
            "panel_streaming_matmul": "src/repro/kernels/gemm.py:92"}
CASE_MNK = (16384, 16384, 256)  # repro_torch.case_study.SIZES["cuda"]
FA_CASES = [  # tests/test_kernels.py FA_CASES + ragged shapes
    (2, 128, 128, 4, 4, 64, True, 0),
    (2, 128, 128, 4, 2, 64, True, 0),
    (1, 256, 256, 2, 1, 32, True, 0),
    (1, 128, 384, 2, 2, 64, True, 0),
    (2, 128, 128, 4, 4, 64, False, 0),
    (1, 256, 256, 2, 2, 64, True, 64),
    (1, 64, 192, 1, 1, 128, True, 0),
    (1, 200, 200, 4, 2, 64, True, 0),
    (2, 77, 301, 2, 1, 128, True, 48),
]


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


# ---------------------------------------------------------------------------
# 1-2: card and build
# ---------------------------------------------------------------------------

def card(torch):
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    say("card", f"{torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
        f"torch {torch.__version__} cuda {torch.version.cuda} | "
        f"{torch.cuda.device_count()} device(s)")
    from repro_torch.kernels import gemm

    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    say("card", f"max SM clock {clock}; the GEMM cost model's CLOCK_HZ "
        f"{gemm.CLOCK_HZ / 1e9:.2f} GHz, PEAK_FLOPS {gemm.PEAK_FLOPS / 1e12:.0f} "
        f"TFLOP/s f32, HBM_BW {gemm.HBM_BW / 1e12:.2f} TB/s")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("card", "TF32 off for matmul and cuDNN (f32 comparisons are f32)")
    return smi


def build_kernels():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    logs = build.build(["probe_reduce", "flash_attn", "gemm"])
    say("build", f"nvcc for {sorted(logs)} in "
        f"{time.perf_counter() - t0:.1f} s into {build.BUILD_DIR}")
    for name, log in logs.items():
        regs = re.findall(r"Used (\d+) registers", log)
        smem = re.findall(r"(\d+) bytes smem", log)
        spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores", log)]
        say("build", f"{name}: registers {regs}, static smem bytes {smem}, "
            f"spill-store bytes {spills}")
    spills = re.findall(r"(\d+) bytes spill (?:stores|loads)", logs["gemm"])
    check(bool(spills) and not any(int(x) for x in spills),
          f"ptxas reports spills in the GEMM kernels: {spills}")


# ---------------------------------------------------------------------------
# 3-4: kernels against their plain versions
# ---------------------------------------------------------------------------

def moments_err(torch, pr, got, want):
    """Max |got - want| and whether it is in tolerance: sums to 1e-5 of the
    summed magnitudes (f32 sums in another order: the error bound grows
    with the magnitudes summed, not with the result), counts and max
    exact."""
    g, w = got.double().cpu(), want.double().cpu()
    scale = {pr.M_SUM: w[pr.M_SUM_ABS], pr.M_SUM_SQ: w[pr.M_SUM_SQ],
             pr.M_SUM_ABS: w[pr.M_SUM_ABS]}
    err, ok = 0.0, True
    for i in range(len(w)):
        a, b = g[i].item(), w[i].item()
        if math.isnan(a) or math.isnan(b):
            ok &= math.isnan(a) and math.isnan(b)
            continue
        d = abs(a - b) if a != b else 0.0
        err = max(err, d)
        if i in scale:
            ok &= d <= 1e-5 * abs(scale[i].item()) + 1e-6
        elif i == pr.M_ENT:
            ok &= d <= 1e-5 * abs(b) + 1e-6
        else:
            ok &= d == 0.0
    return err, ok


def parity_b1(torch, dev):
    from repro_torch.kernels import probe_reduce as pr

    gen = torch.Generator(device=dev).manual_seed(1)
    cases = []
    for n in (1, 7, 1000, 1024, 4097, 3 * 77777):
        for dt in (torch.float32, torch.bfloat16, torch.float16):
            cases.append((f"n={n} {dt}", torch.randn(n, generator=gen,
                                                     device=dev).to(dt), False))
    for shape in ((4, 512, 5120), (4, 1, 151936), (4, 1, 5120),
                  (1, 384, 5120), (1, 1, 151936)):
        x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        x.view(-1)[::97] = 0
        cases.append((f"{list(shape)} bf16", x, False))
    poison = torch.tensor([float("nan"), 1.5, float("inf"), float("-inf"),
                           0.0] * 640, device=dev)
    cases.append(("nan/inf f32", poison, False))
    cases.append(("nan/inf bf16", poison.to(torch.bfloat16), False))
    probs = torch.softmax(torch.randn(4, 8, 300, 300, generator=gen,
                                      device=dev), dim=-1)
    cases.append(("entropy probs f32", probs, True))
    cases.append(("entropy probs bf16", probs.to(torch.bfloat16), True))
    cases.append(("strided", torch.randn(64, 300, generator=gen,
                                         device=dev).t(), False))
    worst = {}
    for name, x, ent in cases:
        got = pr.probe_moments(x, with_entropy=ent)
        want = pr.moments_plain(x, with_entropy=ent)
        torch.cuda.synchronize()
        err, ok = moments_err(torch, pr, got, want)
        check(ok, f"B1 {name}: kernel {got.tolist()} vs plain {want.tolist()}")
        worst[name] = err
    say("B1", f"probe_moments vs plain: {len(cases)} cases pass "
        f"(sums within 1e-5 of the summed magnitudes, counts and max exact); "
        f"max abs err {max(worst.values()):.3g}; at [4,512,5120] bf16 "
        f"{worst['[4, 512, 5120] bf16']:.3g}")
    return worst["[4, 512, 5120] bf16"]


def parity_b2(torch, dev):
    from repro_torch.kernels import flash_attn as fa

    gen = torch.Generator(device=dev).manual_seed(2)

    def inputs(b, sq, sk, h, kvh, d, dt):
        return [torch.randn(shape, generator=gen, device=dev).to(dt)
                for shape in ((b, sq, h, d), (b, sk, kvh, d), (b, sk, kvh, d))]

    for case in FA_CASES:
        b, sq, sk, h, kvh, d, causal, win = case
        q, k, v = inputs(b, sq, sk, h, kvh, d, torch.float32)
        got = fa.flash_attention(q, k, v, causal=causal, window=win)
        want = fa.flash_attention_plain(q, k, v, causal=causal, window=win)
        err = (got - want).abs().max().item()
        check(err <= 2e-5, f"B2 f32 {case}: max abs err {err}")
        say("B2", f"f32 {case}: max abs err {err:.3g} (atol 2e-5)")
    worst = 0.0
    for b, sq in ((4, 512), (1, 384)):
        q, k, v = inputs(b, sq, sq, 40, 8, 128, torch.bfloat16)
        got = fa.flash_attention(q, k, v)
        want = fa.flash_attention_plain(q, k, v)
        err = (got.float() - want.float()).abs().max().item()
        check(err <= 1.6e-2, f"B2 bf16 qwen3 b={b} sq={sq}: err {err}")
        say("B2", f"bf16 qwen3 q[{b},{sq},40,128] kv[{b},{sq},8,128]: max abs "
            f"err {err:.3g} (atol 1.6e-2: four bf16 ulps at 1.0)")
        if b == 4:
            worst = err
    q, k, v = inputs(2, 130, 130, 4, 2, 64, torch.float32)
    qs = q.transpose(1, 2).contiguous().transpose(1, 2)  # strided view
    err = (fa.flash_attention(qs, k, v)
           - fa.flash_attention_plain(q, k, v)).abs().max().item()
    check(err <= 2e-5, f"B2 strided q: err {err}")
    say("B2", f"f32 strided q: max abs err {err:.3g}")
    return worst


GEMM_TOL = 2e-4  # the reference's f32 TOL; bf16 products are exact in f32


def parity_gemm(torch, dev):
    """B3 and B4 against ``matmul_plain`` (f32 ``torch.matmul``, TF32 off):
    within rtol 2e-4 and atol 2e-4 * sqrt(k), sums in another order."""
    from repro_torch import case_study as cs
    from repro_torch.kernels import gemm, ops

    gen = torch.Generator(device=dev).manual_seed(6)
    cases = [(s, shape, (128, 128, 128), dt) for s in gemm.SCHEDULES
             for shape in ((128, 128, 128), (256, 128, 384), (512, 256, 128),
                           (128, 512, 256))
             for dt in (torch.float32, torch.bfloat16)]
    for dt in (torch.float32, torch.bfloat16):
        cases.append(("cache_blocked", (512, 384, 192), (256, 128, 64), dt))
        cases.append(("panel_streaming", (384, 768, 160), (128, 256, 256), dt))
    for impl, cfg in cs.IMPLS.items():
        cases.append((cfg["schedule"], CASE_MNK,
                      (cfg["bm"], cfg["bn"], cfg.get("bk", 256)),
                      torch.float32))
    worst = {}
    for schedule, (m, n, k), (bm, bn, bk), dt in cases:
        a = torch.randn(m, k, generator=gen, device=dev).to(dt)
        b = torch.randn(k, n, generator=gen, device=dev).to(dt)
        got = ops.matmul(a, b, schedule, bm=bm, bn=bn, bk=bk)
        want = gemm.matmul_plain(a, b)
        err = (got - want).abs().max().item()
        bad = ((got - want).abs()
               > GEMM_TOL * math.sqrt(k) + GEMM_TOL * want.abs()).sum().item()
        name = f"{schedule} {m}x{n}x{k} at {(bm, bn, bk)} {dt}"
        check(bad == 0, f"gemm {name}: {bad} elements out of tolerance, "
              f"max abs err {err}")
        worst[schedule] = max(worst.get(schedule, 0.0), err)
        say("gemm", f"{name}: max abs err {err:.3g}")
        del got, want
    say("gemm", f"{len(cases)} cases within rtol {GEMM_TOL} and atol "
        f"{GEMM_TOL} * sqrt(k); max abs err {worst}")
    return worst


# ---------------------------------------------------------------------------
# 5: the main path
# ---------------------------------------------------------------------------

def kernel_sweeps(plan):
    """B1 launches of one probe under ``plan``: its sweeps that ask for a
    channel the shape does not give (NUMEL alone launches nothing)."""
    from repro_torch.kernels import probe_reduce as pr

    return sum(1 for sw in plan.sweeps
               if set(sw.channels) - set(pr.STATIC_CHANNELS))


def expected_launches(spec, n_layers, sq):
    """Kernel launches of one prefill and one decode step, from the compiled
    plans: each probe call sweeps ``len(plan.sweeps)`` tensors (one B1
    launch each); attention probes ``probs`` only at sq <= 256, where no B2
    runs."""
    from repro_torch.core import plan as plan_lib

    def sweeps(scope, tensors):
        ctx = spec.context(scope)
        return kernel_sweeps(plan_lib.compile_scope_plans(
            ctx, frozenset(tensors)).plans[0])

    flash = sq > 256
    prefill = (sweeps("embed", {"out"}) + sweeps("logits", {"out"})
               + n_layers * (sweeps("layer/mlp", {"out"})
                             + (0 if flash else sweeps("layer/attn",
                                                       {"probs"}))))
    decode = (sweeps("embed", {"out"}) + sweeps("logits", {"out"})
              + n_layers * (sweeps("layer/attn", {"out"})
                            + sweeps("layer/mlp", {"out"})))
    return {"b1_prefill": prefill, "b1_decode": decode,
            "b2_prefill": n_layers if flash else 0}


def sync_strict(torch, fn):
    """``fn`` run with CUDA sync debug mode "error": any operation that
    waits for the device raises."""

    def run(*args, **kwargs):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    return run


def reset_counts(fa, pr, gemm):
    for fn in (pr.probe_moments, fa.flash_attention,
               gemm.cache_blocked_matmul, gemm.panel_streaming_matmul):
        fn.launches = 0


def counts(fa, pr, gemm):
    return {fn.__name__: fn.launches
            for fn in (pr.probe_moments, fa.flash_attention,
                       gemm.cache_blocked_matmul,
                       gemm.panel_streaming_matmul)}


def main_path(torch, dev):
    from repro_torch.configs import model_config
    from repro_torch.kernels import flash_attn as fa
    from repro_torch.kernels import gemm
    from repro_torch.kernels import probe_reduce as pr
    from repro_torch.models import Arch
    from repro_torch.serve.engine import Engine, ServeConfig

    cfg = model_config("qwen3_14b")
    arch = Arch(cfg)
    t0 = time.perf_counter()
    params = arch.init(torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    say("main", f"{cfg.name}: {arch.n_params() / 1e9:.2f} B params, "
        f"{cfg.n_layers} layers (no depth cut), d_model {cfg.d_model}, "
        f"{cfg.param_dtype} weights from seed 0 in "
        f"{time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    eng = Engine(arch, params, ServeConfig(cache_len=1024, max_new_tokens=32))
    check(eng.spec.fingerprint == FINGERPRINT,
          f"fingerprint {eng.spec.fingerprint} != {FINGERPRINT}")
    say("main", f"spec {eng.spec.scopes}, plan fingerprint "
        f"{eng.spec.fingerprint} (the JAX package's)")
    gen = torch.Generator(device=dev).manual_seed(3)
    prompts = {f"{b}x{s}": torch.randint(0, cfg.vocab, (b, s), generator=gen,
                                         device=dev)
               for b, s in ((4, 512), (1, 384))}

    # launches of one monitored prefill and one decode step, attested apart
    with torch.inference_mode():
        reset_counts(fa, pr, gemm)
        (cache, logits), ms = eng._prefill(eng.mon.init(), params,
                                           {"tokens": prompts["4x512"]})
        per_prefill = (pr.probe_moments.launches, fa.flash_attention.launches)
        reset_counts(fa, pr, gemm)
        tok = eng._sample(logits, gen)
        eng._decode(ms, params, cache, tok)
        per_decode = (pr.probe_moments.launches, fa.flash_attention.launches)
        del cache, logits, ms
    exp = expected_launches(eng.spec, cfg.n_layers, 512)
    say("main", f"per prefill (4x512): B1 {per_prefill[0]} B2 "
        f"{per_prefill[1]}; per decode step: B1 {per_decode[0]} B2 "
        f"{per_decode[1]} (expected {exp})")
    check(per_prefill == (exp["b1_prefill"], exp["b2_prefill"]),
          "launches per prefill")
    check(per_decode == (exp["b1_decode"], 0), "launches per decode step")

    # the main path: two generate calls, counts from zero, no syncs inside
    # the decode steps
    eng._decode = sync_strict(torch, eng._decode)
    eng._sample = sync_strict(torch, eng._sample)
    torch.cuda.synchronize()
    reset_counts(fa, pr, gemm)
    stats, outs = {}, {}
    for key, toks in prompts.items():
        out, st = eng.generate({"tokens": toks})
        outs[key], stats[key] = out, st
    launches = counts(fa, pr, gemm)
    want = dict.fromkeys(launches, 0)
    for key in prompts:
        e = expected_launches(eng.spec, cfg.n_layers, int(key.split("x")[1]))
        want["probe_moments"] += e["b1_prefill"] + 32 * e["b1_decode"]
        want["flash_attention"] += e["b2_prefill"]
    say("main", f"kernel launches over both generate calls: {launches} "
        f"(expected from the compiled plans {want}); decode steps ran in "
        f"sync-debug mode 'error' without a sync")
    check(launches == want, "main-path launch counts")
    for key, out in outs.items():
        b = int(key.split("x")[0])
        check(tuple(out.shape) == (b, 32), f"tokens {key} shape {out.shape}")
        check(bool(((out >= 0) & (out < cfg.vocab)).all()), "token range")
        st = stats[key]
        say("main", f"batch {key}: prefill {1e3 * st['prefill_s']:.3f} ms, "
            f"decode {1e3 * st['decode_per_tok_s']:.3f} ms/token (32 tokens)")
    for r in eng.mon.reports(eng.mstate):
        for s in r.slots:  # a sampled slot has a finite estimate
            check(s.samples == 0 or math.isfinite(s.estimate),
                  f"report {r.scope} {s.slot_id} est {s.estimate}")
    print(eng.report(), flush=True)
    return eng, prompts, launches, stats


def profile_device(torch, fn, steps, label):
    """Run ``fn`` ``steps`` times under torch.profiler.  Returns the device
    events of the trace as sorted (start us, end us, category) and the wall
    time per step."""
    from torch.profiler import ProfilerActivity, profile

    path = os.path.join(ROOT, "build", "repro_torch", f"trace_{label}.json")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(steps):
            fn(i)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / steps
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    dev = sorted((e["ts"], e["ts"] + e.get("dur", 0), e.get("cat", ""),
                  e.get("name", "")) for e in events
                 if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    check(bool(dev), f"{label}: the profiler recorded no device events")
    return dev, wall


def busy_span_us(dev):
    """Union of the device intervals (busy) and first start to last end."""
    busy, end = 0.0, dev[0][0]
    for s, e, *_ in dev:
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy, end - dev[0][0]


def device_idle(torch, fn, steps, label):
    """Kernels and copies per step, and the device's busy time over the
    span of its first to last device event, from a profiler trace."""
    dev, wall = profile_device(torch, fn, steps, label)
    busy, span = busy_span_us(dev)
    by_name: dict = {}
    for s, e, _, name in dev:
        n, t = by_name.get(name[:80], (0, 0.0))
        by_name[name[:80]] = (n + 1, t + e - s)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    out = {
        "kernels_per_step": sum(c == "kernel" for _, _, c, _ in dev) / steps,
        "copies_per_step": sum(c != "kernel" for _, _, c, _ in dev) / steps,
        "device_busy_ms_per_step": busy / 1e3 / steps,
        "device_span_ms_per_step": span / 1e3 / steps,
        "wall_ms_per_step": wall * 1e3,
        "idle_share": 1.0 - busy / span,
        "top_kernels": [{"name": k, "per_step": n / steps,
                         "ms_per_step": t / 1e3 / steps}
                        for k, (n, t) in top],
    }
    say("trace", f"{label}: {out['kernels_per_step']:.1f} kernels and "
        f"{out['copies_per_step']:.1f} copies per step, device busy "
        f"{out['device_busy_ms_per_step']:.3f} ms of a "
        f"{out['device_span_ms_per_step']:.3f} ms span (idle share "
        f"{out['idle_share']:.3f}), wall {out['wall_ms_per_step']:.3f} ms "
        f"(under the profiler)")
    for k in out["top_kernels"]:
        say("trace", f"  {k['ms_per_step']:.3f} ms/step in "
            f"{k['per_step']:.1f} x {k['name']}")
    return out


def traces(torch, eng, prompts):
    with torch.inference_mode():
        toks = {"tokens": prompts["4x512"]}
        pre = device_idle(torch, lambda i: eng._prefill(
            eng.mstate, eng.params, toks), 2, "prefill")
        (cache, logits), ms = eng._prefill(eng.mstate, eng.params, toks)
        gen = torch.Generator(device=logits.device).manual_seed(4)
        state = {"cache": cache, "ms": ms, "tok": eng._sample(logits, gen)}

        def decode_step(i=0):
            (lg, state["cache"]), state["ms"] = eng._decode(
                state["ms"], eng.params, state["cache"], state["tok"])
            state["tok"] = eng._sample(lg, gen)

        decode_step()  # warm
        dec = device_idle(torch, decode_step, 8, "decode")
    return {"prefill_4x512": pre, "decode_4x512": dec}


# ---------------------------------------------------------------------------
# 6: SMOKE parity, card against CPU
# ---------------------------------------------------------------------------

def to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def smoke_parity(torch, dev):
    from repro_torch.configs import model_config
    from repro_torch.models import Arch
    from repro_torch.serve.engine import Engine, ServeConfig

    cfg = model_config("qwen3_14b", smoke=True)
    arch = Arch(cfg)
    cpu_params = arch.init(torch.Generator().manual_seed(0), "cpu")
    gpu_params = to_device(cpu_params, dev)
    scfg = ServeConfig(cache_len=320, max_new_tokens=8)
    engines = {"cpu": Engine(arch, cpu_params, scfg),
               "gpu": Engine(arch, gpu_params, scfg)}
    gen = torch.Generator().manual_seed(5)
    for s in (288, 32):
        toks = torch.randint(0, cfg.vocab, (2, s), generator=gen)
        out = {k: e.generate({"tokens": toks.to(e.device)})[0]
               for k, e in engines.items()}
        check(torch.equal(out["cpu"], out["gpu"]),
              f"SMOKE tokens differ at prompt {s}: {out}")
        with torch.inference_mode():
            lc = arch.prefill(cpu_params, {"tokens": toks}, 320)[1]
            lg = arch.prefill(gpu_params, {"tokens": toks.to(dev)}, 320)[1]
        lerr = (lc - lg.cpu()).abs().max().item()
        check(lerr <= 1e-4, f"SMOKE logits err {lerr}")
        say("smoke", f"prompt {s}: tokens equal card vs CPU "
            f"{out['gpu'][0].tolist()}, prefill logits max err {lerr:.3g}")
    mc, mg = engines["cpu"].mstate, engines["gpu"].mstate
    check(torch.equal(mc.calls, mg.calls) and torch.equal(mc.samples,
                                                          mg.samples),
          "SMOKE calls/samples")
    verr = ((mc.values - mg.values.cpu()).abs()
            / mc.values.abs().clamp_min(1e-30)).max().item()
    check(verr <= 1e-4, f"SMOKE counters rel err {verr}")
    say("smoke", f"SMOKE f32 card vs CPU: calls and samples exact, counter "
        f"values max rel err {verr:.3g} (rtol 1e-4)")


# ---------------------------------------------------------------------------
# 7: the second path, the GEMM case study
# ---------------------------------------------------------------------------

def case_study_path(torch, dev):
    """The case study as ``case_study.main()`` runs it on the card, each of
    its six runs driven here with every kernel count set to 0 just before
    it and read just after, then ``case_study.report``."""
    from repro_torch import case_study as cs
    from repro_torch.core import plan as plan_lib
    from repro_torch.kernels import flash_attn as fa
    from repro_torch.kernels import gemm
    from repro_torch.kernels import probe_reduce as pr

    m, n, k = cs.SIZES["cuda"]
    n_calls, period = cs.RUNS[False]
    t0 = time.perf_counter()
    results = []
    for impl in cs.IMPLS:
        for multiplexed in (False, True):
            reset_counts(fa, pr, gemm)
            r = cs.run_impl(impl, n_calls, m, n, k, multiplexed, period, dev)
            r["launches"] = counts(fa, pr, gemm)
            ctx = cs.spec(multiplexed, period).contexts[0]
            plans = plan_lib.compile_scope_plans(
                ctx, frozenset({"out", "refills", "hbm", "mxu", "flops",
                                "stalls"})).plans
            sets = [(i // period) % ctx.n_sets if multiplexed else 0
                    for i in range(n_calls)]
            r["b1_expected"] = sum(kernel_sweeps(plans[j]) for j in sets)
            results.append(r)
    max_err = cs.report(results, period)
    total = dict.fromkeys(counts(fa, pr, gemm), 0)
    for r in results:
        schedule = cs.IMPLS[r["impl"]]["schedule"]
        want = {"probe_moments": r["b1_expected"], "flash_attention": 0,
                "cache_blocked_matmul": 0, "panel_streaming_matmul": 0}
        want[f"{schedule}_matmul"] = r["calls"]
        check(r["launches"] == want,
              f"case {r['impl']}/{r['mode']} launches {r['launches']} != {want}")
        for key, v in r["launches"].items():
            total[key] += v
        for sid, v in r["estimates"].items():
            check(math.isfinite(v), f"case {r['impl']} {sid} estimate {v}")
        say("case", f"{r['impl']}/{r['mode']}: {r['calls']} calls in "
            f"{r['wall_s']} s ({1e3 * r['wall_s'] / r['calls']:.3f} ms per "
            f"call from the host clock); launches {r['launches']} (expected "
            f"{want})")
    say("case", f"all six runs in {time.perf_counter() - t0:.1f} s; B3/B4 "
        f"launches per run equal the calls and B1 launches equal the "
        f"compiled plans'; max sampling error {max_err:.3f} %")
    summary = {f"{r['impl']}/{r['mode']}": {
        "ms_per_call_host": 1e3 * r["wall_s"] / r["calls"],
        "estimates": r["estimates"]} for r in results}
    return total, summary, max_err


def traces_case(torch, dev):
    """Device time, kernels and idle share of one monitored DGEMM call of
    the case study per implementation, every event on (the exhaustive
    spec), from a profiler trace of ten calls."""
    from repro_torch import case_study as cs

    m, n, k = CASE_MNK
    gen = torch.Generator(device=dev).manual_seed(9)
    a = torch.randn(m, k, generator=gen, device=dev)
    b = torch.randn(k, n, generator=gen, device=dev)
    out = {}
    for impl, cfg in cs.IMPLS.items():
        step, _ = cs.dgemm_step(cfg, m, n, k, cs.spec(False), dev)
        state = {"ms": step.monitor.init()}

        def call(i, step=step, state=state):
            state["c"], state["ms"] = step(a * (1.0 + 0.01 * i), b,
                                           state["ms"])

        call(0)  # warm
        out[impl] = device_idle(torch, call, 10, f"case_{impl}")
    return out


# ---------------------------------------------------------------------------
# 8: timing
# ---------------------------------------------------------------------------

def eager_ms(torch, fn, args_list, reps):
    """Mean ms per call from CUDA events around ``reps`` back-to-back calls
    from Python: device time, or the host's issue time where that is
    longer."""
    for a in args_list:
        fn(*a)
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for i in range(reps):
        fn(*args_list[i % len(args_list)])
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_ms(torch, fn, args_list, reps, label):
    """Mean device time per call (ms) from a profiler trace of ``reps``
    calls, host gaps excluded: for each kernel name, its mean duration
    times its launches per call.  The profiler can drop records of a
    session (9 of 10 GEMM launches kept, on an H100), and a mean over the
    records it kept is still whole.  Calls rotate through
    ``args_list``, more bytes than the L2 cache holds, so each call reads
    its inputs from device memory."""
    for a in args_list:
        fn(*a)
    dev, _ = profile_device(
        torch, lambda i: fn(*args_list[i % len(args_list)]), reps, label)
    by_name: dict = {}
    for s, e, _, name in dev:
        by_name.setdefault(name, []).append(e - s)
    per_call, kept, want = 0.0, 0, 0
    for durs in by_name.values():
        n = round(len(durs) / reps)
        per_call += n * sum(durs) / len(durs)
        kept, want = kept + len(durs), want + n * reps
    if kept < want:
        say("timing", f"{label}: the profiler kept {kept} of {want} device "
            f"records; means over the kept ones")
    return per_call / 1e3


def rotation(nbytes):
    return max(2, math.ceil(2 * L2_BYTES / nbytes))


def timing_b1(torch, dev):
    from repro_torch.kernels import probe_reduce as pr

    shape = (4, 512, 5120)
    n = math.prod(shape)
    sets = [(torch.randn(shape, device=dev, dtype=torch.bfloat16),)
            for _ in range(rotation(2 * n))]
    ms = device_ms(torch, pr.probe_moments, sets, 200, "b1")
    eager = eager_ms(torch, pr.probe_moments, sets, 200)
    plain = device_ms(torch, pr.moments_plain, sets, 20, "b1_plain")
    nbytes = 2 * n + 4 * len(pr.MOMENTS)
    flops = 10 * n  # add, square-add, abs-add, max, three compares, in f32
    bound = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3
    by = "bytes" if nbytes / HBM_BYTES_PER_S >= flops / F32_FLOPS \
        else "operations"
    say("timing", f"probe_moments x{list(shape)} bf16: {ms:.4f} ms on the "
        f"device, {eager:.4f} ms per call from Python (bound {bound:.4f} ms "
        f"by {by}: {nbytes / 1e6:.1f} MB), plain {plain:.4f} ms on the "
        f"device, no single PyTorch call computes the vector")
    return {"ms": ms, "eager_ms": eager, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by, "library_ms": None}


def live_pairs(sq, sk, causal, window):
    offs, n = sk - sq, 0
    for i in range(sq):
        hi = min(sk - 1, i + offs) if causal else sk - 1
        lo = max(0, i + offs - window + 1) if window else 0
        n += max(0, hi - lo + 1)
    return n


def timing_b2(torch, dev):
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attn as fa

    b, s, h, kvh, d = 4, 512, 40, 8, 128
    nbytes = 2 * (2 * b * s * h * d + 2 * b * s * kvh * d)  # q, o, k, v
    sets = []
    for _ in range(rotation(nbytes)):
        q = torch.randn(b, s, h, d, device=dev, dtype=torch.bfloat16)
        k = torch.randn(b, s, kvh, d, device=dev, dtype=torch.bfloat16)
        v = torch.randn(b, s, kvh, d, device=dev, dtype=torch.bfloat16)
        sets.append((q, k, v))
    ms = device_ms(torch, fa.flash_attention, sets, 30, "b2")
    eager = eager_ms(torch, fa.flash_attention, sets, 30)
    plain = device_ms(torch, fa.flash_attention_plain, sets, 6, "b2_plain")
    sdpa_sets = [tuple(t.transpose(1, 2).contiguous() for t in a)
                 for a in sets]
    lib = device_ms(torch, lambda q, k, v: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), sdpa_sets, 30, "b2_sdpa")
    flops = 4.0 * b * h * d * live_pairs(s, s, True, 0)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    bound = max(t_bytes, t_ops) * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    say("timing", f"flash_attention q[{b},{s},{h},{d}] kv[{b},{s},{kvh},{d}] "
        f"bf16 causal: {ms:.4f} ms on the device, {eager:.4f} ms per call "
        f"from Python (bound {bound:.4f} ms by {by}: {nbytes / 1e6:.1f} MB, "
        f"{flops / 1e9:.2f} GFLOP), plain {plain:.4f} ms, SDPA {lib:.4f} ms "
        f"on the device")
    return {"ms": ms, "eager_ms": eager, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by, "library_ms": lib}


def timing_gemm(torch, dev):
    """Each case-study blocking at 16384 x 16384 x 256 f32 beside the 2.05
    ms bound, the plain version and ``torch.matmul`` (TF32 off)."""
    from repro_torch import case_study as cs
    from repro_torch.kernels import gemm, ops

    m, n, k = CASE_MNK
    nbytes = 4 * (m * k + k * n + m * n)  # A and B read once, C written once
    flops = 2.0 * m * n * k
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    bound = max(t_bytes, t_ops) * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    sets = [(torch.randn(m, k, device=dev), torch.randn(k, n, device=dev))
            for _ in range(rotation(nbytes))]
    plain = device_ms(torch, gemm.matmul_plain, sets, 10, "gemm_plain")
    lib = device_ms(torch, torch.matmul, sets, 10, "gemm_torch_matmul")
    out = {}
    for impl, cfg in cs.IMPLS.items():
        kw = {kk: v for kk, v in cfg.items() if kk != "schedule"}

        def fn(a, b, schedule=cfg["schedule"], kw=kw):
            return ops.matmul(a, b, schedule, **kw)

        ms = device_ms(torch, fn, sets, 10, f"gemm_{impl}")
        eager = eager_ms(torch, fn, sets, 10)
        say("timing", f"{impl} ({cfg['schedule']} {kw}) {m}x{n}x{k} f32: "
            f"{ms:.4f} ms on the device, {eager:.4f} ms per call from Python "
            f"(bound {bound:.4f} ms by {by}: {flops / 1e9:.1f} GFLOP at 67 "
            f"TFLOP/s f32; {nbytes / 1e6:.1f} MB would take "
            f"{t_bytes * 1e3:.4f} ms), plain {plain:.4f} ms, torch.matmul "
            f"{lib:.4f} ms on the device")
        out[impl] = {"ms": ms, "eager_ms": eager, "plain_ms": plain,
                     "bound_ms": bound, "bound_by": by, "library_ms": lib}
    return out


# ---------------------------------------------------------------------------

def main() -> int:
    import torch

    smi = card(torch)
    dev = torch.device("cuda", 0)
    build_kernels()
    err_b1 = parity_b1(torch, dev)
    err_b2 = parity_b2(torch, dev)
    err_gemm = parity_gemm(torch, dev)
    eng, prompts, launches, stats = main_path(torch, dev)
    trace = traces(torch, eng, prompts)
    t_b1 = timing_b1(torch, dev)
    t_b2 = timing_b2(torch, dev)
    del eng
    torch.cuda.empty_cache()
    smoke_parity(torch, dev)
    say("main", json.dumps({
        "prefill_ms": {k: 1e3 * v["prefill_s"] for k, v in stats.items()},
        "decode_ms_per_token": {k: 1e3 * v["decode_per_tok_s"]
                                for k, v in stats.items()},
        "trace": trace}))
    case_launches, case, case_err = case_study_path(torch, dev)
    case_trace = traces_case(torch, dev)
    say("case", json.dumps({"mnk": CASE_MNK, "max_sampling_err_pct": case_err,
                            "runs": case, "trace": case_trace}))
    t_gemm = timing_gemm(torch, dev)
    from repro_torch import case_study as cs

    by_impl = {schedule: {impl: t_gemm[impl]["ms"] for impl, cfg
                          in cs.IMPLS.items() if cfg["schedule"] == schedule}
               for schedule in ("cache_blocked", "panel_streaming")}
    kernels = []
    for name, err, t in (
            ("probe_moments", err_b1, t_b1),
            ("flash_attention", err_b2, t_b2),
            ("cache_blocked_matmul", err_gemm["cache_blocked"],
             {**t_gemm["atlas_default"],
              "ms_by_impl": by_impl["cache_blocked"]}),
            ("panel_streaming_matmul", err_gemm["panel_streaming"],
             {**t_gemm["goto"], "ms_by_impl": by_impl["panel_streaming"]})):
        paths = {"serve": launches[name], "case_study": case_launches[name]}
        kernels.append({"name": name, "route": "cuda",
                        "source": SOURCES[name], "replaces": REPLACES[name],
                        "launches": sum(paths.values()),
                        "launches_by_path": paths, "max_abs_err": err, **t})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
