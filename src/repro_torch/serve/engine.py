"""Static-batch serving with ScALPEL counters: prefill, then a token loop.

The JAX package's ``repro.serve.engine.Engine`` in PyTorch.  A fixed batch
of prompts runs one monitored prefill, then ``max_new`` monitored decode
steps; the next token is sampled on the device (greedy argmax, or
Gumbel-max sampling from a ``torch.Generator`` at a temperature).  The
decode loop never waits for the device: the write position is a host
integer, the monitor decides on host values, and sampled tokens stay on
the device until the loop ends.  The two waits are the prefill logits (for
the prefill time) and the final tokens.

Monitoring rides the functional ``Monitor``: the engine threads one
``MonitorState`` through every prefill and decode step and hands the
newest counters to its ``ScalpelRuntime``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from .. import core as scalpel
from ..models.registry import Arch


@dataclasses.dataclass
class ServeConfig:
    cache_len: int = 1024
    max_new_tokens: int = 32
    temperature: float = 0.0  # 0 => greedy
    seed: int = 0


def _discover_spec(arch: Arch, cfg: ServeConfig):
    """Scope discovery from a prefill + decode on ``meta`` tensors — the
    same walk as the JAX package's, so both compile identical plans."""

    def probe_fn(p, toks):
        cache, _ = arch.prefill(p, {"tokens": toks}, cache_len=cfg.cache_len)
        return arch.decode_step(p, cache, toks[:, :1])

    seen = scalpel.discover(
        probe_fn, arch.abstract_params(),
        torch.zeros((1, min(32, cfg.cache_len)), dtype=torch.int64,
                    device="meta"),
    )
    return scalpel.spec_from_discovery(seen)


def _wait(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


class Engine:
    def __init__(self, arch: Arch, params, cfg: ServeConfig, spec=None,
                 runtime=None):
        self.arch = arch
        self.params = params
        self.cfg = cfg
        self.device = params["embed"]["table"].device
        self.spec = spec if spec is not None else _discover_spec(arch, cfg)
        self.runtime = runtime or scalpel.ScalpelRuntime(
            self.spec, device=self.device)
        self.mon = scalpel.Monitor(self.spec, params=self.runtime.params,
                                   device=self.device)
        self.mstate = self.mon.init()
        # per-token decode times, keyed by (batch, max_new)
        self.step_times: dict[tuple[int, int], list[float]] = {}
        # carried across generate() calls: reseeding per call would make
        # every unseeded generation sample identically
        self._gen = torch.Generator(device=self.device).manual_seed(cfg.seed)

        def _prefill(params, batch):
            return self.arch.prefill(params, batch,
                                     cache_len=self.cfg.cache_len)

        def _decode(params, cache, tokens):
            return self.arch.decode_step(params, cache, tokens)

        self._prefill = self.mon.jit(_prefill)
        self._decode = self.mon.jit(_decode)

    def _sample(self, logits, gen: torch.Generator):
        logits = logits[:, -1, :].to(torch.float32)
        if self.cfg.temperature <= 0:
            return torch.argmax(logits, dim=-1, keepdim=True)
        u = torch.rand(logits.shape, generator=gen, device=logits.device)
        gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
        return torch.argmax(logits / self.cfg.temperature + gumbel, dim=-1,
                            keepdim=True)

    @torch.inference_mode()
    def generate(self, batch: dict[str, Any], max_new: int | None = None,
                 seed: int | None = None):
        """batch: {'tokens': [b, s] int}.  Returns ([b, n_new] tokens on the
        host, timing stats).

        ``max_new=None`` falls back to the config default; an explicit 0
        returns an empty ``[b, 0]`` result.  ``seed``: a per-request sampling
        stream that neither reads nor advances the engine's own generator.
        """
        max_new = self.cfg.max_new_tokens if max_new is None else int(max_new)
        if max_new <= 0:
            b = int(batch["tokens"].shape[0])
            return (
                torch.zeros((b, 0), dtype=torch.int64),
                {"prefill_s": 0.0, "decode_total_s": 0.0,
                 "decode_per_tok_s": 0.0, "decode_p50_s": 0.0},
            )
        gen = self._gen if seed is None else \
            torch.Generator(device=self.device).manual_seed(seed)
        t0 = time.perf_counter()
        self.mstate = self.mon.sync(self.mstate, runtime=self.runtime)
        (cache, logits), self.mstate = self._prefill(
            self.mstate, self.params, batch)
        self.runtime.observe(self.mstate.counters)
        _wait(logits)  # output wait: the prefill time ends here
        prefill_s = time.perf_counter() - t0
        outs = []
        tok = self._sample(logits, gen)
        t0 = time.perf_counter()
        for _ in range(max_new):
            outs.append(tok)
            self.mstate = self.mon.sync(self.mstate, runtime=self.runtime)
            (logits, cache), self.mstate = self._decode(
                self.mstate, self.params, cache, tok)
            self.runtime.on_step(self.mstate.counters)
            tok = self._sample(logits, gen)
        out = torch.cat(outs, dim=1).cpu()  # output wait: the tokens
        decode_s = time.perf_counter() - t0
        per_tok = decode_s / max_new
        bucket = self.step_times.setdefault(
            (int(batch["tokens"].shape[0]), max_new), [])
        bucket.append(per_tok)
        return out, {
            "prefill_s": prefill_s,
            "decode_total_s": decode_s,
            "decode_per_tok_s": per_tok,
            "decode_p50_s": float(np.median(bucket)),
        }

    def report(self) -> str:
        self.runtime.observe(self.mstate.counters)
        return self.runtime.report("ScALPEL serving report")
