"""Decoder-only transformer backbone (dense family): serving prefill and
decode, the JAX package's ``repro.models.transformer`` in PyTorch.

The layer stack is a Python loop over layer-stacked parameters
(``scalpel.scan_with_counters``).  The KV cache is a dict ``{"k", "v":
[n_layers, b, S, kvh, hd], "pos": int}``: prefill fills it, decode writes
one position per step in place, and ``pos`` (uniform across the batch) is a
host integer, so no step reads the device to find where to write.
"""
from __future__ import annotations

import torch

from .. import core as scalpel
from . import layers as L
from .params import stacked
from .spec import ModelConfig


def layer_specs(cfg: ModelConfig) -> dict:
    return {
        "ln1": L.rms_norm_spec(cfg.d_model),
        "attn": L.attention_specs(cfg),
        "ln2": L.rms_norm_spec(cfg.d_model),
        "ffn": L.mlp_specs(cfg),
    }


def specs(cfg: ModelConfig) -> dict:
    return {
        "embed": L.embed_specs(cfg),
        "layers": stacked(lambda: layer_specs(cfg), cfg.n_layers),
        "final_norm": L.rms_norm_spec(cfg.d_model),
    }


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, device) -> dict:
    shape = (cfg.n_layers, batch, cache_len, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    kvd = L.dt(cfg)
    return {"k": torch.zeros(shape, dtype=kvd, device=device),
            "v": torch.zeros(shape, dtype=kvd, device=device),
            "pos": 0}


def prefill(cfg: ModelConfig, params, tokens, cache_len: int):
    """Run the full prompt and build a KV cache of ``cache_len`` slots.
    Returns (cache, last_logits [b, 1, V])."""
    x = L.embed(cfg, params["embed"], tokens)
    b, s, _ = x.shape
    if s > cache_len:
        raise ValueError(f"prompt of {s} tokens exceeds cache_len {cache_len}")
    positions = torch.arange(s, device=x.device).expand(b, s)
    cache = init_cache(cfg, b, cache_len, x.device)

    def body(xx, layer_in):
        lp, kc, vc = layer_in
        with scalpel.function("layer"):
            h = L.rms_norm(xx, lp["ln1"])
            with scalpel.function("attn"):
                q, k, v = L._qkv(cfg, lp["attn"], h, positions)
                a = L.run_attention(cfg, q, k, v, True)
                y = L._out_proj(cfg, lp["attn"], a)
            xx = xx + y
            h = L.rms_norm(xx, lp["ln2"])
            xx = xx + L.mlp(cfg, lp["ffn"], h)
        kc[:, :s] = k.to(kc.dtype)
        vc[:, :s] = v.to(vc.dtype)
        return xx, None

    x, _ = scalpel.scan_with_counters(
        body, x, (params["layers"], cache["k"], cache["v"]))
    x = L.rms_norm(x, params["final_norm"])
    logits = L.unembed(cfg, params["embed"], x[:, -1:, :])
    cache["pos"] = s
    return cache, logits


def decode_step(cfg: ModelConfig, params, cache, tokens):
    """One decode step for the whole batch. tokens: [b, 1] int.
    Returns (logits [b, 1, V], cache advanced by one position)."""
    x = L.embed(cfg, params["embed"], tokens)
    pos = cache["pos"]

    def body(xx, layer_in):
        lp, kc, vc = layer_in
        with scalpel.function("layer"):
            h = L.rms_norm(xx, lp["ln1"])
            y, _, _ = L.decode_attention(cfg, lp["attn"], h, kc, vc, pos)
            xx = xx + y
            h = L.rms_norm(xx, lp["ln2"])
            xx = xx + L.mlp(cfg, lp["ffn"], h)
        return xx, None

    x, _ = scalpel.scan_with_counters(
        body, x, (params["layers"], cache["k"], cache["v"]))
    x = L.rms_norm(x, params["final_norm"])
    logits = L.unembed(cfg, params["embed"], x)
    return logits, {"k": cache["k"], "v": cache["v"], "pos": pos + 1}
