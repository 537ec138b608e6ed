"""Shared model layers, instrumented with ScALPEL scopes.

The JAX package's ``repro.models.layers`` for the dense decoder, in
PyTorch, with the same param layouts and the same scopes and probes: every
block opens a ``scalpel.function`` scope and probes its live tensors;
whether anything is computed is decided by the runtime MonitorParams.

Prefill attention dispatches as the reference does: up to 256 query rows it
materializes the probabilities (``reference_attention``, which probes them
as ``probs``); above that it runs the flash kernel
(kernels/ops.flash_attention), the JAX package's ``attn_impl="pallas"``
route.  Decode attention is plain einsum/softmax
over the whole cache, masked past the write position.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import core as scalpel
from ..kernels import ops
from .params import P
from .spec import ModelConfig

NEG_INF = -1e30
FLASH_MIN_SQ = 257  # the reference's `sq <= 256` materializes probs


def dt(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rms_norm_spec(d: int) -> P:
    return P((d,), ("embed",), init="ones")


def rms_norm(x, scale, eps: float = 1e-6):
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.to(torch.float32)).to(x.dtype)


def head_rms_norm(x, scale, eps: float = 1e-6):
    """qk-norm: normalize over head_dim (qwen3)."""
    return rms_norm(x, scale, eps)


# ---------------------------------------------------------------------------
# rope
# ---------------------------------------------------------------------------

def rope(x, positions, theta: float):
    """x: [..., s, h, d]; positions: [..., s] int."""
    d = x.shape[-1]
    half = d // 2
    freqs = torch.exp(
        -math.log(theta)
        * torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    )
    ang = positions[..., :, None].to(torch.float32) * freqs  # [..., s, half]
    cos = torch.cos(ang)[..., :, None, :]  # broadcast over heads
    sin = torch.sin(ang)[..., :, None, :]
    xf1 = x[..., :half].to(torch.float32)
    xf2 = x[..., half:].to(torch.float32)
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def attention_specs(cfg: ModelConfig) -> dict:
    d, h, k, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    sp = {
        "wq": P((d, h, hd), ("embed", "heads", "head_dim")),
        "wk": P((d, k, hd), ("embed", "kv_heads", "head_dim")),
        "wv": P((d, k, hd), ("embed", "kv_heads", "head_dim")),
        "wo": P((h, hd, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qk_norm:
        sp["q_norm"] = P((hd,), ("head_dim",), init="ones")
        sp["k_norm"] = P((hd,), ("head_dim",), init="ones")
    return sp


def _qkv(cfg: ModelConfig, p, x, positions):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(x.dtype))
    if cfg.qk_norm:
        q = head_rms_norm(q, p["q_norm"])
        k = head_rms_norm(k, p["k_norm"])
    return rope(q, positions, cfg.rope_theta), rope(k, positions, cfg.rope_theta), v


def _repeat_kv(k, n_rep: int):
    if n_rep == 1:
        return k
    return k.repeat_interleave(n_rep, dim=2)


def _out_proj(cfg: ModelConfig, p, a):
    return torch.einsum("bshk,hkd->bsd", a, p["wo"].to(a.dtype))


def reference_attention(cfg: ModelConfig, q, k, v, causal: bool = True):
    """Materialized-probs attention.  Probes the probabilities."""
    k = _repeat_kv(k, q.shape[2] // k.shape[2])
    v = _repeat_kv(v, q.shape[2] // v.shape[2])
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) * scale
    sq, sk = q.shape[1], k.shape[1]
    qpos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    scalpel.probe(probs=probs)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(q.dtype), v)


def run_attention(cfg: ModelConfig, q, k, v, causal: bool = True):
    """Dispatch the sequence mixing.  (The reference pads heads to the
    tensor-parallel axis here; with one device that is a no-op, and it
    returns with the distribution slice.)"""
    if q.shape[1] < FLASH_MIN_SQ:
        return reference_attention(cfg, q, k, v, causal)
    return ops.flash_attention(q, k, v, causal=causal)


def decode_attention(cfg: ModelConfig, p, x, cache_k, cache_v, pos: int):
    """One-token decode for the whole batch.

    x: [b, 1, d]; cache_{k,v}: [b, S, kvh, hd], written IN PLACE at ``pos``
    (the host-side write position, uniform across the batch as in
    static-batch serving).  Query heads are grouped over their KV head
    instead of repeating the cache.  Returns (y [b,1,d], cache_k, cache_v).
    """
    with scalpel.function("attn"):
        b = x.shape[0]
        positions = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
        q, k_new, v_new = _qkv(cfg, p, x, positions)
        cache_k[:, pos:pos + 1] = k_new.to(cache_k.dtype)
        cache_v[:, pos:pos + 1] = v_new.to(cache_v.dtype)
        kvh, hd = cache_k.shape[2], cache_k.shape[3]
        qg = q.reshape(b, kvh, cfg.n_heads // kvh, hd)  # [b, g, rep, hd]
        scale = 1.0 / math.sqrt(hd)
        s = torch.einsum("bgrd,bkgd->bgrk", qg,
                         cache_k.to(x.dtype)).to(torch.float32) * scale
        kpos = torch.arange(cache_k.shape[1], device=x.device)
        s = torch.where(kpos <= pos, s, NEG_INF)
        p_attn = torch.softmax(s, dim=-1)
        out = torch.einsum("bgrk,bkgd->bgrd", p_attn.to(x.dtype),
                           cache_v.to(x.dtype))
        y = _out_proj(cfg, p, out.reshape(b, 1, cfg.n_heads, hd))
        scalpel.probe(out=y)
        return y, cache_k, cache_v


# ---------------------------------------------------------------------------
# mlp
# ---------------------------------------------------------------------------

def mlp_specs(cfg: ModelConfig, d_ff: int | None = None) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return {
        "wi": P((d, f), ("embed", "mlp")),
        "wg": P((d, f), ("embed", "mlp")),
        "wo": P((f, d), ("mlp", "embed")),
    }


def mlp(cfg: ModelConfig, p, x):
    with scalpel.function("mlp"):
        h = x @ p["wi"].to(x.dtype)
        g = x @ p["wg"].to(x.dtype)
        h = F.silu(g.to(torch.float32)).to(x.dtype) * h
        y = h @ p["wo"].to(x.dtype)
        scalpel.probe(out=y)
        return y


# ---------------------------------------------------------------------------
# embedding / unembedding
# ---------------------------------------------------------------------------

def embed_specs(cfg: ModelConfig) -> dict:
    return {"table": P((cfg.vocab, cfg.d_model), ("vocab", "embed"),
                       scale=0.02),
            "unembed": P((cfg.d_model, cfg.vocab), ("embed", "vocab"))}


def embed(cfg: ModelConfig, p, tokens):
    with scalpel.function("embed"):
        x = F.embedding(tokens, p["table"]).to(dt(cfg))
        scalpel.probe(out=x)
        return x


def unembed(cfg: ModelConfig, p, x):
    with scalpel.function("logits"):
        logits = x @ p["unembed"].to(x.dtype)
        scalpel.probe(out=logits)
        return logits
