"""Model configuration — the JAX package's ``ModelConfig`` fields that the
port's configs use, so one config means the same model in both packages.
The port has no bias, tied-embedding, sliding-window or attention-route
options: qwen3-14b needs none, and each comes back with the config that
does.  The other families' fields (MoE, SSM, hybrid, encoder-decoder) come
with the slices that port those families.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str              # dense
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    # attention details
    head_dim: int = 0        # 0 -> d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 1e6
    # numerics / execution policy (overridable per run)
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
