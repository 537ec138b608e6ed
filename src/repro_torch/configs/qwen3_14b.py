"""qwen3-14b [dense]: 40L d_model=5120 40H (GQA kv=8) d_ff=17408
vocab=151936 — qk_norm, GQA, rope theta 1e6 (Qwen3 config on the HF hub;
the same values as the JAX package's ``repro.configs.qwen3_14b``)."""
from repro_torch.models.spec import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=17408, vocab=151936, head_dim=128, qk_norm=True,
    rope_theta=1e6,
)

SMOKE = CONFIG.replace(
    name="qwen3-14b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=192, vocab=512, head_dim=16,
    param_dtype="float32", compute_dtype="float32",
)
