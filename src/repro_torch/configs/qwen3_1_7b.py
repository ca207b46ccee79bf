"""Qwen3-1.7B: qk-norm, GQA kv=8, head_dim 128, tied embeddings, rope
theta 1e6."""
from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-1.7b", arch_type="dense",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=8, d_ff=6144,
    vocab_size=151936, head_dim=128,
    norm="rmsnorm", act="silu", gated_mlp=True,
    qk_norm=True, tie_embeddings=True, rope_theta=1_000_000.0,
    source="[hf:Qwen/Qwen3-1.7B]",
)
