"""Nemotron-4-15B [arXiv:2402.16819] — GQA kv=8, squared-ReLU MLP (no
gate), partial rotary (50%), LayerNorm."""
from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-15b", arch_type="dense",
    n_layers=32, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=24576,
    vocab_size=256000, head_dim=128,
    norm="layernorm", act="squared_relu", gated_mlp=False,
    rotary_pct=0.5, rope_theta=10000.0,
    source="Nemotron-4 [arXiv:2402.16819]",
)
