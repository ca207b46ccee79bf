"""StableLM-2-1.6B [hf:stabilityai/stablelm-2-1_6b] — LayerNorm, partial
rotary (25%), gated SiLU MLP, full MHA (kv=32)."""
from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-1.6b", arch_type="dense",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=5632,
    vocab_size=100352, head_dim=64,
    norm="layernorm", act="silu", gated_mlp=True,
    rotary_pct=0.25, rope_theta=10000.0,
    source="[hf:stabilityai/stablelm-2-1_6b]",
)
