"""GPT-20B — the paper's own weak-scaling model (Table 3: 24 layers,
hidden 8192, 64 heads, batch 1024 x seq 2048, G_tensor=16 on 128 GPUs).
Used by the paper-reproduction benchmarks (Figs. 5/8, Table 5)."""
from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    name="gpt-paper-20b", arch_type="dense",
    n_layers=24, d_model=8192, n_heads=64, n_kv_heads=64, d_ff=32768,
    vocab_size=51200, head_dim=128,
    norm="layernorm", act="gelu", gated_mlp=False,
    source="paper Table 3 / GPT-3 family [arXiv:2005.14165]",
)
