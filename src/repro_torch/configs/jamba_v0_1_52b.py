"""Jamba-v0.1-52B [arXiv:2403.19887] — hybrid Mamba+attention 1:7
interleave (attention at position 4 of each 8-layer block), MoE every
other layer: 16 experts top-2 of width 14336.

``DENSE_FFN`` is the same decoder with each MoE FFN replaced by the dense
gated-SiLU MLP of width ``d_ff`` that Jamba's other layers use: 9.285 B
parameters, which fit one card in float32 at full width and depth for
serving (the real one's 51.56 B do not). Training in float32 keeps about
20 bytes a parameter (weights, gradients, their fp32 sum and AdamW's m
and v): one card trains one period of 8 layers (2.724 B); the real
model's period (13.29 B) needs several."""
import dataclasses

from repro_torch.models.base import ArchConfig, MambaCfg, MoECfg

CONFIG = ArchConfig(
    name="jamba-v0.1-52b", arch_type="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab_size=65536, head_dim=128,
    norm="rmsnorm", act="silu", gated_mlp=True,
    rotary_pct=0.0,  # jamba uses no positional encoding
    mixer_pattern=("mamba", "mamba", "mamba", "mamba",
                   "attn", "mamba", "mamba", "mamba"),
    mamba=MambaCfg(d_state=16, d_conv=4, expand=2),
    moe=MoECfg(n_experts=16, top_k=2, d_expert=14336, n_shared=0,
               first_dense=1, period=2),
    source="Jamba [arXiv:2403.19887]",
)

DENSE_FFN = dataclasses.replace(
    CONFIG, name="jamba-v0.1-52b-dense-ffn", moe=None,
    source="Jamba [arXiv:2403.19887], its 16 top-2 experts of each MoE "
           "layer replaced by the dense gated-SiLU MLP (d_ff 14336) of "
           "its other layers",
)
