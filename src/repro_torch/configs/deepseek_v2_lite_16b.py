"""DeepSeek-V2-Lite-16B [arXiv:2405.04434] — MLA kv_lora=512 (no q-lora),
1 dense layer then MoE: 2 shared + 64 routed top-6 experts of width 1408.
(The assignment header says 64 experts; its prose "160 routed" matches
DSv2-full — we follow the 64e header, noted in DESIGN.md.)"""
from repro_torch.models.base import ArchConfig, MLACfg, MoECfg

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b", arch_type="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=10944,
    vocab_size=102400,
    norm="rmsnorm", act="silu", gated_mlp=True,
    rope_theta=10000.0,
    mla=MLACfg(kv_lora_rank=512, q_lora_rank=0, qk_nope_dim=128,
               qk_rope_dim=64, v_dim=128),
    moe=MoECfg(n_experts=64, top_k=6, d_expert=1408, n_shared=2,
               first_dense=1),
    source="DeepSeek-V2 [arXiv:2405.04434]",
)
