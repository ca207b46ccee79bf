"""DeepSeek-V3-671B [arXiv:2412.19437] — MLA (kv_lora 512, q_lora 1536,
rope 64), 3 dense layers then MoE: 1 shared + 256 routed top-8 experts of
width 2048 (sigmoid scores, routed scale 2.5), MTP. Dense-layer ff=18432.
The assignment's "d_ff=2048" is the per-expert width."""
from repro_torch.models.base import ArchConfig, MLACfg, MoECfg

CONFIG = ArchConfig(
    name="deepseek-v3-671b", arch_type="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128, d_ff=18432,
    vocab_size=129280,
    norm="rmsnorm", act="silu", gated_mlp=True,
    rope_theta=10000.0,
    mla=MLACfg(kv_lora_rank=512, q_lora_rank=1536, qk_nope_dim=128,
               qk_rope_dim=64, v_dim=128),
    moe=MoECfg(n_experts=256, top_k=8, d_expert=2048, n_shared=1,
               first_dense=3, score_fn="sigmoid", routed_scale=2.5),
    mtp_depth=1,
    source="DeepSeek-V3 [arXiv:2412.19437]",
)
