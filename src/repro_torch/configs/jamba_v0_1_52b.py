"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave, MoE 16e top-2.
Period-8 block: attention at index 4, MoE FFN on odd indices.
[arXiv:2403.19887; hf]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=65536,
    num_experts=16, top_k=2,
    hybrid_period=8, hybrid_attn_index=4, hybrid_moe_stride=2,
    ssm_state=16, ssm_expand=2, ssm_head_dim=64, ssm_chunk=128, conv_width=4,
)

REDUCED = CONFIG.replace(
    num_layers=8, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512, num_experts=4, ssm_state=16, ssm_head_dim=16,
    ssm_chunk=8,
)
