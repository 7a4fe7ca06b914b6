"""mixtral-8x7b [moe] — 8 experts top-2, sliding-window attention.
[arXiv:2401.04088; hf]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=32000,
    num_experts=8, top_k=2, sliding_window=4096, rope_theta=1_000_000.0,
)

REDUCED = CONFIG.replace(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512, num_experts=4, sliding_window=8,
)
