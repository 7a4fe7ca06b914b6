"""qwen2-0.5b [dense] — GQA with QKV bias. [arXiv:2407.10671; hf]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b", family="dense",
    num_layers=24, d_model=896, num_heads=14, num_kv_heads=2, head_dim=64,
    d_ff=4864, vocab_size=151936,
    qkv_bias=True, tie_embeddings=True, rope_theta=1_000_000.0,
)

REDUCED = CONFIG.replace(
    num_layers=2, d_model=56, num_heads=7, num_kv_heads=1, head_dim=8,
    d_ff=128, vocab_size=512,
)
