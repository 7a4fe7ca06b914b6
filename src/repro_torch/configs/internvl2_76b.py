"""internvl2-76b [vlm] — InternViT + llama3-70b-class text backbone.
The vision frontend is a STUB: input_specs() provides precomputed patch
embeddings for the first frontend_tokens positions. [arXiv:2404.16821;
unverified]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b", family="vlm",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=28672, vocab_size=128256, rope_theta=500_000.0,
    frontend="vision_patches", frontend_tokens=256,
)

REDUCED = CONFIG.replace(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512, frontend_tokens=8,
)
