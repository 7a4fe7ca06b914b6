"""gemma2-2b [dense] — local+global alternating attention, logit softcaps.
[arXiv:2408.00118; hf]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b", family="dense",
    num_layers=26, d_model=2304, num_heads=8, num_kv_heads=4, head_dim=256,
    d_ff=9216, vocab_size=256000,
    sliding_window=4096, local_global_pattern="lg",
    attn_logit_softcap=50.0, final_logit_softcap=30.0,
    post_block_norms=True, scale_embeddings=True, tie_embeddings=True,
    act="gelu", rope_theta=10_000.0,
)

REDUCED = CONFIG.replace(
    num_layers=4, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512, sliding_window=8,
)
