"""seamless-m4t-large-v2 [audio] — encoder-decoder multimodal backbone.
The speech frontend is a STUB: input_specs() provides precomputed frame
embeddings (B, S_enc, d_model). [arXiv:2308.11596; hf]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="audio",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16, head_dim=64,
    d_ff=8192, vocab_size=256206,
    is_encoder_decoder=True, num_encoder_layers=24,
    frontend="audio_frames", act="gelu",
)

REDUCED = CONFIG.replace(
    num_layers=2, num_encoder_layers=2, d_model=64, num_heads=4,
    num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=512,
)
