"""The paper's own workload unit: PixelsDB serves SQL analytics, not LMs;
our ML-query adaptation uses a mid-size dense LM as the default "query
engine" model for SLA scheduling examples (DESIGN.md §2)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="paper-default", family="dense",
    num_layers=16, d_model=1024, num_heads=16, num_kv_heads=8, head_dim=64,
    d_ff=4096, vocab_size=32000,
)

REDUCED = CONFIG.replace(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512,
)
