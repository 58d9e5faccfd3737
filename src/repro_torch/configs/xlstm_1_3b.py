"""xlstm-1.3b [ssm]: 48L d_model=2048 4H, d_ff=0 (projection inside block),
vocab=50304 — sLSTM + mLSTM blocks at 1:7 ratio (every 8th layer sLSTM).
[arXiv:2405.04517 — xLSTM]  O(1) decode state -> long_500k native."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="xlstm-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    ssm_state=256,  # mLSTM qk dim per head (matrix memory N x P)
    ssm_heads=4,
    ssm_expand=2,
    slstm_every=8,
    rope_type="none",
)
