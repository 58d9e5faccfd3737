"""qwen3-moe-235b-a22b [moe]: 94L d_model=4096 64H (GQA kv=4, head_dim=128),
moe_d_ff=1536, vocab=151936, 128 experts top-8.  [hf:Qwen/Qwen3-30B-A3B
scaled per assignment]  Too large to replicate per-client: params are FSDP-
sharded over the data axis and FL clients live on the pod axis.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=0,  # every layer is MoE
    vocab_size=151936,
    num_experts=128,
    experts_per_token=8,
    moe_d_ff=1536,
    moe_every=1,
    activation="swiglu",
    rope_theta=1_000_000.0,
    fl_axes=("pod",),
    param_sharding="fsdp",
    remat=True,
)
