"""llama4-maverick-400b-a17b [moe]: 48L d_model=5120 40H (GQA kv=8),
d_ff=8192, vocab=202048, 128 experts top-1 + shared expert, MoE every other
layer. [hf:meta-llama/Llama-4-Scout-17B-16E scaled per assignment; early
fusion = multimodal tokens share the decoder, handled by the stub-frontend
carve-out]  FSDP-sharded; FL clients on the pod axis."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    num_experts=128,
    experts_per_token=1,
    moe_d_ff=8192,
    moe_every=2,  # interleaved dense / MoE
    shared_expert=True,
    activation="swiglu",
    rope_theta=500_000.0,
    fl_axes=("pod",),
    param_sharding="fsdp",
    remat=True,
)
