"""Model/architecture configuration and the assigned input shapes (a copy of
``repro.models.config``, which needs no framework; the port keeps its own
so that it never imports the JAX package)."""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


# The four assigned input shapes.
SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One architecture. Field semantics follow the assignment table."""

    arch_id: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // num_heads
    activation: str = "swiglu"  # swiglu | geglu
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    rope_type: str = "rope"  # rope | mrope | none
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)  # t/h/w splits of head_dim/2
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    moe_every: int = 1  # 1 = every layer is MoE; 2 = alternate dense/MoE
    shared_expert: bool = False
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_heads: int = 0  # SSD heads; 0 = derive d_model // 64
    ssm_expand: int = 2
    slstm_every: int = 0  # xlstm: every Nth layer is sLSTM (0 = none)

    # --- enc-dec (audio) ---
    encoder_layers: int = 0  # >0 => encoder-decoder
    frontend_len: int = 0  # frames/patches emitted by the stub frontend

    # --- VLM ---
    vision_patches: int = 0  # stub patch-embedding count for train/prefill

    # --- long-context policy ---
    sliding_window: int = 0  # 0 = full attention (long_500k unsupported)

    # --- numerics / implementation ---
    param_dtype: str = "bfloat16"
    q_chunk: int = 1024  # unrolled query-chunk size for attention
    ssd_chunk: int = 256  # chunk length for SSD/mLSTM chunked scan
    scan_layers: bool = True
    # the JAX package's lax.scan over attention query chunks and CE blocks
    # (same values as the unrolled loop); the port keeps the loop and
    # recomputes each chunk in the backward (torch.utils.checkpoint)
    scan_attn_chunks: bool = False
    attn_impl: str = "xla"  # xla (plain attention) | flash (the flash kernel)
    remat: bool = False  # activation checkpointing around each block

    # --- FL mapping (DESIGN.md §5: which mesh axes host FL clients) ---
    fl_axes: Tuple[str, ...] = ("data", "pod")  # huge MoEs use ("pod",)
    server_strategy: str = "fedadam"
    # parameter sharding: "tp" = model-axis tensor parallel, replicated over
    # client axes; "fsdp" = additionally sharded over the data axis (archs too
    # large to replicate — their FL clients sit on the pod axis only)
    param_sharding: str = "tp"

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    # ------------------------------------------------------------------ #
    @property
    def padded_vocab(self) -> int:
        """Embedding-table rows, padded to a multiple of 256 (Megatron-style)
        so the vocab dim shards on any reasonable model axis. Logits are
        sliced back to ``vocab_size`` at the serving API boundary; padded
        columns simply participate in the softmax during training."""
        return -(-self.vocab_size // 256) * 256

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def ssd_dims(self) -> Tuple[int, int, int]:
        """The SSD sub-block's inner width, heads and state size (d_i, H,
        N); each head's value columns are P = d_i // H."""
        d_i = self.d_model * self.ssm_expand
        return d_i, self.ssm_heads or max(1, d_i // 64), self.ssm_state

    @property
    def layer_period(self) -> int:
        """Smallest repeating unit of the layer stack (for cost extraction)."""
        period = 1
        if self.slstm_every:
            period = self.slstm_every
        if self.is_moe and self.moe_every > 1:
            period = max(period, self.moe_every)
        return period

    def supports_long_context(self) -> bool:
        return (
            self.family in ("ssm", "hybrid")
            or self.sliding_window > 0
        ) and self.encoder_layers == 0

    # ---------------------- analytic param count ----------------------- #
    def param_count(self) -> int:
        d, v = self.d_model, self.vocab_size
        emb = v * d * (1 if self.tie_embeddings else 2)
        per_attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        if self.qkv_bias:
            per_attn += self.q_dim + 2 * self.kv_dim
        def ffn_params(ff: int) -> int:
            return 3 * d * ff  # swiglu/geglu: gate, up, down

        total = emb
        n_layers = self.num_layers
        if self.family == "ssm":
            # xlstm: mLSTM blocks (qkv + gates + out) ~ SSD-style params
            d_i = self.d_model * self.ssm_expand
            per_m = d * (3 * d_i) + d_i * d + 2 * d_i  # qkv/out + gates
            per_s = 4 * d * d + 4 * d  # sLSTM: 4 gates
            n_s = n_layers // self.slstm_every if self.slstm_every else 0
            total += (n_layers - n_s) * per_m + n_s * per_s + n_layers * d
            return total
        if self.family == "hybrid":
            d_i = self.d_model * self.ssm_expand
            per_ssm = d * (2 * d_i) + d_i * d + d_i * (2 * self.ssm_state)
            total += n_layers * (per_attn + per_ssm + ffn_params(self.d_ff) + 3 * d)
            return total
        if self.encoder_layers:
            enc = self.encoder_layers * (per_attn + ffn_params(self.d_ff) + 2 * d)
            dec = n_layers * (2 * per_attn + ffn_params(self.d_ff) + 3 * d)
            return total + enc + dec
        if self.is_moe:
            n_moe = n_layers // self.moe_every
            n_dense = n_layers - n_moe
            moe = n_moe * (
                per_attn
                + self.num_experts * 3 * d * self.moe_d_ff
                + d * self.num_experts
                + (3 * d * self.d_ff if self.shared_expert else 0)
                + 2 * d
            )
            dense = n_dense * (per_attn + ffn_params(self.d_ff) + 2 * d)
            return total + moe + dense
        total += n_layers * (per_attn + ffn_params(self.d_ff) + 2 * d)
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top-k of experts)."""
        if not self.is_moe:
            return self.param_count()
        full = self.param_count()
        n_moe = self.num_layers // self.moe_every
        all_experts = n_moe * self.num_experts * 3 * self.d_model * self.moe_d_ff
        active_experts = (
            n_moe * self.experts_per_token * 3 * self.d_model * self.moe_d_ff
        )
        return full - all_experts + active_experts

    def reduced(self, **overrides) -> "ModelConfig":
        """Smoke-test variant: 2 layers, d_model<=512, <=4 experts."""
        d_model = min(self.d_model, 256)
        head_dim = 32
        num_heads = max(2, min(4, self.num_heads))
        num_kv = max(1, min(num_heads, self.num_kv_heads))
        period = self.layer_period
        small: Dict = dict(
            num_layers=2 * period if period > 1 else 2,
            d_model=d_model,
            num_heads=num_heads,
            num_kv_heads=num_kv,
            head_dim=head_dim,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            num_experts=min(self.num_experts, 4),
            experts_per_token=min(self.experts_per_token, 2),
            moe_d_ff=min(self.moe_d_ff, 128),
            encoder_layers=2 if self.encoder_layers else 0,
            frontend_len=min(self.frontend_len, 16) if self.frontend_len else 0,
            vision_patches=min(self.vision_patches, 16) if self.vision_patches else 0,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            slstm_every=self.slstm_every,
            ssm_heads=min(self.ssm_heads, 4) if self.ssm_heads else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            mrope_sections=(8, 4, 4),  # sums to head_dim/2 = 16
            param_dtype="float32",
            q_chunk=32,
            ssd_chunk=16,
            scan_layers=False,
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)
