"""Uniform model API: one ``ModelBundle`` per architecture family (the port
of ``repro.models.api``).

Batch layouts per family:

* text (dense): ``{"tokens": (B, S) int}``
* vlm: ``{"tokens", "patch_embeds": (B, P, d), "positions": (3, B, S)}``;
  patch embeddings (stub vision frontend) overwrite the first P token
  slots, and M-RoPE positions carry the three t/h/w streams.

Serve batches are ``{"token": (B, 1) int}`` against a model cache. The
bundle holds its device: ``build_model`` puts it on the card unless the
caller asks for the CPU, and raises where there is no card.

Ported are the decoder-only families whose blocks are dense or
mixture-of-experts (dense, vlm, moe), for serving and training (``loss_fn``, through ``transformer.lm_loss``; the
plain attention only: the flash kernel has no backward). The
encoder-decoder family raises ``NotImplementedError`` (ROADMAP Queue 1 item
8); so do the other block kinds, when their parameters or caches are made.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.convert import resolve_device
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.models.layers import embed_apply

Tree = Any


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: ModelConfig
    device: torch.device
    init: Callable[[torch.Generator], Tree]
    loss_fn: Callable[[Tree, Dict[str, torch.Tensor], Any], torch.Tensor]
    init_cache: Callable[[int, int], Tree]
    serve_step: Callable[[Tree, Tree, Dict[str, torch.Tensor]], Tuple[torch.Tensor, Tree]]
    prefill: Callable[[Tree, Dict[str, torch.Tensor], Tree], Tuple[torch.Tensor, Tree]]
    input_specs: Callable[[ShapeConfig], Dict[str, torch.Tensor]]


def _embed_with_patches(params, cfg, tokens, patch_embeds):
    """Vision tokens (stub patch embeddings) occupy the first P slots (the
    token embeddings of those slots get no gradient, as in the JAX
    package's ``.at[:, :P].set``)."""
    h = embed_apply(params["embed"], tokens)
    P = patch_embeds.shape[1]
    return torch.cat([patch_embeds.to(h.dtype), h[:, P:]], dim=1)


def build_model(cfg: ModelConfig, device: Any = None) -> ModelBundle:
    """The bundle of ``cfg`` on ``device`` (the card when None)."""
    if cfg.encoder_layers:
        raise NotImplementedError(
            f"{cfg.arch_id}: the encoder-decoder family is not ported yet (ROADMAP Queue 1 item 8)")
    return _build_decoder_only(cfg, resolve_device(device))


# --------------------------------------------------------------------- #
# decoder-only families
# --------------------------------------------------------------------- #
def _build_decoder_only(cfg: ModelConfig, device: torch.device) -> ModelBundle:
    is_vlm = cfg.family == "vlm"
    dtype = transformer.param_dtype(cfg)

    def init(gen: torch.Generator):
        if gen.device.type != device.type:
            raise ValueError(f"the generator is on {gen.device}, the model on {device}")
        return transformer.init_params(gen, cfg)

    def loss_fn(params, batch, rng):
        """Mean next-token cross-entropy of ``batch`` (a 0-d float32 tensor);
        ``rng`` is unused by these families."""
        del rng
        if cfg.attn_impl == "flash":
            raise ValueError("the flash kernel is forward only: train with attn_impl='xla'")
        if is_vlm:
            embeds = _embed_with_patches(params, cfg, batch["tokens"], batch["patch_embeds"])
            return transformer.lm_loss(params, cfg, batch["tokens"], embeds=embeds,
                                       positions=batch.get("positions"))
        return transformer.lm_loss(params, cfg, batch["tokens"])

    def init_cache(batch_size, max_len):
        return transformer.init_cache(cfg, batch_size, max_len, device)

    def serve_step(params, cache, batch):
        return transformer.decode_step(params, cfg, batch["token"], cache)

    def prefill(params, batch, cache):
        embeds = None
        if is_vlm:
            embeds = _embed_with_patches(params, cfg, batch["tokens"], batch["patch_embeds"])
        h, new_cache, _ = transformer.forward_hidden(
            params, cfg, tokens=batch["tokens"], embeds=embeds,
            positions=batch.get("positions"), cache=cache, mode="full",
        )
        # serving prefill: only the last position's logits are needed to
        # sample the first generated token, and rows are independent, so
        # only that position is unembedded (all of them would be B*S*V f32)
        return transformer.logits_of(params, cfg, h[:, -1:]), new_cache

    def input_specs(shape: ShapeConfig):
        """Meta tensors (shape and dtype, no data) of a batch for ``shape``."""
        B, S = shape.global_batch, shape.seq_len

        def spec(dims, dt):
            return torch.empty(dims, dtype=dt, device="meta")

        if shape.kind == "decode":
            return {"token": spec((B, 1), torch.int32)}
        specs = {"tokens": spec((B, S), torch.int32)}
        if is_vlm:
            P = cfg.vision_patches or 256
            specs["patch_embeds"] = spec((B, P, cfg.d_model), dtype)
            specs["positions"] = spec((3, B, S), torch.int32)
        return specs

    return ModelBundle(
        cfg=cfg,
        device=device,
        init=init,
        loss_fn=loss_fn,
        init_cache=init_cache,
        serve_step=serve_step,
        prefill=prefill,
        input_specs=input_specs,
    )
