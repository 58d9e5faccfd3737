"""Uniform model API: one ``ModelBundle`` per architecture family (the port
of ``repro.models.api``).

Batch layouts per family:

* text (dense, moe, ssm, hybrid): ``{"tokens": (B, S) int}``
* vlm: ``{"tokens", "patch_embeds": (B, P, d), "positions": (3, B, S)}``;
  patch embeddings (stub vision frontend) overwrite the first P token
  slots, and M-RoPE positions carry the three t/h/w streams.
* audio (encoder-decoder): ``{"tokens", "frames": (B, F, d)}``; stub
  frontend frames feed the encoder, which runs in the frames' dtype (as in
  the JAX package: float32 frames give a bfloat16 model a float32 encoder
  and float32 cross K/V), the decoder computes the logits and the loss.

Serve batches are ``{"token": (B, 1) int}`` against a model cache. The
bundle holds its device: ``build_model`` puts it on the card unless the
caller asks for the CPU, and raises where there is no card.

Every family of the JAX package is ported, for serving and training
(``loss_fn``; the plain attention only: the flash kernel has no backward).

``build_model(cfg, device, group)`` with a model group of m ranks
(``launch.tensor_parallel``) is one rank's bundle: ``init`` draws the tree
as the one-process bundle does, in the same order, and cuts each leaf to
the rank's block (``launch.sharding.param_pspec``) as soon as it is drawn,
so no more than one leaf is ever whole (a MoE expert leaf is cut as its
float32 draw, before the cast); ``init_cache`` allocates
the rank's block of every cache leaf (``cache_pspec``), and every call runs
under the group, so the model code computes on the blocks and meets the
other ranks in the collectives. Logits come back as the rank's vocabulary block
(``transformer.vocab_offset``). ``group=None`` is the one-process model.

On a grid (a group whose client axes are processes too) the rank keeps
its blocks over ``data`` as well (FSDP configs), and serves and trains its
own rows of the batch: ``init_cache(rows, ...)`` allocates the cache of
the rank's rows (its ``model`` blocks), and ``loss_fn`` returns the loss
of the whole batch, each rank's share summed over the rows group
(``tensor_parallel.reduce_from_rows``; each rank's gradient is of its
own share).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.convert import resolve_device
from repro_torch.launch import sharding
from repro_torch.launch import tensor_parallel as tp
from repro_torch.models import encdec, transformer
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.models.layers import MetaGenerator, embed_apply

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
    group: Optional[tp.ModelGroup] = None


def param_shapes(cfg: ModelConfig) -> Tree:
    """The parameter tree of ``cfg`` on the meta device: shapes and dtypes,
    no data (the JAX package's ``jax.eval_shape(bundle.init, key)``)."""
    init = encdec.init_params if cfg.encoder_layers else transformer.init_params
    return init(MetaGenerator(), cfg)


def cache_shapes(cfg: ModelConfig, batch: int, max_len: int) -> Tree:
    """The cache tree of ``cfg`` on the meta device."""
    init = encdec.init_cache if cfg.encoder_layers else transformer.init_cache
    return init(cfg, batch, max_len, torch.device("meta"))


# a cache leaf's initial value, by name: the slot positions start empty
# (-1), the sLSTM stabilizer at -1e30, everything else at zero
_CACHE_FILL = {"pos": -1, "m": -1e30}


def _rank_keep(cfg: ModelConfig, group: tp.ModelGroup):
    """An init's ``keep`` (``transformer.init_params``) that cuts each part,
    as it is drawn, to the rank's block of every leaf, by the spec of the
    leaf in the whole tree: a stacked leaf's spec leads with ``None``, so
    layer ``i``'s block is slot ``i`` of the stack's block."""
    mesh, coords = group.mesh, group.coords

    def keep(path, tree, stack=None):
        def leaf(p, x):
            if stack is None:
                return sharding.shard(x, sharding.param_pspec(p, x, cfg, mesh), mesh, coords)
            whole = torch.empty((stack,) + tuple(x.shape), dtype=x.dtype, device="meta")
            spec = sharding.param_pspec(p, whole, cfg, mesh)
            if spec[0] is not None:
                raise ValueError(f"{p}: a stacked layer dim is split ({spec})")
            return sharding.shard(x, spec[1:], mesh, coords)

        return sharding.map_with_path(leaf, tree, path)

    return keep


def _rank_cache(cfg: ModelConfig, batch: int, max_len: int, group: tp.ModelGroup,
                device: torch.device) -> Tree:
    """The rank's block of every cache leaf, allocated at its block shape:
    the cache of the rank's ``batch`` rows, cut over the ``model`` axis."""
    full = cache_shapes(cfg, batch, max_len)
    mesh = group.model_mesh

    def leaf(path, x):
        spec = sharding.cache_pspec(path, x, cfg, mesh)
        return torch.full(sharding.shard_shape(x.shape, spec, mesh),
                          _CACHE_FILL.get(path[-1], 0),
                          dtype=x.dtype, device=device)

    return sharding.map_with_path(leaf, full)


def _on_group(bundle: "ModelBundle") -> "ModelBundle":
    """``bundle`` whose every call runs under its group, with the group's
    blocks for parameters and caches."""
    group, cfg = bundle.group, bundle.cfg
    if group is None or group.world == 1:
        return bundle
    if group.data_size > 1 and not cfg.encoder_layers:
        transformer.param_specs_on(cfg, group.mesh)  # the specs the layers gather by

    def init(gen):
        return bundle.init(gen, _rank_keep(cfg, group))

    def init_cache(batch_size, max_len):
        return _rank_cache(cfg, batch_size, max_len, group, bundle.device)

    return dataclasses.replace(
        bundle, init=init, init_cache=init_cache, loss_fn=tp.bind(bundle.loss_fn, group),
        serve_step=tp.bind(bundle.serve_step, group), prefill=tp.bind(bundle.prefill, group))


def _embed_with_patches(params, cfg, tokens, patch_embeds):
    """Vision tokens (stub patch embeddings) occupy the first P slots (the
    token embeddings of those slots get no gradient, as in the JAX
    package's ``.at[:, :P].set``)."""
    h = embed_apply(params["embed"], tokens, cfg.padded_vocab)
    P = patch_embeds.shape[1]
    return torch.cat([patch_embeds.to(h.dtype), h[:, P:]], dim=1)


def build_model(cfg: ModelConfig, device: Any = None,
                group: Optional[tp.ModelGroup] = None) -> ModelBundle:
    """The bundle of ``cfg`` on ``device`` (the card when None); with a
    model ``group``, that rank's bundle."""
    build = _build_encdec if cfg.encoder_layers else _build_decoder_only
    bundle = build(cfg, resolve_device(device))
    return _on_group(dataclasses.replace(bundle, group=group))


def _check_generator(gen: torch.Generator, device: torch.device) -> None:
    if gen.device.type != device.type:
        raise ValueError(f"the generator is on {gen.device}, the model on {device}")


def _refuse_flash_training(cfg: ModelConfig) -> None:
    if cfg.attn_impl == "flash":
        raise ValueError("the flash kernel is forward only: train with attn_impl='xla'")


# --------------------------------------------------------------------- #
# decoder-only families
# --------------------------------------------------------------------- #
def _build_decoder_only(cfg: ModelConfig, device: torch.device) -> ModelBundle:
    is_vlm = cfg.family == "vlm"
    dtype = transformer.param_dtype(cfg)

    def init(gen: torch.Generator, keep=transformer.keep_whole):
        _check_generator(gen, device)
        return transformer.init_params(gen, cfg, keep)

    def loss_fn(params, batch, rng):
        """Mean next-token cross-entropy of ``batch`` (a 0-d float32 tensor);
        ``rng`` is unused by these families."""
        del rng
        _refuse_flash_training(cfg)
        if is_vlm:
            embeds = _embed_with_patches(params, cfg, batch["tokens"], batch["patch_embeds"])
            return tp.reduce_from_rows(transformer.lm_loss(
                params, cfg, batch["tokens"], embeds=embeds, positions=batch.get("positions")))
        return tp.reduce_from_rows(transformer.lm_loss(params, cfg, batch["tokens"]))

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


# --------------------------------------------------------------------- #
# encoder-decoder (audio)
# --------------------------------------------------------------------- #
def _build_encdec(cfg: ModelConfig, device: torch.device) -> ModelBundle:
    dtype = transformer.param_dtype(cfg)

    def init(gen: torch.Generator, keep=transformer.keep_whole):
        _check_generator(gen, device)
        return encdec.init_params(gen, cfg, keep)

    def loss_fn(params, batch, rng):
        del rng
        _refuse_flash_training(cfg)
        return tp.reduce_from_rows(encdec.lm_loss(params, cfg, batch["tokens"], batch["frames"]))

    def init_cache(batch_size, max_len):
        return encdec.init_cache(cfg, batch_size, max_len, device)

    def serve_step(params, cache, batch):
        logits, new_cache, _ = encdec.decode_forward(
            params, cfg, batch["token"], memory=None, cache=cache, mode="decode")
        return logits, new_cache

    def prefill(params, batch, cache):
        memory = encdec.encode(params, cfg, batch["frames"])
        h, new_cache, _ = encdec.decode_hidden(params, cfg, batch["tokens"], memory,
                                               cache=cache, mode="full")
        # only the last position's logits sample the first token
        return transformer.logits_of(params, cfg, h[:, -1:]), new_cache

    def input_specs(shape: ShapeConfig):
        B, S = shape.global_batch, shape.seq_len
        F = cfg.frontend_len or 1024

        def spec(dims, dt):
            return torch.empty(dims, dtype=dt, device="meta")

        if shape.kind == "decode":
            return {"token": spec((B, 1), torch.int32)}
        return {"tokens": spec((B, S), torch.int32), "frames": spec((B, F, cfg.d_model), dtype)}

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
