"""Encoder-decoder backbone (SeamlessM4T): a bidirectional encoder over stub
frame embeddings and a causal decoder with cross-attention (the port of
``repro.models.encdec``).

The audio frontend (mel features and the conv feature extractor) is a stub,
as in the JAX package: the encoder takes precomputed frame embeddings
(B, F, d). The decoder is a causal transformer with a cross-attention per
layer; the cross K/V are projected once from the encoder memory at prefill
and carried in the cache (``cross_k`` / ``cross_v``, F = ``frontend_len``).
Every layer keeps its input's dtype, as in the JAX package: the encoder
runs in the frames' dtype, and the cross K/V in the memory's.

Layers are stacked (each leaf of ``params["encoder"]`` / ``["decoder"]`` and
of the cache's ``layers`` leads with the layer count) and run in a loop,
where the JAX package scans them; a layer's cache slices are views, so its
in-place writes land in the stacked cache. The encoder's bidirectional
attention and the cross-attention are the plain chunked attention, as in
the JAX package; only the decoder's causal self-attention goes through
``blocks._attn_core_full``, so only it reaches the flash kernel under
``attn_impl="flash"``.

Under a model group (``launch.tensor_parallel``) the encoder's, the
decoder's and the cross-attention split by heads as ``models.attention``
does, and the MLPs by their blocks; the cross K/V cache is stored by the
sharding rule like the self-attention cache.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.core.tree import tree_map
from repro_torch.launch import tensor_parallel as tp
from repro_torch.models import attention as attn
from repro_torch.models.blocks import _attn_core_decode, _attn_core_full, attn_cache_init
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    embed_apply,
    embed_init,
    keep_below,
    keep_whole,
    mlp_apply,
    mlp_init,
    rmsnorm_apply,
    rmsnorm_init,
)
from repro_torch.models.transformer import (
    _unstack,
    chunked_ce,
    default_positions,
    logits_of,
    param_dtype,
    stacked_draws,
)

Tree = Any


def _enc_block_init(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
                    keep=keep_whole) -> Tree:
    d, dev = cfg.d_model, gen.device
    return {
        "ln1": keep(("ln1",), rmsnorm_init(d, dtype, dev)),
        "attn": attn.attn_init(gen, cfg, dtype, keep_below(keep, "attn")),
        "ln2": keep(("ln2",), rmsnorm_init(d, dtype, dev)),
        "mlp": mlp_init(gen, d, cfg.d_ff, dtype, keep_below(keep, "mlp")),
    }


def _dec_block_init(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
                    keep=keep_whole) -> Tree:
    d, dev = cfg.d_model, gen.device
    return {
        "ln1": keep(("ln1",), rmsnorm_init(d, dtype, dev)),
        "self": attn.attn_init(gen, cfg, dtype, keep_below(keep, "self")),
        "ln_x": keep(("ln_x",), rmsnorm_init(d, dtype, dev)),
        "cross": attn.attn_init(gen, cfg, dtype, keep_below(keep, "cross")),
        "ln2": keep(("ln2",), rmsnorm_init(d, dtype, dev)),
        "mlp": mlp_init(gen, d, cfg.d_ff, dtype, keep_below(keep, "mlp")),
    }


def init_params(gen: torch.Generator, cfg: ModelConfig, keep=keep_whole) -> Tree:
    """Parameters on ``gen``'s device, drawn in order: the embedding, the
    encoder layers, the decoder layers, the unembedding; each part cut to
    ``keep`` as it is drawn (``transformer.init_params``)."""
    dtype = param_dtype(cfg)
    dev = gen.device
    E, L = cfg.encoder_layers, cfg.num_layers
    params = {"embed": keep(("embed",), embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype))}
    params["encoder"] = stacked_draws(E, lambda: _enc_block_init(
        gen, cfg, dtype, lambda path, tree: keep(("encoder",) + path, tree, E)))
    params["decoder"] = stacked_draws(L, lambda: _dec_block_init(
        gen, cfg, dtype, lambda path, tree: keep(("decoder",) + path, tree, L)))
    params["ln_enc"] = keep(("ln_enc",), rmsnorm_init(cfg.d_model, dtype, dev))
    params["ln_f"] = keep(("ln_f",), rmsnorm_init(cfg.d_model, dtype, dev))
    if not cfg.tie_embeddings:
        params["unembed"] = keep(("unembed",),
                                 embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype))
    return params


def _remat(cfg: ModelConfig) -> bool:
    return cfg.remat and torch.is_grad_enabled()


def encode(params: Tree, cfg: ModelConfig, frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, F, d) stub frontend embeddings -> encoder memory (B, F, d)."""

    def body(h, p):
        a = rmsnorm_apply(p["ln1"], h, cfg.norm_eps)
        hs = attn.head_split(cfg)
        pa = attn.rank_weights(p["attn"], cfg, hs)
        a = attn.enter(a, hs)
        q = attn.project_q(pa, a, cfg)  # no rope in the encoder
        k, v = attn.project_kv(pa, a, cfg)
        out = attn.chunked_attention(q, attn.kv_heads(k, hs), attn.kv_heads(v, hs),
                                     causal=False, q_chunk=cfg.q_chunk,
                                     recompute=cfg.scan_attn_chunks)
        h = h + attn.attn_output(pa, out, cfg, hs)
        m = rmsnorm_apply(p["ln2"], h, cfg.norm_eps)
        return h + mlp_apply(p["mlp"], m, cfg.activation, cfg.d_ff)

    h = frames
    for p in _unstack(params["encoder"], cfg.encoder_layers):
        h = tp.checkpoint(body, h, p) if _remat(cfg) else body(h, p)
    return rmsnorm_apply(params["ln_enc"], h, cfg.norm_eps)


def _cross_attend(p: Tree, h: torch.Tensor, mem_k: torch.Tensor, mem_v: torch.Tensor,
                  cfg: ModelConfig, hs: attn.HeadSplit) -> torch.Tensor:
    """``p``: the rank's weights (``attn.rank_weights``); ``mem_k`` /
    ``mem_v``: the cross K/V the rank's heads read."""
    q = attn.project_q(p, attn.enter(h, hs), cfg)  # no rope on cross-attention
    out = attn.chunked_attention(q, mem_k, mem_v, causal=False, q_chunk=cfg.q_chunk,
                                 recompute=cfg.scan_attn_chunks)
    return attn.attn_output(p, out, cfg, hs)


def decode_hidden(
    params: Tree,
    cfg: ModelConfig,
    tokens: torch.Tensor,
    memory: Optional[torch.Tensor],
    cache: Optional[Tree] = None,
    mode: str = "full",
) -> Tuple[torch.Tensor, Optional[Tree], torch.Tensor]:
    """Causal decoder over ``tokens`` attending to encoder ``memory`` (None
    in decode mode: the cache holds the cross K/V). Returns (final-norm
    hidden, new cache, a 0-d float32 aux loss of 0)."""
    h = embed_apply(params["embed"], tokens, cfg.padded_vocab)
    B, S = h.shape[:2]
    decode = mode == "decode"
    offset = cache["len"] if (cache is not None and decode) else 0
    positions = default_positions(cfg, B, S, h.device, offset=offset)

    def body(h, p, c):
        a = rmsnorm_apply(p["ln1"], h, cfg.norm_eps)
        if decode:
            s, _ = _attn_core_decode(p["self"], a, positions, c["self"], cfg)
        else:
            s, _ = _attn_core_full(p["self"], a, positions, c["self"] if c else None, cfg)
        h = h + s
        xh = rmsnorm_apply(p["ln_x"], h, cfg.norm_eps)
        hs = attn.head_split(cfg)
        pc = attn.rank_weights(p["cross"], cfg, hs)
        if c is not None and decode:
            F = cfg.frontend_len
            mem_k, mem_v = attn.cache_read(c["cross_k"], F), attn.cache_read(c["cross_v"], F)
        else:
            mem = attn.enter(memory, hs)
            mem_k, mem_v = attn.project_kv(pc, mem, cfg)
            if c is not None:
                attn.cache_fill(c["cross_k"], mem_k, mem_k.shape[1])
                attn.cache_fill(c["cross_v"], mem_v, mem_v.shape[1])
        mem_k, mem_v = attn.kv_heads(mem_k, hs), attn.kv_heads(mem_v, hs)
        h = h + _cross_attend(pc, xh, mem_k, mem_v, cfg, hs)
        m = rmsnorm_apply(p["ln2"], h, cfg.norm_eps)
        return h + mlp_apply(p["mlp"], m, cfg.activation, cfg.d_ff)

    layers = cache["layers"] if cache is not None else None
    if layers is not None and not decode and layers["cross_k"].dtype != memory.dtype:
        # the cross K/V take the memory's dtype, as the JAX package's scan
        # outputs do (float32 frames in a bfloat16 model: float32 K/V)
        layers = dict(layers, **{name: torch.empty_like(layers[name], dtype=memory.dtype)
                                 for name in ("cross_k", "cross_v")})
    remat = _remat(cfg) and cache is None
    for i, p in enumerate(_unstack(params["decoder"], cfg.num_layers)):
        c = tree_map(lambda x: x[i], layers) if layers is not None else None
        h = tp.checkpoint(body, h, p, c) if remat else body(h, p, c)
    new_cache = None
    if cache is not None:
        new_cache = {"layers": layers, "len": cache["len"] + S}
    h = rmsnorm_apply(params["ln_f"], h, cfg.norm_eps)
    return h, new_cache, torch.zeros((), dtype=torch.float32, device=h.device)


def decode_forward(
    params: Tree,
    cfg: ModelConfig,
    tokens: torch.Tensor,
    memory: Optional[torch.Tensor],
    cache: Optional[Tree] = None,
    mode: str = "full",
) -> Tuple[torch.Tensor, Optional[Tree], torch.Tensor]:
    """Returns (logits (B, S, V) f32, new cache, aux loss)."""
    h, new_cache, aux = decode_hidden(params, cfg, tokens, memory, cache=cache, mode=mode)
    return logits_of(params, cfg, h), new_cache, aux


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device: torch.device,
               dtype: Optional[torch.dtype] = None) -> Tree:
    """Decoder cache: per layer the self-attention ring and the cross K/V."""
    dtype = dtype or param_dtype(cfg)
    L, F = cfg.num_layers, cfg.frontend_len
    shape = (batch, F, cfg.num_kv_heads, cfg.head_dim)
    one = {
        "self": attn_cache_init(cfg, batch, max_len, dtype, device),
        "cross_k": torch.zeros(shape, dtype=dtype, device=device),
        "cross_v": torch.zeros(shape, dtype=dtype, device=device),
    }
    # real copies, not a broadcast view: the cache is written in place
    layers = tree_map(lambda x: x.unsqueeze(0).repeat((L,) + (1,) * x.dim()), one)
    return {"layers": layers, "len": torch.zeros((), dtype=torch.int32, device=device)}


def lm_loss(params: Tree, cfg: ModelConfig, tokens: torch.Tensor,
            frames: torch.Tensor) -> torch.Tensor:
    """Next-token cross-entropy of the decoder over ``tokens`` given the
    encoded ``frames`` (on a grid of D client ranks, the rank's share: its
    mean over D)."""
    memory = encode(params, cfg, frames)
    h, _, _ = decode_hidden(params, cfg, tokens, memory)
    unemb = params["embed"] if cfg.tie_embeddings else params["unembed"]
    return chunked_ce(h[:, :-1], unemb, tokens[:, 1:], use_scan=cfg.scan_attn_chunks,
                      vocab=cfg.padded_vocab) / tp.row_share()[1]
