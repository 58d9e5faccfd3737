"""Decoder-only language model assembled from ``repro_torch.models.blocks``
(the port of ``repro.models.transformer``).

Layer stacking follows the JAX package: the repeating kind pattern
(``layer_kinds``) defines a period. With ``scan_layers`` the parameters are
stacked per period position with a leading ``G`` (groups) dim, in
``params["groups"]``, and ``apply_stack`` loops over the groups (the JAX
package scans them); otherwise ``params["layers"]`` holds one tree per
layer. The model-level cache is ``{"len": int32 0-d tensor,
"layers"/"groups": ...}``; decode positions derive from ``len``.

Training: ``lm_loss`` is the next-token cross-entropy through
``chunked_ce``. Where the JAX package wraps a scanned body in
``jax.checkpoint`` (``cfg.remat`` around each group of blocks, and each
chunk of ``chunked_ce``'s scan), the port runs the same piece under
``torch.utils.checkpoint`` while gradients are recorded, so its activations
are recomputed in the backward instead of kept.

The JAX package pins activations to a sharding profile (``shard_ctx``);
on one device that is a no-op, so the port pins none.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.tree import tree_flatten, tree_map, tree_unflatten
from repro_torch.models.blocks import block_apply, block_cache_init, block_init, layer_kinds
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import embed_apply, embed_init, rmsnorm_apply, rmsnorm_init, unembed_apply

Tree = Any


def param_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def _n_groups(cfg: ModelConfig) -> int:
    kinds = layer_kinds(cfg)
    if cfg.num_layers % len(kinds):
        raise ValueError(f"{cfg.num_layers} layers are not whole periods of {kinds}")
    return cfg.num_layers // len(kinds)


# --------------------------------------------------------------------- #
# init
# --------------------------------------------------------------------- #
def init_params(gen: torch.Generator, cfg: ModelConfig) -> Tree:
    """Parameters on ``gen``'s device, drawn from ``gen`` in order: the
    embedding, the layers (group by group), the unembedding."""
    dtype = param_dtype(cfg)
    kinds = layer_kinds(cfg)
    G = _n_groups(cfg)
    params: Dict[str, Tree] = {"embed": embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype)}
    if cfg.scan_layers:
        # stack per period position: each leaf leads with G. Each group is
        # drawn, copied into the stack and dropped, so the init holds the
        # stack and one group, not two copies of every layer.
        stacked = None
        for g in range(G):
            trees = tuple(block_init(gen, cfg, kind, dtype) for kind in kinds)
            if stacked is None:
                stacked = tuple(tree_map(lambda x: x.new_empty((G,) + tuple(x.shape)), t)
                                for t in trees)
            for dst, src in zip(stacked, trees):
                for a, b in zip(tree_flatten(dst)[0], tree_flatten(src)[0]):
                    a[g].copy_(b)
            del trees
        params["groups"] = stacked
    else:
        params["layers"] = tuple(
            block_init(gen, cfg, kinds[i % len(kinds)], dtype) for i in range(cfg.num_layers))
    params["ln_f"] = rmsnorm_init(cfg.d_model, dtype, gen.device)
    if not cfg.tie_embeddings:
        params["unembed"] = embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype)
    return params


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device: torch.device,
               dtype: Optional[torch.dtype] = None) -> Tree:
    dtype = dtype or param_dtype(cfg)
    kinds = layer_kinds(cfg)
    G = _n_groups(cfg)
    cache: Dict[str, Tree] = {"len": torch.zeros((), dtype=torch.int32, device=device)}
    if cfg.scan_layers:
        def stack(kind):
            one = block_cache_init(cfg, kind, batch, max_len, dtype, device)
            # real copies, not a broadcast view: the cache is written in place
            return tree_map(lambda x: x.unsqueeze(0).repeat((G,) + (1,) * x.dim()), one)

        cache["groups"] = tuple(stack(kind) for kind in kinds)
    else:
        cache["layers"] = tuple(
            block_cache_init(cfg, kinds[i % len(kinds)], batch, max_len, dtype, device)
            for i in range(cfg.num_layers))
    return cache


# --------------------------------------------------------------------- #
# forward
# --------------------------------------------------------------------- #
def default_positions(cfg: ModelConfig, batch: int, seq: int, device: torch.device,
                      offset: Any = 0) -> torch.Tensor:
    pos = offset + torch.arange(seq, dtype=torch.int32, device=device)[None, :]
    pos = pos.to(torch.int32).expand(batch, seq)
    if cfg.rope_type == "mrope":
        return pos[None].expand(3, batch, seq)
    return pos


def _unstack(tree: Tree, G: int) -> List[Tree]:
    """The G per-group trees of a stacked tree, as views. One ``unbind`` per
    leaf: its backward stacks the G gradients once, where G ``x[g]`` slices
    would each scatter into a zero tensor of the whole stack."""
    leaves, treedef = tree_flatten(tree)
    cols = [torch.unbind(x, 0) for x in leaves]
    return [tree_unflatten(treedef, [c[g] for c in cols]) for g in range(G)]


def apply_stack(
    params: Tree,
    h: torch.Tensor,
    positions: torch.Tensor,
    cache: Optional[Tree],
    mode: str,
    cfg: ModelConfig,
) -> Tuple[torch.Tensor, Optional[Tree], torch.Tensor]:
    kinds = layer_kinds(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    new_cache = dict(cache) if cache is not None else None
    if cfg.scan_layers:
        # layer g of kind j is the g-th slice of every leaf; the cache
        # slices are views, so each block's in-place update lands in the
        # stacked cache, which is returned as it came
        G = _n_groups(cfg)
        layers = [_unstack(params["groups"][j], G) for j in range(len(kinds))]

        def group(g, h, aux):
            for j, kind in enumerate(kinds):
                c = tree_map(lambda x: x[g], cache["groups"][j]) if cache is not None else None
                h, _, a = block_apply(layers[j][g], h, positions, c, mode, cfg, kind)
                aux = aux + a
            return h, aux

        remat = cfg.remat and cache is None and torch.is_grad_enabled()
        for g in range(G):
            if remat:
                h, aux = checkpoint(group, g, h, aux, use_reentrant=False)
            else:
                h, aux = group(g, h, aux)
        return h, new_cache, aux

    new_layers = []
    for i, p in enumerate(params["layers"]):
        ci = cache["layers"][i] if cache is not None else None
        h, ci_new, a = block_apply(p, h, positions, ci, mode, cfg, kinds[i % len(kinds)])
        new_layers.append(ci_new)
        aux = aux + a
    if new_cache is not None:
        new_cache["layers"] = tuple(new_layers)
    return h, new_cache, aux


def forward_hidden(
    params: Tree,
    cfg: ModelConfig,
    tokens: Optional[torch.Tensor] = None,
    embeds: Optional[torch.Tensor] = None,
    positions: Optional[torch.Tensor] = None,
    cache: Optional[Tree] = None,
    mode: str = "full",
) -> Tuple[torch.Tensor, Optional[Tree], torch.Tensor]:
    """Returns (final-norm hidden (B, S, d), new_cache, aux_loss)."""
    if embeds is None:
        if tokens is None:
            raise ValueError("forward needs tokens or embeds")
        h = embed_apply(params["embed"], tokens)
    else:
        h = embeds
    B, S = h.shape[:2]
    if positions is None:
        offset = cache["len"] if (cache is not None and mode == "decode") else 0
        positions = default_positions(cfg, B, S, h.device, offset=offset)
    h, new_cache, aux = apply_stack(params, h, positions, cache, mode, cfg)
    if new_cache is not None:
        new_cache["len"] = cache["len"] + S
    h = rmsnorm_apply(params["ln_f"], h, cfg.norm_eps)
    return h, new_cache, aux


def logits_of(params: Tree, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    """float32 logits (..., vocab_size) of final hidden states: the vocab
    padding rows (``cfg.padded_vocab``) are dropped at this boundary."""
    unemb = params["embed"] if cfg.tie_embeddings else params["unembed"]
    return unembed_apply(unemb, h)[..., : cfg.vocab_size]


def forward(
    params: Tree,
    cfg: ModelConfig,
    tokens: Optional[torch.Tensor] = None,
    embeds: Optional[torch.Tensor] = None,
    positions: Optional[torch.Tensor] = None,
    cache: Optional[Tree] = None,
    mode: str = "full",
) -> Tuple[torch.Tensor, Optional[Tree], torch.Tensor]:
    """Returns (logits (B, S, V) f32, new_cache, aux_loss)."""
    h, new_cache, aux = forward_hidden(
        params, cfg, tokens=tokens, embeds=embeds, positions=positions,
        cache=cache, mode=mode,
    )
    return logits_of(params, cfg, h), new_cache, aux


def chunked_ce(
    h: torch.Tensor,  # (B, S, d): hidden states of the positions predicting t+1
    unemb: Tree,
    targets: torch.Tensor,  # (B, S) int
    *,
    n_chunks: int = 16,
    use_scan: bool = True,
) -> torch.Tensor:
    """Mean cross-entropy without materializing the full (B*S, V) float32
    logits.

    Flattens the tokens into ``n_chunks`` blocks (one block when they do not
    divide evenly): each block computes its (chunk, V) logits, a
    log-sum-exp and the target gather, and the blocks' sums add up in
    order. With ``use_scan`` (the JAX package's scan) each block's logits
    are recomputed in the backward instead of kept."""
    B, S, d = h.shape
    N = B * S
    hf = h.reshape(N, d)
    tf = targets.reshape(N).to(torch.int64)
    if N % n_chunks:
        n_chunks = 1
    chunk = N // n_chunks

    def chunk_nll(hc, tc):
        logits = unembed_apply(unemb, hc)  # (chunk, V) f32
        lse = torch.logsumexp(logits, dim=-1)
        picked = torch.gather(logits, 1, tc[:, None])[:, 0]
        return torch.sum(lse - picked)

    if use_scan and n_chunks > 1:
        total = torch.zeros((), dtype=torch.float32, device=h.device)
        recompute = torch.is_grad_enabled()
        for i in range(n_chunks):
            hc, tc = hf[i * chunk:(i + 1) * chunk], tf[i * chunk:(i + 1) * chunk]
            nll = (checkpoint(chunk_nll, hc, tc, use_reentrant=False) if recompute
                   else chunk_nll(hc, tc))
            total = total + nll
    else:
        total = chunk_nll(hf, tf)
    return total / N


# --------------------------------------------------------------------- #
# losses / steps
# --------------------------------------------------------------------- #
def lm_loss(
    params: Tree,
    cfg: ModelConfig,
    tokens: torch.Tensor,
    embeds: Optional[torch.Tensor] = None,
    positions: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Next-token cross-entropy (tokens shifted internally) + router aux.

    Uses ``chunked_ce``'s recomputed blocks when the config is in
    deployment mode (``scan_attn_chunks``), as the JAX package does."""
    h, _, aux = forward_hidden(params, cfg, tokens=tokens, embeds=embeds, positions=positions)
    unemb = params["embed"] if cfg.tie_embeddings else params["unembed"]
    loss = chunked_ce(h[:, :-1], unemb, tokens[:, 1:], use_scan=cfg.scan_attn_chunks)
    return loss + cfg.router_aux_weight * aux


def decode_step(
    params: Tree,
    cfg: ModelConfig,
    token: torch.Tensor,
    cache: Tree,
) -> Tuple[torch.Tensor, Tree]:
    """One serving step: token (B, 1) int -> (logits (B, 1, V), new cache)."""
    logits, new_cache, _ = forward(params, cfg, tokens=token, cache=cache, mode="decode")
    return logits, new_cache
