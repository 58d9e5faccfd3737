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
the port calls the same pins, which return their input.

Under a model group (``launch.tensor_parallel``) the embedding is a block
of the padded vocabulary: ``logits_of`` gives the rank's block of the
logits (its columns below ``vocab_size``, from ``vocab_offset``), and
``chunked_ce`` takes a distributed log-sum-exp over the blocks (an
all-reduce of the row maxima, of the sums of exponentials and of the
target logits).

On a grid whose ``data`` axis holds FSDP's blocks (``launch.
tensor_parallel.data_group``), each layer's leaves split over ``data``
are gathered whole over it as the layer begins (inside the checkpointed
piece, so a remat layer frees them after its forward and gathers them
again in the recompute), and the embedding at the lookup and at the
logits (``data_whole``); the MoE expert leaves are gathered by the expert
FFN, one at a time (``models.moe``). Each rank runs its own rows of the
batch.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core.tree import tree_flatten, tree_map, tree_unflatten
from repro_torch.launch import sharding as shd
from repro_torch.launch import tensor_parallel as tp
from repro_torch.models import moe
from repro_torch.models.blocks import block_apply, block_cache_init, block_init, layer_kinds
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (MetaGenerator, embed_apply, embed_init, keep_below,
                                       keep_whole, rmsnorm_apply, rmsnorm_init, unembed_apply)
from repro_torch.models.shard_ctx import pin_activation, pin_stash

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
def stacked_draws(n: int, draw) -> Tree:
    """``n`` trees from ``draw()``, drawn in order, stacked leaf by leaf (the
    JAX package's ``tree_map(stack)``: dicts in sorted-key order). Each tree
    is copied into the stack and dropped, so the init holds the stack and
    one tree, not two copies of every layer. A stack of one tree is that
    tree's leaves (a view of each, copied only where a ``keep`` of the
    draw cut a view of a larger leaf): one Llama4 period is 37 GB in
    bfloat16, which a copy would hold twice."""
    if n == 1:
        return tree_map(lambda x: (x if x._base is None else x.clone(
            memory_format=torch.contiguous_format)).unsqueeze(0), draw())
    stack = None
    for i in range(n):
        one = draw()
        if stack is None:
            stack = tree_map(lambda x: x.new_empty((n,) + tuple(x.shape)), one)
        tree_map(lambda dst, src: dst[i].copy_(src), stack, one)
        del one
    return stack


def init_params(gen: torch.Generator, cfg: ModelConfig, keep=keep_whole) -> Tree:
    """Parameters on ``gen``'s device, drawn from ``gen`` in order: the
    embedding, the layers (group by group), the unembedding. Each part is
    cut to ``keep(path, part, stack)`` as it is drawn, down to a layer's
    single leaves (``layers.keep_below``; ``stack``: the number of layers
    stacked in the part's leaves, else None), so a model-group rank
    (``models.api``) never holds more than one leaf whole."""
    dtype = param_dtype(cfg)
    kinds = layer_kinds(cfg)
    G = _n_groups(cfg)
    params: Dict[str, Tree] = {
        "embed": keep(("embed",), embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype))}
    if cfg.scan_layers:
        # stack per period position: each leaf leads with G
        def in_stack(path, tree):
            return keep(("groups",) + path, tree, G)

        params["groups"] = stacked_draws(G, lambda: tuple(
            block_init(gen, cfg, kind, dtype, keep_below(in_stack, j))
            for j, kind in enumerate(kinds)))
    else:
        params["layers"] = tuple(
            block_init(gen, cfg, kinds[i % len(kinds)], dtype, keep_below(keep, "layers", i))
            for i in range(cfg.num_layers))
    params["ln_f"] = keep(("ln_f",), rmsnorm_init(cfg.d_model, dtype, gen.device))
    if not cfg.tie_embeddings:
        params["unembed"] = keep(("unembed",),
                                 embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype))
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


@functools.lru_cache(maxsize=16)
def param_specs_on(cfg: ModelConfig, mesh: Any) -> Tree:
    """The parameter specs of ``cfg`` on ``mesh`` (from the meta tree; a
    rank's bundle computes them as it is built, outside its calls)."""
    return shd.param_specs(init_params(MetaGenerator(), cfg), cfg, mesh)


def data_specs(cfg: ModelConfig, *path: Any) -> Optional[Tree]:
    """The specs of the part of the parameter tree at ``path`` on the
    running grid's mesh when its ``data`` axis splits leaves, else None."""
    group = tp.data_group()
    if group is None or cfg.param_sharding != "fsdp":
        return None
    specs = param_specs_on(cfg, group.mesh)
    for k in path:
        specs = specs[k]
    return specs


def data_whole(tree: Tree, specs: Optional[Tree], stacked: bool = False) -> Tree:
    """``tree`` with each leaf that ``specs`` splits over ``data`` gathered
    whole over it (``tp.gather_data``), but the MoE expert leaves, which
    the expert FFN gathers one at a time as it uses them
    (``moe.gathered_at_use``); ``stacked``: the specs are a stack's and
    the leaves one slice of it (a leading dim fewer)."""
    if specs is None:
        return tree
    group = tp.data_group()

    def leaf(path, x):
        spec = specs
        for k in path:
            spec = spec[k]
        dim = shd.split_dim(spec, "data", group.mesh)
        if dim is None or moe.gathered_at_use(path):
            return x
        return tp.gather_data(x, dim - 1 if stacked else dim)

    return shd.map_with_path(leaf, tree)


def _unstack(tree: Tree, G: int) -> List[Tree]:
    """The G per-group trees of a stacked tree, as views. One ``unbind`` per
    leaf: its backward stacks the G gradients once, where G ``x[g]`` slices
    would each scatter into a zero tensor of the whole stack. A stack of
    one group keeps its MoE expert leaves as ``moe.StackSlice``s, sliced
    where the expert FFN uses them, so that autograd hands each its
    gradient as soon as it is made."""
    if G == 1:
        return [shd.map_with_path(lambda path, x: moe.StackSlice(x) if moe.gathered_at_use(path)
                                  else torch.unbind(x, 0)[0], tree)]
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
        specs = [data_specs(cfg, "groups", j) for j in range(len(kinds))]

        def group(g, h, aux):
            h = pin_activation(h)  # the JAX package's scan-carry pin
            for j, kind in enumerate(kinds):
                c = tree_map(lambda x: x[g], cache["groups"][j]) if cache is not None else None
                p = data_whole(layers[j][g], specs[j], stacked=True)
                h, _, a = block_apply(p, h, positions, c, mode, cfg, kind)
                aux = aux + a
            return pin_stash(h), aux

        remat = cfg.remat and cache is None and torch.is_grad_enabled()
        for g in range(G):
            if remat:
                h, aux = tp.checkpoint(group, g, h, aux)
            else:
                h, aux = group(g, h, aux)
        return h, new_cache, aux

    new_layers = []
    for i, p in enumerate(params["layers"]):
        ci = cache["layers"][i] if cache is not None else None
        p = data_whole(p, data_specs(cfg, "layers", i))
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
        # no name holds the gathered embedding: it is freed once looked up,
        # not kept through the layers (1.04 GB a rank for Llama4 on a grid)
        h = embed_apply(data_whole(params["embed"], data_specs(cfg, "embed")), tokens,
                        cfg.padded_vocab)
    else:
        h = embeds
    h = pin_activation(h)
    B, S = h.shape[:2]
    if positions is None:
        offset = cache["len"] if (cache is not None and mode == "decode") else 0
        positions = default_positions(cfg, B, S, h.device, offset=offset)
    h, new_cache, aux = apply_stack(params, h, positions, cache, mode, cfg)
    if new_cache is not None:
        new_cache["len"] = cache["len"] + S
    h = rmsnorm_apply(params["ln_f"], h, cfg.norm_eps)
    return h, new_cache, aux


def _unembedding(params: Tree, cfg: ModelConfig) -> Tree:
    return params["embed"] if cfg.tie_embeddings else params["unembed"]


def _unembedding_whole(params: Tree, cfg: ModelConfig) -> Tree:
    """The unembedding gathered whole over ``data`` where FSDP splits it."""
    key = "embed" if cfg.tie_embeddings else "unembed"
    return data_whole(params[key], data_specs(cfg, key))


def vocab_offset(params: Tree, cfg: ModelConfig) -> int:
    """The first vocabulary column of the rank's logits (0 unless the
    unembedding is a block of the vocabulary)."""
    rows = _unembedding(params, cfg)["emb"].shape[0]
    return tp.current_group().rank * rows if tp.is_block(rows, cfg.padded_vocab) else 0


def logits_of(params: Tree, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    """float32 logits (..., vocab_size) of final hidden states: the vocab
    padding rows (``cfg.padded_vocab``) are dropped at this boundary. Under
    a model group with a vocab-sharded unembedding, the rank's columns
    ``[vocab_offset, ...)`` below ``vocab_size``."""
    unemb = _unembedding_whole(params, cfg)
    lo = vocab_offset(params, cfg)
    if unemb["emb"].shape[0] != cfg.padded_vocab:
        h = tp.copy_to_group(h)
    return unembed_apply(unemb, h)[..., : max(0, cfg.vocab_size - lo)]


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
    vocab: int = 0,
) -> torch.Tensor:
    """Mean cross-entropy without materializing the full (B*S, V) float32
    logits.

    Flattens the tokens into ``n_chunks`` blocks (one block when they do not
    divide evenly): each block computes its (chunk, V) logits, a
    log-sum-exp and the target gather, and the blocks' sums add up in
    order. With ``use_scan`` (the JAX package's scan) each block's logits
    are recomputed in the backward instead of kept. Under a model group
    whose ``unemb`` is a block of the ``vocab`` (padded) rows, each block's
    log-sum-exp and target logit are taken over the ranks' columns."""
    B, S, d = h.shape
    N = B * S
    hf = h.reshape(N, d)
    tf = targets.reshape(N).to(torch.int64)
    if N % n_chunks:
        n_chunks = 1
    chunk = N // n_chunks
    split = bool(vocab) and tp.is_block(unemb["emb"].shape[0], vocab)
    if split:
        hf = tp.copy_to_group(hf)

    def chunk_nll(hc, tc):
        logits = unembed_apply(unemb, hc)  # (chunk, V) f32
        if split:
            return _split_nll(logits, tc)
        lse = torch.logsumexp(logits, dim=-1)
        picked = torch.gather(logits, 1, tc[:, None])[:, 0]
        return torch.sum(lse - picked)

    if use_scan and n_chunks > 1:
        total = torch.zeros((), dtype=torch.float32, device=h.device)
        recompute = torch.is_grad_enabled()
        for i in range(n_chunks):
            hc, tc = hf[i * chunk:(i + 1) * chunk], tf[i * chunk:(i + 1) * chunk]
            nll = tp.checkpoint(chunk_nll, hc, tc) if recompute else chunk_nll(hc, tc)
            total = total + nll
    else:
        total = chunk_nll(hf, tf)
    return total / N


def _split_nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """The summed negative log-likelihood of ``targets`` from the rank's
    block of the logits: the row maxima all-reduced (max, a constant
    shift), the sums of exponentials and the target logits (each nonzero
    on one rank) all-reduced (sum)."""
    n = logits.shape[-1]
    lo = tp.current_group().rank * n
    top = tp.all_reduce_max(torch.amax(logits, dim=-1).detach())
    sum_exp = tp.reduce_from_group(torch.sum(torch.exp(logits - top[:, None]), dim=-1))
    local = targets - lo
    inside = (local >= 0) & (local < n)
    picked = torch.gather(logits, 1, torch.where(inside, local, 0)[:, None])[:, 0]
    picked = tp.reduce_from_group(picked * inside.to(picked.dtype))
    return torch.sum(torch.log(sum_exp) + top - picked)


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
    deployment mode (``scan_attn_chunks``), as the JAX package does. On a
    grid whose rows are split over D client ranks, the rank's share of the
    global batch's loss: its mean cross-entropy over D, and its share of
    the router aux (``moe.moe_apply``); the shares sum to the loss of the
    whole batch."""
    h, _, aux = forward_hidden(params, cfg, tokens=tokens, embeds=embeds, positions=positions)
    loss = chunked_ce(h[:, :-1], _unembedding_whole(params, cfg), tokens[:, 1:],
                      use_scan=cfg.scan_attn_chunks, vocab=cfg.padded_vocab)
    return loss / tp.row_share()[1] + cfg.router_aux_weight * aux


def decode_step(
    params: Tree,
    cfg: ModelConfig,
    token: torch.Tensor,
    cache: Tree,
) -> Tuple[torch.Tensor, Tree]:
    """One serving step: token (B, 1) int -> (logits (B, 1, V), new cache)."""
    logits, new_cache, _ = forward(params, cfg, tokens=token, cache=cache, mode="decode")
    return logits, new_cache
