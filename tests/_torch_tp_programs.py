"""Rank functions of the port's tensor-parallel tests.

``launch.tensor_parallel.GroupPool`` runs a function by its module's name
in spawned ranks, so these live in a module that imports the port alone
(a rank that re-imported a test file would import JAX too). Every function
takes the rank's ``ModelGroup`` first and returns host objects.
"""
import contextlib
import weakref
from unittest import mock

import numpy as np
import torch

from repro_torch.convert import shard_tree_from_numpy, tree_to_numpy
from repro_torch.core.mesh_lowering import Mesh
from repro_torch.fl.fedstep import FedStepConfig
from repro_torch.launch import steps
from repro_torch.launch import tensor_parallel as tp
from repro_torch.launch.steps import _with_moe_profile, build_serve_step, build_train_step
from repro_torch.models import attention, transformer
from repro_torch.models.layers import dense_apply
from repro_torch.models.api import build_model


def serve_batch(cfg, tokens: np.ndarray, frames=None, device="cpu") -> dict:
    """The prefill batch of ``tokens`` for ``cfg``'s family on ``device``:
    zero patch embeddings and text positions for a VLM, ``frames`` for
    audio."""
    batch = {"tokens": torch.from_numpy(tokens)}
    B, S = tokens.shape
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.zeros((B, cfg.vision_patches, cfg.d_model))
        batch["positions"] = torch.arange(S, dtype=torch.int32)[None, None].expand(3, B, S)
    if cfg.family == "audio":
        batch["frames"] = torch.from_numpy(frames)
    return {k: v.to(device) for k, v in batch.items()}


def greedy(prefill, serve_step, bundle, params, batch, steps: int, group=None) -> dict:
    """Prefill, then ``steps`` greedy serve steps: every step's float32
    logits (the rank's vocabulary block) and tokens."""
    B, S = batch["tokens"].shape
    cache = bundle.init_cache(B, S + steps + 1)
    offset = 0
    if group is not None:
        with tp.use_group(group):
            offset = transformer.vocab_offset(params, bundle.cfg)
    logits, cache = prefill(params, batch, cache)
    out, toks = [logits], []
    for _ in range(steps):
        tok = tp.global_argmax(logits[:, -1], offset, bundle.cfg.vocab_size, group)
        toks.append(tok)
        logits, cache = serve_step(params, cache, {"token": tok[:, None].to(torch.int32)})
        out.append(logits)
    toks.append(tp.global_argmax(logits[:, -1], offset, bundle.cfg.vocab_size, group))
    return {"logits": [x.detach().float().cpu().numpy() for x in out],
            "tokens": torch.stack(toks, 1).cpu().numpy()}


def skipped_wo_all_reduce(group):
    """A planted fault: the last rank keeps its own partial sum of
    attention's ``wo`` (the all-reduce still runs, so the ranks stay in
    step)."""
    whole = attention.attn_output

    def attn_output(p, out, cfg, hs=None):
        y = whole(p, out, cfg, hs)
        if group.rank < group.size - 1 or hs is None or not hs.split:
            return y
        return dense_apply(p["wo"], out.reshape(*out.shape[:2], -1))

    return mock.patch.object(attention, "attn_output", attn_output)


def serve_rank(group, cfg, mesh_axes, params_np, tokens, frames, steps, fault=False):
    """The rank's greedy serving through ``build_serve_step`` on the mesh,
    on the rank's device; with ``fault``, under ``skipped_wo_all_reduce``."""
    torch.set_num_threads(1)
    B, S = tokens.shape
    dev = group.device
    bundle, setup = build_serve_step(cfg, Mesh(mesh_axes), S + steps + 1, B, dev, group)
    params = _params_on(bundle, cfg, params_np, dev, group)
    from repro_torch.kernels.flash_attention import kernel as fkernel

    fkernel.reset_launches()
    planted = skipped_wo_all_reduce(group) if fault else contextlib.nullcontext()
    with torch.no_grad(), planted:
        out = greedy(setup.prefill, setup.serve_step, bundle, params,
                     setup.rows(serve_batch(cfg, tokens, frames, dev)), steps, group)
    out["flash_launches"] = {name: fn.launches for name, fn in fkernel.ROUTES.items()}
    out["counters"] = group.counters()
    out["param_bytes"] = sum(x.numel() * x.element_size()
                             for x in _leaves(params) if isinstance(x, torch.Tensor))
    return out


@contextlib.contextmanager
def one_thread():
    """One intra-op thread, as each rank runs: CPU products change their
    bits with the thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _params_on(bundle, cfg, params_np, device, group=None):
    """The rank's blocks (or the whole tree) of ``params_np``; an int there
    is a seed: the bundle draws its parameters on ``device`` (bfloat16
    trees, which numpy cannot hold)."""
    if isinstance(params_np, int):
        return bundle.init(torch.Generator(device=device).manual_seed(params_np))
    if group is None:
        from repro_torch.convert import tree_from_numpy

        return tree_from_numpy(params_np, device)
    return shard_tree_from_numpy(params_np, cfg, group.mesh, group.coords, device)


def serve_one_process(cfg, mesh_axes, params_np, tokens, frames, steps, device="cpu"):
    """The one-process run of ``serve_rank`` under the same mesh profile."""
    with one_thread():
        return _serve_one_process(cfg, mesh_axes, params_np, tokens, frames, steps, device)


def _serve_one_process(cfg, mesh_axes, params_np, tokens, frames, steps, device):
    bundle = build_model(cfg, device)
    params = _params_on(bundle, cfg, params_np, device)
    prefill = _with_moe_profile(bundle.prefill, cfg, Mesh(mesh_axes))
    serve_step = _with_moe_profile(bundle.serve_step, cfg, Mesh(mesh_axes))
    with torch.no_grad():
        out = greedy(prefill, serve_step, bundle, params,
                     serve_batch(cfg, tokens, frames, device), steps)
    out["param_bytes"] = sum(x.numel() * x.element_size() for x in _leaves(params))
    return out


def _leaves(tree):
    from repro_torch.core.tree import tree_leaves

    return tree_leaves(tree)


def train_batch(cfg, tokens: np.ndarray, frames=None) -> dict:
    batch = {"tokens": tokens}
    B, S = tokens.shape
    if cfg.family == "vlm":
        batch["patch_embeds"] = np.zeros((B, cfg.vision_patches, cfg.d_model), np.float32)
        batch["positions"] = np.broadcast_to(np.arange(S, dtype=np.int32), (3, B, S)).copy()
    if cfg.family == "audio":
        batch["frames"] = frames
    return batch


def train_rank(group, cfg, mesh_axes, params_np, batch, seed, fed_kwargs, strategy=None,
               wire="f32", noise=None):
    """One step of ``build_train_step`` on the mesh: the rank's new blocks
    and the metrics. ``group=None``: the one-process step, on the mesh with
    a model axis of 1, under the profile of ``mesh_axes`` (the MoE routing
    blocks of the split run). ``fed_kwargs["dp"]`` is a ``DPConfig``'s
    fields; ``wire`` the cross-pod wire; ``noise`` the DP draws to inject
    (whole leaves, per client). Each int8 quantization of the wire is
    recorded: its float32 input and its codes (the rank's blocks)."""
    with one_thread():
        return _train_rank(group, cfg, mesh_axes, params_np, batch, seed, fed_kwargs, strategy,
                           wire, noise)


def _train_rank(group, cfg, mesh_axes, params_np, batch, seed, fed_kwargs, strategy, wire,
                noise):
    from repro_torch.core import mesh_lowering
    from repro_torch.fl.privacy import DPConfig

    mesh = Mesh(mesh_axes)
    fed_kwargs = dict(fed_kwargs)
    if fed_kwargs.get("dp") is not None:
        fed_kwargs["dp"] = DPConfig(**fed_kwargs["dp"])
    fed = FedStepConfig(**fed_kwargs)
    if group is None:
        one = Mesh(tuple((a, 1 if a == "model" else n) for a, n in mesh_axes))
        profile = steps._with_moe_profile
        with mock.patch.object(steps, "_with_moe_profile",
                               lambda fn, cfg, _, manual_axes=(): profile(fn, cfg, mesh,
                                                                          manual_axes)):
            bundle, setup = build_train_step(cfg, one, fed, cross_pod_wire=wire, device="cpu",
                                             strategy_name=strategy)
    else:
        bundle, setup = build_train_step(cfg, mesh, fed, cross_pod_wire=wire, device="cpu",
                                         strategy_name=strategy, group=group)
    if group is None:
        from repro_torch.convert import tree_from_numpy

        params = tree_from_numpy(params_np, "cpu")
    else:
        params = shard_tree_from_numpy(params_np, cfg, group.mesh, group.coords, "cpu")
    state = setup.init_state(params)
    codes = []
    quantize = mesh_lowering.quantize_int8

    def recording(x, whole=True):
        q, scale = quantize(x, whole)
        codes.append((x.numpy().copy(), q.numpy().copy()))
        return q, scale

    with mock.patch.object(mesh_lowering, "quantize_int8", recording):
        params, state, metrics = setup.step(params, state, batch, seed,
                                            **({"noise": noise} if noise is not None else {}))
    return {"params": tree_to_numpy(params),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "counters": group.counters() if group is not None else {}, "codes": codes}


def sample_rank(group, cfg, params_np, tokens, gen, temperature):
    """``serve.generate`` at ``temperature`` on the rank's blocks of
    ``params_np`` (``group=None``: the whole model): the tokens."""
    from repro_torch.launch.serve import generate

    with one_thread():
        bundle = build_model(cfg, "cpu", group)
        params = _params_on(bundle, cfg, params_np, "cpu", group)
        with torch.no_grad():
            out = generate(bundle, params, torch.from_numpy(tokens), gen, temperature)
        return {"tokens": out.tokens.numpy(),
                "counters": group.counters() if group is not None else {}}


def adjoint_rank(group, x_np, w_np, v_np):
    """y = g(f(x) @ W_r) @ V for the rank's column block W_r of W: the
    value and the gradients of x, W_r and V (each rank's V is whole)."""
    torch.set_num_threads(1)
    n = w_np.shape[1] // group.size
    x = torch.from_numpy(x_np).requires_grad_(True)
    w = torch.from_numpy(w_np[:, group.rank * n:(group.rank + 1) * n].copy()).requires_grad_(True)
    vr = torch.from_numpy(v_np[group.rank * n:(group.rank + 1) * n].copy()).requires_grad_(True)
    with tp.use_group(group):
        h = torch.tanh(tp.copy_to_group(x) @ w)  # column-parallel
        y = tp.reduce_from_group(h @ vr)  # row-parallel
        loss = torch.sum(y * y)
        loss.backward()
        wg = tp.gather_at_use(w.detach(), 1, w_np.shape[1])
    return {"y": y.detach().numpy(), "gx": x.grad.numpy(), "gw": w.grad.numpy(),
            "gv": vr.grad.numpy(), "w_whole": wg.numpy(), "counters": group.counters()}


def collectives_rank(group, dtype_name):
    """An all-reduce sum of the rank's float32 or bfloat16 tensor, and the
    lowest-index argmax over vocabulary blocks with a tie across ranks."""
    dtype = getattr(torch, dtype_name)
    x = (torch.arange(6, dtype=torch.float32) * 0.375 + group.rank).to(dtype)
    s = tp.all_reduce_sum(x, group)
    logits = torch.zeros((2, 3))
    logits[0, 1] = 5.0  # row 0: 5.0 at column 1 of every rank: the tie goes to rank 0's
    logits[1, 2 if group.rank == group.size - 1 else 0] = 1.0 + group.rank  # row 1: the last
    arg = tp.global_argmax(logits, group.rank * 3, 3 * group.size, group)
    return {"sum": s.float().numpy(), "argmax": arg.numpy()}


def failing_rank(group):
    """Rank 1 raises while the others wait in a collective."""
    if group.rank == 1:
        raise RuntimeError("planted rank failure")
    tp.all_reduce_sum(torch.ones(2), group)
    return {}


def serve_counts_rank(group, cfg, batch, prompt, by_axis=False):
    """``launch.dryrun.serve_counts`` on the rank's real group."""
    from repro_torch.launch import dryrun

    with one_thread():
        return dryrun.serve_counts(group, cfg, batch, prompt, by_axis)


def train_counts_rank(group, cfg, mesh_axes, fed_kwargs, batch, wire, by_axis=False):
    """``launch.dryrun.train_counts`` on the rank's real group."""
    from repro_torch.fl.privacy import DPConfig
    from repro_torch.launch import dryrun

    fed_kwargs = dict(fed_kwargs)
    if fed_kwargs.get("dp") is not None:
        fed_kwargs["dp"] = DPConfig(**fed_kwargs["dp"])
    with one_thread():
        return dryrun.train_counts(group, cfg, Mesh(mesh_axes), FedStepConfig(**fed_kwargs),
                                   batch, wire, None, by_axis)


def data_gather_adjoint_rank(group, w_np, x_np):
    """loss = sum over every rank's rows of ``(x @ W) ** 2``, with W (its
    rows in ``data`` blocks) gathered over ``data`` at use and each rank's
    share summed over the rows group: the loss, the gathered W and the
    gradient of the rank's block."""
    torch.set_num_threads(1)
    d, n = group.coords["data"], w_np.shape[0] // group.data_size
    b = x_np.shape[0] // group.rows
    x = torch.from_numpy(x_np[group.client_rank * b:(group.client_rank + 1) * b].copy())
    wb = torch.from_numpy(w_np[d * n:(d + 1) * n].copy()).requires_grad_(True)
    with tp.use_group(group):
        w = tp.gather_data(wb, 0)
        y = x @ w
        loss = tp.reduce_from_rows(torch.sum(y * y))
        loss.backward()
    return {"loss": float(loss), "w_whole": w.detach().numpy(), "gw": wb.grad.numpy(),
            "counters": group.counters()}


def moe_rows_rank(group, cfg, p_np, x_np, mesh_axes):
    """``moe_apply`` of the rank's rows of ``x_np`` (B, S, d) under the
    mesh's profile (``group=None``: every row, one process), the experts cut
    to the rank's ``model`` block: its output rows and its aux share."""
    from repro_torch.models import moe

    with one_thread():
        p = {k: torch.from_numpy(v) for k, v in p_np.items() if k != "router"}
        p["router"] = {"w": torch.from_numpy(p_np["router"])}
        x = torch.from_numpy(x_np)
        if group is not None:
            E = cfg.num_experts // group.size
            for k in ("gate", "up", "down"):
                p[k] = p[k][group.rank * E:(group.rank + 1) * E]
            b = x.shape[0] // group.rows
            x = x[group.client_rank * b:(group.client_rank + 1) * b]
        fn = _with_moe_profile(lambda: moe.moe_apply(p, x, cfg), cfg, Mesh(mesh_axes))
        with tp.use_group(group), torch.no_grad():
            y, aux = fn()
        return {"y": y.numpy(), "aux": float(aux),
                "counters": group.counters() if group is not None else {}}


@contextlib.contextmanager
def recorded_expert_gathers():
    """``tp.gather_data`` patched to keep a weak reference to each expert
    leaf it gathers (the 3-d leaves): yields a dict of the gathers' count
    and the most expert leaves alive at once, read as each is gathered."""
    whole = tp.gather_data
    refs, seen = [], {"gathers": 0, "most_alive": 0}

    def gather(x, dim):
        # a view of the gathered leaf: the model code holds this object
        # alone, where gloo's worker thread may still hold the gathered
        # tensor for a moment after the collective returns
        out = whole(x, dim).view(x.shape[:dim] + (-1,) + x.shape[dim + 1:])
        if out.dim() == 3:
            refs.append(weakref.ref(out))
            seen["gathers"] += 1
            seen["most_alive"] = max(seen["most_alive"], sum(r() is not None for r in refs))
        return out

    with mock.patch.object(tp, "gather_data", gather):
        yield seen
    seen["alive_after"] = sum(r() is not None for r in refs)


def expert_gathers_rank(group, cfg, mesh_axes, params_np, tokens, steps, share):
    """Reduced Llama4 on the rank's blocks, three ways: as built (the
    expert FFN gathers the expert leaves over data as it uses them; on the
    CPU the rank's memory share sets no bound), with the rank's memory
    share set to ``share`` bytes (``tp.ModelGroup.memory_share``: the FFN
    then takes its experts in slices) and with every split leaf gathered as
    its layer begins (``moe.gathered_at_use`` answering no). Per way:
    greedy serving's logits (a prefill, ``steps`` decode steps), the loss
    and the gradients of the rank's blocks from a train step's forward and
    backward on the rank's rows, and ``recorded_expert_gathers``' counts
    for each."""
    from repro_torch.core.tree import tree_flatten, tree_unflatten
    from repro_torch.models import moe

    torch.set_num_threads(1)
    B, S = tokens.shape
    mesh = Mesh(mesh_axes)
    bundle, setup = build_serve_step(cfg, mesh, S + steps + 1, B, "cpu", group)
    params = _params_on(bundle, cfg, params_np, "cpu", group)
    b = B // group.rows
    rows = {"tokens": torch.from_numpy(tokens[group.client_rank * b:(group.client_rank + 1) * b])}
    loss_fn = _with_moe_profile(bundle.loss_fn, cfg, mesh)
    out = {}
    ways = (("at_use", moe.gathered_at_use, group.memory_share),
            ("sliced", moe.gathered_at_use, share),
            ("at_layer", lambda path: False, group.memory_share))
    for way, at_use, memory_share in ways:
        with mock.patch.object(moe, "gathered_at_use", at_use), \
                mock.patch.object(group, "memory_share", memory_share):
            with recorded_expert_gathers() as serve, torch.no_grad():
                res = greedy(setup.prefill, setup.serve_step, bundle, params,
                             setup.rows(serve_batch(cfg, tokens)), steps, group)
            leaves, treedef = tree_flatten(params)
            xs = [x.detach().clone().requires_grad_(True) for x in leaves]
            with recorded_expert_gathers() as train:
                loss = loss_fn(tree_unflatten(treedef, xs), rows, None)
                loss.backward()
        out[way] = {"logits": res["logits"], "loss": float(loss),
                    "grads": [x.grad.numpy() for x in xs], "serve": serve, "train": train}
        del loss, xs
    return out


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[x.element_size()])


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(_bits(a.contiguous()), _bits(b.contiguous())))


def _all_reduce_cut(g, dim, n, group):
    """The gather's backward summed as it was before each gradient block
    was reduced to its owner: the whole leaf all-reduced over the rows,
    then the rank's block."""
    g = g.contiguous().clone()
    torch.distributed.all_reduce(g, group=group.rows_pg)
    return g.narrow(dim, group.coords["data"] * n, n).clone()


def reduce_to_owners_rank(group, seed):
    """Whole-leaf gradients of the rank's rows (float32 and bfloat16, split
    over data along dim 0 and along dim 1) summed over data into the
    rank's block by ``tp.data_block_grad`` and by an all-reduce over the
    rows cut to the block: per case whether the two are equal bit for bit,
    whether the block is a buffer of its own, and the first's counters."""
    torch.set_num_threads(1)
    out = {}
    for dtype in ("float32", "bfloat16"):
        for dim in (0, 1):
            gen = torch.Generator().manual_seed(seed + 10 * group.client_rank + group.rank)
            g = torch.randn((6, 10, 3), generator=gen).to(getattr(torch, dtype))
            want = _all_reduce_cut(g, dim, g.shape[dim] // group.data_size, group)
            group.reset_counters()
            got = tp.data_block_grad(g.clone(), dim, group)
            out[f"{dtype} dim {dim}"] = {
                "equal": _same_bits(got, want), "own": got._base is None and got.is_contiguous(),
                "counters": group.counters()}
    return out


def _todays_step(group, cfg, bundle, mesh, fed, params, batch, seed):
    """The one-client step's arithmetic as it was written before each
    gradient was applied as it is made: every gradient at once
    (``torch.autograd.grad``), the leaves replicated over data summed over
    the rows, the first local step making new tensors, the gather's
    backward an all-reduce over the rows cut to the block, the deltas
    summed in float32 at the end. (new leaves, loss, delta_norm)."""
    from repro_torch.core.tree import tree_flatten, tree_unflatten
    from repro_torch.fl import fedstep

    blocks = steps._leaf_blocks(cfg, group)
    over_data = None if blocks is None else blocks.sharded_over("data")
    sharded = None if blocks is None else blocks.sharded

    def run(params):
        leaves, treedef = tree_flatten(params)
        b = fedstep.batch_to_device(batch, leaves[0].device)
        gen = fedstep.client_generator(seed, 0, "loss", leaves[0].device)
        me, ranks = tp.row_share()
        cur = leaves
        for i in range(fed.local_steps):
            micro = fedstep.split_batch(b, fed.local_steps, i)
            if ranks > 1:
                micro = fedstep.split_batch(micro, ranks, me)
            xs = [x.detach().requires_grad_(True) for x in cur]
            with torch.enable_grad():
                loss = bundle.loss_fn(tree_unflatten(treedef, xs), micro, gen)
                grads = list(torch.autograd.grad(loss, xs))
            loss = loss.detach()
            if ranks > 1:
                grads = [g if over_data[j] else tp.rows_sum(g) for j, g in enumerate(grads)]
            with torch.no_grad():
                cur = [w.sub_(fed.local_lr * g.to(w.dtype)) if i
                       else w - fed.local_lr * g.to(w.dtype) for w, g in zip(cur, grads)]
        sq = fedstep.sum_of_squares([(a - b).to(torch.float32) for a, b in zip(cur, leaves)],
                                    sharded, over_data)
        return cur, loss, torch.sqrt(sq)

    with mock.patch.object(tp, "_reduce_to_owners", _all_reduce_cut):
        return tp.bind(steps._with_moe_profile(run, cfg, mesh), group)(params)


def streamed_step_rank(group, cfg, mesh_axes, params_np, batch, seed, fed_kwargs, share=None):
    """The one-client train step of ``build_train_step`` on the mesh
    (``group=None``: one process under the mesh's profile), as built: each
    gradient applied as it is made, the given tensors stepped in place,
    each gradient block reduced to its owner; with ``share``, the rank's
    memory share that many bytes (the expert FFN then takes its experts in
    slices). Against ``_todays_step`` on the same parameters: whether the
    new leaves, the loss and ``delta_norm`` are equal bit for bit; whether
    the returned leaves are the given tensors; and, from weak references
    kept by the patched ``fedstep.update_leaf``, the most expert-leaf
    gradients alive at once and the expert-leaf updates."""
    with one_thread():
        return _streamed_step(group, cfg, mesh_axes, params_np, batch, seed, fed_kwargs, share)


def _streamed_step(group, cfg, mesh_axes, params_np, batch, seed, fed_kwargs, share):
    from repro_torch.core.tree import tree_leaves
    from repro_torch.fl import fedstep
    from repro_torch.launch.sharding import map_with_path
    from repro_torch.models import moe

    mesh = Mesh(mesh_axes)
    fed = FedStepConfig(**fed_kwargs)
    if group is None:
        one = Mesh(tuple((a, 1 if a == "model" else n) for a, n in mesh_axes))
        profile = steps._with_moe_profile
        with mock.patch.object(steps, "_with_moe_profile",
                               lambda fn, cfg, _, manual_axes=(): profile(fn, cfg, mesh,
                                                                          manual_axes)):
            bundle, setup = build_train_step(cfg, one, fed, device="cpu")
    else:
        bundle, setup = build_train_step(cfg, mesh, fed, device="cpu", group=group)
    params = _params_on(bundle, cfg, params_np, "cpu", group)
    given = tree_leaves(params)
    experts = []
    map_with_path(lambda path, x: experts.append(moe.gathered_at_use(path)), params)
    alive = []
    seen = {"most_alive": 0}
    whole = fedstep.update_leaf

    def watching(j, w, g, lr, rows=None, base=None):
        if experts[j]:
            alive.append(weakref.ref(g))
            seen["most_alive"] = max(seen["most_alive"], sum(r() is not None for r in alive))
        return whole(j, w, g, lr, rows, base)

    sliced = contextlib.nullcontext()
    if share is not None:
        sliced = (mock.patch.object(group, "memory_share", share) if group is not None
                  else mock.patch.object(tp, "memory_share", lambda device: share))
    with mock.patch.object(fedstep, "update_leaf", watching), sliced:
        new, _, metrics = setup.step(params, (), batch, seed)
    new = tree_leaves(new)
    ref = _params_on(bundle, cfg, params_np, "cpu", group)
    want, loss, norm = _todays_step(group, cfg, bundle, mesh, fed, ref, batch, seed)
    return {"equal": [_same_bits(a, b) for a, b in zip(new, want)],
            "loss_equal": _same_bits(metrics["loss"], loss),
            "norm_equal": _same_bits(metrics["delta_norm"], norm),
            "in_place": len(new) == len(given) and all(a is b for a, b in zip(new, given)),
            "most_alive": seen["most_alive"], "expert_updates": len(alive),
            "counters": group.counters() if group is not None else {}}
