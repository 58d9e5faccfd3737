"""Batched serving: prefill a batch of prompts, then decode tokens
(the port of ``repro.launch.serve``).

The loop is the JAX package's: ``init_cache(B, S + gen)``, ``prefill``,
argmax (or temperature sampling), then ``serve_step`` ``gen - 1`` times.
``generate`` is the loop as a function; ``main`` wraps it with the JAX
CLI's flags and three more: ``--device`` (the card unless ``cpu`` is asked
for; raises without a card), ``--attn-impl`` (the config's ``attn_impl``:
``flash`` runs the prefill's attention in the flash kernel) and
``--ranks N``: every device of the mesh ``launch.mesh.
make_mesh_for_devices(N)`` (``model`` the largest of 8, 4, 2 dividing N,
``data`` the rest) a process (``launch.tensor_parallel``), each on the
card, or on the CPU with ``--device cpu``; every rank draws the one-process
model's parameters and prompts from the same seed and keeps its blocks
(FSDP configs: over ``data`` too) and its rows of the batch (over
``data``); greedy tokens are the argmax over the ranks' vocabulary blocks;
sampled tokens draw from the ranks' blocks gathered whole
(``tensor_parallel.gather_columns``), with the same seeded generator on
every rank (so with one data rank they are the one-process run's draws).
The launcher joins the ranks' rows in (pod, data) order.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_5_3b \\
      --batch 8 --prompt-len 2048 --gen 64 --attn-impl flash
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --ranks 2 --device cpu --reduced
  PYTHONPATH=src python -m repro_torch.launch.serve --ranks 6 --device cpu --reduced
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Optional

import torch

from repro_torch.configs import get_config
from repro_torch.launch import tensor_parallel as tp
from repro_torch.launch.mesh import make_mesh_for_devices
from repro_torch.launch.steps import grid_axes
from repro_torch.models import transformer
from repro_torch.models.api import ModelBundle, build_model


@dataclasses.dataclass
class Generation:
    tokens: torch.Tensor  # (B, gen) token ids
    prefill_s: float  # prefill and first token, after the device finished
    decode_s: float  # the gen - 1 serve steps, after the device finished
    all_finite: bool  # every step's logits were finite


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(
    bundle: ModelBundle,
    params: Any,
    prompts: torch.Tensor,
    gen: int,
    temperature: float = 0.0,
    generator: Optional[torch.Generator] = None,
    frames: Optional[torch.Tensor] = None,
) -> Generation:
    """Prefill ``prompts`` (B, S) and decode ``gen`` tokens per row: greedy
    at temperature 0, else sampled from ``softmax(logits / temperature)``
    with ``generator`` (seeded 0 on the bundle's device when None).

    An encoder-decoder (``audio``) model encodes ``frames`` (B, F, d), the
    stub frontend's embeddings; when None, zeros of (B, ``frontend_len``,
    d), as the JAX package's serve loop passes.

    A rank's bundle (``build_model(..., group)``) decodes greedily on the
    argmax over the ranks' vocabulary blocks (lowest index on ties), and
    samples from the last position's logits gathered whole over the ranks'
    blocks (``generator`` seeded alike on every rank: the same draws)."""
    if gen < 1:
        raise ValueError(f"gen must be >= 1, got {gen}")
    device = bundle.device
    group = bundle.group if bundle.group is not None and bundle.group.size > 1 else None
    if temperature > 0 and generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    cfg = bundle.cfg
    offset = 0
    if group is not None:
        with tp.use_group(group):
            offset = transformer.vocab_offset(params, cfg)

    def pick(logits: torch.Tensor) -> torch.Tensor:
        last = logits[:, -1]
        if temperature > 0:
            if group is not None:
                last = tp.gather_columns(last, offset, cfg.vocab_size, group)
            probs = torch.softmax(last / temperature, dim=-1)
            return torch.multinomial(probs, 1, generator=generator).to(torch.int32)
        if group is not None:
            return tp.global_argmax(last, offset, cfg.vocab_size, group)[:, None].to(torch.int32)
        return torch.argmax(last, dim=-1, keepdim=True).to(torch.int32)

    B, S = prompts.shape
    cache = bundle.init_cache(B, S + gen)
    batch = {"tokens": prompts}
    if cfg.family == "vlm":  # the JAX serve loop's stubs: zero patches, text positions
        batch["patch_embeds"] = torch.zeros((B, min(cfg.vision_patches, S), cfg.d_model),
                                            device=device)
        pos = torch.arange(S, dtype=torch.int32, device=device)
        batch["positions"] = pos[None, None].expand(3, B, S)
    if cfg.family == "audio":
        if frames is None:
            frames = torch.zeros((B, cfg.frontend_len, cfg.d_model), device=device)
        batch["frames"] = frames
    _sync(device)
    t0 = time.perf_counter()
    logits, cache = bundle.prefill(params, batch, cache)
    tok = pick(logits)
    finite = torch.isfinite(logits).all()
    _sync(device)
    prefill_s = time.perf_counter() - t0

    generated = [tok]
    t0 = time.perf_counter()
    for _ in range(gen - 1):
        logits, cache = bundle.serve_step(params, cache, {"token": tok})
        tok = pick(logits)
        finite &= torch.isfinite(logits).all()
        generated.append(tok)
    _sync(device)
    decode_s = time.perf_counter() - t0
    return Generation(torch.cat(generated, dim=1), prefill_s, decode_s, bool(finite))


def _serve(group: Optional[tp.ModelGroup], args: argparse.Namespace) -> dict:
    """One process's serving run (the whole model, or one rank's blocks)."""
    cfg = get_config(args.arch, reduced=args.reduced)
    if args.attn_impl:
        cfg = dataclasses.replace(cfg, attn_impl=args.attn_impl)
    device = args.device if group is None else group.device
    bundle = build_model(cfg, device, group)
    # bf16 products reduce split-K partial sums in float32, as the JAX
    # package's float32 accumulation does (models/layers.py)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    gen = torch.Generator(device=bundle.device).manual_seed(0)
    params = bundle.init(gen)
    B, S = args.batch, args.prompt_len
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device=bundle.device)
    if group is not None and group.rows > 1:  # the rank's rows
        b = B // group.rows
        prompts = prompts[group.client_rank * b:(group.client_rank + 1) * b]
    out = generate(bundle, params, prompts, args.gen, args.temperature)
    if not out.all_finite:
        raise RuntimeError("non-finite logits")
    return {"tokens": out.tokens.cpu(), "prefill_s": out.prefill_s, "decode_s": out.decode_s,
            "device": str(bundle.device), "attn": cfg.attn_impl,
            "counters": group.counters() if group is not None else {},
            "client_rank": group.client_rank if group is not None else 0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2_5_3b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=None,
                    help="prompts (default 4, or the least multiple of the data ranks above)")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--attn-impl", choices=("xla", "flash"), default=None,
                    help="attention of the prefill (default: the config's)")
    ap.add_argument("--ranks", type=int, default=1,
                    help="processes: the devices of the JAX driver's mesh for that many")
    args = ap.parse_args(argv)

    mesh = make_mesh_for_devices(args.ranks)
    rows = mesh.shape["data"] if args.ranks > 1 else 1
    if args.batch is None:
        args.batch = rows * -(-4 // rows)
    B = args.batch
    if B % rows:
        raise ValueError(f"a batch of {B} does not split over {rows} data ranks")
    if args.ranks == 1:
        out = _serve(None, args)
    else:
        cfg = get_config(args.arch, reduced=args.reduced)
        axes = grid_axes(cfg, mesh, "serve")
        devices = _rank_devices(args.device, args.ranks)
        with tp.GroupPool(devices, axes=axes) as pool:
            print(f"[serve] {args.ranks} ranks on {devices}: grid {dict(axes)}, backend "
                  f"{pool.backend}")
            outs = [r.value for r in pool.run(_serve, args)]
        # every model rank of a client coordinate decodes its rows alike;
        # the rows join in (pod, data) order
        m = mesh.shape["model"]
        for i in range(0, len(outs), m):
            if any(not torch.equal(o["tokens"], outs[i]["tokens"]) for o in outs[i:i + m]):
                raise RuntimeError("the model ranks of a data rank decoded different tokens")
        out = dict(outs[0], tokens=torch.cat([o["tokens"] for o in outs[::m]], dim=0))
        c = out["counters"]
        print(f"[serve] rank 0: all-reduces over model {c['model_all_reduces']} "
              f"({c['model_all_reduce_bytes']} bytes), over data {c['data_all_reduces']} "
              f"({c['data_all_reduce_bytes']} bytes), gathered leaves "
              f"{c['gathered_leaves']} (model) {c['data_gathered_leaves']} (data); rows of "
              f"{rows} data ranks joined: {tuple(out['tokens'].shape)}")
    print(f"[serve] prefill {B}x{args.prompt_len} in {out['prefill_s']:.2f}s "
          f"({out['device']}, attn {out['attn']})")
    print(f"[serve] generated {args.gen} tokens/seq x {B} seqs in {out['decode_s']:.2f}s "
          f"({B * args.gen / max(out['decode_s'], 1e-9):.1f} tok/s)")
    print("[serve] sample token ids:", out["tokens"][0][:12].tolist())
    print("[serve] every row's first token ids:", out["tokens"][:, :4].tolist())
    return 0


def _rank_devices(device: Optional[str], ranks: int) -> list:
    """One device per rank: the CPU with ``--device cpu``, else the cards in
    turn (ranks share a card when there are fewer cards than ranks)."""
    if device is not None and torch.device(device).type == "cpu":
        return ["cpu"] * ranks
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card by default; pass "
                           "--device cpu to run on the CPU")
    n = torch.cuda.device_count()
    return [f"cuda:{r % n}" for r in range(ranks)]


if __name__ == "__main__":
    raise SystemExit(main())
