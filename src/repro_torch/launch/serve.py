"""Batched serving: prefill a batch of prompts, then decode tokens
(the port of ``repro.launch.serve``).

The loop is the JAX package's: ``init_cache(B, S + gen)``, ``prefill``,
argmax (or temperature sampling), then ``serve_step`` ``gen - 1`` times.
``generate`` is the loop as a function; ``main`` wraps it with the JAX
CLI's flags and two more: ``--device`` (the card unless ``cpu`` is asked
for; raises without a card) and ``--attn-impl`` (the config's
``attn_impl``: ``flash`` runs the prefill's attention in the flash kernel).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_5_3b \\
      --batch 8 --prompt-len 2048 --gen 64 --attn-impl flash
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Optional

import torch

from repro_torch.configs import get_config
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
    d), as the JAX package's serve loop passes."""
    if gen < 1:
        raise ValueError(f"gen must be >= 1, got {gen}")
    device = bundle.device
    if temperature > 0 and generator is None:
        generator = torch.Generator(device=device).manual_seed(0)

    def pick(logits: torch.Tensor) -> torch.Tensor:
        last = logits[:, -1]
        if temperature > 0:
            probs = torch.softmax(last / temperature, dim=-1)
            return torch.multinomial(probs, 1, generator=generator).to(torch.int32)
        return torch.argmax(last, dim=-1, keepdim=True).to(torch.int32)

    cfg = bundle.cfg
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2_5_3b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--attn-impl", choices=("xla", "flash"), default=None,
                    help="attention of the prefill (default: the config's)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=args.reduced)
    if args.attn_impl:
        cfg = dataclasses.replace(cfg, attn_impl=args.attn_impl)
    bundle = build_model(cfg, args.device)
    # bf16 products reduce split-K partial sums in float32, as the JAX
    # package's float32 accumulation does (models/layers.py)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    gen = torch.Generator(device=bundle.device).manual_seed(0)
    params = bundle.init(gen)
    B, S = args.batch, args.prompt_len
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device=bundle.device)
    out = generate(bundle, params, prompts, args.gen, args.temperature)
    print(f"[serve] prefill {B}x{S} in {out.prefill_s:.2f}s ({bundle.device}, attn {cfg.attn_impl})")
    print(f"[serve] generated {args.gen} tokens/seq x {B} seqs in {out.decode_s:.2f}s "
          f"({B * args.gen / max(out.decode_s, 1e-9):.1f} tok/s)")
    print("[serve] sample token ids:", out.tokens[0][:12].tolist())
    if not out.all_finite:
        raise RuntimeError("non-finite logits")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
