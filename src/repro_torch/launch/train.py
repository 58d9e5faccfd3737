"""End-to-end training driver (the port of ``repro.launch.train``).

Runs the TAG-driven federated train step for a chosen architecture on the
card (``--device cpu`` for the CPU): the reduced config for runnable
examples, the full config on the card. ``--clients N`` stands for the JAX
driver's device count, which sizes its ``data`` axis: N virtual clients on
one device. Data is the synthetic LM stream of ``repro_torch.data``, equal
to the JAX package's for the same seed. ``--ranks N`` takes the JAX
driver's mesh for N devices (``launch.mesh.make_mesh_for_devices``): its
``model`` axis is that many processes (``launch.tensor_parallel``), on the
cards or on the CPU with ``--device cpu``, and its ``data`` axis virtual
clients; an FSDP config (its clients live on ``pod``) makes every device
of the mesh a process instead, each holding its (data, model) blocks and
training on its rows of each microbatch. Every rank draws the one-process
parameters from the same seed and keeps its blocks.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2_5_3b --reduced \\
      --steps 50 --batch 8 --seq 128 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu --ranks 2
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_moe_235b_a22b --reduced \
      --device cpu --ranks 6
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint.checkpoint import save as save_checkpoint
from repro_torch.configs import get_config
from repro_torch.data.datasets import synthetic_lm_batches
from repro_torch.fl.fedstep import FedStepConfig
from repro_torch.launch import tensor_parallel as tp
from repro_torch.launch.mesh import make_mesh_for_devices, make_smoke_mesh, make_virtual_mesh
from repro_torch.launch.serve import _rank_devices
from repro_torch.launch.steps import build_train_step, grid_axes


def make_batch(cfg, tokens, device) -> dict:
    """The train batch of ``tokens`` (B, S) for ``cfg``'s family: the JAX
    driver's stubs (zero patch embeddings, text positions) for a VLM."""
    batch = {"tokens": torch.as_tensor(tokens, device=device)}
    B, S = batch["tokens"].shape
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.zeros((B, cfg.vision_patches, cfg.d_model), device=device)
        batch["positions"] = torch.arange(S, dtype=torch.int32, device=device)[None, None].expand(
            3, B, S)
    return batch


def _train(group, args, mesh) -> dict:
    """One process's training run (the whole model, or one rank's blocks)."""
    cfg = get_config(args.arch, reduced=args.reduced)
    fed = FedStepConfig(local_steps=args.local_steps, local_lr=args.local_lr)
    device = args.device if group is None else group.device
    bundle, setup = build_train_step(cfg, mesh, fed, cross_pod_wire=args.cross_pod_wire,
                                     strategy_name=args.strategy, device=device, group=group)
    # bf16 products reduce split-K partial sums in float32, as the JAX
    # package's float32 accumulation does (models/layers.py)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    if group is None or group.rank == group.client_rank == 0:
        print(f"[train] arch={cfg.arch_id} params={cfg.param_count():,} "
              f"mesh={mesh.shape} clients over {setup.client_axes} "
              f"tag={setup.tag.name if setup.tag else None} device={bundle.device}", flush=True)

    params = bundle.init(torch.Generator(device=bundle.device).manual_seed(0))
    state = setup.init_state(params)
    data = synthetic_lm_batches(vocab=cfg.vocab_size, batch=args.batch, seq=args.seq, seed=0)
    t0 = time.time()
    losses = []
    for i in range(args.steps):
        batch = make_batch(cfg, next(data), bundle.device)
        params, state, metrics = setup.step(params, state, batch, i)
        losses.append(float(metrics["loss"]))
        if (group is None or group.rank == group.client_rank == 0) and (i % args.log_every == 0
                                                   or i == args.steps - 1):
            print(f"[train] step {i:4d} loss {losses[-1]:.4f} "
                  f"({(time.time() - t0) / (i + 1):.2f}s/step)", flush=True)
    if args.checkpoint and group is None:
        save_checkpoint(args.checkpoint, args.steps, params)
        print(f"[train] saved checkpoint to {args.checkpoint}")
    return {"losses": losses, "counters": group.counters() if group is not None else {}}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2_5_3b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=None,
                    help="rows a step (default 8, or the least multiple above of the local "
                         "steps times the data ranks)")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--local-steps", type=int, default=2)
    ap.add_argument("--local-lr", type=float, default=0.05)
    ap.add_argument("--strategy", default=None)
    ap.add_argument("--cross-pod-wire", default="f32")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--clients", type=int, default=1,
                    help="virtual clients on the data axis (the JAX driver's device count)")
    ap.add_argument("--ranks", type=int, default=1,
                    help="the JAX driver's device count as a mesh: its model axis in processes")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    clients = args.clients * (make_mesh_for_devices(args.ranks).shape["data"])
    unit = args.local_steps * clients
    if args.batch is None:
        args.batch = unit * -(-8 // unit)
    if args.ranks == 1:
        mesh = make_smoke_mesh() if args.clients == 1 else make_virtual_mesh(args.clients)
        losses = _train(None, args, mesh)["losses"]
    else:
        if args.clients != 1 or args.checkpoint:
            raise ValueError("--ranks takes its clients from the mesh and saves no checkpoint")
        mesh = make_mesh_for_devices(args.ranks)
        axes = grid_axes(get_config(args.arch, reduced=args.reduced), mesh, "train")
        n = 1
        for _, k in axes:
            n *= k
        devices = _rank_devices(args.device, n)
        with tp.GroupPool(devices, axes=axes) as pool:
            print(f"[train] {len(devices)} ranks on {devices}: grid {dict(axes)}, backend "
                  f"{pool.backend}")
            outs = [r.value for r in pool.run(_train, args, mesh, timeout_s=3600)]
        losses = outs[0]["losses"]
        if any(o["losses"] != losses for o in outs):
            raise RuntimeError("the ranks computed different losses")
    print(f"[train] done: first loss {losses[0]:.4f} -> last {losses[-1]:.4f}")
    assert losses[-1] < losses[0], "loss did not improve"
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
