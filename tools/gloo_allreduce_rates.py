#!/usr/bin/env python3
"""All-reduce and all-gather rates of gloo on one CUDA card for a (data 2,
model 2) grid of four ranks (``launch.tensor_parallel.GroupPool``), the
layout phase 9f of ``chip_smoke.py`` runs: each rank all-reduces a buffer
over its data group (two ranks) while the other pair does the same.

Modes, each timed on the host clock around work that ends in a
synchronize (median of 3, after a warm-up):

* ``cuda``: one all-reduce of the whole float32 CUDA buffer;
* ``cuda_chunks_N``: the buffer in N chunks, all issued with
  ``async_op=True`` before the first wait (gloo's worker threads may run
  them at once);
* ``cpu_pinned``: one all-reduce of a pinned host buffer of the same size
  (gloo's host ring alone, no device copies);
* ``gather_padded``: FSDP's data gather as an all-reduce of the whole
  bf16 leaf, zero but for the rank's block along dim 1 (an expert leaf's
  data dim);
* ``gather_all_gather``: the same gather as one ``all_gather`` of the
  blocks, moved to their place along dim 1;
* ``gather_data``: the same gather through
  ``tensor_parallel.gather_data`` (one broadcast from each data rank),
  each gather checked equal to the padded all-reduce's;
* ``grad_all_reduce``: the whole leaf's gradient summed over the data
  group by one all-reduce and cut to the rank's block (the gather's
  backward before the reduce);
* ``grad_reduce``: the same sum as one ``dist.reduce`` of each data
  block, to the block's owner, on the CUDA tensor;
* ``grad_reduce_host``: the same reduces on a pinned host copy of each
  block, copied back to the card by the owner;
* ``grad_reduce_data``: the same sum through
  ``tensor_parallel.data_block_grad`` (each block sent to its owner
  through pinned host copies, the owner summing); each block checked
  equal, bit for bit, to the all-reduce's (two terms: the order does not
  matter).

``GB_per_s`` is the buffer's (the whole leaf's) bytes over the seconds.

Usage (on the card's machine, from the root of a checkout):
  python3 tools/gloo_allreduce_rates.py [--mb 512] [--chunks 4,16]
"""
import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.launch import tensor_parallel as tp  # noqa: E402

AXES = (("data", 2), ("model", 2))


def _timed(fn, dev, runs=3):
    fn()
    torch.cuda.synchronize(dev)
    out = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        out.append(time.perf_counter() - t0)
    return statistics.median(out)


def rates_rank(group, mb: int, chunks: list) -> dict:
    dev = group.device
    n = mb * (1 << 20) // 4
    x = torch.ones(n, dtype=torch.float32, device=dev)
    pg = group.rows_pg
    out = {}

    def whole():
        dist.all_reduce(x, group=pg)

    out["cuda"] = _timed(whole, dev)
    for k in chunks:
        parts = x.chunk(k)

        def chunked(parts=parts):
            for w in [dist.all_reduce(p, group=pg, async_op=True) for p in parts]:
                w.wait()

        out[f"cuda_chunks_{k}"] = _timed(chunked, dev)
    h = torch.ones(n, dtype=torch.float32).pin_memory()

    def host():
        dist.all_reduce(h, group=pg)

    out["cpu_pinned"] = _timed(host, dev)
    # a bf16 leaf (8, rows, 8192) of the buffer's bytes, split over data on dim 1
    rows = mb * (1 << 20) // (8 * 8192 * 2)
    me, D = group.coords["data"], group.data_size
    gen = torch.Generator(device=dev).manual_seed(me)
    block = torch.randn((8, rows // D, 8192), generator=gen, device=dev).to(torch.bfloat16)
    got = {}

    def padded():
        full = block.new_zeros((8, rows, 8192))
        full.narrow(1, me * (rows // D), rows // D).copy_(block)
        dist.all_reduce(full, group=group.data_pg)
        got["padded"] = full

    def all_gather():
        blocks = block.new_empty((D,) + tuple(block.shape))
        dist.all_gather(list(blocks.unbind(0)), block, group=group.data_pg)
        got["all_gather"] = blocks.movedim(0, 1).reshape(8, rows, 8192)

    def gather_data():
        with tp.use_group(group), torch.no_grad():
            got["gather_data"] = tp.gather_data(block, 1)

    for name, fn in (("gather_padded", padded), ("gather_all_gather", all_gather),
                     ("gather_data", gather_data)):
        out[name] = _timed(fn, dev)
    for name in ("all_gather", "gather_data"):
        if not torch.equal(got["padded"], got[name]):
            raise AssertionError(f"{name}'s leaf differs from the padded all-reduce's")
    out.update(_grad_sums(group, rows, dev))
    return {k: {"s": v, "GB_per_s": mb * (1 << 20) / v / 1e9} if isinstance(v, float)
            else {"error": v} for k, v in out.items()}


def _grad_sums(group, rows: int, dev) -> dict:
    """The ``grad_*`` modes: the gradient of a whole bf16 leaf (8, rows,
    8192) on the rank's rows, summed over data into the rank's block along
    dim 1. A mode that the backend refuses records its error instead of a
    time."""
    me, D = group.coords["data"], group.data_size
    n = rows // D
    pg = group.data_pg
    owners = [dist.get_global_rank(pg, i) for i in range(D)]
    gen = torch.Generator(device=dev).manual_seed(100 + group.client_rank)
    whole = torch.randn((8, rows, 8192), generator=gen, device=dev).to(torch.bfloat16)
    got, out = {}, {}

    def all_reduce():
        g = whole.clone()
        dist.all_reduce(g, group=pg)
        got["all_reduce"] = g.narrow(1, me * n, n).clone()

    def reduce():
        for i in range(D):
            piece = whole.narrow(1, i * n, n).contiguous()
            dist.reduce(piece, dst=owners[i], group=pg)
            if i == me:
                got["reduce"] = piece

    def reduce_host():
        for i in range(D):
            piece = torch.empty((8, n, 8192), dtype=torch.bfloat16, pin_memory=True)
            piece.copy_(whole.narrow(1, i * n, n))
            dist.reduce(piece, dst=owners[i], group=pg)
            if i == me:
                got["reduce_host"] = piece.to(dev)

    def reduce_data():
        with tp.use_group(group), torch.no_grad():
            got["reduce_data"] = tp.data_block_grad(whole.clone(), 1, group)

    for name, fn in (("grad_all_reduce", all_reduce), ("grad_reduce", reduce),
                     ("grad_reduce_host", reduce_host), ("grad_reduce_data", reduce_data)):
        try:
            out[name] = _timed(fn, dev)
        except Exception as e:  # noqa: BLE001 - a refused mode is a result
            out[name] = f"{type(e).__name__}: {e}"[:300]
    for name in ("reduce", "reduce_host", "reduce_data"):
        if name in got and not torch.equal(got["all_reduce"].view(torch.int16),
                                           got[name].view(torch.int16)):
            raise AssertionError(f"{name}'s block differs from the all-reduce's")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mb", type=int, default=512)
    ap.add_argument("--chunks", default="4,16")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    chunks = [int(c) for c in args.chunks.split(",") if c]
    with tp.GroupPool(["cuda:0"] * 4, timeout_s=600, axes=AXES) as pool:
        res = [r.value for r in pool.run(rates_rank, args.mb, chunks)]
    print(json.dumps({"buffer_mb": args.mb, "grid": dict(AXES), "ranks": res}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
