#!/usr/bin/env python3
"""All-reduce rates of gloo on one CUDA card for a (data 2, model 2) grid
of four ranks (``launch.tensor_parallel.GroupPool``), the layout phase 9f
of ``chip_smoke.py`` runs: each rank all-reduces a buffer over its data
group (two ranks) while the other pair does the same.

Modes, each timed on the host clock around work that ends in a
synchronize (median of 3, after a warm-up):

* ``cuda``: one all-reduce of the whole CUDA buffer (the data gather's);
* ``cuda_chunks_N``: the buffer in N chunks, all issued with
  ``async_op=True`` before the first wait (gloo's worker threads may run
  them at once);
* ``cpu_pinned``: one all-reduce of a pinned host buffer of the same size
  (gloo's host ring alone, no device copies).

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
    return {k: {"s": v, "GB_per_s": mb * (1 << 20) / v / 1e9} for k, v in out.items()}


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
