#!/usr/bin/env python3
"""Device time of one-table calls of ``embedding_bag``,
``blockscale_compress`` and ``embedding_sgd`` at the kwai-dlrm shapes, to
hold two trees' kernels against each other in one run on one card:

    python3 tools/one_table_times.py [--src DIR]

``--src`` names the ``src`` directory whose ``repro_torch`` is imported
(default: this checkout's); that tree builds its own kernels. Each time is
one call's device ms, from a CUDA graph of 32 calls (one per table of
62,500 x 128 fp32) replayed 20 times between CUDA events, as
``chip_smoke.py`` times a kernel: ``embedding_bag`` at the serving (B 64)
and training (B 512) shapes, L 8, uniform random ids with a random-length
tail of -1 padding; ``blockscale_compress`` (block 128) of 1,024 rows of
128 per table, a training get's width; ``embedding_sgd`` of a unique put
of 694 rows per table (the entry point's put), also as one call per graph
replay (200 replays). Prints the card and one JSON line. Needs a GPU.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

TABLES, V, DIM, L = 32, 62_500, 128, 8


def device_ms(fn, reps: int = 20) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(reps):
        graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def bags(rng, b):
    ids = rng.integers(0, V, (b, L))
    lens = rng.integers(1, L + 1, b)
    return np.where(np.arange(L)[None, :] < lens[:, None], ids,
                    -1).astype(np.int32)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("one_table_times: no CUDA device visible", file=sys.stderr)
        return 1
    sys.path.insert(0, args.src)
    from repro_torch.kernels import ops

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(0)
    tables = [torch.randn((V, DIM), generator=gen, device=dev) * 0.02
              for _ in range(TABLES)]
    out = {"src": args.src}
    for name, b in (("embedding_bag_serve_ms", 64),
                    ("embedding_bag_train_ms", 512)):
        ids = [torch.as_tensor(bags(rng, b), device=dev)
               for _ in range(TABLES)]
        out[name] = device_ms(lambda ids=ids: [
            ops.embedding_bag(t, i) for t, i in zip(tables, ids)]) / TABLES
    rows = [torch.randn((1024, DIM), generator=gen, device=dev) * 0.02
            for _ in range(TABLES)]
    out["blockscale_compress_ms"] = device_ms(lambda: [
        ops.blockscale_compress(r, 128) for r in rows]) / TABLES
    puts = [(torch.randperm(V, generator=gen, device=dev)[:694].int(),
             torch.randn((694, DIM), generator=gen, device=dev) * 1e-3)
            for _ in range(TABLES)]
    out["embedding_sgd_ms"] = device_ms(lambda: [
        ops.embedding_sgd(t, *p, 1e-2, assume_unique=True)
        for t, p in zip(tables, puts)]) / TABLES
    out["embedding_sgd_lone_ms"] = device_ms(lambda: ops.embedding_sgd(
        tables[0], *puts[0], 1e-2, assume_unique=True), 200)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
