#!/usr/bin/env python3
"""The sharded router's host_lru prepare through its thread pool against
the same shard prepares run one after another on the caller's thread, in
one run on one card:

    python3 tools/router_prepare_pool.py

kwai-dlrm at full width on host_lru (7,812 cache slots a table, the
launchers' default), hybrid(3), batch 512, warmed by 26 steps until it
evicts. One shard, then the router's four: 6 staged steps each (the
stage boundaries synchronised, as ``chip_smoke.py``'s ``staged_step``),
the router's three times over: its pool, inline, its pool again. Prints
the card and, per run, the median stage ms, the fault path's host ms by
part (summed over the shards' threads) and the faults and write-backs a
step. Needs a GPU.
"""
from __future__ import annotations

import concurrent.futures
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.core.hybrid import TrainMode  # noqa: E402

STEPS, WARM = 6, 26


class Inline:
    """An executor that runs each task at once on the caller's thread."""

    def submit(self, fn, *args):
        f = concurrent.futures.Future()
        f.set_result(fn(*args))
        return f

    def shutdown(self, wait=True):
        pass


def main() -> int:
    if not torch.cuda.is_available():
        print("router_prepare_pool: needs a GPU", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    ds = cs.CTR_BENCHMARKS["kwai_video"]
    it = ds.sampler(cs.TRAIN_B, seed=cs.SEED + 31)
    batches = [next(it) for _ in range(WARM + 3 * STEPS)]
    for k, runs in ((1, ("one",)), (cs.SHARDS, ("pool", "inline", "pool"))):
        tr = cs.kwai_train_trainer(dev, TrainMode.hybrid(cs.TAU),
                                   cs.HOST_LRU, shards=k)
        s = tr.init(seed=cs.SEED, batch_example=batches[0])
        for b in batches[:WARM]:
            s, _ = tr.step(s, b)
        torch.cuda.synchronize()
        for i, how in enumerate(runs):
            if k > 1:
                for b in tr.backends.values():
                    b._pool = Inline() if how == "inline" else None
            times, split = {}, {}
            for b in batches[WARM + i * STEPS:WARM + (i + 1) * STEPS]:
                c = cs.lru_counters(tr)
                s, _ = cs.staged_step(tr, s, b, times)
                for key, v in cs.lru_delta(c, cs.lru_counters(tr)).items():
                    split.setdefault(key, []).append(v)
            print(json.dumps({
                "shards": k, "prepare": how,
                "stage_ms": {key: float(np.median(v))
                             for key, v in times.items()},
                "fault_path_ms": {key: float(np.median(v)) * 1e3
                                  for key, v in split.items()
                                  if key.endswith("_s")},
                "faults": float(np.median(split["faults"])),
                "writebacks": float(np.median(split["writebacks"]))}),
                flush=True)
        del tr, s
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
