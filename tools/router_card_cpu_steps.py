#!/usr/bin/env python3
"""Where the card and the CPU part on kwai-dlrm's sharded router at the
config's 62,500 rows, one hybrid(3) step after another from one state:

    python3 tools/router_card_cpu_steps.py

For one shard and for the router's four, a trainer on the card and one on
the CPU start from the card's state (``TrainState.to``) and run two steps
stage by stage (prepare, lookup, dense step, put), each on its own state.
Each step prints whether the pooled bags and the tables are equal bit for
bit, and how far apart the activation gradients and the dense parameters
are. Prints the card first. Needs a GPU.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.core.hybrid import TrainMode  # noqa: E402
from repro_torch.utils import tree_leaves  # noqa: E402


def max_abs(a, b) -> float:
    return max(float((x.cpu().float() - y.float()).abs().max())
               for x, y in zip(a, b))


def main() -> int:
    if not torch.cuda.is_available():
        print("router_card_cpu_steps: needs a GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    ds = cs.CTR_BENCHMARKS["kwai_video"]
    it = ds.sampler(cs.TRAIN_B, seed=cs.SEED + 20)
    batches = [next(it) for _ in range(2)]
    for shards in (1, cs.SHARDS):
        trainers = {d: cs.kwai_train_trainer(d, TrainMode.hybrid(cs.TAU),
                                             shards=shards)
                    for d in (dev, "cpu")}
        states = {dev: trainers[dev].init(seed=cs.SEED + 1,
                                          batch_example=batches[0])}
        states["cpu"] = states[dev].to("cpu")
        for step, b in enumerate(batches):
            out = {}
            for d, tr in trainers.items():
                lookup_fn, dense_step, emb_put = tr.decomposed_fns()
                st, dev_ids, _ = tr._prepare(states[d], b)
                pooled, _ = lookup_fn(st.emb, dev_ids)
                dense, opt, dq, agrads, m = dense_step(
                    st.dense, st.opt, st.dense_queue, pooled, b, st.step)
                emb, q, _ = emb_put(st.emb, st.emb_queue, dev_ids, agrads)
                states[d] = st.replace(dense=dense, opt=opt, emb=emb,
                                       emb_queue=q, dense_queue=dq,
                                       step=st.step + 1)
                out[d] = (pooled, agrads, float(m["loss"]))
            (pg, ag, lg), (pc, ac, lc) = out[dev], out["cpu"]
            names = list(pg)
            print(f"shards {shards} step {step}: loss {lg!r} / {lc!r}; "
                  "pooled equal "
                  f"{all(torch.equal(pg[n].cpu(), pc[n]) for n in names)}; "
                  "tables equal "
                  f"{max_abs(tree_leaves(states[dev].emb), tree_leaves(states['cpu'].emb)) == 0.0}; "
                  f"activation grads apart {max_abs([ag[n] for n in names], [ac[n] for n in names]):.4g} "
                  f"(largest {max(float(ac[n].abs().max()) for n in names):.4g}); "
                  f"dense apart {max_abs(tree_leaves(states[dev].dense), tree_leaves(states['cpu'].dense)):.4g}",
                  flush=True)
        del trainers, states
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
