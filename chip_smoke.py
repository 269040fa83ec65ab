#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs its serving path on one
NVIDIA GPU (H100, sm_90a). Run from the repository root:

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) if it goes wrong:

1. Build: compiles every CUDA source of the port with nvcc (TF32 is off for
   all float32 products).
2. Kernels: holds ``embedding_bag`` and ``unique_bag`` bit for bit against
   their plain torch versions on the card, at the serving shape (B=64,
   L=8, D=128, V=62,500) and on edge cases (all-padding bags, plan
   padding, all-duplicate bags, D=13 on the scalar path), and times each
   kernel, its plain version and ``torch.nn.functional.embedding_bag`` as a
   yardstick (the port never calls it) over 32 tables of that shape.
3. Serve: the full width of ``kwai-dlrm`` (32 tables of 62,500 x 128 fp32,
   FFNN 4112-4096-2048-1024-512-256-4) with random weights from a seeded
   generator. A ``ServingService(max_batch=64)`` answers 512 traffic-model
   requests from 4 client threads; half the tables read through the dedup
   plan (``unique_bag``), half at occurrence width (``embedding_bag``).
   The predictions must be finite, in (0, 1), agree with the plain lookup
   (gather + pool, no kernel) and the launch counts must show that every
   flush went through both kernels. Then ``trainer.eval`` on a 1024-row
   batch.

It prints the card's name and power limit, one JSON line per phase, the
``{"kernels": [...]}`` line and, last, ``{"ok": true, "device": ...}``.
The full record goes to ``chiprun_out/chip_smoke.json``. Without a GPU it
exits non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs.recsys_configs import KWAI  # noqa: E402
from repro_torch.core import adapters  # noqa: E402
from repro_torch.core import dedup as D  # noqa: E402
from repro_torch.core.hybrid import PersiaTrainer, TrainMode  # noqa: E402
from repro_torch.data.ctr import CTR_BENCHMARKS  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.models.recsys import pool_bag  # noqa: E402
from repro_torch.serving import (ServingConfig, ServingService,  # noqa: E402
                                 StateCell, TrafficModel)

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and fp32 outside the
# tensor cores. The bound of a kernel is the larger of its bytes over the
# first and its operations over the second.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

B, L, DIM, V = 64, 8, 128, 62_500        # the serving flush of one table
N_TABLES = 32                             # kwai-dlrm's tables
N_REQUESTS, N_CLIENTS, CHUNK = 512, 4, 16
SEED = 0

KERNELS = {
    "embedding_bag": {"source": "src/repro_torch/kernels/csrc/bag.cu",
                      "replaces": "src/repro/kernels/embedding_bag.py:35"},
    "unique_bag": {"source": "src/repro_torch/kernels/csrc/bag.cu",
                   "replaces": "src/repro/kernels/unique_bag.py:45"},
}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str):
    if not cond:
        raise SmokeFailure(what)


def emit(obj: dict):
    print(json.dumps(obj), flush=True)


def eager_ms(fn, reps: int) -> float:
    """Mean ms of one eager ``fn()`` call between CUDA events, after a
    warm-up call: what a caller pays, host enqueue included."""
    fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def device_ms(fn, reps: int) -> float:
    """Mean device ms of one ``fn()`` call: ``fn`` is captured once into a
    CUDA graph and replayed ``reps`` times between CUDA events, so the
    host's enqueue cost drops out."""
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


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------

def bag_ids(rng, b, l, v):
    """(b, l) ids in [0, v) with a random-length tail of -1 padding."""
    ids = rng.integers(0, v, (b, l))
    lens = rng.integers(1, l + 1, b)
    return np.where(np.arange(l)[None, :] < lens[:, None], ids, -1)


def plan_of(ids, v):
    """Dedup plan of host ids: (dev (U,) int32 rows, inv (B, L) int32)."""
    u_pad, inv, _, _ = D.make_plan(ids, v, D.dedup_cap(ids.size, v))
    return u_pad.astype(np.int32), inv


def exact(name, case, got, want):
    """Bit-for-bit agreement of a kernel with its plain version."""
    err = float((got - want).abs().max()) if got.numel() else 0.0
    check(got.shape == want.shape and torch.equal(got, want),
          f"{name}[{case}]: kernel differs from plain version "
          f"(max abs err {err})")
    return err


def kernel_phase(dev, rng):
    cuda = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    errs = {k: 0.0 for k in KERNELS}

    def both(case, table, ids, plan=None):
        ids_t = cuda(ids.astype(np.int32))
        errs["embedding_bag"] = max(errs["embedding_bag"], exact(
            "embedding_bag", case, ops.embedding_bag(table, ids_t),
            ref.embedding_bag_ref(table, ids_t)))
        u, inv = plan if plan is not None else plan_of(ids, table.shape[0])
        u_t, inv_t = cuda(u), cuda(inv)
        errs["unique_bag"] = max(errs["unique_bag"], exact(
            "unique_bag", case, ops.unique_bag(table, u_t, inv_t),
            ref.unique_bag_ref(table, u_t, inv_t)))

    gen = torch.Generator(device=dev).manual_seed(SEED)
    tables = [torch.randn((V, DIM), generator=gen, device=dev) * 0.02
              for _ in range(N_TABLES)]
    serve_ids = [bag_ids(rng, B, L, V) for _ in range(N_TABLES)]
    t = tables[0]
    both("serve", t, serve_ids[0])
    both("all_padding", t, np.full((B, L), -1))
    both("all_duplicate", t, np.full((B, L), 4242))
    out_of_range = serve_ids[1].copy()
    out_of_range[:, 0] = V + 7
    both("ids_past_end", t, out_of_range)
    # plan padding: half the occurrences point at dev slots holding -1
    u, inv = plan_of(serve_ids[2], V)
    n_u = int((u >= 0).sum())
    u = np.concatenate([u, np.full(32, -1, np.int32)])
    inv = np.where((np.arange(L)[None, :] % 2 == 1) & (inv >= 0),
                   n_u + (inv % 32), inv).astype(np.int32)
    both("dev_padding", t, serve_ids[2], plan=(u, inv))
    t13 = torch.randn((1000, 13), generator=gen, device=dev)
    both("d13_scalar", t13, bag_ids(rng, B, L, 1000))
    torch.cuda.synchronize()

    # timing: one call per table over the 32 tables, as one serving flush
    # does; the 1 GB of tables is 20x the L2, so rows come from HBM. Each
    # time is per call: on the device (graph replay) and eager
    ids_t = [cuda(i.astype(np.int32)) for i in serve_ids]
    plans = [tuple(cuda(a) for a in plan_of(i, V)) for i in serve_ids]
    safe = [torch.clamp(i, min=0).long() for i in ids_t]
    wts = [(i >= 0).float() for i in ids_t]
    rows_u = [torch.where(inv >= 0, u[inv.clamp(min=0).long()], -1)
              for u, inv in plans]
    safe_u = [torch.clamp(r, min=0).long() for r in rows_u]
    wts_u = [(r >= 0).float() for r in rows_u]
    reps = 20

    def loop(f):
        return lambda: [f(k) for k in range(N_TABLES)]

    fns = {
        "embedding_bag": {
            "ms": lambda k: ops.embedding_bag(tables[k], ids_t[k]),
            "plain_ms": lambda k: ref.embedding_bag_ref(tables[k], ids_t[k]),
            "library_ms": lambda k: F.embedding_bag(
                safe[k], tables[k], mode="sum", per_sample_weights=wts[k]),
        },
        "unique_bag": {
            "ms": lambda k: ops.unique_bag(tables[k], *plans[k]),
            "plain_ms": lambda k: ref.unique_bag_ref(tables[k], *plans[k]),
            "library_ms": lambda k: F.embedding_bag(
                safe_u[k], tables[k], mode="sum", per_sample_weights=wts_u[k]),
        },
    }
    timing = {name: {} for name in fns}
    for name, by in fns.items():
        for key, f in by.items():
            run = loop(f)
            timing[name][key] = device_ms(run, reps) / N_TABLES
            timing[name]["eager_" + key] = eager_ms(run, reps) / N_TABLES
    # bound: each distinct row read once, each output row written once,
    # each index read once; operations: one fp32 add per valid element
    for name in KERNELS:
        bound, n_bytes, n_ops = [], [], []
        for k, ids in enumerate(serve_ids):
            valid = ids[ids >= 0]
            idx_bytes = ids.size * 4 + (plans[k][0].numel() * 4
                                        if name == "unique_bag" else 0)
            nb = np.unique(valid).size * DIM * 4 + B * DIM * 4 + idx_bytes
            no = valid.size * DIM
            n_bytes.append(nb)
            n_ops.append(no)
            bound.append(max(nb / HBM_BYTES_PER_S, no / FP32_OPS_PER_S))
        b_bytes = float(np.mean(n_bytes)) / HBM_BYTES_PER_S
        b_ops = float(np.mean(n_ops)) / FP32_OPS_PER_S
        timing[name].update(
            bound_ms=float(np.mean(bound)) * 1e3,
            bound_by="bytes" if b_bytes >= b_ops else "operations",
            max_abs_err=errs[name])
    del tables
    torch.cuda.empty_cache()
    return timing


# ---------------------------------------------------------------------------
# serve phase
# ---------------------------------------------------------------------------

def kwai_trainer(dev):
    ds = CTR_BENCHMARKS["kwai_video"]
    # even tables read through the dedup plan (unique_bag), odd ones at
    # occurrence width (embedding_bag), so one flush runs both kernels
    coll = adapters.ctr_collection(KWAI, field_rows=ds.field_rows()) \
        .map_specs(lambda n, s: dataclasses.replace(
            s, batch_dedup=int(n.rsplit("_", 1)[1]) % 2 == 0))
    adapter = adapters.recsys_adapter(KWAI, collection=coll)
    return ds, PersiaTrainer(adapter, TrainMode.sync(), device=dev)


def serve(trainer, cell, reqs, config):
    """Answer ``reqs`` from N_CLIENTS threads, each submitting bursts of
    CHUNK requests; returns (predictions in request order, metrics)."""
    preds = [None] * len(reqs)
    errors = []

    def client(k):
        try:
            idx = list(range(k, len(reqs), N_CLIENTS))
            for i in range(0, len(idx), CHUNK):
                part = idx[i:i + CHUNK]
                out = svc.predict_many([reqs[j] for j in part])
                for j, p in zip(part, out):
                    preds[j] = p
        except Exception as e:   # noqa: BLE001 — reported below
            errors.append(repr(e))

    svc = ServingService(trainer, cell, config).start()
    try:
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(N_CLIENTS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        check(not any(th.is_alive() for th in threads),
              "serving clients did not finish")
    finally:
        svc.stop()
    check(not errors, f"serving clients failed: {errors[:3]}")
    return np.stack(preds), svc.metrics()


def stack(reqs):
    return {"ids": np.stack([r["ids"] for r in reqs]),
            "dense": np.stack([r["dense"] for r in reqs])}


def flush_breakdown(trainer, state, batch, reps: int = 20) -> dict:
    """Where one full flush (64 requests) spends its time: host wall ms of
    the pooled read (32 tables: plan, index copies, kernel) and of the
    FFNN, each ended by a synchronize, and the share of the flush's wall
    time in which the device ran work (kernel and copy times summed by the
    profiler over a second, profiled set of flushes)."""
    lookup_ms, predict_ms = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pooled, _ = trainer.serve_lookup(state, batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        trainer.adapter.predict(state.dense, pooled, batch).cpu()
        t2 = time.perf_counter()
        lookup_ms.append((t1 - t0) * 1e3)
        predict_ms.append((t2 - t1) * 1e3)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            pooled, _ = trainer.serve_lookup(state, batch)
            trainer.adapter.predict(state.dense, pooled, batch).cpu()
    device_us = sum(e.self_device_time_total for e in prof.key_averages())
    flush_ms = float(np.median(lookup_ms) + np.median(predict_ms))
    return {"lookup_ms": float(np.median(lookup_ms)),
            "predict_ms": float(np.median(predict_ms)),
            "device_ms": device_us / 1e3 / reps,
            "device_busy_share": device_us / 1e3 / reps / flush_ms}


def serve_phase(dev):
    ds, trainer = kwai_trainer(dev)
    state = trainer.init(seed=SEED)
    cell = StateCell(state, 0)
    reqs = [r for _, r in TrafficModel.for_dataset(ds, seed=SEED)
            .requests(N_REQUESTS, seed=1)]
    config = ServingConfig(max_batch=64, max_wait_ms=2.0)
    serve(trainer, cell, reqs[:128], config)             # warm-up
    torch.cuda.synchronize()

    ops.reset_launch_counts()
    preds, m = serve(trainer, cell, reqs, config)
    launches = ops.launch_counts()

    n_plan = sum(s.batch_dedup for _, s in trainer.collection.items())
    n_flat = len(trainer.collection) - n_plan
    flushes = int(m["serving/batches"])
    check(int(m["serving/requests"]) == N_REQUESTS
          and m["serving/errors"] == 0, f"service metrics {m}")
    check(launches["unique_bag"] == n_plan * flushes
          and launches["embedding_bag"] == n_flat * flushes,
          f"launches {launches} != one per table per flush "
          f"({flushes} flushes, {n_plan} plan / {n_flat} flat tables)")
    check(preds.shape == (N_REQUESTS, KWAI.n_tasks), f"shape {preds.shape}")
    check(bool(np.all(np.isfinite(preds))) and preds.min() > 0
          and preds.max() < 1, "predictions not finite in (0, 1)")

    # the same requests through the plain lookup (gather + pool, no
    # kernel) at another batch shape: cuBLAS may pick another reduction
    # order for another M, hence allclose and not equality
    batch = stack(reqs)
    acts = trainer.lookup(state, batch)
    ids = trainer.adapter.emb_ids(batch)
    pooled = {n: pool_bag(a, ids[n]) for n, a in acts.items()}
    plain = trainer.adapter.predict(state.dense, pooled, batch) \
        .cpu().numpy()
    via_kernels = trainer.predict(state, batch).cpu().numpy()
    diff = float(np.abs(preds - plain).max())
    check(np.allclose(preds, plain, rtol=1e-5, atol=1e-6),
          f"served predictions differ from the plain lookup by {diff}")
    check(np.allclose(via_kernels, plain, rtol=1e-5, atol=1e-6),
          "trainer.predict differs from the plain lookup")

    breakdown = flush_breakdown(trainer, state, stack(reqs[:64]))

    eb = next(ds.sampler(1024, seed=2))
    em = trainer.eval(state, eb)
    ep = trainer.predict(state, eb).cpu().numpy()
    aucs = [adapters.auc(eb["labels"][:, t], ep[:, t])
            for t in range(KWAI.n_tasks)]
    loss = float(em["loss"])
    check(np.isfinite(loss) and ep.shape == (1024, KWAI.n_tasks),
          "eval not finite")
    return launches, {
        "phase": "serve", "model": KWAI.name, "tables": len(state.emb),
        "table_rows": int(state.emb["field_00"]["table"].shape[0]),
        "emb_dim": KWAI.emb_dim,
        "mlp": [int(lyr["w"].shape[0]) for lyr in state.dense["mlp"]]
        + [KWAI.n_tasks],
        "requests": N_REQUESTS, "clients": N_CLIENTS, "max_batch": 64,
        "flushes": flushes, "fill": m["serving/field_00/batch_fill"],
        "p50_ms": m["serving/p50_ms"], "p99_ms": m["serving/p99_ms"],
        "qps": m["serving/qps"], "max_abs_diff_vs_plain": diff,
        "flush": breakdown,
        "eval_rows": 1024, "eval_loss": loss,
        "eval_pred_mean": float(em["pred_mean"]),
        "eval_auc_per_task": aucs,
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this check runs on a GPU",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi gave nothing"
    print(card, flush=True)

    t0 = time.perf_counter()
    libs = build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for p in libs.values()
             for ln in p.with_suffix(".log").read_text().splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": build_s,
          "libraries": [p.name for p in libs.values()], "ptxas": ptxas})

    rng = np.random.default_rng(SEED)
    timing = kernel_phase(dev, rng)
    emit({"phase": "kernels", "shape": {"B": B, "L": L, "D": DIM, "V": V,
                                        "tables": N_TABLES},
          "bit_exact": True, "per_call_ms": timing})
    launches, serve_rec = serve_phase(dev)
    emit(serve_rec)

    kernels = []
    for name, meta in KERNELS.items():
        t = timing[name]
        kernels.append({
            "name": name, "route": "cuda", **meta,
            "launches": launches[name], "max_abs_err": t["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
    record = {"card": card, "build_s": build_s, "ptxas": ptxas,
              "serve": serve_rec, "kernels": kernels}
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
