"""Training launcher (port of ``repro/launch/train.py``): runs the Persia
hybrid trainer end to end on the card, serially or through the pipelined
trainer, on the CTR task or the LM task.

Usage (on the card; ``--device cpu`` runs the plain versions on the CPU):
  PYTHONPATH=src python -m repro_torch.launch.train --dataset taobao_ad \\
      --mode hybrid --steps 300 --batch 512
  PYTHONPATH=src python -m repro_torch.launch.train --pipeline pipelined \\
      --max-inflight 4 --emb-backend host_lru
  PYTHONPATH=src python -m repro_torch.launch.train --pipeline decomposed \\
      --ckpt-dir /tmp/ck --resume
  PYTHONPATH=src python -m repro_torch.launch.train --task lm --steps 200 \\
      --batch 8 --seq-len 128

The CTR model trains one embedding table per ID feature field (the
multi-table EmbeddingCollection) through the PersiaTrainer facade;
checkpoints carry the FULL train state — dense params, optimizer moments,
every PS table with its adagrad accumulator (a host_lru table with its
host tiers), and the staleness queues — so ``--resume`` continues
bit-identically. The LM task trains ``small_lm_cfg`` (about 100M dense
parameters) on synthetic Markov tokens through the one-table collection
of ``adapters.lm_adapter``. ``--emb-shards`` (a bare int or ``table=k``
pairs) runs tables over the sharded router.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import BlockCfg, ModelConfig
from repro_torch.core import adapters
from repro_torch.core.hybrid import PersiaTrainer, TrainMode
from repro_torch.data.ctr import CTR_BENCHMARKS
from repro_torch.data.lm import lm_batches
from repro_torch.launch.shards import (apply_backend_choice,
                                       default_cache_rows, parse_emb_shards)
from repro_torch.optim.optimizers import OptConfig
from repro_torch.utils import tree_leaves


def scaled_recsys_cfg(dataset: str) -> ModelConfig:
    ds = CTR_BENCHMARKS[dataset]
    return ModelConfig(
        name=f"{dataset}-dlrm", arch_type="recsys",
        n_id_fields=ds.n_fields, ids_per_field=ds.ids_per_field,
        emb_dim=32, emb_rows=ds.n_rows, n_dense_features=ds.n_dense,
        mlp_dims=(256, 128, 64), n_tasks=ds.n_tasks, emb_staleness=3)


def small_lm_cfg() -> ModelConfig:
    """~100M dense params (the end-to-end example scale)."""
    return ModelConfig(
        name="lm-100m", d_model=512, n_heads=8, n_kv_heads=4, head_dim=64,
        d_ff=2048, vocab_size=8192,
        pattern=(BlockCfg("gqa", "dense"),), pattern_repeats=20,
        emb_staleness=2)


def mode_from_name(name: str, tau: int) -> TrainMode:
    if name == "sync":
        return TrainMode.sync()
    if name == "hybrid":
        return TrainMode.hybrid(tau)
    if name == "async":
        return TrainMode.async_(tau, tau)
    raise ValueError(name)


def _step_fn(trainer: PersiaTrainer, pipeline: str):
    if pipeline == "decomposed":
        return trainer.decomposed_step
    return trainer.step


def _make_engine(trainer: PersiaTrainer, args):
    """--pipeline pipelined: the staged engine (core/pipeline.py) carrying
    up to --max-inflight microbatches."""
    from repro_torch.core.pipeline import PipelinedTrainer
    return PipelinedTrainer(trainer, max_inflight=args.max_inflight)


def _pipelined_span(engine, state, it, n):
    """Run n steps through the engine, pulling batches lazily from ``it``;
    returns (state, last-step metrics)."""
    state, ms = engine.run(state, (next(it) for _ in range(n)))
    return state, (ms[-1] if ms else {})


def _ctr_collection_for(cfg, ds, args):
    """Per-field tables with the CLI-selected storage backend (dense PS,
    host_lru out-of-core, or either behind the compressed wire)."""
    coll = adapters.ctr_collection(cfg, lr=args.emb_lr,
                                   field_rows=ds.field_rows())
    coll = apply_backend_choice(
        coll, args.emb_backend,
        default_cache_rows(ds.rows_per_field, args.cache_rows))
    shards = parse_emb_shards(args.emb_shards)
    if shards != 1:
        coll = coll.with_shards(shards)
    return _apply_emb_tuning(coll, args)


def _apply_emb_tuning(coll, args):
    """--store-dtype / --backward-kernel spec overrides (the second selects
    nothing in the port: every put runs the fused_backward kernel)."""
    if args.store_dtype != "fp32":
        coll = coll.with_store_dtype(args.store_dtype)
    if args.backward_kernel:
        coll = coll.with_backward_kernel(True)
    return coll


def _eval_line(trainer, state, eval_it, step, start, batch, t0, metrics):
    eb = next(eval_it)
    preds = trainer.predict(state, eb).cpu().numpy()
    a = adapters.auc(np.asarray(eb["labels"]), preds)
    dt = time.time() - t0
    thr = (step - start) * batch / dt
    loss = float(metrics["loss"])
    print(f"step {step:5d} loss {loss:.4f} AUC {a:.4f} "
          f"thr {thr:,.0f} samples/s")
    return {"step": step, "time_s": dt, "loss": loss, "auc": a,
            "throughput": thr}


def train_ctr(args):
    ds = CTR_BENCHMARKS[args.dataset]
    cfg = scaled_recsys_cfg(args.dataset)
    adapter = adapters.recsys_adapter(
        cfg, lr=args.emb_lr, field_rows=ds.field_rows(),
        collection=_ctr_collection_for(cfg, ds, args))
    mode = mode_from_name(args.mode, args.tau)
    trainer = PersiaTrainer(adapter, mode,
                            OptConfig(kind="adam", lr=args.lr),
                            batch_dedup=False if args.no_batch_dedup
                            else None, device=args.device)
    it = ds.sampler(args.batch)
    eval_it = ds.sampler(args.batch, seed=999)
    batch = next(it)
    start = 0
    mgr = CheckpointManager(args.ckpt_dir, every=args.ckpt_every) \
        if args.ckpt_dir else None
    if args.resume and not mgr:
        raise SystemExit("--resume requires --ckpt-dir")
    have_ckpt = mgr and os.path.isdir(args.ckpt_dir) and \
        any(d.startswith("step_") for d in os.listdir(args.ckpt_dir))
    if args.resume and not have_ckpt:
        print(f"--resume: no checkpoints under {args.ckpt_dir!r}, "
              "starting fresh")
    if args.resume and have_ckpt:
        state = trainer.restore(args.ckpt_dir)
        start = int(state.step)
        # fast-forward the deterministic streams to where the run stopped,
        # so resumed training sees the batches an uninterrupted run would
        for _ in range(start):
            next(it)
        for _ in range(start // args.eval_every):
            next(eval_it)
        print(f"resumed full state from step {start}")
    else:
        state = trainer.init(args.seed, batch)
    history = []
    t0 = time.time()
    engine = None
    if args.pipeline == "pipelined":
        # the engine consumes whole spans, ending at every eval and
        # checkpoint boundary, so the stages overlap across microbatches
        # and eval/ckpt run on the settled state
        engine = _make_engine(trainer, args)
        step = start
        while step < args.steps:
            n = min(args.eval_every - step % args.eval_every,
                    args.steps - step)
            if mgr:
                n = min(n, args.ckpt_every - step % args.ckpt_every)
            state, metrics = _pipelined_span(engine, state, it, n)
            step += n
            if step % args.eval_every == 0:
                history.append(_eval_line(trainer, state, eval_it, step,
                                          start, args.batch, t0, metrics))
            if mgr:
                mgr.maybe_save_state(step, trainer, state)
    else:
        step_fn = _step_fn(trainer, args.pipeline)
        for step in range(start, args.steps):
            state, metrics = step_fn(state, next(it))
            if (step + 1) % args.eval_every == 0:
                history.append(_eval_line(trainer, state, eval_it, step + 1,
                                          start, args.batch, t0, metrics))
            if mgr:
                mgr.maybe_save_state(step + 1, trainer, state)
    if args.out:
        rec = {"mode": args.mode, "dataset": args.dataset,
               "pipeline": args.pipeline, "device": str(trainer.device),
               "history": history}
        if engine is not None:
            rec["pipeline_metrics"] = engine.pipeline_metrics()
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    return history


def _lm_line(step, batch, seq_len, t0, metrics):
    dt = time.time() - t0
    tok_s = step * batch * seq_len / dt
    loss = float(metrics["loss"])
    print(f"step {step:5d} loss {loss:.4f} {tok_s:,.0f} tok/s")
    return {"step": step, "time_s": dt, "loss": loss}


def train_lm(args):
    """The LM task: ``small_lm_cfg`` through ``lm_adapter``, on
    ``lm_batches``; a loss line every ``--eval-every`` steps."""
    import dataclasses
    cfg = small_lm_cfg()
    adapter = adapters.lm_adapter(cfg, lr=args.emb_lr)
    coll = apply_backend_choice(
        adapter.collection, args.emb_backend,
        default_cache_rows(cfg.vocab_size, args.cache_rows))
    shards = parse_emb_shards(args.emb_shards)
    if shards != 1:
        coll = coll.with_shards(shards)
    coll = _apply_emb_tuning(coll, args)
    if coll is not adapter.collection:
        adapter = dataclasses.replace(adapter, collection=coll)
    mode = mode_from_name(args.mode, args.tau)
    trainer = PersiaTrainer(adapter, mode,
                            OptConfig(kind="adam", lr=args.lr),
                            batch_dedup=False if args.no_batch_dedup
                            else None, device=args.device)
    it = lm_batches(cfg.vocab_size, args.batch, args.seq_len)
    state = trainer.init(args.seed, next(it))
    n_params = sum(x.numel() for x in tree_leaves(state.dense))
    vocab_spec = trainer.collection["vocab"]
    print(f"dense params: {n_params/1e6:.1f}M + emb "
          f"{vocab_spec.rows * vocab_spec.dim/1e6:.1f}M")
    history = []
    t0 = time.time()
    engine = None
    if args.pipeline == "pipelined":
        engine = _make_engine(trainer, args)
        step = 0
        while step < args.steps:
            n = min(args.eval_every - step % args.eval_every,
                    args.steps - step)
            state, metrics = _pipelined_span(engine, state, it, n)
            step += n
            if step % args.eval_every == 0:
                history.append(_lm_line(step, args.batch, args.seq_len, t0,
                                        metrics))
    else:
        step_fn = _step_fn(trainer, args.pipeline)
        for step in range(args.steps):
            state, metrics = step_fn(state, next(it))
            if (step + 1) % args.eval_every == 0:
                history.append(_lm_line(step + 1, args.batch, args.seq_len,
                                        t0, metrics))
    if args.out:
        rec = {"mode": args.mode, "task": "lm", "pipeline": args.pipeline,
               "device": str(trainer.device), "history": history}
        if engine is not None:
            rec["pipeline_metrics"] = engine.pipeline_metrics()
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    return history


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--task", choices=["ctr", "lm"], default="ctr")
    ap.add_argument("--dataset", default="taobao_ad")
    ap.add_argument("--mode", choices=["sync", "hybrid", "async"],
                    default="hybrid")
    ap.add_argument("--pipeline",
                    choices=["fused", "decomposed", "pipelined"],
                    default="fused",
                    help="fused / decomposed = the serial step (one eager "
                         "computation in the port); pipelined = the staged "
                         "engine (core/pipeline.py)")
    ap.add_argument("--max-inflight", type=int, default=4,
                    help="pipelined engine: max microbatches in flight "
                         "(1 = bit-exact with --pipeline decomposed)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--seq-len", type=int, default=128,
                    help="LM task: tokens per sequence")
    ap.add_argument("--tau", type=int, default=3)
    ap.add_argument("--emb-backend", default="dense",
                    choices=["dense", "host_lru", "host_lru+disk",
                             "dense+compressed", "host_lru+compressed",
                             "host_lru+disk+compressed"],
                    help="embedding storage backend (core/backend.py): "
                         "host_lru keeps tables host-side behind a device "
                         "hot-cache; +disk stacks the mmap tier under the "
                         "host store; +compressed adds the §4.2.3 wire")
    ap.add_argument("--cache-rows", type=int, default=0,
                    help="host_lru device-cache slots per table "
                         "(0 = rows_per_field/8, at least 1024)")
    ap.add_argument("--store-dtype", default="fp32",
                    choices=["fp32", "blockscale16"],
                    help="host/disk cold-row format (core/lru.py)")
    ap.add_argument("--backward-kernel", action="store_true",
                    help="kept for the JAX launcher's command lines: every "
                         "put of the port runs the fused_backward kernel")
    ap.add_argument("--tuned-host", action="store_true",
                    help="apply the tuned host profile (launch/hostenv.py): "
                         "tcmalloc LD_PRELOAD (re-execs once; a no-op "
                         "when absent)")
    ap.add_argument("--no-batch-dedup", action="store_true",
                    help="disable worker-side batch dedup (core/dedup.py): "
                         "the occurrence-width lookup/queue/put path")
    ap.add_argument("--emb-shards", default="1",
                    help="embedding-PS shards per table: a bare int or "
                         "comma-separated table=k pairs (the sharded "
                         "router)")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--emb-lr", type=float, default=5e-2)
    ap.add_argument("--eval-every", type=int, default=25)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a GPU) or 'cpu'")
    return ap.parse_args(argv)


def main(argv=None):
    """Parse ``argv`` (the command line when None) and train; returns the
    eval history."""
    args = parse_args(argv)
    if args.tuned_host:
        from repro_torch.launch.hostenv import apply_tuned_host
        status = apply_tuned_host()      # re-execs once when tcmalloc found
        if status == "no-tcmalloc":
            print("--tuned-host: libtcmalloc not installed; "
                  "applying env-only profile")
    if args.task == "lm":
        return train_lm(args)
    return train_ctr(args)


if __name__ == "__main__":
    main()
