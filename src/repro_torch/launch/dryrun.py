"""Dry run on the production meshes (port of ``repro/launch/dryrun.py``):
every (architecture x input shape) traced as ONE rank of the mesh on the
``meta`` device, with its per-device cost, memory and roofline terms.

The JAX package lowers and compiles each case with XLA for 256 (or 512)
placeholder host devices and reads the compiled program. The port runs
its own SPMD program instead: this process plays rank 0 of the mesh in a
``torch.distributed`` world of the mesh's size on the fake backend
(``FakeStore``, backend ``"fake"``: every collective returns at once), on
tensors of the ``meta`` device, so a 2.5B-parameter model traces with no
memory. The program is the one a rank runs on the card: the trainer's
step (``PersiaTrainer.train_step`` over ``lm_adapter``, hybrid mode, Adam),
or the vocab lookup and ``transformer.prefill`` / ``decode_step``, each
under the mesh (tensor parallelism over ``model``, ZeRO over ``data`` at
``REPRO_ZERO_STAGE``: 3 by default, 2 with the tensor-parallel weights
whole over ``data`` and the per-step update's reduce-scatter and
all-gather a leaf; the sequence-sharded decode caches).
``launch.op_cost`` counts it: FLOPs, HBM bytes, collective bytes by kind,
the kernel wrappers as one kernel each. The token ids are real (the host
builds the dedup plans from them).

A row has the JAX dry run's keys, with three changes: ``trace_s`` stands
for ``lower_s`` / ``compile_s`` (nothing is compiled), XLA's
``xla_flops_static`` is gone, and ``dtype`` is recorded: fp32, the dtype
the port's LM paths run (the JAX dry run lowers bf16; the port has no
bf16 put kernel). ``argument_bytes_per_device`` is exact: the bytes of the
rank's blocks of the parameters, the optimizer state, the tables, the
queues, the batch and the caches. ``temp_bytes_per_device`` is the peak
of a live-bytes count over the tensors the traced ops make (freed with
the tensor), not a compiler's buffer assignment, and
``peak_bytes_per_device`` is the two added. The roofline divides by the
H100's rates (``H100``), not a TPU's.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite_3_2b
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] \\
      [--out f.json]
  REPRO_ZERO_STAGE=2 PYTHONPATH=src python -m repro_torch.launch.dryrun \\
      --arch granite_3_2b
"""
from __future__ import annotations

import argparse
import json
import math
import time
import traceback

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config
from repro_torch.launch import input_specs as IS
from repro_torch.launch import op_cost

DTYPE = torch.float32
META = torch.device("meta")

# The card's rates, from NVIDIA's H100 SXM5 data sheet (NVIDIA H100 80GB
# HBM3 at its 700 W power limit): fp32 outside the tensor cores (the
# port's GEMMs run with TF32 off), HBM3, and NVLink 4 (900 GB/s both ways,
# 450 GB/s each way).
H100 = {"card": "NVIDIA H100 80GB HBM3", "power_limit_w": 700.0,
        "peak_flops_fp32": 67e12, "hbm_bytes_per_s": 3.35e12,
        "nvlink_bytes_per_s": 450e9,
        "source": "NVIDIA H100 SXM5 data sheet"}
PEAK_FLOPS = H100["peak_flops_fp32"]
HBM_BW = H100["hbm_bytes_per_s"]
LINK_BW = H100["nvlink_bytes_per_s"]

# (arch, shape) pairs that are skipped, with the JAX package's rationale.
SKIPS = {
    ("whisper_medium", "long_500k"):
        "enc-dec with learned absolute decoder positions (64k table); "
        "500k-token decode is architecturally out of range for the family",
}

# dense/full-attention archs run long_500k only via the sliding-window
# variant (window 4096) -- recorded as 'variant' in the result row.
FULL_ATTN_ARCHS = {"qwen3_14b", "phi3_mini_3_8b", "deepseek_coder_33b",
                   "granite_3_2b", "llama_3_2_vision_90b",
                   "deepseek_v2_lite_16b", "deepseek_v2_236b"}


def arch_shape_plan(arch: str, shape_name: str):
    """Returns (run: bool, cfg_transform, note)."""
    if (arch, shape_name) in SKIPS:
        return False, None, SKIPS[(arch, shape_name)]
    if shape_name == "long_500k" and arch in FULL_ATTN_ARCHS:
        return True, lambda c: c.replace(sliding_window=4096), \
            "sliding-window 4096 variant"
    return True, lambda c: c, ""


# ---------------------------------------------------------------------------
# The mesh: one rank of a fake world
# ---------------------------------------------------------------------------

def fake_world(n: int) -> None:
    """A ``torch.distributed`` world of ``n`` ranks on the fake backend,
    this process rank 0 (an earlier one of another size is replaced)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == n and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)


def production_shape(multi_pod: bool):
    return ((2, 16, 16), ("pod", "data", "model")) if multi_pod else \
        ((16, 16), ("data", "model"))


def make_mesh(shape, axes):
    """Rank 0 of a fake world of the mesh's size (see :func:`fake_world`);
    a real world of that size, when one is initialised, is used as it
    is."""
    import torch.distributed as dist
    from repro_torch.utils import Mesh
    if not dist.is_initialized() or dist.get_backend() == "fake":
        fake_world(math.prod(shape))
    return Mesh(shape, axes, "cpu")


def _nb(mesh) -> int:
    return mesh.axis_size(("pod", "data"))


def _batch_specs(batch, mesh):
    """The batch over the batch axes where its rows divide over them,
    else replicated (decode's B = 1)."""
    from repro_torch.sharding.partition import BATCH, P
    nb = _nb(mesh)

    def leaf(x):
        if x.dim() and x.shape[0] % nb == 0:
            return P(BATCH, *([None] * (x.dim() - 1)))
        return P(*([None] * x.dim()))
    return {k: leaf(v) for k, v in batch.items()}


def _cache_specs_guarded(caches, cfg, mesh):
    """``cache_specs`` and the divisibility guards against this mesh."""
    from repro_torch.sharding import partition as SP
    nb = _nb(mesh)
    nm = mesh.shape.get("model", 1)

    def fix(spec, leaf):
        parts = list(spec) + [None] * (leaf.dim() - len(spec))
        for i, p in enumerate(parts):
            if p is None:
                continue
            n = nm if p == "model" else nb
            if leaf.shape[i] % n != 0:
                parts[i] = None
        return SP.P(*parts)
    return SP._zip_map(fix, SP.cache_specs(caches, cfg), caches)


def _local(mesh, specs, tree):
    """The rank's blocks of a global tree (copies)."""
    from repro_torch.sharding import partition as SP
    return SP._zip_map(lambda s, x: SP.local_block(mesh, s, x).clone(),
                       specs, tree)


def _tensor_bytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, np.ndarray):
        return int(tree.nbytes)
    if isinstance(tree, dict):
        return sum(_tensor_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tensor_bytes(v) for v in tree)
    if hasattr(tree, "__dataclass_fields__"):
        return sum(_tensor_bytes(getattr(tree, f))
                   for f in tree.__dataclass_fields__)
    return 0


def _real_batch(batch: dict, cfg, device, seed: int) -> dict:
    """Values for the meta stand-ins of a batch (a run on a real
    device): targets drawn from ``seed``, the mask all ones, memories
    normal draws; the token ids as they are."""
    gen = torch.Generator().manual_seed(seed + 1)
    out = {}
    for k, v in batch.items():
        if v.device.type != "meta":
            out[k] = v
        elif k == "targets":
            out[k] = torch.randint(0, cfg.vocab_size, v.shape,
                                   generator=gen, dtype=v.dtype)
        elif k == "mask":
            out[k] = torch.ones(v.shape, dtype=v.dtype)
        else:
            out[k] = torch.randn(v.shape, generator=gen, dtype=v.dtype)
        if k != "tokens":
            out[k] = out[k].to(device)
    return out


# ---------------------------------------------------------------------------
# Case builders: (fn, args) of one rank
# ---------------------------------------------------------------------------

def _trainer(cfg, device):
    from repro_torch.core.adapters import lm_adapter
    from repro_torch.core.hybrid import PersiaTrainer, TrainMode
    from repro_torch.optim.optimizers import OptConfig
    adapter = lm_adapter(cfg, dtype=DTYPE)
    mode = TrainMode("hybrid", cfg.emb_staleness, 0)
    meta = torch.device(device).type == "meta"
    tr = PersiaTrainer(adapter, mode, OptConfig(kind="adam", lr=3e-4),
                       device="cpu" if meta else device)
    if meta:
        tr.device = META
    return tr


def _meta_state(tr, cfg, batch, n_model: int):
    """``PersiaTrainer.init``'s state on the meta device: the rank's
    blocks of the dense leaves and the tables, a fresh Adam state and the
    queues of this rank's batch."""
    from repro_torch.core import embedding_ps as PS
    from repro_torch.core.hybrid import TrainState
    from repro_torch.models import transformer as T
    dense = tr._local_dense(T.init_dense(cfg, torch.Generator(), DTYPE,
                                         device=META))
    emb = {}
    for n, spec in tr.collection.items():
        rows = spec.padded_rows(max(n_model, PS.n_shards(spec)))
        emb[n] = {"table": torch.empty((rows, spec.dim), dtype=spec.dtype,
                                       device=META)}
        if spec.optimizer == "adagrad":
            emb[n]["acc"] = torch.empty((rows,), device=META)
    ids = tr.adapter.emb_ids(batch)
    queues = {n: tr.backends[n].queue_init(tuple(np.shape(a)), META)
              for n, a in ids.items()}
    return TrainState(dense=dense, opt=tr.opt_init(tr._moment_views(dense)),
                      emb=tr._local_emb(emb), emb_queue=queues,
                      dense_queue=None, step=0)


def build_train_case(cfg, shape, mesh, device=META, seed: int = 0):
    """``(fn, args)``: one hybrid train step of this rank (its blocks of
    the state and the batch). On the meta device the state is made
    without data; on a real device by ``PersiaTrainer.init(seed)`` and the
    batch drawn from ``seed``."""
    from repro_torch.launch.mesh import mesh_model_shards
    from repro_torch.utils import set_mesh
    n_model = mesh_model_shards(mesh)
    batch = IS.train_inputs(cfg, shape, DTYPE, seed)
    if torch.device(device).type != "meta":
        batch = _real_batch(batch, cfg, device, seed)
    batch = _local(mesh, _batch_specs(batch, mesh), batch)
    batch["tokens"] = batch["tokens"].numpy()
    tr = _trainer(cfg, device)
    with set_mesh(mesh):
        if torch.device(device).type == "meta":
            state = _meta_state(tr, cfg, batch, n_model)
        else:
            state = tr.init(seed, batch, emb_shards=n_model)
    return tr.train_step, (state, batch)


def _serve_params(cfg, mesh, device, seed: int):
    from repro_torch.core import embedding_ps as PS
    from repro_torch.launch.mesh import mesh_model_shards
    from repro_torch.models import tp as TP
    from repro_torch.models import transformer as T
    from repro_torch.sharding import partition as SP
    spec = PS.EmbeddingSpec(rows=cfg.vocab_size, dim=cfg.d_model,
                            mode="model", dtype=DTYPE)
    rows = spec.padded_rows(mesh_model_shards(mesh))
    gen = torch.Generator(device=device if torch.device(device).type ==
                          "cuda" else "cpu").manual_seed(seed)
    if torch.device(device).type == "meta":
        table = torch.empty((rows, cfg.d_model), dtype=DTYPE, device=META)
    else:
        table = torch.randn((rows, cfg.d_model), generator=gen,
                            device=gen.device).mul_(0.02).to(device)
    dense = T.init_dense(cfg, gen, DTYPE, device=device)
    params = {"emb": {"table": table}, "dense": dense}
    specs = {"emb": SP.emb_state_specs(params["emb"], spec),
             "dense": TP.dense_specs(cfg, mesh)}
    return _local(mesh, specs, params), spec


def _serve_batch(cfg, batch, mesh, device, seed):
    if torch.device(device).type != "meta":
        batch = _real_batch(batch, cfg, device, seed)
    batch = _local(mesh, _batch_specs(batch, mesh), batch)
    batch["tokens"] = batch["tokens"].to(device)
    return batch


def build_prefill_case(cfg, shape, mesh, device=META, seed: int = 0):
    """``(fn, args)``: the vocab lookup and ``transformer.prefill`` of this
    rank's batch rows."""
    from repro_torch.core import embedding_ps as PS
    from repro_torch.models import transformer as T
    params, spec = _serve_params(cfg, mesh, device, seed)
    batch = _serve_batch(cfg, IS.prefill_inputs(cfg, shape, DTYPE, seed),
                         mesh, device, seed)

    @torch.no_grad()
    def prefill_fn(params, batch):
        acts = PS.lookup(params["emb"], spec, batch["tokens"])
        return T.prefill(cfg, params["dense"], acts,
                         memory=batch.get("memory"))
    return prefill_fn, (params, batch)


def build_decode_case(cfg, shape, mesh, device=META, seed: int = 0):
    """``(fn, args)``: the vocab lookup and one ``transformer.decode_step``
    of this rank's rows against its blocks of full-length caches
    (``_cache_specs_guarded``)."""
    from repro_torch.core import embedding_ps as PS
    from repro_torch.models import transformer as T
    params, spec = _serve_params(cfg, mesh, device, seed)
    batch = _serve_batch(cfg, IS.decode_inputs(cfg, shape, seed), mesh,
                         device, seed)
    B, S = shape.global_batch, shape.seq_len
    caches = T.cache_init(cfg, B, S, DTYPE, META,
                          memory_len=IS.memory_len(cfg))
    specs = _cache_specs_guarded(caches, cfg, mesh)
    caches = _local(mesh, specs, caches)
    if torch.device(device).type != "meta":
        caches = _real_caches(caches, device)

    @torch.no_grad()
    def decode_fn(params, caches, batch):
        acts = PS.lookup(params["emb"], spec, batch["tokens"])
        return T.decode_step(cfg, params["dense"], acts, caches)
    return decode_fn, (params, caches, batch)


def _real_caches(tree, device):
    if isinstance(tree, dict):
        return {k: _real_caches(v, device) for k, v in tree.items()}
    return torch.zeros(tree.shape, dtype=tree.dtype, device=device)


BUILDERS = {"training": build_train_case, "prefill": build_prefill_case,
            "decode": build_decode_case}


def measure(cfg, shape, mesh, device=META, seed: int = 0) -> dict:
    """One rank's case of ``shape`` under ``mesh`` run once under
    ``op_cost``: the per-device stats of a row (FLOPs, HBM bytes,
    collectives, argument and temporary bytes, trace seconds). The run
    on a real device counts the same as the dry run on the meta device."""
    from repro_torch.utils import set_mesh
    t0 = time.time()
    fn, args = BUILDERS[shape.kind](cfg, shape, mesh, device, seed)
    arg_bytes = _tensor_bytes(args)
    with set_mesh(mesh):
        _, walk = op_cost.analyze(fn, *args)
    coll = {k: walk[k] for k in op_cost.COLLECTIVES}
    coll["total"] = walk["collective_total"]
    coll["counts"] = walk["counts"]
    return {"flops_per_device": float(walk["flops"]),
            "hbm_bytes_per_device": float(walk["hbm_bytes"]),
            "collectives": coll, "kernels": walk["kernels"],
            "hbm_bytes_by_op": walk["hbm_bytes_by_op"],
            "argument_bytes_per_device": arg_bytes,
            "temp_bytes_per_device": walk["temp_peak_bytes"],
            "peak_bytes_per_device": arg_bytes + walk["temp_peak_bytes"],
            "trace_s": round(time.time() - t0, 1)}


# ---------------------------------------------------------------------------
# Model FLOPs and the roofline
# ---------------------------------------------------------------------------

def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE); decode D=B tokens."""
    n_active = active_params(cfg)
    if shape.kind == "training":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch


def active_params(cfg) -> float:
    """Forward-activated parameter count (MoE: top-k + shared only)."""
    if cfg.arch_type == "recsys":
        n, dims = 0, (cfg.n_id_fields * cfg.emb_dim + cfg.n_dense_features,) \
            + tuple(cfg.mlp_dims) + (cfg.n_tasks,)
        for i in range(len(dims) - 1):
            n += dims[i] * dims[i + 1]
        return float(n)
    d = cfg.d_model
    total = cfg.vocab_size * d * 2          # embed + head
    for blk in cfg.prologue + cfg.pattern * cfg.pattern_repeats:
        if blk.mixer == "gqa" or blk.mixer == "cross_attn":
            total += d * cfg.n_heads * cfg.head_dim * 2
            total += d * cfg.n_kv_heads * cfg.head_dim * 2
        elif blk.mixer == "mla":
            r, dr = cfg.kv_lora_rank, cfg.rope_head_dim
            H, dn, dv = cfg.n_heads, cfg.head_dim, cfg.v_head_dim
            if cfg.q_lora_rank:
                total += d * cfg.q_lora_rank + cfg.q_lora_rank * H * (dn + dr)
            else:
                total += d * H * (dn + dr)
            total += d * (r + dr) + r * H * (dn + dv) + H * dv * d
        elif blk.mixer == "mamba2":
            d_inner = cfg.ssm_expand * d
            Hh = d_inner // cfg.ssm_head_dim
            total += d * (2 * d_inner + 2 * cfg.ssm_state + Hh)
            total += d_inner * d
        if blk.cross:
            total += d * cfg.n_heads * cfg.head_dim * 2
            total += d * cfg.n_kv_heads * cfg.head_dim * 2
        if blk.ffn == "dense":
            total += 3 * d * cfg.d_ff
        elif blk.ffn == "moe":
            f = cfg.moe_d_ff or cfg.d_ff
            total += 3 * d * f * (cfg.moe_top_k + cfg.n_shared_experts)
            total += d * cfg.n_experts     # router
    if cfg.is_encdec:
        total += active_params(cfg.encoder.replace(vocab_size=0))
    return float(total)


def roofline(stats: dict, cfg, shape, n_chips: int) -> dict:
    flops_dev = stats["flops_per_device"]
    t_compute = flops_dev / PEAK_FLOPS
    t_memory = stats["hbm_bytes_per_device"] / HBM_BW
    t_coll = stats["collectives"]["total"] / LINK_BW
    dominant = max((t_compute, "compute"), (t_memory, "memory"),
                   (t_coll, "collective"))[1]
    mf = model_flops(cfg, shape)
    return {"compute_s": t_compute, "memory_s": t_memory,
            "collective_s": t_coll, "dominant": dominant,
            "model_flops": mf,
            "useful_flops_frac": mf / max(flops_dev * n_chips, 1.0)}


# ---------------------------------------------------------------------------
# Runner
# ---------------------------------------------------------------------------

def run_case(arch: str, shape_name: str, *, multi_pod: bool = False,
             verbose: bool = True, cfg=None, shape=None,
             mesh_shape=None, seed: int = 0) -> dict:
    """One row. ``cfg`` / ``shape`` / ``mesh_shape`` override the arch's
    config, the named input shape and the production mesh (``mesh_shape``
    a ``(shape, axes)`` pair): a small case checked against a real run;
    ``seed`` draws the token ids. The row is at the partition rules'
    ZeRO stage (``REPRO_ZERO_STAGE``, or ``partition.zero_stage``)."""
    from repro_torch.sharding import partition as SP
    shape = INPUT_SHAPES[shape_name] if shape is None else shape
    run, transform, note = arch_shape_plan(arch, shape_name)
    mshape, axes = production_shape(multi_pod) if mesh_shape is None \
        else mesh_shape
    row = {"arch": arch, "shape": shape_name,
           "mesh": "x".join(map(str, mshape)), "note": note,
           "dtype": "float32", "zero_stage": SP.ZERO_STAGE,
           "hardware": H100}
    if not run:
        row["status"] = "skipped"
        return row
    try:
        cfg = transform(get_config(arch) if cfg is None else cfg)
        mesh = make_mesh(mshape, axes)
        stats = measure(cfg, shape, mesh, seed=seed)
        row.update(status="ok", **stats,
                   **roofline(stats, cfg, shape, math.prod(mshape)))
        if verbose:
            print(f"[{row['mesh']}] {arch} x {shape_name}: OK "
                  f"(trace {row['trace_s']:.0f}s) args "
                  f"{row['argument_bytes_per_device'] / 2**30:.2f}GiB "
                  f"temp {row['temp_bytes_per_device'] / 2**30:.2f}GiB "
                  f"dominant={row['dominant']}", flush=True)
    except Exception as e:  # noqa: BLE001 - report into the matrix
        row["status"] = "error"
        row["error"] = f"{type(e).__name__}: {e}"[:2000]
        if verbose:
            print(f"[{row['mesh']}] {arch} x {shape_name}: FAIL "
                  f"{row['error']}")
            traceback.print_exc()
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or not args.shape) \
        else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    cases = [run_case(a, s, multi_pod=mp)
             for mp in meshes for a in archs for s in shapes]
    if args.out:
        with open(args.out, "w") as f:
            json.dump(cases, f, indent=1)
        print(f"wrote {args.out}")
    ok = sum(1 for c in cases if c["status"] == "ok")
    sk = sum(1 for c in cases if c["status"] == "skipped")
    err = sum(1 for c in cases if c["status"] == "error")
    print(f"== dry-run: {ok} ok / {sk} skipped / {err} failed "
          f"of {len(cases)}")
    return 0 if err == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
