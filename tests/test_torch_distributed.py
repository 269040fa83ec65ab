"""The port's mesh paths on ``torch.distributed`` against the JAX package on
the CPU: the ports of both tests of ``tests/test_distributed.py`` and the
new paths.

One world of 8 gloo processes (a (data 2, model 4) mesh, as the JAX test
forces 8 host devices) runs every mesh check once (``WORLD``); each test
below reads its part of the world's result. The oracle is the JAX package
with no mesh, computed in this process and handed to the world; the MoE at
a binding capacity and the all-to-all dispatch are also held against
JAX's own sharded run (``JAX_SHARDED``: a subprocess with 8 forced host
devices), since the sharded psum dispatch sizes its capacity from the
local tokens and drops other pairs than one device does.

Tolerances: the PS lookups 1e-5 and puts 1e-4 (the JAX test's), the MoE
2e-5, the decode 3e-5 of the largest output, the trainers 1e-5 against
the port's single-process trainer (the JAX test's bound) and the class of
``tests/test_torch_pipeline.py`` against JAX's trainer; the first pooled
lookups bit for bit. The partition rules, ``_guard`` / ``_strip`` /
``to_placements`` and ``core/theory.py`` run without the world.

The world also runs the out-of-core tier and the wire under the mesh
(``TIERS``: host_lru with a row-sharded and a replicated cache, ``+disk``,
``dense+compressed``, ``host_lru+compressed``; hybrid(2), caches small
enough to evict) from a JAX checkpoint, against the JAX trainer with no
mesh (losses rtol 1e-5; tables, caches and stores allclose, the wire's
in the lossy class of ``tests/test_torch_train.py``; the LRU counters and
slot maps equal on every rank), and its checkpoints: saved under the mesh
and restored by JAX and by one port process bit for bit, a resume under
the mesh bit for bit, and a table whose padded rows differ between shard
counts refused.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JARCH_IDS
from repro.configs import get_config as jget_config
from repro.configs.base import ModelConfig as JModelConfig
from repro.core import adapters as jadapters
from repro.core import backend as jbackend
from repro.core import embedding_ps as JPS
from repro.core import hybrid as jhybrid
from repro.core import theory as jtheory
from repro.data import ctr as jctr
from repro.models import layers as JL
from repro.models import moe as JMOE
from repro.models import transformer as JT
from repro.optim import optimizers as jopt
from repro.sharding import partition as JSP

from repro_torch import convert
from repro_torch.configs.base import ModelConfig
from repro_torch.core import adapters, theory
from repro_torch.core import backend as BK
from repro_torch.core import embedding_ps as PS
from repro_torch.core.embedding_ps import EmbeddingSpec
from repro_torch.core.hybrid import PersiaTrainer, TrainMode
from repro_torch.data.ctr import CTRDataset
from repro_torch.launch import mesh as launch_mesh
from repro_torch.models import moe as MOE
from repro_torch.optim.optimizers import OptConfig
from repro_torch.sharding import partition as SP
from repro_torch.utils import MeshLayout
from test_torch_moe import CFG as MLA_CFG, CFG_J as MLA_CFG_J
from test_torch_train import _close_lossy

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
LAYOUT = MeshLayout((2, 4), ("data", "model"))
N_RANKS = 8

# the JAX test's PS, MoE and decode shapes
PS_MODEL = dict(rows=64, dim=16, mode="model", optimizer="sgd", lr=0.5)
PS_FULL = dict(rows=128, dim=8, mode="full", optimizer="adagrad", lr=0.3)
# above 4,294 rows the uniform shuffle wraps 2^32: ids share physical rows
# (a multiple of the 8 ranks, so one device shuffles over the same rows)
PS_SHARED = dict(rows=8376, dim=8, mode="full", optimizer="adagrad", lr=0.3)
MOE_KW = dict(name="m", d_model=32, d_ff=64, n_experts=8, moe_top_k=2,
              moe_d_ff=64, n_shared_experts=1, capacity_factor=8.0)
GQA_KW = dict(name="a", d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
              d_ff=128, vocab_size=64)
DEC_B, DEC_CAP, DEC_PRE, DEC_STEPS = 4, 32, 20, 8
# the JAX pipeline test's CTR model; 8 steps of a 32-row batch (16 a data
# rank), 64 rows a table (divides over the 8 ranks)
CTR_KW = dict(name="pm", arch_type="recsys", n_id_fields=3, ids_per_field=2,
              emb_dim=8, emb_rows=192, n_dense_features=4, mlp_dims=(16,),
              n_tasks=1)
DS_KW = dict(name="pm", n_rows=192, n_fields=3, ids_per_field=2, n_dense=4)
STEPS, BATCH, EMB_LR, DENSE_LR = 8, 32, 5e-2, 5e-3
MODES = {"sync": (jhybrid.TrainMode.sync(), TrainMode.sync()),
         "hybrid": (jhybrid.TrainMode.hybrid(2), TrainMode.hybrid(2))}
# the tiers under the mesh: (backend, cache_rows, spec fields). A batch
# reads about 22 of a table's 64 rows: 32 slots (4 a rank) are row-sharded
# over the 8 ranks, 34 do not divide them (replicated); both evict within
# 4 steps. The wire's block is the dim (whole rows of blocks).
TIERS = {"lru_sharded": ("host_lru", 32, {}),
         "lru_replicated": ("host_lru", 34, {}),
         "lru_disk": ("host_lru+disk", 32, {"host_rows": 32}),
         "dense_wire": ("dense+compressed", 0, {"wire_block": 8}),
         "lru_wire": ("host_lru+compressed", 32, {"wire_block": 8})}
# JAX steps before its checkpoint, mesh steps after it, the mesh's save
TIER_PRE, TIER_STEPS, TIER_SAVE = 2, 4, 2
PAD_ROWS = (60, 60, 60)             # pad to 64 over 8 ranks


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _batches():
    it = CTRDataset(**DS_KW).sampler(BATCH, seed=3)
    return [next(it) for _ in range(STEPS + 1)]     # the last one: eval


def _jax_trainer(mode):
    jcfg = JModelConfig(**CTR_KW)
    jds = jctr.CTRDataset(**DS_KW)
    return jhybrid.PersiaTrainer(
        jadapters.recsys_adapter(jcfg, lr=EMB_LR,
                                 field_rows=jds.field_rows()),
        MODES[mode][0], jopt.OptConfig(kind="adam", lr=DENSE_LR))


def _port_trainer(mode):
    return PersiaTrainer(
        adapters.recsys_adapter(ModelConfig(**CTR_KW), lr=EMB_LR,
                                field_rows=CTRDataset(**DS_KW).field_rows()),
        MODES[mode][1], OptConfig(kind="adam", lr=DENSE_LR), device="cpu")


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tier_trainers(tag, field_rows=None):
    """The JAX and the port trainer (hybrid(2)) over a tier's
    collection (``field_rows`` overrides the tables' rows)."""
    name, cache, kw = TIERS[tag]
    rows = field_rows or CTRDataset(**DS_KW).field_rows()
    jcfg = JModelConfig(**CTR_KW)
    jcoll = jadapters.ctr_collection(jcfg, lr=EMB_LR, field_rows=rows) \
        .with_backend(name, cache) \
        .map_specs(lambda _, sp: dataclasses.replace(sp, **kw))
    tcoll = adapters.ctr_collection(ModelConfig(**CTR_KW), lr=EMB_LR,
                                    field_rows=rows) \
        .with_backend(name, cache) \
        .map_specs(lambda _, sp: dataclasses.replace(sp, **kw))
    jt = jhybrid.PersiaTrainer(
        jadapters.recsys_adapter(jcfg, field_rows=rows, collection=jcoll),
        MODES["hybrid"][0], jopt.OptConfig(kind="adam", lr=DENSE_LR))
    tt = PersiaTrainer(
        adapters.recsys_adapter(ModelConfig(**CTR_KW), field_rows=rows,
                                collection=tcoll),
        MODES["hybrid"][1], OptConfig(kind="adam", lr=DENSE_LR),
        device="cpu")
    return jt, tt


def _counters(backends) -> dict:
    """Every host_lru table's slot map and counters."""
    out = {}
    for n, b in backends.items():
        b = jbackend.unwrap(b) if not isinstance(b, BK.EmbeddingBackend) \
            else BK.unwrap(b)
        if hasattr(b, "faults"):
            out[n] = {"counts": (b.faults, b.writebacks, b.hits, b.admits),
                      "id_for_slot": np.asarray(b._id_for_slot).copy(),
                      "store": b.store.serialize()}
    return out


def _tier_inputs(work) -> tuple[dict, object]:
    """Each tier's JAX checkpoint after TIER_PRE steps (the world starts
    from it), and a function that computes the oracles (JAX's next
    TIER_STEPS steps), run while the world runs."""
    batches, inp, runs = _batches(), {}, {}
    for tag in TIERS:
        jt, _ = _tier_trainers(tag)
        js = jt.init(jax.random.PRNGKey(0), _jnp(batches[0]))
        for b in batches[:TIER_PRE]:
            js, _ = jt.step(js, _jnp(b))
        jt.save(str(work / f"jax_{tag}"), js)
        inp[tag] = {"jax_ckpt": str(work / f"jax_{tag}")}
        runs[tag] = (jt, js)
    one = PersiaTrainer(adapters.recsys_adapter(
        ModelConfig(**CTR_KW), lr=EMB_LR, field_rows=PAD_ROWS),
        TrainMode.hybrid(2), OptConfig(kind="adam", lr=DENSE_LR),
        device="cpu")
    one.save(str(work / "pad60"), one.init(0, batches[0]))
    inp["pad"] = {"one_process_ckpt": str(work / "pad60"), "rows": PAD_ROWS}

    def oracle():
        out = {}
        for tag, (jt, js) in runs.items():
            losses = []
            for b in batches[TIER_PRE:TIER_PRE + TIER_STEPS]:
                js, m = jt.step(js, _jnp(b))
                losses.append(float(m["loss"]))
            out[tag] = {"losses": losses, "emb": _np(js.emb),
                        "dense": _np(js.dense),
                        "counters": _counters(jt.backends)}
        return out
    return inp, oracle


def _inputs() -> tuple[dict, dict]:
    """(inputs handed to the world, the no-mesh JAX oracles)."""
    inp, ora = {}, {}
    # ---- PS, both modes (the JAX test's data) ---------------------------
    for tag, kw, key, n, ids_shape, seeds in (
            ("model", PS_MODEL, 0, 4, (8, 6), (0, 1)),
            ("full", PS_FULL, 1, 8, (16, 4), (2, 3))):
        spec = JPS.EmbeddingSpec(**kw)
        st = JPS.ps_init(jax.random.PRNGKey(key), spec, n_shards=n)
        ids = np.random.default_rng(seeds[0]).integers(
            -1, kw["rows"], ids_shape).astype(np.int32)
        g = np.random.default_rng(seeds[1]).standard_normal(
            (ids.size, kw["dim"])).astype(np.float32)
        inp[f"ps_{tag}"] = {"state": _np(st), "ids": ids, "g": g}
        ora[f"ps_{tag}"] = {
            "lookup": np.asarray(JPS.lookup(st, spec, jnp.asarray(ids))),
            "put": _np(JPS.apply_put(st, spec, jnp.asarray(ids.reshape(-1)),
                                     jnp.asarray(g)))}
    # ---- full mode over shared rows: a put of unique ids, one with dups
    spec = JPS.EmbeddingSpec(**PS_SHARED)
    st = JPS.ps_init(jax.random.PRNGKey(9), spec, n_shards=8)
    rng = np.random.default_rng(9)
    pos = np.asarray(JPS.shuffle_pos(jnp.arange(8376), 8376))
    order = np.argsort(pos, kind="stable")       # ids grouped by their row
    pair = np.flatnonzero(pos[order][1:] == pos[order][:-1])[::2][:192]
    twins = np.concatenate([order[pair], order[pair + 1]])   # both ids
    ids_u = np.concatenate([twins, rng.choice(np.setdiff1d(
        np.arange(8376), twins), 128, replace=False)])
    ids_u = rng.permutation(ids_u).astype(np.int32)
    ids_d = rng.choice(ids_u, 1024).astype(np.int32)
    inp["ps_shared"] = {"state": _np(st), "spec": PS_SHARED,
                        "unique": (ids_u, rng.standard_normal(
                            (512, 8)).astype(np.float32)),
                        "dups": (ids_d, rng.standard_normal(
                            (1024, 8)).astype(np.float32))}
    ora["ps_shared"] = {
        k: _np(JPS.apply_put(st, spec, jnp.asarray(i), jnp.asarray(g),
                             assume_unique=k == "unique"))
        for k, (i, g) in ((k, inp["ps_shared"][k])
                          for k in ("unique", "dups"))}
    # ---- MoE (the JAX test's) --------------------------------------------
    cfg = JModelConfig(**MOE_KW)
    p = JMOE.moe_init(jax.random.PRNGKey(2), cfg)
    x = jax.random.normal(jax.random.PRNGKey(3), (4, 8, 32))
    inp["moe"] = {"p": _np(p), "x": np.asarray(x)}
    out, aux = JMOE.moe_forward(p, cfg, x)
    ora["moe"] = {"out": np.asarray(out), "aux": _np(aux)}
    # ---- decode: a cache filled to DEC_PRE positions, then DEC_STEPS ----
    rng = np.random.default_rng(7)
    cfg_a = JModelConfig(**GQA_KW)
    pa = JL.gqa_init(jax.random.PRNGKey(4), cfg_a, jnp.float32)
    kv = (DEC_B, DEC_CAP, cfg_a.n_kv_heads, cfg_a.head_dim)
    cache = {"k": np.zeros(kv, np.float32), "v": np.zeros(kv, np.float32),
             "len": np.full((DEC_B,), DEC_PRE, np.int32)}
    cache["k"][:, :DEC_PRE] = rng.standard_normal(
        (DEC_B, DEC_PRE) + kv[2:]).astype(np.float32)
    cache["v"][:, :DEC_PRE] = rng.standard_normal(
        (DEC_B, DEC_PRE) + kv[2:]).astype(np.float32)
    xs = (rng.standard_normal((DEC_B, DEC_STEPS, 64)) * 0.5).astype(
        np.float32)
    inp["gqa"] = {"p": _np(pa), "cache": cache, "x": xs}
    ora["gqa"] = _jax_decode(JL.gqa_decode, pa, cfg_a, cache, xs)
    pm = JL.mla_init(jax.random.PRNGKey(6), MLA_CFG_J, jnp.float32)
    r, dr = MLA_CFG.kv_lora_rank, MLA_CFG.rope_head_dim
    mc = {"ckv": np.zeros((DEC_B, DEC_CAP, r), np.float32),
          "k_rope": np.zeros((DEC_B, DEC_CAP, dr), np.float32),
          "len": np.full((DEC_B,), DEC_PRE, np.int32)}
    mc["ckv"][:, :DEC_PRE] = rng.standard_normal((DEC_B, DEC_PRE, r))
    mc["k_rope"][:, :DEC_PRE] = rng.standard_normal((DEC_B, DEC_PRE, dr))
    xm = (rng.standard_normal((DEC_B, DEC_STEPS, MLA_CFG.d_model))
          * 0.5).astype(np.float32)
    inp["mla"] = {"p": _np(pm), "cache": mc, "x": xm}
    ora["mla"] = _jax_decode(JL.mla_decode, pm, MLA_CFG_J, mc, xm)
    # ---- the trainers: one JAX-exported start a mode, STEPS steps --------
    batches = _batches()
    inp["batches"] = batches
    inp["cfg"] = {"ps_model": PS_MODEL, "ps_full": PS_FULL,
                  "moe": ModelConfig(**MOE_KW), "gqa": ModelConfig(**GQA_KW),
                  "mla": MLA_CFG, "ctr": ModelConfig(**CTR_KW),
                  "field_rows": CTRDataset(**DS_KW).field_rows(),
                  "modes": {m: t for m, (_, t) in MODES.items()},
                  "steps": STEPS, "lr": (EMB_LR, DENSE_LR),
                  "tiers": TIERS,
                  "tier_steps": (TIER_PRE, TIER_STEPS, TIER_SAVE)}
    for mode in MODES:
        jt = _jax_trainer(mode)
        js = jt.init(jax.random.PRNGKey(0), _jnp(batches[0]))
        inp[f"train_{mode}"] = {
            "dense": _np(js.dense), "emb": _np(js.emb), "opt": _np(js.opt),
            "emb_queue": _np(js.emb_queue), "step": int(js.step)}
        losses = []
        for b in batches[:STEPS]:
            js, m = jt.step(js, _jnp(b))
            losses.append(float(m["loss"]))
        ora[f"train_{mode}"] = {"dense": _np(js.dense), "emb": _np(js.emb),
                                "losses": losses}
    return inp, ora


def _jax_decode(fn, p, cfg, cache, xs):
    c = {k: jnp.asarray(v) for k, v in cache.items()}
    outs = []
    for t in range(xs.shape[1]):
        o, c = fn(p, cfg, jnp.asarray(xs[:, t:t + 1]), c)
        outs.append(np.asarray(o))
    return {"out": np.stack(outs), "cache": _np(c)}


# ---------------------------------------------------------------------------
# the world: 8 gloo processes, one mesh (data 2, model 4)
# ---------------------------------------------------------------------------

WORLD = textwrap.dedent("""
    import dataclasses, datetime, pickle, sys
    import numpy as np
    import torch
    import torch.distributed as dist

    rank, work = int(sys.argv[1]), sys.argv[2]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{work}/rdzv",
                            rank=rank, world_size=8,
                            timeout=datetime.timedelta(seconds=90))

    from repro_torch import convert
    from repro_torch.core import adapters
    from repro_torch.core import backend as BK
    from repro_torch.core import embedding_ps as PS
    from repro_torch.core.hybrid import PersiaTrainer
    from repro_torch.core.pipeline import PipelinedTrainer
    from repro_torch.launch import mesh as LM
    from repro_torch.models import layers as L
    from repro_torch.models import moe as MOE
    from repro_torch.optim.optimizers import OptConfig
    from repro_torch.sharding import partition as SP
    from repro_torch.utils import Mesh, gather_batch, set_mesh

    with open(f"{work}/inputs.pkl", "rb") as f:
        inp = pickle.load(f)
    C = inp["cfg"]
    mesh = Mesh((2, 4), ("data", "model"), "cpu")
    blk = lambda spec, a: SP.local_block(mesh, spec, torch.as_tensor(
        np.asarray(a))).clone()
    bat = lambda a: blk(SP.P(SP.BATCH), a)
    tens = lambda t: ({k: tens(v) for k, v in t.items()}
                      if isinstance(t, dict) else torch.as_tensor(t))
    out = {"coord": mesh.get_coordinate(),
           "groups": {k: dist.get_world_size(g)
                      for k, g in mesh._groups.items()}}
    for build in (LM.make_production_mesh, LM.make_host_mesh):
        try:
            build(device_type="cpu")
            out[build.__name__] = "built"
        except ValueError as e:
            out[build.__name__] = str(e)

    def trainer(mode):
        return PersiaTrainer(
            adapters.recsys_adapter(C["ctr"], lr=C["lr"][0],
                                    field_rows=C["field_rows"]),
            C["modes"][mode], OptConfig(kind="adam", lr=C["lr"][1]),
            device="cpu")

    # ---- a model-mode table on a mesh with no model axis: replicated ----
    flat8 = Mesh((8,), ("data",), "cpu")
    with set_mesh(flat8):
        spec = PS.EmbeddingSpec(**C["ps_model"])
        d = inp["ps_model"]
        st = {k: torch.tensor(v) for k, v in d["state"].items()}
        b8 = lambda a: SP.local_block(flat8, SP.P(SP.BATCH), torch.tensor(
            np.asarray(a))).clone()
        out["ps_replicated_lookup"] = PS.lookup(st, spec, b8(d["ids"]))
        PS.apply_put(st, spec, b8(d["ids"]).reshape(-1), b8(d["g"]))
        out["ps_replicated_put"] = st

    with set_mesh(mesh):
        # ---- the PS, both modes ------------------------------------------
        for tag in ("model", "full"):
            spec = PS.EmbeddingSpec(**C[f"ps_{tag}"])
            d = inp[f"ps_{tag}"]
            specs = SP.emb_state_specs(d["state"], spec)
            st = {k: blk(specs[k], v) for k, v in d["state"].items()}
            out[f"ps_{tag}_lookup"] = PS.lookup(st, spec, bat(d["ids"]))
            PS.apply_put(st, spec, bat(d["ids"]).reshape(-1), bat(d["g"]))
            out[f"ps_{tag}_put"] = st
        d = inp["ps_shared"]
        spec = PS.EmbeddingSpec(**d["spec"])
        specs = SP.emb_state_specs(d["state"], spec)
        for k in ("unique", "dups"):
            st = {kk: blk(specs[kk], v) for kk, v in d["state"].items()}
            ids, g = d[k]
            PS.apply_put(st, spec, bat(ids), bat(g),
                         assume_unique=k == "unique")
            out[f"ps_shared_{k}"] = st
        # ---- the MoE, both dispatches, capacity factors 8 and 1.25 --------
        cfg = C["moe"]
        specs = MOE._moe_param_specs(cfg)
        p = {k: ({kk: blk(specs[k][kk], vv) for kk, vv in v.items()}
                 if isinstance(v, dict) else blk(specs[k], v))
             for k, v in inp["moe"]["p"].items()}
        x = bat(inp["moe"]["x"])
        for disp in ("psum", "a2a"):
            MOE.MOE_DISPATCH = disp
            for cf in (8.0, 1.25):
                o, aux = MOE.moe_forward(p, cfg, x, capacity_factor=cf)
                out[f"moe_{disp}_{cf}"] = {"out": o, "aux": aux}
        MOE.MOE_DISPATCH = "psum"
        # ---- the sequence-sharded decode ----------------------------------
        for tag, fn in (("gqa", L.gqa_decode), ("mla", L.mla_decode)):
            d, cfg = inp[tag], C[tag]
            cspecs = SP.cache_specs(d["cache"], cfg)
            cache = {k: blk(cspecs[k], v) for k, v in d["cache"].items()}
            p, xs, outs = tens(d["p"]), bat(d["x"]), []
            for t in range(xs.shape[1]):
                o, cache = fn(p, cfg, xs[:, t:t + 1], cache)
                outs.append(o)
            out[tag] = {"out": torch.stack(outs), "cache": cache}
        # ---- the trainer, sync and hybrid(2), serial and pipelined -------
        batches = [{k: bat(v).numpy() for k, v in b.items()}
                   for b in inp["batches"]]
        for mode in C["modes"]:
            d = inp[f"train_{mode}"]
            runs = {}
            for runner in ("serial", "pipelined_1", "pipelined_deep"):
                tr = trainer(mode)
                with set_mesh(None):
                    g = convert.state_from_numpy(
                        tr, d["dense"], d["emb"], opt=d["opt"],
                        emb_queue=d["emb_queue"], step=d["step"])
                s = tr.local_state(g)
                if runner == "serial":
                    pooled, _ = tr.serve_lookup(s, batches[0])
                    s2, dev_ids, _ = tr._prepare(s, batches[0])
                    train_pooled, _ = tr.decomposed_fns()[0](s2.emb,
                                                             dev_ids)
                    runs["lookup"] = {"serve": pooled,
                                      "train": train_pooled}
                    runs["eval"] = {
                        "metrics": tr.eval(s, batches[-1]),
                        "preds": gather_batch(tr.predict(s, batches[-1]))}
                    s, ms = tr.run(s, batches[:C["steps"]])
                else:
                    eng = PipelinedTrainer(
                        tr, max_inflight=1 if runner == "pipelined_1"
                        else 3)
                    s, ms = eng.run(s, batches[:C["steps"]])
                    runs[runner + "_order"] = list(eng.applied_order)
                runs[runner] = {"losses": [float(m["loss"]) for m in ms],
                                "emb": s.emb, "dense": s.dense,
                                "emb_grad_norm": [float(m["emb_grad_norm"])
                                                  for m in ms]}
            out[f"train_{mode}"] = runs
        # ---- the tiers and the wire under the mesh, from JAX checkpoints -
        P0, T, SAVE = C["tier_steps"]

        def tier_trainer(tag, rows=None):
            name, cache, kw = C["tiers"][tag]
            coll = adapters.ctr_collection(
                C["ctr"], lr=C["lr"][0],
                field_rows=rows or C["field_rows"]).with_backend(
                name, cache).map_specs(
                lambda _, sp: dataclasses.replace(sp, **kw))
            return PersiaTrainer(
                adapters.recsys_adapter(C["ctr"], field_rows=rows or
                                        C["field_rows"], collection=coll),
                C["modes"]["hybrid"], OptConfig(kind="adam", lr=C["lr"][1]),
                device="cpu")

        def glob(tr, s):
            g = tr.global_state(s)
            return {"emb": g.emb, "queue": g.emb_queue, "dense": g.dense}

        def counters(tr):
            return {n: {"counts": (b.faults, b.writebacks, b.hits, b.admits),
                        "id_for_slot": b._id_for_slot.copy(),
                        "store": b.store.serialize()}
                    for n, b in ((n, BK.unwrap(b))
                                 for n, b in tr.backends.items())
                    if hasattr(b, "faults")}
        for tag in C["tiers"]:
            tr = tier_trainer(tag)
            s = tr.restore(inp["tiers"][tag]["jax_ckpt"])
            rec = {"restored": glob(tr, s), "losses": []}
            for i, b in enumerate(batches[P0:P0 + T]):
                s, m = tr.step(s, b)
                rec["losses"].append(float(m["loss"]))
                if i + 1 == SAVE:
                    tr.save(f"{work}/mesh_{tag}", s)
                    rec["ckpt"] = f"{work}/mesh_{tag}"
                    rec["saved"] = glob(tr, s)
            rec.update(glob(tr, s), counters=counters(tr),
                       local_rows={n: int(e["table"].shape[0])
                                   for n, e in s.emb.items()})
            tr2 = tier_trainer(tag)
            s2 = tr2.restore(rec["ckpt"])
            for b in batches[P0 + SAVE:P0 + T]:
                s2, _ = tr2.step(s2, b)
            rec["resumed"] = glob(tr2, s2)
            rec["resumed_counters"] = counters(tr2)
            out["tier_" + tag] = rec
        # ---- padded rows: 60-row tables pad to 64 over the 8 ranks --------
        pad = inp["tiers"]["pad"]
        tr = PersiaTrainer(adapters.recsys_adapter(
            C["ctr"], lr=C["lr"][0], field_rows=pad["rows"]),
            C["modes"]["hybrid"], OptConfig(kind="adam", lr=C["lr"][1]),
            device="cpu")
        s = tr.init(seed=0, batch_example=batches[0])
        tr.save(f"{work}/pad64", s)
        out["pad"] = {"ckpt": f"{work}/pad64", "saved": glob(tr, s)}
        try:
            tr.restore(pad["one_process_ckpt"])
            out["pad"]["refused"] = None
        except ValueError as e:
            out["pad"]["refused"] = str(e)
    dist.barrier()

    def host(x):
        if isinstance(x, torch.Tensor):
            return x.detach().numpy()
        if isinstance(x, dict):
            return {k: host(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(host(v) for v in x)
        return x
    with open(f"{work}/rank{rank}.pkl", "wb") as f:
        pickle.dump(host(out), f)
    dist.destroy_process_group()
    print("RANK_OK", rank)
""")

JAX_SHARDED = textwrap.dedent("""
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, numpy as np
    from repro.configs.base import ModelConfig
    import repro.models.moe as MOE

    from repro.core import embedding_ps as PS
    work, kw = sys.argv[1], eval(sys.argv[2])
    with open(f"{work}/inputs.pkl", "rb") as f:
        everything = pickle.load(f)
    inp = everything["moe"]
    mesh = jax.make_mesh((2, 4), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    cfg = ModelConfig(**kw)
    out = {}
    d = everything["ps_shared"]
    spec = PS.EmbeddingSpec(**d["spec"])
    for k in ("unique", "dups"):
        with jax.sharding.set_mesh(mesh):
            st = jax.jit(lambda s, i, g: PS.apply_put(
                s, spec, i, g, assume_unique=k == "unique"))(
                d["state"], *d[k])
        out[f"ps_shared_{k}"] = {kk: np.asarray(v) for kk, v in st.items()}
    for disp in ("psum", "a2a"):
        MOE.MOE_DISPATCH = disp
        for cf in (8.0, 1.25):
            with jax.sharding.set_mesh(mesh):
                o, aux = jax.jit(lambda p, x: MOE.moe_forward(
                    p, cfg, x, capacity_factor=cf))(inp["p"], inp["x"])
            out[f"moe_{disp}_{cf}"] = {
                "out": np.asarray(o),
                "aux": {k: np.asarray(v) for k, v in aux.items()}}
    with open(f"{work}/jax_sharded.pkl", "wb") as f:
        pickle.dump(out, f)
    print("JAX_OK")
""")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Runs the world and JAX's sharded MoE once for the module: ``{rank:
    result}``, the JAX oracles, JAX's sharded MoE and the port's no-mesh
    runs."""
    work = tmp_path_factory.mktemp("mesh_world")
    inp, ora = _inputs()
    inp["tiers"], tier_oracle = _tier_inputs(work)
    with open(work / "inputs.pkl", "wb") as f:
        pickle.dump(inp, f)
    (work / "world.py").write_text(WORLD)
    (work / "jax_sharded.py").write_text(JAX_SHARDED)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(SRC),
                                         env.get("PYTHONPATH", "")])
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen([sys.executable, str(work / "world.py"),
                               str(r), str(work)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(N_RANKS)]
    jproc = subprocess.Popen(
        [sys.executable, str(work / "jax_sharded.py"), str(work),
         repr(MOE_KW)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    port = _port_runs(inp)
    ora["tiers"] = tier_oracle()
    logs = []
    try:
        for p in procs + [jproc]:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs + [jproc]:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, log in enumerate(logs[:-1]):
        assert f"RANK_OK {r}" in log, f"rank {r}:\n{log[-4000:]}"
    assert "JAX_OK" in logs[-1], logs[-1][-4000:]
    ranks = []
    for r in range(N_RANKS):
        with open(work / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    with open(work / "jax_sharded.pkl", "rb") as f:
        jsh = pickle.load(f)
    return {"ranks": ranks, "oracle": ora, "jax_sharded": jsh,
            "port": port, "inputs": inp}


def _port_runs(inp) -> dict:
    """The port with no mesh on the world's inputs: the MoE at both
    factors, and each trainer's STEPS steps with its first lookups."""
    out = {}
    cfg = ModelConfig(**MOE_KW)
    for cf in (8.0, 1.25):
        o, aux = MOE.moe_forward(_t(inp["moe"]["p"]),
                                 cfg, torch.tensor(inp["moe"]["x"]),
                                 capacity_factor=cf)
        out[f"moe_{cf}"] = {"out": o.numpy(),
                            "aux": {k: float(v) for k, v in aux.items()}}
    batches = inp["batches"]
    for mode in MODES:
        d = inp[f"train_{mode}"]
        tr = _port_trainer(mode)
        s = convert.state_from_numpy(tr, d["dense"], d["emb"], opt=d["opt"],
                                     emb_queue=d["emb_queue"],
                                     step=d["step"])
        pooled, _ = tr.serve_lookup(s, batches[0])
        ev = {k: float(v) for k, v in tr.eval(s, batches[-1]).items()}
        preds = tr.predict(s, batches[-1]).numpy()
        s, ms = tr.run(s, batches[:STEPS])
        out[f"train_{mode}"] = {
            "lookup": {k: v.numpy() for k, v in pooled.items()},
            "losses": [float(m["loss"]) for m in ms],
            "emb_grad_norm": [float(m["emb_grad_norm"]) for m in ms],
            "emb": {n: {k: v.numpy() for k, v in e.items()}
                    for n, e in s.emb.items()},
            "dense": jax.tree.map(lambda t: t.numpy(), s.dense),
            "eval": ev, "auc": adapters.auc(batches[-1]["labels"], preds)}
    return out


def _join(world, key_fn, spec, shape=None):
    """The global array from every rank's block (``key_fn(rank result)``)
    under ``spec``."""
    blocks = [torch.from_numpy(np.asarray(key_fn(r))) for r in
              world["ranks"]]
    return SP.from_blocks(LAYOUT, spec, blocks, shape).numpy()


def _close(got, want, atol, what, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol, err_msg=what)


# ---------------------------------------------------------------------------
# the mesh itself
# ---------------------------------------------------------------------------

def test_mesh_coordinates_groups_and_builders(world):
    """Ranks lie row-major over (data, model); every subset of the axes
    has its group; the production and host builders refuse a world of
    another size."""
    for r, res in enumerate(world["ranks"]):
        assert res["coord"] == [r // 4, r % 4]
        assert res["groups"] == {("data",): 2, ("model",): 4,
                                 ("data", "model"): 8}
        assert "256 positions" in res["make_production_mesh"]
        assert "1 positions" in res["make_host_mesh"]
    assert launch_mesh.mesh_batch_shards(LAYOUT) == 2
    assert launch_mesh.mesh_model_shards(LAYOUT) == 4
    assert launch_mesh.mesh_all_shards(LAYOUT) == 8
    assert [LAYOUT.flat_index(("data", "model"), r)
            for r in range(8)] == list(range(8))


# ---------------------------------------------------------------------------
# the embedding PS, both modes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tag", ["model", "full"])
def test_ps_lookup_and_put_match_single_device(world, tag):
    """The rank blocks of the lookup and of the table after the put, joined,
    against JAX with no mesh (the JAX test's atol 1e-5 / 1e-4)."""
    ora = world["oracle"][f"ps_{tag}"]
    spec = EmbeddingSpec(**(PS_MODEL if tag == "model" else PS_FULL))
    look = _join(world, lambda r: r[f"ps_{tag}_lookup"], SP.P(SP.BATCH))
    _close(look, ora["lookup"], 1e-5, "lookup")
    st = world["inputs"][f"ps_{tag}"]["state"]
    specs = SP.emb_state_specs(st, spec)
    for k in st:
        got = _join(world, lambda r: r[f"ps_{tag}_put"][k], specs[k])
        _close(got, ora["put"][k], 1e-4, k)
    assert not np.array_equal(ora["put"]["table"], st["table"])


def test_ps_table_replicated_on_a_mesh_without_its_axis(world):
    """A model-mode table on a (data 8) mesh is replicated: each rank looks
    up its block of the ids from its whole table, and the put gathers
    every rank's block, so every replica applies the whole put (JAX with
    no mesh: lookups 1e-5, tables 1e-4)."""
    ora = world["oracle"]["ps_model"]
    flat8 = MeshLayout((8,), ("data",))
    look = SP.from_blocks(flat8, SP.P(SP.BATCH), [
        torch.from_numpy(r["ps_replicated_lookup"])
        for r in world["ranks"]]).numpy()
    _close(look, ora["lookup"], 1e-5, "lookup")
    for r in world["ranks"]:
        _close(r["ps_replicated_put"]["table"], ora["put"]["table"], 1e-4,
               "table")


@pytest.mark.parametrize("put", ["unique", "dups"])
def test_ps_full_mode_put_over_shared_rows_matches_jax_sharded(world, put):
    """8,376 rows (the shuffle is no bijection: the put holds both ids of
    192 rows that two ids share): the mesh put against JAX's own
    sharded put, table and accumulator within 1e-5. JAX's mesh path sums
    the ids of a shared row before the accumulator sees them (its second
    dedup, on physical rows), JAX's one device adds each id's increment
    first: for a put of unique ids the two differ on the shared rows and
    agree on the others."""
    jsh = world["jax_sharded"][f"ps_shared_{put}"]
    st = world["inputs"]["ps_shared"]["state"]
    specs = SP.emb_state_specs(st, EmbeddingSpec(**PS_SHARED))
    got = {k: _join(world, lambda r: r[f"ps_shared_{put}"][k], specs[k])
           for k in st}
    for k in st:
        _close(got[k], jsh[k], 1e-5, k)
        assert not np.array_equal(got[k], st[k])
    one = world["oracle"]["ps_shared"][put]
    pos = np.asarray(JPS.shuffle_pos(jnp.arange(8376), 8376))
    shared = np.bincount(pos, minlength=8376) > 1
    _close(got["acc"][~shared], one["acc"][~shared], 1e-5, "unshared")
    if put == "unique":
        assert np.abs(got["acc"][shared] - one["acc"][shared]).max() > 1e-3


# ---------------------------------------------------------------------------
# the expert-parallel MoE
# ---------------------------------------------------------------------------

def _moe(world, key):
    out = _join(world, lambda r: r[key]["out"], SP.P(SP.BATCH))
    aux = world["ranks"][0][key]["aux"]
    for r in world["ranks"]:          # the means are every rank's
        for k, v in r[key]["aux"].items():
            assert float(v) == float(aux[k]), k
    return out, aux


@pytest.mark.parametrize("disp", ["psum", "a2a"])
def test_moe_expert_parallel_matches_local(world, disp):
    """Capacity factor 8 (nothing dropped): the output against JAX's
    local moe_forward and the port's (2e-5, the JAX test's bound), the
    balance loss within 0.05 of the global statistic, and against JAX's
    own sharded run."""
    out, aux = _moe(world, f"moe_{disp}_8.0")
    ora = world["oracle"]["moe"]
    _close(out, ora["out"], 2e-5, "out vs JAX local")
    _close(out, world["port"]["moe_8.0"]["out"], 2e-5, "out vs port local")
    assert abs(float(aux["moe_balance"])
               - float(ora["aux"]["moe_balance"])) <= 0.05
    jsh = world["jax_sharded"][f"moe_{disp}_8.0"]
    _close(out, jsh["out"], 2e-5, "out vs JAX sharded")
    for k, v in jsh["aux"].items():
        _close(float(aux[k]), v, 2e-5, k)


@pytest.mark.parametrize("disp", ["psum", "a2a"])
def test_moe_at_a_binding_capacity_matches_jax_sharded(world, disp):
    """Capacity factor 1.25: the sharded psum dispatch sizes capacity from
    the local tokens, so it drops other pairs than one device does; held
    against JAX's own sharded run (output, balance, z and drop share)."""
    out, aux = _moe(world, f"moe_{disp}_1.25")
    jsh = world["jax_sharded"][f"moe_{disp}_1.25"]
    _close(out, jsh["out"], 2e-5, "out vs JAX sharded")
    for k, v in jsh["aux"].items():
        _close(float(aux[k]), v, 2e-5, k)
    if disp == "psum":
        assert float(aux["moe_drop_frac"]) > 0
        local = world["port"]["moe_1.25"]["aux"]["moe_drop_frac"]
        assert float(aux["moe_drop_frac"]) != local


# ---------------------------------------------------------------------------
# the sequence-sharded decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tag", ["gqa", "mla"])
def test_decode_over_sequence_sharded_caches_matches_local(world, tag):
    """A cache filled to 20 of 32 positions (the model ranks' spans of 8:
    ranks 0-2 hold positions, rank 3's span fills during the steps), 8
    decode steps under the mesh: every step's output within 3e-5 of the
    largest (the JAX test's bound) of JAX's local decode, the joined
    cache and lengths equal to its cache."""
    ora = world["oracle"][tag]
    out = _join(world, lambda r: np.moveaxis(r[tag]["out"], 0, 1),
                SP.P(SP.BATCH))
    out = np.moveaxis(out, 1, 0)
    scale = np.abs(ora["out"]).max()
    _close(out, ora["out"], 3e-5 * scale, "decode out")
    cfg = ModelConfig(**GQA_KW) if tag == "gqa" else MLA_CFG
    cspecs = SP.cache_specs(ora["cache"], cfg)
    for k, v in ora["cache"].items():
        got = _join(world, lambda r: r[tag]["cache"][k], cspecs[k])
        _close(got, v, 1e-6, f"cache {k}")
    assert cspecs["k" if tag == "gqa" else "ckv"][1] == "model"


# ---------------------------------------------------------------------------
# the hybrid trainer under the mesh
# ---------------------------------------------------------------------------

def _train(world, mode, runner):
    res = [r[f"train_{mode}"] for r in world["ranks"]]
    for r in res[1:]:                   # losses and dense are replicated
        assert r[runner]["losses"] == res[0][runner]["losses"]
        for a, b in zip(jax.tree.leaves(r[runner]["dense"]),
                        jax.tree.leaves(res[0][runner]["dense"])):
            np.testing.assert_array_equal(a, b)
    spec = SP.P(("pod", "data", "model"), None)
    emb = {n: {k: _join(world, lambda r, n=n, k=k:
                        r[f"train_{mode}"][runner]["emb"][n][k], spec)
               for k in e}
           for n, e in res[0][runner]["emb"].items()}
    return res[0][runner], emb


@pytest.mark.parametrize("mode", list(MODES))
def test_trainer_under_mesh_matches_single_process(world, mode):
    """8 steps under the mesh (each data rank on its 16 rows, the tables
    over all 8 ranks) against the port's single-process trainer from one
    JAX-exported start: losses, emb_grad_norm, tables, accumulators and
    dense parameters within atol 1e-5 (the JAX test's bound)."""
    got, emb = _train(world, mode, "serial")
    want = world["port"][f"train_{mode}"]
    _close(got["losses"], want["losses"], 1e-5, "losses")
    _close(got["emb_grad_norm"], want["emb_grad_norm"], 1e-5, "grad norm")
    for n, e in want["emb"].items():
        for k in e:
            _close(emb[n][k], e[k], 1e-5, f"{n}.{k}")
    for a, b in zip(jax.tree.leaves(got["dense"]),
                    jax.tree.leaves(want["dense"])):
        _close(a, b, 1e-5, "dense")


@pytest.mark.parametrize("mode", list(MODES))
def test_trainer_under_mesh_matches_jax(world, mode):
    """The same run against JAX's trainer (no mesh), in the class of
    ``tests/test_torch_pipeline.py``: losses rtol 1e-5, dense rtol 1e-5 /
    atol 1e-6, tables rtol 1e-5 / atol 1e-6, accumulators rtol 1e-5 /
    atol 1e-9."""
    got, emb = _train(world, mode, "serial")
    want = world["oracle"][f"train_{mode}"]
    _close(got["losses"], want["losses"], 0, "losses", rtol=1e-5)
    for n, e in want["emb"].items():
        _close(emb[n]["table"], e["table"], 1e-6, n, rtol=1e-5)
        _close(emb[n]["acc"], e["acc"], 1e-9, n, rtol=1e-5)
    for a, b in zip(jax.tree.leaves(got["dense"]),
                    jax.tree.leaves(want["dense"])):
        _close(a, b, 1e-6, "dense", rtol=1e-5)


@pytest.mark.parametrize("mode", list(MODES))
def test_first_pooled_lookups_are_bit_exact(world, mode):
    """The first batch's pooled bags, through the serve read and the
    training lookup (the mesh lookup's unique rows pooled by the bag
    kernel's plain version), bit for bit with one process: each row is
    one rank's value plus zeros."""
    want = world["port"][f"train_{mode}"]["lookup"]
    for path in ("serve", "train"):
        for n, v in want.items():
            got = _join(world, lambda r, n=n: r[f"train_{mode}"]["lookup"]
                        [path][n], SP.P(SP.BATCH))
            np.testing.assert_array_equal(got, v, err_msg=f"{path} {n}")


@pytest.mark.parametrize("mode", list(MODES))
def test_pipelined_under_mesh_matches_serial_and_keeps_order(world, mode):
    """``PipelinedTrainer(max_inflight=1)`` under the mesh equals the
    serial trainer under it (atol 1e-5, the JAX test's), and a deep one
    (max_inflight 3) applies its puts in batch order with finite
    losses."""
    serial, emb_s = _train(world, mode, "serial")
    pipe, emb_p = _train(world, mode, "pipelined_1")
    for n in emb_s:
        for k in emb_s[n]:
            _close(emb_p[n][k], emb_s[n][k], 1e-5, f"{n}.{k}")
    for a, b in zip(jax.tree.leaves(pipe["dense"]),
                    jax.tree.leaves(serial["dense"])):
        _close(a, b, 1e-5, "dense")
    deep, _ = _train(world, mode, "pipelined_deep")
    assert np.isfinite(deep["losses"]).all() and len(deep["losses"]) == STEPS
    for r in world["ranks"]:
        assert r[f"train_{mode}"]["pipelined_deep_order"] == \
            list(range(STEPS))


@pytest.mark.parametrize("mode", list(MODES))
def test_eval_is_over_the_global_batch(world, mode):
    """``eval`` under the mesh (at the start state) gives the global
    batch's loss and mean prediction, and the predictions gathered over
    the batch axes give the global AUC, as one process does."""
    want = world["port"][f"train_{mode}"]
    for r in world["ranks"]:
        ev = r[f"train_{mode}"]["eval"]
        for k, v in want["eval"].items():
            _close(float(ev["metrics"][k]), v, 1e-6, k)
        labels = world["inputs"]["batches"][-1]["labels"]
        assert abs(adapters.auc(labels, ev["preds"]) - want["auc"]) <= 1e-6


# ---------------------------------------------------------------------------
# the out-of-core tier and the wire under the mesh; checkpoints
# ---------------------------------------------------------------------------

def _tier(world, tag):
    return world["ranks"][0]["tier_" + tag]


def _equal_trees(got, want, what):
    """Two trees of arrays (dicts, lists, tensors or arrays), bit for
    bit."""
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _equal_trees(got[k], want[k], f"{what}/{k}")
    elif isinstance(want, (list, tuple)):
        for i, (g, w) in enumerate(zip(got, want)):
            _equal_trees(g, w, f"{what}/{i}")
    elif want is None:
        assert got is None, what
    elif np.ndim(want) == 0:        # the queues' ptr / filled: host ints
        assert int(np.asarray(got)) == int(np.asarray(want)), what
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.dtype == w.dtype and g.shape == w.shape, what
        np.testing.assert_array_equal(g, w, err_msg=what)


def _jax_state_np(jt, js):
    return {"emb": {n: jbackend.unwrap(b).state_for_checkpoint(js.emb[n])
                    for n, b in jt.backends.items()},
            "queue": _np(js.emb_queue), "dense": _np(js.dense)}


@pytest.mark.parametrize("tag", list(TIERS))
def test_tier_under_mesh_matches_jax(world, tag):
    """4 hybrid(2) steps under the (2, 4) mesh from JAX's checkpoint
    against JAX's trainer with no mesh: losses rtol 1e-5; every rank's
    slot map, faults, write-backs, hits and admits equal to JAX's (the
    tier evicts); host stores and device caches allclose (tables rtol 1e-5
    / atol 1e-6, the wire's in the lossy class, accumulators atol 1e-9);
    a row-sharded cache holds its slots' block, a replicated one every
    slot."""
    ora = world["oracle"]["tiers"][tag]
    got = _tier(world, tag)
    _close(got["losses"], ora["losses"], 0, "losses", rtol=1e-5)
    name, cache, _ = TIERS[tag]
    lossy = name.endswith("+compressed")
    for r in world["ranks"]:
        rc = r["tier_" + tag]["counters"]
        assert set(rc) == set(ora["counters"])
        for n, c in ora["counters"].items():
            assert rc[n]["counts"] == c["counts"], (n, rc[n]["counts"])
            np.testing.assert_array_equal(rc[n]["id_for_slot"],
                                          c["id_for_slot"])
            for k in ("vectors", "opt_acc") if "disk" not in c["store"] \
                    else ():
                _close(rc[n]["store"][k], c["store"][k], 1e-6, k, 1e-5)
        rows = r["tier_" + tag]["local_rows"]
        want = {"lru_sharded": 4, "lru_replicated": 34, "lru_disk": 4,
                "dense_wire": 8, "lru_wire": 4}[tag]
        assert set(rows.values()) == {want}
    if name.startswith("host_lru"):
        assert all(c["counts"][1] > 0 for c in ora["counters"].values())
    for n, e in ora["emb"].items():
        if lossy:
            _close_lossy(got["emb"][n]["table"], e["table"], 1e-4, n)
        else:
            _close(got["emb"][n]["table"], e["table"], 1e-6, n, 1e-5)
        _close(got["emb"][n]["acc"], e["acc"], 1e-9, n, 1e-5)
        if "slot_ids" in e:
            np.testing.assert_array_equal(got["emb"][n]["slot_ids"],
                                          e["slot_ids"])
    for a, b in zip(jax.tree.leaves(got["dense"]),
                    jax.tree.leaves(ora["dense"])):
        _close(a, b, 1e-6, "dense", 1e-5)


@pytest.mark.parametrize("tag", list(TIERS))
def test_jax_checkpoint_restores_under_mesh(world, tag):
    """JAX's checkpoint restored under the mesh: the ranks' blocks joined
    (``global_state``) are its tables, caches, queues and dense
    parameters bit for bit."""
    jt, _ = _tier_trainers(tag)
    js = jt.restore(world["inputs"]["tiers"][tag]["jax_ckpt"])
    got = _tier(world, tag)["restored"]
    want = _jax_state_np(jt, js)
    _equal_trees({n: {k: v for k, v in e.items()}
                  for n, e in got["emb"].items()},
                 {n: e["cache"] if "cache" in e else e
                  for n, e in want["emb"].items()}, "emb")
    _equal_trees(got["queue"], want["queue"], "queue")
    _equal_trees(got["dense"], want["dense"], "dense")


@pytest.mark.parametrize("tag", list(TIERS))
def test_mesh_checkpoint_restores_in_jax_and_one_process(world, tag):
    """The checkpoint saved under the mesh (after 2 of the 4 steps),
    restored by the JAX package and by one port process: the tables,
    device caches, host tiers, queues and dense parameters equal the
    joined mesh state bit for bit, and each one's next step gives the
    mesh's next loss (JAX rtol 1e-5, the port 1e-6)."""
    got = _tier(world, tag)
    saved = got["saved"]
    nxt = _batches()[TIER_PRE + TIER_SAVE]
    jt, tt = _tier_trainers(tag)
    js = jt.restore(got["ckpt"])
    ts = tt.restore(got["ckpt"])
    want = _jax_state_np(jt, js)
    for n, e in saved["emb"].items():
        jc = want["emb"][n].get("cache", want["emb"][n])
        _equal_trees({k: jc[k] for k in e}, e, f"jax {n}")
        _equal_trees({k: v.numpy() for k, v in ts.emb[n].items()}, e,
                     f"port {n}")
    _equal_trees(want["queue"], saved["queue"], "jax queue")
    _equal_trees(convert.state_to_numpy(ts)["emb_queue"], saved["queue"],
                 "port queue")
    _equal_trees(want["dense"], saved["dense"], "jax dense")
    _equal_trees(convert.state_to_numpy(ts)["dense"], saved["dense"],
                 "port dense")
    for n in _counters(tt.backends):
        jb, tb = jbackend.unwrap(jt.backends[n]), BK.unwrap(tt.backends[n])
        assert (jb.faults, jb.writebacks, jb.hits) == \
            (tb.faults, tb.writebacks, tb.hits)
        _equal_trees(tb.store.serialize(), jb.store.serialize(), n)
    _, jm = jt.step(js, _jnp(nxt))
    _, tm = tt.step(ts, nxt)
    mesh_loss = got["losses"][TIER_SAVE]
    _close(float(jm["loss"]), mesh_loss, 0, "jax next loss", rtol=1e-5)
    _close(float(tm["loss"]), mesh_loss, 0, "port next loss", rtol=1e-6)


@pytest.mark.parametrize("tag", list(TIERS))
def test_resume_under_mesh_is_bit_exact(world, tag):
    """The mesh's checkpoint restored under the mesh by a fresh trainer
    and run the last 2 steps: tables, caches, queues, dense parameters
    and every rank's LRU counters and host stores equal the uninterrupted
    run's bit for bit."""
    got = _tier(world, tag)
    for k in ("emb", "queue", "dense"):
        _equal_trees(got["resumed"][k], got[k], k)
    for r in world["ranks"]:
        t = r["tier_" + tag]
        _equal_trees(t["resumed_counters"], t["counters"], "counters")


def test_padded_rows_between_shard_counts_are_refused(world, tmp_path):
    """60-row tables under 8 ranks are drawn and saved with 64 rows (the
    shuffle's modulus). One port process refuses that checkpoint, naming
    both sizes, and the mesh refuses one process's 60-row checkpoint.
    The JAX package restores the 64-row table into one device and reads
    other rows than the mesh wrote (its lookup takes the shuffle modulo
    60): the finding ROADMAP Queue 3 records. Its save of that state
    records no modulus, and one port process refuses it too."""
    pad = world["ranks"][0]["pad"]
    for r in world["ranks"]:
        assert r["pad"]["refused"] is not None
        assert "60" in r["pad"]["refused"] and "64" in r["pad"]["refused"]
    tt = PersiaTrainer(adapters.recsys_adapter(
        ModelConfig(**CTR_KW), lr=EMB_LR, field_rows=PAD_ROWS),
        TrainMode.hybrid(2), OptConfig(kind="adam", lr=DENSE_LR),
        device="cpu")
    with pytest.raises(ValueError, match=r"over 64 rows .* 60 ids over 60"):
        tt.restore(pad["ckpt"])
    jt = jhybrid.PersiaTrainer(jadapters.recsys_adapter(
        JModelConfig(**CTR_KW), lr=EMB_LR, field_rows=PAD_ROWS),
        jhybrid.TrainMode.hybrid(2), jopt.OptConfig(kind="adam"))
    js = jt.restore(pad["ckpt"])
    n = "field_00"
    table = np.asarray(js.emb[n]["table"])
    np.testing.assert_array_equal(table, pad["saved"]["emb"][n]["table"])
    assert table.shape[0] == 64
    ids = np.arange(60)
    spec = jt.collection[n]
    jax_rows = np.asarray(JPS.lookup(js.emb[n], spec, jnp.asarray(ids)))
    mesh_rows = table[np.asarray(JPS.shuffle_pos(jnp.asarray(ids), 64))]
    other = ~np.all(jax_rows == mesh_rows, axis=1)
    assert other.mean() > 0.5, other.mean()
    jt.save(str(tmp_path), js)
    with pytest.raises(ValueError, match=r"has 64 rows .* 60 ids over 60"):
        tt.restore(str(tmp_path))


# ---------------------------------------------------------------------------
# without the world: the partition rules, placements, theory
# ---------------------------------------------------------------------------

def _flat_port(tree, path=""):
    if isinstance(tree, SP.P):
        return {path: tuple(tree)}
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat_port(v, path + f"[{k!r}]"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flat_port(v, path + f"[{i}]"))
    return out


def _flat_jax(tree):
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {jax.tree_util.keystr(p): tuple(s) for p, s in leaves}


def _meta(shapes):
    return jax.tree.map(lambda s: torch.empty(s.shape, device="meta")
                        if hasattr(s, "shape") else s, shapes)


@pytest.mark.parametrize("stage", [3, 2])
@pytest.mark.parametrize("arch", JARCH_IDS)
def test_partition_rules_match_jax(arch, stage):
    """Every dense leaf's spec (ZeRO 3 and 2), the optimizer moments' and
    every decode cache leaf's, spec for spec against JAX's, on shapes from
    ``jax.eval_shape`` of the reduced config (no weights drawn)."""
    cfg = jget_config(arch, reduced=True)
    dense = jax.eval_shape(lambda: JT.init_dense(cfg, jax.random.PRNGKey(0)))
    want = _flat_jax(JSP.dense_param_specs(dense, stage))
    got = _flat_port(SP.dense_param_specs(_meta(dense), stage))
    assert got == want
    opt = {"m": dense, "v": dense, "t": 0}
    assert _flat_port(SP._opt_specs(_meta(opt), None)) == _flat_jax(
        JSP._opt_specs(opt, None))
    mem = 16 if (cfg.encoder is not None or any(
        b.mixer == "cross_attn" for b in cfg.pattern)) else 0
    caches = jax.eval_shape(lambda: JT.cache_init(cfg, 2, 64, jnp.float32,
                                                  memory_len=mem))
    assert _flat_port(SP.cache_specs(_meta(caches), cfg)) == _flat_jax(
        JSP.cache_specs(caches, cfg))


def test_state_queue_batch_and_table_specs_match_jax():
    """The train-state, queue, batch and table rules on a CTR trainer's
    state (hybrid(2), so queues exist) and a legacy single-table state."""
    jt = _jax_trainer("hybrid")
    batch = _batches()[0]
    js = jax.eval_shape(lambda: jt.init(jax.random.PRNGKey(0),
                                        _jnp(batch)))
    want = _flat_jax(JSP.train_state_specs(js, jt.collection))
    tstate = _meta(js)
    got = SP.train_state_specs(tstate, _port_trainer("hybrid").collection)
    flat = {}
    for f in ("dense", "opt", "emb", "emb_queue", "dense_queue", "step"):
        flat.update(_flat_port(getattr(got, f), f".{f}"))
    assert flat == want
    assert _flat_port(SP.batch_specs(_meta(batch))) == _flat_jax(
        JSP.batch_specs(batch))
    for kw in (PS_MODEL, PS_FULL):
        assert tuple(JPS.table_spec(JPS.EmbeddingSpec(**kw))) == tuple(
            PS.table_spec(EmbeddingSpec(**kw)))
    router = {"s0": {"table": 0, "acc": 0}, "s1": {"table": 0, "acc": 0}}
    assert _flat_port(SP.emb_state_specs(router, EmbeddingSpec(**PS_FULL))) \
        == _flat_jax(JSP.emb_state_specs(router, JPS.EmbeddingSpec(
            **PS_FULL)))
    q = {"s0": {"ids": 0, "grads": 0, "slots": 0, "ptr": 0, "filled": 0}}
    assert _flat_port(SP.queue_specs(q)) == _flat_jax(JSP.queue_specs(q))
    # the legacy single-table state: an LM's, async (both queues)
    cfg = jget_config("granite_3_2b", reduced=True)
    ad = jadapters.lm_adapter(cfg)
    tok = jnp.zeros((2, 8), jnp.int32)
    opt_init, _ = jopt.make_optimizer(jopt.OptConfig(kind="adam"))
    st = jax.eval_shape(lambda: jhybrid.init_train_state(
        ad, jhybrid.TrainMode.async_(2, 2), opt_init, jax.random.PRNGKey(0),
        {"tokens": tok, "targets": tok, "mask": tok})[0])
    want = _flat_jax(JSP.state_specs(st, JPS.EmbeddingSpec(
        rows=cfg.vocab_size, dim=cfg.d_model, mode="model")))
    got = _flat_port(SP.state_specs(_meta(st), EmbeddingSpec(
        rows=cfg.vocab_size, dim=cfg.d_model, mode="model")))
    assert got == want and len(got) > 20


def test_guard_strip_and_placements_on_uneven_dims_and_missing_axes():
    """``_strip`` drops axes the mesh lacks, ``_guard`` axes that do not
    divide a dim, as JAX's; ``to_placements`` maps what is left onto the
    mesh dims and ``local_block`` / ``from_blocks`` cut and join by it."""
    from torch.distributed.tensor.placement_types import Replicate, Shard

    class _JMesh:
        axis_names = LAYOUT.axis_names
        shape = LAYOUT.shape
    cases = [(SP.P(("pod", "data"), "model"), (6, 8)),
             (SP.P("data", ("data", "model")), (3, 16)),
             (SP.P(None, "model", "pod"), (2, 6, 4)),
             (SP.P(("pod", "data", "model"), None), (64, 3))]
    for spec, shape in cases:
        leaf = torch.empty(shape, device="meta")
        jspec = jax.sharding.PartitionSpec(*spec)
        assert tuple(SP._strip(spec, LAYOUT)) == tuple(
            JSP._strip(jspec, _JMesh))
        assert tuple(SP._guard(SP._strip(spec, LAYOUT), LAYOUT, leaf)) == \
            tuple(JSP._guard(JSP._strip(jspec, _JMesh), _JMesh, leaf))
    pl = SP.to_placements(LAYOUT, {"a": SP.P(("pod", "data"), "model"),
                                   "b": SP.P("model"),
                                   "c": SP.P(("data", "model"), None)},
                          {"a": torch.empty(6, 8, device="meta"),
                           "b": torch.empty(6, device="meta"),
                           "c": torch.empty(16, 2, device="meta")})
    assert pl["a"] == (Shard(0), Shard(1))
    assert pl["b"] == (Replicate(), Replicate())          # 6 % 4
    assert pl["c"] == (Shard(0), Shard(0))
    x = torch.arange(16 * 6.0).view(16, 6)
    for spec in (SP.P(("data", "model")), SP.P("model", None),
                 SP.P(None, "data"), SP.P("model", "data")):
        blocks = [SP.local_block(LAYOUT, spec, x, r) for r in range(8)]
        assert torch.equal(SP.from_blocks(LAYOUT, spec, blocks, x.shape), x)
    assert torch.equal(SP.local_block(LAYOUT, SP.P("model"), x, 6),
                       x[8:12])
    assert torch.equal(SP.local_block(LAYOUT, SP.P(("data", "model")), x,
                                      6), x[12:14])


def test_theory_matches_jax():
    rng = np.random.default_rng(0)
    for T, sigma, tau, alpha in ((100, 0.5, 3, 0.2), (10_000, 2.0, 0, 1.7)):
        got = theory.hybrid_rate_bound(T, sigma, tau, alpha, L=2.0)
        want = jtheory.hybrid_rate_bound(T, sigma, tau, alpha, L=2.0)
        assert got == pytest.approx(want, rel=0, abs=0)
        assert theory.optimal_lr(T, sigma, tau, alpha) == \
            jtheory.optimal_lr(T, sigma, tau, alpha)
    batches = [rng.integers(-1, 50, (16, 4)) for _ in range(3)]
    assert theory.estimate_alpha(batches, 50) == \
        jtheory.estimate_alpha(batches, 50)


def test_no_mesh_paths_are_unchanged_without_a_mesh():
    """With no mesh in scope the mesh helpers are the identity and the
    table is one shard."""
    from repro_torch import utils
    assert utils.get_mesh() is None and utils.batch_axes() == ()
    assert utils.n_batch_shards() == 1 and utils.flat_index("model") == 0
    x = torch.arange(6.0)
    assert utils.psum(x, ("data",)) is x
    assert utils.all_gather(x, ("data",)) is x
    assert PS.n_shards(EmbeddingSpec(**PS_FULL)) == 1
    assert utils.shard(x, "data") is x
    assert utils.from_rank0(x) is x     # no group to wait on


def _world_of_one():
    """A mesh of one rank as a world of one builds it, without a process
    group: every axis has size 1, so every collective is the identity."""
    from repro_torch.utils import Mesh
    m = object.__new__(Mesh)
    MeshLayout.__init__(m, (1, 1), ("data", "model"))
    m.rank, m.device, m.device_type, m._groups = 0, torch.device("cpu"), \
        "cpu", {}
    m._coords = m.coords(0)
    return m


@pytest.mark.parametrize("scope", ["no_mesh", "world_of_one"])
def test_no_mesh_service_and_online_loop_take_the_one_process_path(scope):
    """The case of ``test_no_mesh_paths_are_unchanged_without_a_mesh`` for
    the service and the online loop: with no mesh in scope and under a
    mesh of one rank the service runs its free flush loop (no fork, no
    turns), ``train_turn`` is the cell's lock with ``agreed = agree``, a
    failed flush counts an error and raises nothing, and
    ``launch.online._online_loop`` trains every step on the sampler's
    batches (a feedback batch wider than all the requests served) to the
    losses and state of a run with no mesh, bit for bit."""
    from repro_torch.launch import cluster, online
    from repro_torch.serving import (ServingConfig, ServingService,
                                     StateCell, TrafficModel)
    from repro_torch.utils import set_mesh
    mesh = None if scope == "no_mesh" else _world_of_one()
    reqs = [r for _, r in TrafficModel.for_dataset(
        CTRDataset(**DS_KW), n_users=300).requests(6, seed=3)]
    runs = []
    for m in (None, mesh):
        tr = PersiaTrainer(adapters.recsys_adapter(
            ModelConfig(**CTR_KW), field_rows=CTRDataset(**DS_KW)
            .field_rows()), TrainMode.sync(), OptConfig(kind="adam",
                                                        lr=DENSE_LR),
            device="cpu")
        cell = StateCell(tr.init(seed=0), 0)
        with set_mesh(m):
            svc = ServingService(tr, cell, ServingConfig(1, 0.0)).start()
            assert svc._fork is None and svc._thread.name == "serving-flush"
            preds = svc.predict_many(reqs)
            held = svc.train_turn(lambda agreed: (agreed,
                                                  cell.lock._is_owned()),
                                  agree=False)
            real = tr.serve_lookup
            tr.serve_lookup = lambda *a: 1 / 0
            with pytest.raises(ZeroDivisionError):
                svc.predict(reqs[0])
            tr.serve_lookup = real
            svc.stop()
            assert held == (False, True)
            assert svc.metrics()["serving/errors"] == 1.0
            assert svc.turn_counts() == {"ticks": 0, "flush": 0, "step": 0}
            ltr, ds = cluster.small_ctr_trainer(backend="host_lru",
                                                device="cpu")
            summary, extras = online._online_loop(
                ltr, ds, steps=3, batch=8, config=ServingConfig(max_batch=4),
                n_clients=1, requests_per_client=6, n_users=200, seed=1)
        assert summary["fallback_batches"] == 3 and summary["served"] == 6
        assert summary["feedback"]["put"] == 6
        assert extras["turns"] == {"ticks": 0, "flush": 0, "step": 0}
        runs.append((preds, extras["state"], summary))
    np.testing.assert_array_equal(runs[0][0], runs[1][0])
    _equal_trees(convert.state_to_numpy(runs[1][1]),
                 convert.state_to_numpy(runs[0][1]), "state")
    assert runs[0][2]["loss_first"] == runs[1][2]["loss_first"]
    assert runs[0][2]["loss_last"] == runs[1][2]["loss_last"]


@pytest.mark.parametrize("tier", ["router_dense", "router_lru",
                                  "host_lru_flat", "remote_lru"])
def test_no_mesh_tables_take_the_one_process_path(tier):
    """The router, remote and host_lru tables with no mesh in scope and
    under a mesh of one rank take the one-process path: a router's plan
    carries its ``ShardParts`` and no logical ids, a plan keeps its
    power-of-two width, a remote table holds its own connection, and 3
    hybrid(2) steps give the same losses, tables and LRU counters bit for
    bit."""
    from repro_torch.net import connect_remote_backends
    from repro_torch.net.ps_server import PSServer
    from repro_torch.utils import set_mesh
    base, kw = {"router_dense": ("dense", {"emb_shards": 2}),
                "router_lru": ("host_lru", {"emb_shards": 2}),
                "host_lru_flat": ("host_lru", {"batch_dedup": False}),
                "remote_lru": ("host_lru", {})}[tier]
    batches = _batches()[:3]
    runs = []
    for mesh in (None, _world_of_one()):
        coll = adapters.ctr_collection(
            ModelConfig(**CTR_KW), lr=EMB_LR,
            field_rows=CTRDataset(**DS_KW).field_rows()).with_backend(
            base, 32).map_specs(lambda _, sp: dataclasses.replace(sp, **kw))
        tr = PersiaTrainer(adapters.recsys_adapter(
            ModelConfig(**CTR_KW), field_rows=CTRDataset(**DS_KW)
            .field_rows(), collection=coll), TrainMode.hybrid(2),
            OptConfig(kind="adam", lr=DENSE_LR), device="cpu")
        servers = []
        with set_mesh(mesh):
            if tier == "remote_lru":
                servers = [PSServer(device="cpu").start() for _ in range(2)]
                connect_remote_backends(
                    tr, [("127.0.0.1", s.port) for s in servers])
                assert all(sub._lead and sub._client is not None
                           for b in tr.backends.values()
                           for sub in b.shard_backends)
            s = tr.init(seed=0, batch_example=batches[0])
            _, dev_ids, _ = tr._prepare(s, batches[0])
            plan = dev_ids["field_00"]
            if tier.startswith("router"):
                assert plan.shards is not None and plan.ids is None
            if tier == "host_lru_flat":
                assert isinstance(plan, torch.Tensor)
            else:                               # a power of two
                assert plan.dev.shape[0] & (plan.dev.shape[0] - 1) == 0
            losses = []
            for b in batches:
                s, m = tr.step(s, b)
                losses.append(float(m["loss"]))
            if tier == "remote_lru":
                tables = {n: b.state_for_checkpoint(s.emb[n])
                          for n, b in tr.backends.items()}
                for b in tr.backends.values():
                    b.close()
                for srv in servers:
                    srv.stop()
            else:
                tables = convert.state_to_numpy(s)["emb"]
        subs = {f"{n}/{k}": sub for n, b in tr.backends.items()
                for k, sub in enumerate(getattr(BK.unwrap(b),
                                                "shard_backends", None)
                                        or [BK.unwrap(b)])}
        runs.append((losses, tables, {
            n: (getattr(b, "faults", 0), getattr(b, "hits", 0),
                getattr(b, "writebacks", 0)) for n, b in subs.items()}))
    assert runs[0][0] == runs[1][0]
    _equal_trees(runs[1][1], runs[0][1], "tables")
    assert runs[0][2] == runs[1][2]
