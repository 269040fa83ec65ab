"""The LM under a mesh (tensor parallelism over ``model``, ZeRO-3 over
``data``, by the partition rules) against the JAX package on one CPU
device.

One world of 8 gloo processes (mesh data 2 x model 4) is started once for
the file (``WORLD``) and runs every case; each test reads its part. The
reduced configs: granite-3-2b (gqa + dense FFN; 4 query heads over 2
key/value heads, so model 4 splits a key/value head over two ranks),
deepseek-v2-lite-16b (MLA + MoE), jamba-v0.1-52b (Mamba-2 + gqa + MoE),
whisper-medium (the encoder and cross-attention) and llama-3.2-vision-90b
(gated cross-attention layers, xgate opened to 0.5 in the state given to
both packages). Each rank starts from its blocks of the JAX package's own
state (``convert`` then ``local_block``):

* ``lm_loss`` and the gradients of every dense leaf (joined by
  ``from_blocks`` after the trainer's reduction) and of the activations
  against ``jax.value_and_grad`` of ``repro.models.transformer.lm_loss``;
* 2 ``PersiaTrainer(lm_adapter)`` hybrid(1) Adam steps against the JAX
  ``PersiaTrainer``: the losses, the dense leaves and the vocab table;
* prefill logits and 4 decode steps against JAX's ``prefill`` /
  ``decode_step`` (the caches sequence-sharded over ``model``);
* the MoE layer's gradients under the ``psum`` and the ``a2a`` dispatch.

A MoE under the mesh routes each data rank's tokens on their own (its
capacity from the local tokens) and averages its aux statistics over
the ranks, as the JAX package's ``shard_map`` does: for the MoE families
the JAX oracle is the JAX function on one device over each data rank's
half of the batch, averaged (the loss and gradients of the mean of the
halves' losses; prefill and decode per half).

Tolerance: rtol 1e-4 / atol 1e-5 (the allclose class of ROADMAP's ground
rules). The trained state after Adam's 2 steps: the trajectory class of
``tests/test_torch_lm_models_train.py`` (Adam's step is about lr * sign(g),
so a gradient within rounding of 0 moves its weight by up to 2 lr either
way), the losses in the allclose class.

The world also records ``launch.op_cost`` around one more train step of
reduced granite and deepseek-v2-lite on rank 0; the dry run of the same
case at mesh (2, 4) on the meta device (a subprocess) must count equal
FLOPs, collective counts and bytes and argument bytes, and HBM bytes
within 1%.
"""
import dataclasses
import json
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

from repro.configs import get_config as jget_config
from repro.core import adapters as jadapters
from repro.core import hybrid as jhybrid
from repro.models import moe as JMOE
from repro.models import transformer as JT
from repro.optim import optimizers as jopt

from repro_torch.configs import get_config
from repro_torch.models import tp as TP
from repro_torch.sharding import partition as SP
from repro_torch.utils import MeshLayout
from test_torch_cross import open_gates

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
LAYOUT = MeshLayout((2, 4), ("data", "model"))
ARCHS = ("granite_3_2b", "deepseek_v2_lite_16b", "jamba_v0_1_52b",
         "whisper_medium", "llama_3_2_vision_90b")
MOE_ARCHS = {"deepseek_v2_lite_16b", "jamba_v0_1_52b"}
COST_ARCHS = ("granite_3_2b", "deepseek_v2_lite_16b")
B, S, CACHE, STEPS = 4, 32, 48, 4
EMB_LR, DENSE_LR = 1e-2, 1e-3
RTOL, ATOL = 1e-4, 1e-5
HALVES = (slice(0, B // 2), slice(B // 2, B))


def _np(tree):
    return jax.tree.map(np.array, tree)


def _jcfg(arch):
    return jget_config(arch, reduced=True)


def _memory(cfg, rng):
    if cfg.is_encdec:
        shape = (B, cfg.encoder.n_memory_tokens, cfg.encoder.d_memory)
    elif cfg.n_memory_tokens:
        shape = (B, cfg.n_memory_tokens, cfg.d_memory)
    else:
        return None
    return (rng.standard_normal(shape) * 0.1).astype(np.float32)


def _batches(cfg, rng, n):
    out = []
    for _ in range(n):
        b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
                 np.int32),
             "targets": rng.integers(0, cfg.vocab_size, (B, S)).astype(
                 np.int32),
             "mask": np.ones((B, S), np.float32)}
        mem = _memory(cfg, rng)
        if mem is not None:
            b["memory"] = mem
        out.append(b)
    return out


def _parts(arch):
    """The batch slices the JAX oracle runs apart: the data ranks' halves
    for a MoE family, else the whole batch."""
    return HALVES if arch in MOE_ARCHS else (slice(0, B),)


def _half_loss(loss, parts):
    """``loss(dense, acts, batch)`` as the mean over ``parts`` of the
    batch (the JAX trainer's adapter for a MoE family)."""
    def fn(dense, acts, b):
        outs = [loss(dense, {k: v[p] for k, v in acts.items()},
                     {k: v[p] for k, v in b.items()}) for p in parts]
        n = len(outs)
        return (sum(o[0] for o in outs) / n,
                jax.tree.map(lambda *v: sum(v) / n, *[o[1] for o in outs]))
    return fn


def _inputs(arch) -> tuple[dict, object]:
    """(the world's inputs of one family, a function that computes the
    JAX oracles: run while the world runs)."""
    cfg = _jcfg(arch)
    rng = np.random.default_rng(7)
    dense = open_gates(_np(JT.init_dense(cfg, jax.random.PRNGKey(1))))
    acts = (rng.standard_normal((B, S, cfg.d_model)) * 0.5).astype(
        np.float32)
    dacts = (rng.standard_normal((B, STEPS, cfg.d_model)) * 0.5).astype(
        np.float32)
    b0 = _batches(cfg, rng, 1)[0]
    inp = {"dense": dense, "acts": acts, "dacts": dacts, "batch": b0}
    parts = _parts(arch)
    jad = jadapters.lm_adapter(cfg, lr=EMB_LR)
    if arch in MOE_ARCHS:
        jad = dataclasses.replace(jad, loss=_half_loss(jad.loss, parts))
    jt = jhybrid.PersiaTrainer(jad, jhybrid.TrainMode.hybrid(1),
                               jopt.OptConfig(kind="adam", lr=DENSE_LR))
    bs = _batches(cfg, rng, 2)
    jb = lambda b: {k: jnp.asarray(v) for k, v in b.items()}  # noqa: E731
    js = jt.init(jax.random.PRNGKey(0), jb(bs[0]), emb_shards=4)
    js = js.replace(dense=jax.tree.map(jnp.asarray, open_gates(
        _np(js.dense))))
    inp["train"] = {"dense": _np(js.dense), "emb": _np(js.emb),
                    "opt": _np(js.opt), "emb_queue": _np(js.emb_queue),
                    "step": int(js.step), "batches": bs}

    def oracle():
        jd = jax.tree.map(jnp.asarray, dense)
        mem = b0.get("memory")

        @jax.jit
        def loss(d, a):
            ls = [JT.lm_loss(cfg, d, a[p], b0["targets"][p], b0["mask"][p],
                             None if mem is None else jnp.asarray(mem[p]))[0]
                  for p in parts]
            return sum(ls) / len(ls)
        lj, (gd, ga) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))(
            jd, jnp.asarray(acts))
        ora = {"loss": float(lj), "grads": _np(gd), "agrad": np.asarray(ga)}
        prefill = jax.jit(lambda a, m: JT.prefill(cfg, jd, a, memory=m,
                                                  max_len=CACHE))
        decode = jax.jit(lambda a, c: JT.decode_step(cfg, jd, a, c))
        pre, dec = [], []
        for p in parts:
            lg, c = prefill(jnp.asarray(acts[p]),
                            None if mem is None else jnp.asarray(mem[p]))
            pre.append(np.asarray(lg))
            steps = []
            for t in range(STEPS):
                lg, c = decode(jnp.asarray(dacts[p, t:t + 1]), c)
                steps.append(np.asarray(lg))
            dec.append(np.stack(steps))
        ora["prefill"] = np.concatenate(pre)
        ora["decode"] = np.concatenate(dec, axis=1)
        st, start, losses = js, _np(js.dense), []
        for b in bs:
            st, m = jt.step(st, jb(b))
            losses.append(float(m["loss"]))
        ora["train"] = {"losses": losses, "dense": _np(st.dense),
                        "start": start, "table": np.asarray(
                            st.emb["vocab"]["table"])}
        return ora
    return inp, oracle


def _moe_inputs() -> tuple[dict, object]:
    """deepseek-v2-lite's reduced MoE layer (4 experts, top 2, a shared
    expert) at capacity factor 8 (no token dropped): the layer's
    parameters and input, a cotangent, and JAX's gradients of
    sum(out * w) summed over the data ranks' halves."""
    cfg = _jcfg("deepseek_v2_lite_16b")
    p = JMOE.moe_init(jax.random.PRNGKey(3), cfg)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    w = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)

    def oracle():
        gp, gx = None, []
        for h in HALVES:
            def f(p_, x_):
                return jnp.sum(JMOE.moe_forward(p_, cfg, x_, 8.0)[0]
                               * jnp.asarray(w[h]))
            a, b = jax.jit(jax.grad(f, argnums=(0, 1)))(p, jnp.asarray(x[h]))
            gp = a if gp is None else jax.tree.map(jnp.add, gp, a)
            gx.append(np.asarray(b))
        return {"p": _np(gp), "x": np.concatenate(gx)}
    return {"p": _np(p), "x": x, "w": w}, oracle


WORLD = textwrap.dedent("""
    import datetime, pickle, sys
    import numpy as np
    import torch
    import torch.distributed as dist

    rank, work = int(sys.argv[1]), sys.argv[2]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{work}/rdzv",
                            rank=rank, world_size=8,
                            timeout=datetime.timedelta(seconds=120))

    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.core import adapters
    from repro_torch.core.hybrid import (PersiaTrainer, TrainMode,
                                         _mesh_dense_grads)
    from repro_torch.launch import dryrun as DR
    from repro_torch.models import moe as MOE
    from repro_torch.models import tp as TP
    from repro_torch.models import transformer as T
    from repro_torch.optim.optimizers import OptConfig
    from repro_torch.sharding import partition as SP
    from repro_torch.utils import (Mesh, collective_counts,
                                   reset_collective_counts, set_mesh)

    with open(f"{work}/inputs.pkl", "rb") as f:
        inp = pickle.load(f)
    mesh = Mesh((2, 4), ("data", "model"), "cpu")
    bat = lambda a: SP.local_block(mesh, SP.P(SP.BATCH), torch.as_tensor(
        np.asarray(a))).clone()
    leaves = lambda specs, tree: (lambda out: (SP._zip_map(
        lambda s, x: out.append(x), specs, tree), out)[1])([])
    host = lambda xs: [x.detach().numpy() for x in xs]
    out = {}

    def zero2(cfg, tr, s, g0, st):
        # the stage-3 state saved and restored at ZeRO stage 2; the same
        # 2 steps at stage 2 from the JAX state, their collectives counted
        # beside stage 3's
        rec = {}
        tr.save(f"{work}/lm_ck", s)
        rec["saved"] = convert.state_to_numpy(tr.global_state(s))
        with SP.zero_stage(2):
            t2 = PersiaTrainer(adapters.lm_adapter(cfg, lr=%(emb_lr)r),
                               TrainMode.hybrid(1),
                               OptConfig(kind="adam", lr=%(dense_lr)r),
                               device="cpu")
            rec["restored_z2"] = convert.state_to_numpy(t2.global_state(
                t2.restore(f"{work}/lm_ck")))
        calls = {}
        for stage in (2, 3):
            with SP.zero_stage(stage):
                t = PersiaTrainer(adapters.lm_adapter(cfg, lr=%(emb_lr)r),
                                  TrainMode.hybrid(1),
                                  OptConfig(kind="adam", lr=%(dense_lr)r),
                                  device="cpu")
                sz = t.local_state(g0)
                losses = []
                for i, b in enumerate(st["batches"]):
                    reset_collective_counts()
                    sz, m = t.step(sz, {k: bat(v).numpy()
                                        for k, v in b.items()})
                    losses.append(float(m["loss"]))
                    if i == 0:
                        calls[stage] = collective_counts()
                if stage == 2:
                    rec["z2"] = {
                        "losses": losses,
                        "dense": convert.state_to_numpy(
                            t.global_state(sz))["dense"],
                        "dense_bytes": sum(x.numel() * 4 for x in leaves(
                            t.dense_specs(), sz.dense)),
                        "moment_bytes": sum(x.numel() * 4 for x in leaves(
                            t.moment_specs(), sz.opt["m"]))}
        rec["z2"]["collectives"] = calls
        return rec
    for arch in inp["archs"]:
        d, cfg = inp[arch], get_config(arch, reduced=True)
        specs = TP.dense_specs(cfg, mesh)
        full = convert.lm_dense_from_numpy(d["dense"], cfg, device="cpu")
        blk = SP._zip_map(lambda s, x: SP.local_block(mesh, s, x).clone()
                          .requires_grad_(True), specs, full)
        b0 = d["batch"]
        mem = b0.get("memory")
        rec = {}
        with set_mesh(mesh):
            a = bat(d["acts"]).requires_grad_(True)
            loss, _ = T.lm_loss(cfg, blk, a, bat(b0["targets"]),
                                bat(b0["mask"]),
                                None if mem is None else bat(mem))
            g = torch.autograd.grad(loss, leaves(specs, blk) + [a])
            it = iter(g[:-1])
            grads = _mesh_dense_grads(
                SP._zip_map(lambda s, x: next(it), specs, blk), specs)
            rec["loss"] = float(loss)
            rec["grads"] = host(leaves(specs, grads))
            rec["agrad"] = g[-1].numpy() / 2
            with torch.no_grad():
                lg, caches = T.prefill(cfg, blk, bat(d["acts"]),
                                       None if mem is None else bat(mem),
                                       max_len=%(cache)d)
                rec["prefill"] = lg.numpy()
                steps = []
                for t in range(d["dacts"].shape[1]):
                    lg, caches = T.decode_step(
                        cfg, blk, bat(d["dacts"][:, t:t + 1]), caches)
                    steps.append(lg.numpy())
                rec["decode"] = np.stack(steps)
            # the trainer from the JAX state, 2 hybrid(1) Adam steps
            tr = PersiaTrainer(adapters.lm_adapter(cfg, lr=%(emb_lr)r),
                               TrainMode.hybrid(1),
                               OptConfig(kind="adam", lr=%(dense_lr)r),
                               device="cpu")
            st = d["train"]
            with set_mesh(None):
                g0 = convert.state_from_numpy(
                    tr, st["dense"], st["emb"], opt=st["opt"],
                    emb_queue=st["emb_queue"], step=st["step"])
            s = tr.local_state(g0)
            rec["dense_bytes"] = sum(x.numel() * 4 for x in
                                     leaves(specs, s.dense))
            rec["moment_bytes"] = sum(x.numel() * 4 for x in
                                      leaves(specs, s.opt["m"]))
            losses = []
            for b in st["batches"]:
                s, m = tr.step(s, {k: bat(v).numpy()
                                   for k, v in b.items()})
                losses.append(float(m["loss"]))
            rec["train"] = {"losses": losses,
                            "dense": host(leaves(specs, s.dense)),
                            "table": s.emb["vocab"]["table"].numpy()}
            if arch == "granite_3_2b":
                rec.update(zero2(cfg, tr, s, g0, st))
        out[arch] = rec
    # ---- the MoE layer's backward under both dispatches -------------------
    cfg = get_config("deepseek_v2_lite_16b", reduced=True)
    spec = TP.unstacked(TP.dense_specs(cfg, mesh)["stack"])["0"]["ffn"]
    tens = lambda t: ({k: tens(v) for k, v in t.items()}
                      if isinstance(t, dict) else torch.as_tensor(t))
    p = tens(inp["moe"]["p"])
    for disp in ("psum", "a2a"):
        pb = SP._zip_map(lambda s, x: SP.local_block(mesh, s, x).clone()
                         .requires_grad_(True), spec, p)
        x = bat(inp["moe"]["x"]).requires_grad_(True)
        MOE.MOE_DISPATCH = disp
        try:
            with set_mesh(mesh):
                o, aux = MOE.moe_forward(TP.gather_params(pb, spec), cfg, x,
                                         8.0)
                g = torch.autograd.grad((o * bat(inp["moe"]["w"])).sum(),
                                        leaves(spec, pb) + [x])
                it = iter(g[:-1])
                gp = _mesh_dense_grads(
                    SP._zip_map(lambda s, _: next(it) * 2, spec, pb), spec)
        finally:
            MOE.MOE_DISPATCH = "psum"
        out["moe_" + disp] = {"p": host(leaves(spec, gp)),
                              "x": g[-1].numpy(),
                              "drop": float(aux["moe_drop_frac"])}
    # ---- op_cost around one train step, against the dry run --------------
    shape = InputShape("mesh_train", %(seq)d, %(batch)d, "training")
    for arch, stage in [(a, 3) for a in %(cost)r] + [(%(cost)r[0], 2)]:
        with SP.zero_stage(stage):
            c = DR.measure(get_config(arch, reduced=True), shape, mesh,
                           device="cpu")
        key = "cost_" + arch + ("" if stage == 3 else "_zero2")
        out[key] = {k: c[k] for k in (
            "flops_per_device", "hbm_bytes_per_device", "collectives",
            "argument_bytes_per_device", "kernels",
            "hbm_bytes_by_op")}
    dist.barrier()

    def tohost(x):
        if isinstance(x, torch.Tensor):
            return x.detach().numpy()
        if isinstance(x, dict):
            return {k: tohost(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(tohost(v) for v in x)
        return x
    with open(f"{work}/rank{rank}.pkl", "wb") as f:
        pickle.dump(tohost(out), f)
    dist.destroy_process_group()
    print("RANK_OK", rank)
""") % {"cache": CACHE, "emb_lr": EMB_LR, "dense_lr": DENSE_LR, "seq": S,
        "batch": B, "cost": COST_ARCHS}

DRY = textwrap.dedent("""
    import json, sys
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import dryrun as DR
    from repro_torch.sharding import partition as SP
    out = {}
    for arch in %(cost)r:
        row = DR.run_case(arch, "train_4k",
                          cfg=get_config(arch, reduced=True),
                          shape=InputShape("mesh_train", %(seq)d, %(batch)d,
                                           "training"),
                          mesh_shape=((2, 4), ("data", "model")),
                          verbose=False)
        out[arch] = row
    with SP.zero_stage(2):
        out[%(cost)r[0] + "_zero2"] = DR.run_case(
            %(cost)r[0], "train_4k",
            cfg=get_config(%(cost)r[0], reduced=True),
            shape=InputShape("mesh_train", %(seq)d, %(batch)d, "training"),
            mesh_shape=((2, 4), ("data", "model")), verbose=False)
    print("DRY" + json.dumps(out))
""") % {"cost": COST_ARCHS, "seq": S, "batch": B}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Runs the world and the dry run once: ``{"ranks": [...], "oracle":
    {...}, "dry": {...}}``."""
    work = tmp_path_factory.mktemp("lm_mesh")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(SRC),
                                         env.get("PYTHONPATH", "")])
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    dry = subprocess.Popen([sys.executable, "-c", DRY], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True)
    inp, oracles = {"archs": ARCHS}, {}
    for arch in ARCHS:
        inp[arch], oracles[arch] = _inputs(arch)
    inp["moe"], oracles["moe"] = _moe_inputs()
    with open(work / "inputs.pkl", "wb") as f:
        pickle.dump(inp, f)
    (work / "world.py").write_text(WORLD)
    procs = [subprocess.Popen([sys.executable, str(work / "world.py"),
                               str(r), str(work)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(8)]
    logs = []
    try:
        ora = {k: fn() for k, fn in oracles.items()}
        for p in procs + [dry]:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs + [dry]:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, log in enumerate(logs[:-1]):
        assert f"RANK_OK {r}" in log, f"rank {r}:\n{log[-4000:]}"
    line = [ln for ln in logs[-1].splitlines() if ln.startswith("DRY")]
    assert line, logs[-1][-4000:]
    ranks = []
    for r in range(8):
        with open(work / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return {"ranks": ranks, "oracle": ora, "inputs": inp,
            "dry": json.loads(line[0][3:]), "work": str(work)}


def _close(got, want, what, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


def _specs(arch):
    specs = TP.dense_specs(get_config(arch, reduced=True), LAYOUT)
    out = []
    SP._zip_map(lambda s, _: out.append(s), specs, specs)
    return out


def _join(world, fn, spec, shape):
    blocks = [torch.from_numpy(np.asarray(fn(r))) for r in world["ranks"]]
    return SP.from_blocks(LAYOUT, spec, blocks, shape).numpy()


def _batch_rows(world, fn):
    """The global batch rows from the data ranks (model rank 0 of each)."""
    return np.concatenate([fn(world["ranks"][r]) for r in (0, 4)])


def _dense_pairs(world, arch, got_fn, want_tree):
    """(spec, joined port leaf, JAX leaf) of every dense leaf, in the
    order of the spec walk (the port's trees are dicts walked in
    insertion order, JAX's leaves by sorted key: paired by path)."""
    cfg = get_config(arch, reduced=True)
    specs = TP.dense_specs(cfg, LAYOUT)
    paths = []

    def walk(s, t, path):
        if isinstance(s, SP.P):
            paths.append((path, s))
            return
        for k in s:
            walk(s[k], t, path + (k,))
    walk(specs, None, ())
    for i, (path, spec) in enumerate(paths):
        want = want_tree
        for k in path:
            want = want[k]
        want = np.asarray(want)
        got = _join(world, lambda r: got_fn(r)[i], spec, want.shape)
        yield "/".join(path), got, want


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_grads_match_jax(world, arch):
    """The mean over the data ranks of ``lm_loss`` under the mesh, every
    dense leaf's gradient (the rank's blocks after the trainer's
    reduction, joined) and the activations' gradient against
    ``jax.value_and_grad``."""
    ora = world["oracle"][arch]
    loss = np.mean([world["ranks"][r][arch]["loss"] for r in (0, 4)])
    _close(loss, ora["loss"], "loss")
    for r in range(8):         # the loss is replicated over 'model'
        assert world["ranks"][r][arch]["loss"] == \
            world["ranks"][r // 4 * 4][arch]["loss"]
    n = 0
    for path, got, want in _dense_pairs(
            world, arch, lambda r: r[arch]["grads"], ora["grads"]):
        _close(got, want, f"grad {path}")
        n += 1
    assert n == len(_specs(arch))
    _close(_batch_rows(world, lambda r: r[arch]["agrad"]), ora["agrad"],
           "activation grads")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(world, arch):
    """Prefill's last-token logits and 4 decode steps (caches of 48
    positions sequence-sharded over model, 12 a rank) against JAX's, the
    logits gathered over ``model`` on every rank."""
    ora = world["oracle"][arch]
    _close(_batch_rows(world, lambda r: r[arch]["prefill"]), ora["prefill"],
           "prefill logits")
    got = np.concatenate([world["ranks"][r][arch]["decode"] for r in (0, 4)],
                         axis=1)
    _close(got, ora["decode"], "decode logits")
    for r in range(8):
        np.testing.assert_array_equal(
            world["ranks"][r][arch]["decode"],
            world["ranks"][r // 4 * 4][arch]["decode"])


@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_matches_jax(world, arch):
    """2 hybrid(1) Adam steps of ``PersiaTrainer(lm_adapter)`` under the
    mesh from the JAX trainer's own state: each step's loss in the
    allclose class, the trained dense leaves and vocab table in the
    trajectory class; each rank holds exactly its blocks of the dense
    leaves and Adam's moments."""
    ora = world["oracle"][arch]["train"]
    rk = world["ranks"]
    _close(rk[0][arch]["train"]["losses"], ora["losses"], "losses")
    num = den = 0.0
    for path, got, want in _dense_pairs(
            world, arch, lambda r: r[arch]["train"]["dense"], ora["dense"]):
        start = np.asarray(_get(ora["start"], path))
        num += float(np.sum((got - want) ** 2))
        den += float(np.sum((want - start) ** 2))
        assert float(np.abs(got - want).max()) <= 2 * DENSE_LR * 2, path
    assert np.sqrt(num / max(den, 1e-30)) <= 1e-3
    spec = SP.emb_state_specs({"table": 0}, _vocab_spec(arch))["table"]
    table = _join(world, lambda r: r[arch]["train"]["table"], spec,
                  ora["table"].shape)
    assert float(np.abs(table - ora["table"]).max()) <= EMB_LR / 100 * 2
    # the rank's blocks: the specs' arithmetic, never a replicated copy
    full = sum(int(np.prod(np.asarray(w).shape)) * 4
               for _, _, w in _dense_pairs(world, arch,
                                           lambda r: r[arch]["train"][
                                               "dense"], ora["dense"]))
    local = 0
    for s, (_, _, w) in zip(_specs(arch), _dense_pairs(
            world, arch, lambda r: r[arch]["train"]["dense"],
            ora["dense"])):
        n = int(np.prod(w.shape)) * 4
        fit = SP._fit(s, LAYOUT, torch.empty(w.shape, device="meta"))
        for e in fit:
            n //= SP._axis_n(LAYOUT, e)
        local += n
    assert local < full
    for r in rk:
        assert r[arch]["dense_bytes"] == local == r[arch]["moment_bytes"]


def _pairs(got, want, path=""):
    """(path, port leaf, JAX leaf) over two dict trees of arrays."""
    if isinstance(want, dict):
        for k in want:
            yield from _pairs(got[k], want[k], f"{path}/{k}")
    else:
        yield path, np.asarray(got), np.asarray(want)


def _equal(got, want, what):
    for path, g, w in _pairs(got, want, what):
        if np.ndim(w) == 0:
            assert int(g) == int(w), path
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, path
        np.testing.assert_array_equal(g, w, err_msg=path)


def test_zero2_trainer_matches_jax(world):
    """granite's cut at ZeRO stage 2 (``REPRO_ZERO_STAGE=2``: the
    tensor-parallel leaves whole over ``data``, the Adam moments at the
    stage-3 blocks) takes the same 2 hybrid(1) Adam steps from the JAX
    state: the losses in the allclose class, the trained dense leaves in
    the trajectory class of the stage-3 test; a rank holds more of the
    parameters than at stage 3 and the same moments, and the first step
    all-gathers less (no per-layer gather of the tensor-parallel
    weights, one gather a leaf after the update)."""
    ora = world["oracle"]["granite_3_2b"]["train"]
    rk = world["ranks"]
    z2 = rk[0]["granite_3_2b"]["z2"]
    _close(z2["losses"], ora["losses"], "losses")
    num = den = 0.0
    for path, got, want in _pairs(z2["dense"], ora["dense"]):
        start = np.asarray(_get(ora["start"], path.strip("/")))
        num += float(np.sum((got - want) ** 2))
        den += float(np.sum((want - start) ** 2))
        assert float(np.abs(got - want).max()) <= 2 * DENSE_LR * 2, path
    assert np.sqrt(num / max(den, 1e-30)) <= 1e-3
    for r in rk:
        g = r["granite_3_2b"]
        assert g["z2"]["losses"] == z2["losses"]
        assert g["z2"]["moment_bytes"] == g["moment_bytes"]
        assert g["z2"]["dense_bytes"] > g["dense_bytes"]
        calls = g["z2"]["collectives"]
        assert calls[2]["all-gather"]["calls"] < \
            calls[3]["all-gather"]["calls"]


def test_lm_checkpoint_saved_at_stage3_restores_at_stage2_and_one_process(
        world):
    """The trained granite state saved under the mesh at ZeRO stage 3,
    restored under the mesh at stage 2 (joined by ``global_state``) and
    by one process: the dense leaves, the Adam moments, the vocab table
    and its queue equal the saved state bit for bit."""
    from repro_torch import convert
    from repro_torch.core import adapters
    from repro_torch.core.hybrid import PersiaTrainer, TrainMode
    from repro_torch.optim.optimizers import OptConfig
    g = world["ranks"][0]["granite_3_2b"]
    saved = g["saved"]
    for k in ("dense", "opt", "emb", "emb_queue"):
        _equal(g["restored_z2"][k], saved[k], k)
    tr = PersiaTrainer(adapters.lm_adapter(get_config(
        "granite_3_2b", reduced=True), lr=EMB_LR), TrainMode.hybrid(1),
        OptConfig(kind="adam", lr=DENSE_LR), device="cpu")
    one = convert.state_to_numpy(tr.restore(world["work"] + "/lm_ck"))
    for k in ("dense", "opt", "emb", "emb_queue"):
        _equal(one[k], saved[k], k)


def test_dry_run_counts_the_zero2_run(world):
    """The dry run at ZeRO stage 2 (granite's cut, mesh (2, 4), the meta
    device) against ``op_cost`` around the CPU world's stage-2 train step:
    FLOPs, collective counts and bytes, argument bytes and kernels equal,
    HBM bytes within 1%; fewer all-gathers than at stage 3."""
    got = world["ranks"][0]["cost_granite_3_2b_zero2"]
    row = world["dry"]["granite_3_2b_zero2"]
    assert row["status"] == "ok", row.get("error")
    assert row["zero_stage"] == 2
    assert got["flops_per_device"] == row["flops_per_device"]
    assert got["collectives"] == row["collectives"]
    assert got["argument_bytes_per_device"] == \
        row["argument_bytes_per_device"]
    assert got["kernels"] == row["kernels"]
    assert abs(got["hbm_bytes_per_device"] - row["hbm_bytes_per_device"]) \
        <= 0.01 * row["hbm_bytes_per_device"]
    z3 = world["ranks"][0]["cost_granite_3_2b"]["collectives"]["counts"]
    assert got["collectives"]["counts"]["all-gather"] < z3["all-gather"]


def _get(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def _vocab_spec(arch):
    from repro_torch.core.embedding_ps import EmbeddingSpec
    cfg = get_config(arch, reduced=True)
    return EmbeddingSpec(rows=cfg.vocab_size, dim=cfg.d_model, mode="model")


@pytest.mark.parametrize("disp", ["psum", "a2a"])
def test_moe_backward_matches_jax(world, disp):
    """deepseek-v2-lite's MoE layer under both dispatches at capacity
    factor 8 (no token dropped): the gradients of sum(out * w) with
    respect to every parameter (experts over ``model`` and ``data``, the
    tensor-parallel shared expert, the router) and the input, against
    JAX's summed over the data ranks' halves."""
    ora = world["oracle"]["moe"]
    rk = world["ranks"]
    assert all(r["moe_" + disp]["drop"] == 0.0 for r in rk)
    cfg = get_config("deepseek_v2_lite_16b", reduced=True)
    spec = TP.unstacked(TP.dense_specs(cfg, LAYOUT)["stack"])["0"]["ffn"]
    paths = []

    def walk(s, path):
        if isinstance(s, SP.P):
            paths.append((path, s))
            return
        for k in s:
            walk(s[k], path + (k,))
    walk(spec, ())
    for i, (path, s) in enumerate(paths):
        want = np.asarray(_get(ora["p"], "/".join(path)))
        got = _join(world, lambda r: r["moe_" + disp]["p"][i], s, want.shape)
        _close(got, want, f"{disp} grad {'/'.join(path)}")
    _close(_batch_rows(world, lambda r: r["moe_" + disp]["x"]), ora["x"],
           f"{disp} input grads")


@pytest.mark.parametrize("arch", COST_ARCHS)
def test_dry_run_counts_what_the_run_records(world, arch):
    """``launch.op_cost`` around one train step of the real (2, 4) world on
    rank 0 against the dry run of the same case on the meta device: FLOPs,
    collective counts and bytes, argument bytes equal; HBM bytes within
    1%; the kernels counted one each."""
    got = world["ranks"][0]["cost_" + arch]
    row = world["dry"][arch]
    assert row["status"] == "ok", row.get("error")
    assert got["flops_per_device"] == row["flops_per_device"]
    assert got["collectives"] == row["collectives"]
    assert got["argument_bytes_per_device"] == \
        row["argument_bytes_per_device"]
    assert got["kernels"] == row["kernels"]
    assert got["kernels"]["flash_attention_fwd"] > 0
    assert got["kernels"]["fused_backward"] > 0
    gap = {k: (v, row["hbm_bytes_by_op"].get(k)) for k, v in
           got["hbm_bytes_by_op"].items() if row["hbm_bytes_by_op"].get(k) != v}
    assert abs(got["hbm_bytes_per_device"] - row["hbm_bytes_per_device"]) \
        <= 0.01 * row["hbm_bytes_per_device"], gap
    assert got["collectives"]["counts"]["reduce-scatter"] > 0
