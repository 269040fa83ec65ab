"""The port's LM training (repro_torch: data/lm, the attention backward,
lm_loss, lm_adapter, the single-table shims, the LM launcher) against the
JAX package on the CPU, from the same numpy inputs and the same JAX state.

Tolerance classes:
* bit-exact: ``lm_batches``; integer and ring logic (queue ids, ``ptr``,
  ``filled``, the step, Adam's ``t``); checkpoint copies; ``step``,
  ``decomposed_step`` and ``PipelinedTrainer(max_inflight=1)`` against each
  other (the same ops in the same order);
* the attention backward: dq, dk and dv within 2e-6 of the largest |grad|
  of the JAX side (both are fp32; the two sum their tiles in other
  orders; measured up to 7e-7);
* allclose, the transformer's class: XLA and torch reduce the matrix
  products and the softmax sums in other orders, and the port's attention
  is the flash kernel's plain version with its recompute backward where
  the JAX package runs ``_attn_naive`` under autodiff. ``lm_loss``: the
  loss rtol 1e-5, the gradients within 1e-5 of their leaf's largest
  |grad|. After 4 trainer steps: losses and ``emb_grad_norm`` rtol 1e-5
  per step; the vocab table and queued grads rtol 1e-4 atol 1e-5, the
  accumulator rtol 1e-5 atol 1e-5; dense parameters atol 1e-4 (Adam moves
  a weight whose gradient is near 0 by up to lr = 3e-3 a step whatever its
  size, so its last bits of gradient decide about 1% of that; measured up
  to 2.3e-5), Adam m rtol 1e-3 atol 1e-6, v rtol 1e-3 atol 1e-9, the
  async dense queue's gradients rtol 1e-4 atol 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import adapters as jadapters
from repro.core import hybrid as jhybrid
from repro.data.lm import lm_batches as jlm_batches
from repro.models import flash as jflash
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.optim import optimizers as jopt

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.configs.base import BlockCfg, ModelConfig
from repro_torch.core import adapters, hybrid
from repro_torch.core.collection import EmbeddingCollection
from repro_torch.core.embedding_ps import EmbeddingSpec
from repro_torch.core.hybrid import PersiaTrainer, TrainMode
from repro_torch.core.pipeline import PipelinedTrainer
from repro_torch.data.lm import lm_batches
from repro_torch.kernels import ops
from repro_torch.launch import train as launch_train
from repro_torch.models import flash
from repro_torch.models import transformer as T
from repro_torch.optim.optimizers import OptConfig, make_optimizer
from repro_torch.utils import tree_leaves, tree_map

# a narrow granite: 2 layers, d_model 64, 4/2 heads of 16, vocab 200
# (padded to 512)
NARROW = dict(pattern_repeats=2, d_model=64, n_heads=4, n_kv_heads=2,
              head_dim=16, d_ff=128, vocab_size=200)
CFG_J = jget_config("granite_3_2b", reduced=True).replace(**NARROW)
CFG = get_config("granite_3_2b", reduced=True).replace(**NARROW)
B, S, EMB_LR, DENSE_LR = 2, 24, 5e-2, 3e-3
MODES = {"sync": ((), ()), "hybrid": ((2,), (2,)), "async": ((2, 2), (2, 2))}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, rtol, atol, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


def _share(got, want, share, what=""):
    """|got - want| within ``share`` of the largest |want|."""
    got, want = np.asarray(got), np.asarray(want)
    _close(got, want, 0, share * float(np.abs(want).max()), what)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def test_lm_batches_bit_equal_with_jax():
    for seed in (0, 3):
        t, j = lm_batches(97, 3, 11, seed=seed), jlm_batches(97, 3, 11,
                                                             seed=seed)
        for _ in range(4):
            a, b = next(t), next(j)
            assert set(a) == set(b) == {"tokens", "targets", "mask"}
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])


# ---------------------------------------------------------------------------
# the attention backward
# ---------------------------------------------------------------------------

ATTN_CASES = {   # S, Hkv, G, causal, window, (q_block, k_block)
    "causal": (100, 2, 2, True, 0, (32, 16)),
    "window": (100, 2, 2, True, 24, (32, 16)),
    "non_causal": (100, 2, 2, False, 0, (32, 16)),
    "hq_eq_hkv": (100, 4, 1, True, 0, (32, 16)),
    "ragged_one_tile": (77, 2, 2, True, 0, (256, 512)),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention_backward_matches_jax_vjp(case, monkeypatch):
    """The Function's gradients against ``jax.vjp`` of the JAX package's
    flash attention (same blocks) and of ``_attn_naive``."""
    Sq, Hkv, G, causal, window, (qb, kb) = ATTN_CASES[case]
    rng = np.random.default_rng(11)
    Bt, Dh, scale = 2, 16, 0.25
    q = rng.standard_normal((Bt, Sq, Hkv, G, Dh)).astype(np.float32)
    k, v = (rng.standard_normal((Bt, Sq, Hkv, Dh)).astype(np.float32)
            for _ in range(2))
    do = rng.standard_normal((Bt, Sq, Hkv, G, Dh)).astype(np.float32)
    _, vjp_f = jax.vjp(lambda a, b, c: jflash.flash_attention(
        a, b, c, scale=scale, causal=causal, window=window, qblk=qb,
        kblk=kb), q, k, v)
    _, vjp_n = jax.vjp(lambda a, b, c: JL._attn_naive(
        a, b, c, scale=scale, causal=causal, window=window, q_offset=0),
        q, k, v)
    monkeypatch.setattr(flash, "Q_BLOCK", qb)
    monkeypatch.setattr(flash, "K_BLOCK", kb)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    o = flash.flash_attention(tq, tk, tv, scale=scale, causal=causal,
                              window=window)
    o.backward(torch.from_numpy(do))
    for want in (vjp_f(do), vjp_n(do)):
        for name, got, w in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
            _share(got.numpy(), w, 2e-6, f"{case}: d{name}")


def test_attention_backward_skips_only_masked_tiles(monkeypatch):
    """Small tiles (most of them wholly masked) give the gradients of one
    tile over the whole sequence; a ragged causal window case."""
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((1, 4, 45, 8))
                         .astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((1, 2, 45, 8))
                             .astype(np.float32)) for _ in range(2))
    do = torch.from_numpy(rng.standard_normal((1, 4, 45, 8))
                          .astype(np.float32))
    o, lse = ops.flash_attention_fwd(q, k, v, 0.3, True, 10)
    whole = flash.flash_attention_bwd(q, k, v, o, lse, do, 0.3, True, 10)
    monkeypatch.setattr(flash, "Q_BLOCK", 4)
    monkeypatch.setattr(flash, "K_BLOCK", 4)
    tiled = flash.flash_attention_bwd(q, k, v, o, lse, do, 0.3, True, 10)
    for a, b in zip(tiled, whole):
        _share(a, b, 1e-6)
    assert flash._tile_masked(0, 4, 4, 8, True, 0, 0)
    assert flash._tile_masked(20, 24, 0, 4, True, 10, 0)
    assert not flash._tile_masked(20, 24, 8, 12, True, 10, 0)


def test_serve_path_takes_the_bare_forward():
    """Under no_grad (serving) the attention is the kernel call alone: no
    autograd Function, the same output as the differentiable call."""
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.standard_normal((1, 9, 2, 2, 8))
                         .astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 9, 2, 8))
                         .astype(np.float32))
    with torch.no_grad():
        a = flash.flash_attention(q, k, k, scale=0.5)
    assert a.grad_fn is None
    b = flash.flash_attention(q.requires_grad_(), k, k, scale=0.5)
    assert type(b.grad_fn).__name__ != "NoneType"
    assert torch.equal(a, b.detach())


# ---------------------------------------------------------------------------
# lm_loss
# ---------------------------------------------------------------------------

def test_lm_loss_value_and_grads_match_jax():
    dj = JT.init_dense(CFG_J, jax.random.PRNGKey(1))
    dt = convert.lm_dense_from_numpy(_np(dj), CFG, device="cpu")
    rng = np.random.default_rng(3)
    acts = (rng.standard_normal((B, S, CFG.d_model)) * 0.5).astype(
        np.float32)
    tg = rng.integers(0, CFG.vocab_size, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) < 0.8).astype(np.float32)
    (lj, mj), (gdj, gaj) = jax.value_and_grad(
        lambda d, a: JT.lm_loss(CFG_J, d, a, tg, mask), argnums=(0, 1),
        has_aux=True)(dj, jnp.asarray(acts))
    params = tree_map(lambda x: x.requires_grad_(), dt)
    ta = torch.tensor(acts, requires_grad=True)
    lt, mt = T.lm_loss(CFG, params, ta, tg, mask)
    lt.backward()
    _close(float(lt.detach()), float(lj), 1e-5, 0, "loss")
    assert set(mt) == {"loss", "ppl_log"}
    _close(float(mt["ppl_log"].detach()), float(mj["ppl_log"]), 1e-5, 0,
           "ppl_log")
    _share(ta.grad.numpy(), gaj, 1e-5, "acts grad")
    got = {k: p.grad.numpy() for k, p in _flat(params).items()}
    want = _flat(_np(gdj))
    assert set(got) == set(want)
    for k in want:
        _share(got[k], want[k], 1e-5, k)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    return {prefix: tree}


def test_lm_loss_remat_equals_no_remat_and_masks_pads():
    """Checkpointed layers recompute the same gradients bit for bit; the
    pad columns never win the target gather and an all-zero mask gives 0."""
    dt = T.init_dense(CFG, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(4)
    acts = torch.from_numpy(rng.standard_normal((B, S, CFG.d_model))
                            .astype(np.float32))
    tg = rng.integers(0, CFG.vocab_size, (B, S))
    grads = []
    for remat in (True, False):
        p = tree_map(lambda x: x.clone().requires_grad_(), dt)
        a = acts.clone().requires_grad_()
        loss, _ = T.lm_loss(CFG.replace(remat=remat), p, a, tg,
                            np.ones((B, S), np.float32))
        loss.backward()
        grads.append([a.grad] + [x.grad for x in tree_leaves(p)])
    for x, y in zip(*grads):
        assert torch.equal(x, y)
    loss, _ = T.lm_loss(CFG, dt, acts, tg, np.zeros((B, S), np.float32))
    assert float(loss) == 0.0


def test_remat_recomputes_each_layers_attention(monkeypatch):
    """A training step calls the attention forward twice per layer with
    remat (forward and recompute) and once without; eval once."""
    calls = []
    fwd = ops.flash_attention_fwd

    def counting(*a, **kw):
        calls.append(1)
        return fwd(*a, **kw)

    monkeypatch.setattr(ops, "flash_attention_fwd", counting)
    bs = _batches(3)
    for remat, want in ((True, 2), (False, 1)):
        tt = PersiaTrainer(adapters.lm_adapter(CFG.replace(remat=remat)),
                           TrainMode.hybrid(1), OptConfig(), device="cpu")
        ts = tt.init(0, bs[0])
        calls.clear()
        ts, _ = tt.step(ts, bs[1])
        assert len(calls) == want * CFG.n_layers
    calls.clear()
    tt.eval(ts, bs[2])
    assert len(calls) == CFG.n_layers


# ---------------------------------------------------------------------------
# PersiaTrainer(lm_adapter) against JAX's, from one exported state
# ---------------------------------------------------------------------------

def _modes(name):
    j = {"sync": jhybrid.TrainMode.sync, "hybrid": jhybrid.TrainMode.hybrid,
         "async": jhybrid.TrainMode.async_}[name]
    t = {"sync": TrainMode.sync, "hybrid": TrainMode.hybrid,
         "async": TrainMode.async_}[name]
    return j(*MODES[name][0]), t(*MODES[name][1])


def _trainers(mode):
    jm, tm = _modes(mode)
    jt = jhybrid.PersiaTrainer(jadapters.lm_adapter(CFG_J, lr=EMB_LR), jm,
                               jopt.OptConfig(kind="adam", lr=DENSE_LR))
    tt = PersiaTrainer(adapters.lm_adapter(CFG, lr=EMB_LR), tm,
                       OptConfig(kind="adam", lr=DENSE_LR), device="cpu")
    return jt, tt


def _batches(n, seed=3):
    it = lm_batches(CFG.vocab_size, B, S, seed=seed)
    return [next(it) for _ in range(n)]


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _carry(tt, js):
    return convert.state_from_numpy(
        tt, _np(js.dense), _np(js.emb), opt=_np(js.opt),
        emb_queue=_np(js.emb_queue), dense_queue=_np(js.dense_queue),
        step=int(js.step))


def _check_lm_states(tstate, jstate):
    got, want = convert.state_to_numpy(tstate), _np(jstate)
    assert int(got["step"]) == int(want.step)
    assert int(got["opt"]["t"]) == int(want.opt["t"])
    for g, w in zip(jax.tree.leaves(got["dense"]),
                    jax.tree.leaves(want.dense)):
        _close(g, w, 0, 1e-4, "dense")
    for g, w in zip(jax.tree.leaves(got["opt"]["m"]),
                    jax.tree.leaves(want.opt["m"])):
        _close(g, w, 1e-3, 1e-6, "adam m")
    for g, w in zip(jax.tree.leaves(got["opt"]["v"]),
                    jax.tree.leaves(want.opt["v"])):
        _close(g, w, 1e-3, 1e-9, "adam v")
    e, ew = got["emb"]["vocab"], want.emb["vocab"]
    _close(e["table"], ew["table"], 1e-4, 1e-5, "table")
    _close(e["acc"], ew["acc"], 1e-5, 1e-5, "acc")
    gq, wq = got["emb_queue"]["vocab"], want.emb_queue["vocab"]
    assert (gq is None) == (wq is None)
    if wq is not None:
        np.testing.assert_array_equal(gq["ids"], wq["ids"])
        assert (int(gq["ptr"]), int(gq["filled"])) == \
            (int(wq["ptr"]), int(wq["filled"]))
        _close(gq["grads"], wq["grads"], 1e-4, 1e-5, "queue grads")
    gd, wd = got["dense_queue"], want.dense_queue
    assert (gd is None) == (wd is None)
    if wd is not None:
        assert (int(gd["ptr"]), int(gd["filled"])) == \
            (int(wd["ptr"]), int(wd["filled"]))
        for g, w in zip(jax.tree.leaves(gd["grads"]),
                        jax.tree.leaves(wd["grads"])):
            _close(g, w, 1e-4, 1e-6, "dense queue")


def _run(tt, ts, batches, runner):
    if runner == "pipelined_1":
        state, ms = PipelinedTrainer(tt, max_inflight=1).run(ts, batches)
        return state, ms
    fn = tt.step if runner == "step" else tt.decomposed_step
    ms = []
    for b in batches:
        ts, m = fn(ts, b)
        ms.append(m)
    return ts, ms


@pytest.mark.parametrize("mode", sorted(MODES))
def test_lm_trainer_matches_jax_from_one_state(mode):
    """4 steps by ``step``, ``decomposed_step`` and the pipelined trainer
    at max_inflight 1 against JAX's ``PersiaTrainer(lm_adapter)``; the
    three port runs equal each other bit for bit."""
    jt, tt = _trainers(mode)
    bs = _batches(5)
    js = jt.init(jax.random.PRNGKey(0), _jb(bs[0]))
    start = _carry(tt, js)
    jl, jn = [], []
    for b in bs[1:]:
        js, m = jt.step(js, _jb(b))
        jl.append(float(m["loss"]))
        jn.append(float(m["emb_grad_norm"]))
    runs = {}
    for runner in ("step", "decomposed", "pipelined_1"):
        ts, ms = _run(tt, start.to("cpu"), bs[1:], runner)
        _close([float(m["loss"]) for m in ms], jl, 1e-5, 0, "losses")
        _close([float(m["emb_grad_norm"]) for m in ms], jn, 1e-5, 0,
               "emb_grad_norm")
        _check_lm_states(ts, js)
        runs[runner] = convert.state_to_numpy(ts)
    for other in ("decomposed", "pipelined_1"):
        for a, b in zip(jax.tree.leaves(runs["step"]),
                        jax.tree.leaves(runs[other])):
            np.testing.assert_array_equal(a, b)


def test_lm_adapter_matches_jax():
    ja, ta = jadapters.lm_adapter(CFG_J, lr=0.1), adapters.lm_adapter(
        CFG, lr=0.1)
    assert ta.collection.names == ja.collection.names == ("vocab",)
    js, ts = ja.collection["vocab"], ta.collection["vocab"]
    for f in ("rows", "dim", "mode", "optimizer", "lr", "staleness"):
        assert getattr(ts, f) == getattr(js, f), f
    assert ta.pooled is False and ta.predict is None
    b = _batches(1)[0]
    np.testing.assert_array_equal(ta.emb_ids(b)["vocab"], b["tokens"])
    one = EmbeddingCollection.single("t", EmbeddingSpec(rows=4, dim=2))
    assert one.names == ("t",) and one["t"].rows == 4


def test_lm_eval_reads_occurrences_and_matches_jax():
    jt, tt = _trainers("hybrid")
    bs = _batches(2)
    js = jt.init(jax.random.PRNGKey(0), _jb(bs[0]))
    ts = _carry(tt, js)
    want = jt.eval(js, _jb(bs[1]))
    got = tt.eval(ts, bs[1])
    _close(float(got["loss"]), float(want["loss"]), 1e-5, 0, "eval loss")


def test_lm_checkpoint_jax_to_port_to_jax(tmp_path):
    """A JAX LM trainer's checkpoint restores into the port bit for bit;
    after 2 steps on both sides the port's checkpoint restores into JAX
    bit for bit (and holds JAX's own state to the trainer class)."""
    jt, tt = _trainers("hybrid")
    bs = _batches(3)
    js = jt.init(jax.random.PRNGKey(0), _jb(bs[0]))
    js, _ = jt.step(js, _jb(bs[0]))
    jt.save(str(tmp_path / "j"), js)
    ts = tt.restore(str(tmp_path / "j"))
    _same_state(ts, js)
    for b in bs[1:]:
        js, _ = jt.step(js, _jb(b))
        ts, _ = tt.step(ts, b)
    tt.save(str(tmp_path / "t"), ts)
    _same_state(ts, jt.restore(str(tmp_path / "t")))
    _check_lm_states(ts, js)


def _same_state(tstate, jstate):
    got, want = convert.state_to_numpy(tstate), _np(jstate)
    for field in ("dense", "opt", "emb", "emb_queue", "dense_queue",
                  "step"):
        a = jax.tree.leaves(got[field])
        b = jax.tree.leaves(getattr(want, field))
        assert len(a) == len(b), field
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y, err_msg=field)


# ---------------------------------------------------------------------------
# the single-table shims
# ---------------------------------------------------------------------------

def _shim_state_from_jax(jstate, spec, device="cpu"):
    """The port's dict state from a JAX shim state, through numpy."""
    n = _np(jstate)
    dense = convert.lm_dense_from_numpy(n["dense"], CFG, device)
    opt = {"m": convert.lm_dense_from_numpy(n["opt"]["m"], CFG, device),
           "v": convert.lm_dense_from_numpy(n["opt"]["v"], CFG, device),
           "t": int(n["opt"]["t"])}
    dq = n["dense_queue"]
    if dq is not None:
        dq = {"grads": tree_map(torch.tensor, dq["grads"]),
              "ptr": int(dq["ptr"]), "filled": int(dq["filled"])}
    return {"dense": dense, "opt": opt,
            "emb": convert.emb_from_numpy(n["emb"], spec, device),
            "emb_queue": convert._queue_from_numpy(n["emb_queue"], spec,
                                                   device),
            "dense_queue": dq, "step": int(n["step"])}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_single_table_shims_match_jax(mode):
    """init_train_state's shapes, then 4 steps of make_train_step (and of
    the decomposed stages in hybrid) against the JAX shims."""
    jm, tm = _modes(mode)
    ja, ta = jadapters.lm_adapter(CFG_J, lr=EMB_LR), adapters.lm_adapter(
        CFG, lr=EMB_LR)
    j_init, j_upd = jopt.make_optimizer(jopt.OptConfig(kind="adam",
                                                       lr=DENSE_LR))
    t_init, t_upd = make_optimizer(OptConfig(kind="adam", lr=DENSE_LR))
    bs = _batches(5)
    js, jspec = jhybrid.init_train_state(ja, jm, j_init,
                                         jax.random.PRNGKey(0), _jb(bs[0]))
    own, tspec = hybrid.init_train_state(ta, tm, t_init, 0, bs[0],
                                         device="cpu")
    assert tspec.staleness == jspec.staleness
    for k in ("emb_queue", "dense_queue"):
        assert (own[k] is None) == (js[k] is None)
    assert own["emb"]["table"].shape == js["emb"]["table"].shape
    ts = _shim_state_from_jax(js, tspec)
    jstep = jax.jit(jhybrid.make_train_step(ja, jspec, jm, j_upd))
    tstep = hybrid.make_train_step(ta, tspec, tm, t_upd)
    tfns = hybrid.make_decomposed_fns(ta, tspec, tm, t_upd)
    td = _shim_state_from_jax(js, tspec)
    for b in bs[1:]:
        js, mj = jstep(js, _jb(b))
        ts, mt = tstep(ts, b)
        _close(float(mt["loss"]), float(mj["loss"]), 1e-5, 0, "loss")
        _close(float(mt["emb_grad_norm"]), float(mj["emb_grad_norm"]), 1e-5,
               0, "emb_grad_norm")
        if mode == "hybrid":
            td, md = hybrid.decomposed_train_step(tfns, td, b, ta)
            assert float(md["loss"]) == float(mt["loss"])
    assert ts["step"] == int(js["step"]) == 4
    want = _np(js)
    for g, w in zip(tree_leaves(ts["dense"]), jax.tree.leaves(want["dense"])):
        _close(g.numpy(), w, 0, 1e-4, "dense")
    _close(ts["emb"]["table"].numpy(), want["emb"]["table"], 1e-4, 1e-5,
           "table")
    _close(ts["emb"]["acc"].numpy(), want["emb"]["acc"], 1e-5, 1e-5, "acc")
    if want["emb_queue"] is not None:
        np.testing.assert_array_equal(ts["emb_queue"]["ids"].numpy(),
                                      want["emb_queue"]["ids"])
        _close(ts["emb_queue"]["grads"].numpy(), want["emb_queue"]["grads"],
               1e-4, 1e-5, "queue grads")
        assert ts["emb_queue"]["ptr"] == int(want["emb_queue"]["ptr"])
    if mode == "hybrid":
        for a, b in zip(tree_leaves(td["emb"]), tree_leaves(ts["emb"])):
            assert torch.equal(a, b)
    ev = hybrid.make_eval_step(ta, tspec)(ts, bs[0])
    jev = jhybrid.make_eval_step(ja, jspec)(js, _jb(bs[0]))
    _close(float(ev["loss"]), float(jev["loss"]), 1e-5, 0, "eval")


def test_training_step_decreases_loss_tiny_lm():
    """A tiny LM learns the synthetic Markov data (loss drops); port of
    ``tests/test_models.py``'s test of that name."""
    cfg = ModelConfig(name="gqa", d_model=64, n_heads=4, n_kv_heads=2,
                      head_dim=16, d_ff=128, vocab_size=64, qk_norm=True,
                      pattern=(BlockCfg("gqa", "dense"),), pattern_repeats=2)
    adapter = adapters.lm_adapter(cfg, lr=0.2)
    opt_init, opt_update = make_optimizer(OptConfig(kind="adam", lr=3e-3))
    it = lm_batches(64, 8, 32, seed=0)
    state, spec = hybrid.init_train_state(adapter, TrainMode.hybrid(2),
                                          opt_init, 0, next(it),
                                          device="cpu")
    step = hybrid.make_train_step(adapter, spec, TrainMode.hybrid(2),
                                  opt_update)
    losses = []
    for _ in range(30):
        state, m = step(state, next(it))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.3, losses


def test_shims_refuse_many_tables_and_shards():
    two = dataclasses.replace(
        adapters.lm_adapter(CFG),
        collection=EmbeddingCollection.from_dict(
            {"a": EmbeddingSpec(rows=4, dim=2),
             "b": EmbeddingSpec(rows=4, dim=2)}))
    with pytest.raises(ValueError, match="single-table"):
        hybrid.make_eval_step(two, None)
    # emb_shards pads the table's rows to a multiple of it, as JAX does
    state, _ = hybrid.init_train_state(adapters.lm_adapter(CFG),
                                       TrainMode.sync(), lambda d: {},
                                       emb_shards=3, device="cpu")
    jstate, _ = jhybrid.init_train_state(jadapters.lm_adapter(CFG_J),
                                         jhybrid.TrainMode.sync(),
                                         lambda d: {}, jax.random.PRNGKey(0),
                                         emb_shards=3)
    assert tuple(state["emb"]["table"].shape) == \
        tuple(jstate["emb"]["table"].shape) == (201, CFG.d_model)
    assert tuple(state["emb"]["acc"].shape) == (201,)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pipeline", ["fused", "decomposed", "pipelined"])
def test_launcher_trains_lm_on_cpu(pipeline, tmp_path):
    out = tmp_path / "lm.json"
    hist = launch_train.main(["--device", "cpu", "--task", "lm", "--steps",
                              "2", "--batch", "2", "--seq-len", "16",
                              "--eval-every", "1", "--pipeline", pipeline,
                              "--max-inflight", "1", "--out", str(out)])
    assert [h["step"] for h in hist] == [1, 2]
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert launch_train.parse_args([]).seq_len == 128
    cfg = launch_train.small_lm_cfg()
    assert (cfg.d_model, cfg.n_layers, cfg.vocab_size) == (512, 20, 8192)
