"""LM training of the port's DeepSeek-V2 (MLA + MoE), Mamba-2 and Jamba
(mamba2 + GQA + MoE) models against the JAX package on the CPU, from the
same numpy inputs and the same JAX state: ``lm_loss`` value and gradients
(with the MoE aux term), then ``PersiaTrainer(lm_adapter)`` steps in sync
and hybrid(2) on each architecture's reduced config.

Tolerance class: allclose, that of ``test_torch_lm_train.py`` (XLA and
torch reduce matrix products, softmax and the SSD einsums in other
orders): the loss rtol 1e-5, gradients within 1e-5 of their leaf's
largest |grad|; after the trainer steps the losses and
``emb_grad_norm`` rtol 1e-5 per step. The trained state is held in the
trajectory class of ``chip_smoke.py``'s LM card-against-CPU check (PR
21): Adam moves every weight by about lr a step whatever its gradient's
size, so a weight whose gradient is near 0 or near eps (1e-9 against a
leaf's 1e-5 here) moves by a share of lr that the gradient's last bits
decide (measured up to 8.8e-4 after 3 steps, a few weights in 10^5), and
from the second step on the gradients that reach the vocab table differ
by that drift, which the row-wise adagrad step scales to about lr. So
the dense parameters' and the table's updates from the shared start must
agree in norm to 1e-3 (measured up to 2.0e-4), no weight may be off by
more than 2 lr a step and no table element by more than lr / 100 a
step; the accumulator agrees in norm to 1e-3, Adam's moments at rtol
1e-3 (m atol 1e-6, v atol 1e-9), the queued put at rtol 1e-3 / atol
1e-3 of its largest element, and the integers (step, Adam's t, queue
ids, ptr, filled) exactly. A MoE model is held
where it routes as the JAX package does: both packages' MoE calls are
recorded (``test_torch_moe.record_routing``), a token that routes
otherwise must lie within 1e-5 of a JAX top-k boundary, and the run is
compared up to the step of the first such call. The models run without
remat here, so each step routes once per MoE layer on both sides (the
port's remat recompute is held bit for bit against no remat).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import adapters as jadapters
from repro.core import hybrid as jhybrid
from repro.models import transformer as JT
from repro.optim import optimizers as jopt

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import adapters
from repro_torch.core.hybrid import PersiaTrainer
from repro_torch.data.lm import lm_batches
from repro_torch.models import transformer as T
from repro_torch.optim.optimizers import OptConfig
from repro_torch.utils import tree_leaves, tree_map
from test_torch_lm_train import (DENSE_LR, EMB_LR, _carry, _close, _flat,
                                 _jb, _modes, _np, _share)
from test_torch_moe import record_routing, routed_alike

ARCHS = ["deepseek_v2_lite_16b", "deepseek_v2_236b", "mamba2_1_3b",
         "jamba_v0_1_52b"]
# batch and sequence: 40 positions are a chunk (32) and a ragged one for
# the reduced SSM configs
B, S = 2, 40


def _cfgs(arch):
    return (jget_config(arch, reduced=True).replace(remat=False),
            get_config(arch, reduced=True).replace(remat=False))


def _n_moe(cfg) -> int:
    return sum(b.ffn == "moe" for b in cfg.prologue) + \
        sum(b.ffn == "moe" for b in cfg.pattern) * cfg.pattern_repeats


def _steps_alike(cfg, jrec, trec, n_steps) -> int:
    """The steps over which every MoE call routed alike."""
    n = _n_moe(cfg)
    return n_steps if n == 0 else routed_alike(jrec, trec, cfg.moe_top_k) // n


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_value_and_grads_match_jax(arch):
    """``lm_loss`` (with the MoE aux term where the model has MoE blocks)
    and its gradients w.r.t. every dense leaf and the activations; then
    the port's remat recompute gives the same gradients bit for bit."""
    cfg_j, cfg = _cfgs(arch)
    dj = JT.init_dense(cfg_j, jax.random.PRNGKey(1))
    dt = convert.lm_dense_from_numpy(_np(dj), cfg, device="cpu")
    rng = np.random.default_rng(3)
    acts = (rng.standard_normal((B, S, cfg.d_model)) * 0.5).astype(
        np.float32)
    tg = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) < 0.8).astype(np.float32)
    params = tree_map(lambda x: x.requires_grad_(), dt)
    ta = torch.tensor(acts, requires_grad=True)
    with record_routing() as (jrec, trec):
        (lj, mj), (gdj, gaj) = jax.value_and_grad(
            lambda d, a: JT.lm_loss(cfg_j, d, a, tg, mask), argnums=(0, 1),
            has_aux=True)(dj, jnp.asarray(acts))
        jax.effects_barrier()
        lt, mt = T.lm_loss(cfg, params, ta, tg, mask)
    assert len(trec) == _n_moe(cfg)
    assert _steps_alike(cfg, jrec, trec, 1) == 1, "routed apart"
    lt.backward()
    _close(float(lt.detach()), float(lj), 1e-5, 0, "loss")
    assert set(mt) == set(mj)
    for k in mj:
        _close(float(mt[k].detach()), float(mj[k]), 1e-5, 1e-7, k)
    _share(ta.grad.numpy(), gaj, 1e-5, "acts grad")
    got = {k: p.grad.numpy() for k, p in _flat(params).items()}
    want = _flat(_np(gdj))
    assert set(got) == set(want)
    for k in want:
        _share(got[k], want[k], 1e-5, k)

    p2 = tree_map(lambda x: x.detach().clone().requires_grad_(), dt)
    a2 = ta.detach().clone().requires_grad_()
    l2, _ = T.lm_loss(cfg.replace(remat=True), p2, a2, tg, mask)
    l2.backward()
    assert torch.equal(l2.detach(), lt.detach())
    assert torch.equal(a2.grad, ta.grad)
    for x, y in zip(tree_leaves(p2), tree_leaves(params)):
        assert torch.equal(x.grad, y.grad)


def _rel(got, want, start) -> float:
    """|got - want| over |want - start| in norm, over the leaves."""
    num = den = 0.0
    for g, w, s0 in zip(got, want, start):
        num += float(np.sum((np.asarray(g, np.float64) - w) ** 2))
        den += float(np.sum((np.asarray(w, np.float64) - s0) ** 2))
    return (num / max(den, 1e-300)) ** 0.5


def _check_trajectory(tstate, jstate, start, steps):
    """The trained states in the trajectory class (module doc)."""
    got, want = convert.state_to_numpy(tstate), _np(jstate)
    assert int(got["step"]) == int(want.step) == steps
    assert int(got["opt"]["t"]) == int(want.opt["t"])
    g, w, s0 = (jax.tree.leaves(t) for t in (got["dense"], want.dense,
                                              start.dense))
    assert _rel(g, w, s0) <= 1e-3, _rel(g, w, s0)
    assert max(float(np.abs(a - b).max()) for a, b in zip(g, w)) <= \
        2 * DENSE_LR * steps
    for name, atol in (("m", 1e-6), ("v", 1e-9)):
        for a, b in zip(jax.tree.leaves(got["opt"][name]),
                        jax.tree.leaves(want.opt[name])):
            _close(a, b, 1e-3, atol, f"adam {name}")
    e, ew, e0 = got["emb"]["vocab"], want.emb["vocab"], start.emb["vocab"]
    assert _rel([e["table"]], [ew["table"]], [e0["table"]]) <= 1e-3
    assert float(np.abs(e["table"] - ew["table"]).max()) <= \
        EMB_LR / 100 * steps
    assert _rel([e["acc"]], [ew["acc"]], [np.zeros_like(ew["acc"])]) <= 1e-3
    gq, wq = got["emb_queue"]["vocab"], want.emb_queue["vocab"]
    assert (gq is None) == (wq is None)
    if wq is not None:
        np.testing.assert_array_equal(gq["ids"], wq["ids"])
        assert (int(gq["ptr"]), int(gq["filled"])) == \
            (int(wq["ptr"]), int(wq["filled"]))
        _close(gq["grads"], wq["grads"], 1e-3,
               1e-3 * float(np.abs(wq["grads"]).max()), "queue grads")


def _trainers(cfg_j, cfg, mode):
    jm, tm = _modes(mode)
    jt = jhybrid.PersiaTrainer(jadapters.lm_adapter(cfg_j, lr=EMB_LR), jm,
                               jopt.OptConfig(kind="adam", lr=DENSE_LR))
    tt = PersiaTrainer(adapters.lm_adapter(cfg, lr=EMB_LR), tm,
                       OptConfig(kind="adam", lr=DENSE_LR), device="cpu")
    return jt, tt


@pytest.mark.parametrize("mode", ["sync", "hybrid"])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_trainer_matches_jax_from_one_state(arch, mode):
    """3 ``step``s of the port's ``PersiaTrainer(lm_adapter)`` against the
    JAX trainer's from one JAX-initialised state: losses and
    ``emb_grad_norm`` each step, then the dense parameters, Adam's
    moments, the vocab table, its accumulator and queue in the trajectory
    class (while every MoE call routed alike)."""
    cfg_j, cfg = _cfgs(arch)
    jt, tt = _trainers(cfg_j, cfg, mode)
    it = lm_batches(cfg.vocab_size, B, S, seed=3)
    bs = [next(it) for _ in range(4)]
    js = jt.init(jax.random.PRNGKey(0), _jb(bs[0]))
    start = _np(js)
    ts = _carry(tt, js)
    jl, jn, tl, tn = [], [], [], []
    with record_routing() as (jrec, trec):
        for b in bs[1:]:
            js, m = jt.step(js, _jb(b))
            jl.append(float(m["loss"]))
            jn.append(float(m["emb_grad_norm"]))
        jax.effects_barrier()
        for b in bs[1:]:
            ts, m = tt.step(ts, b)
            tl.append(float(m["loss"]))
            tn.append(float(m["emb_grad_norm"]))
    assert len(trec) == _n_moe(cfg) * 3
    alike = _steps_alike(cfg, jrec, trec, 3)
    assert alike >= 1, "the first step routed apart"
    assert all(np.isfinite(tl))
    _close(tl[:alike], jl[:alike], 1e-5, 0, "losses")
    _close(tn[:alike], jn[:alike], 1e-5, 0, "emb_grad_norm")
    if alike == 3:
        _check_trajectory(ts, js, start, 3)
