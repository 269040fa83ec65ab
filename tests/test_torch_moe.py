"""The port's MoE FFN (repro_torch/models/moe.py) against the JAX package's
(repro/models/moe.py) on the CPU: the router's top-k and its order among
ties, the capacity dispatch, the aux loss, and the one-device
``moe_forward`` with its aux stats, with and without drops.

Inputs come from a numpy seed and go through both. The integer logic
(``_dispatch_positions``, the top-k order) is held bit for bit; values at
rtol 1e-4 / atol 1e-5 (XLA and torch sum their products in other
orders). Routing is compared first: the two packages' probabilities
differ by float rounding (~1e-7), so a token whose JAX top-k boundary
gap (between the k-th and (k+1)-th probability, or two neighbours inside
the top k, whose order sets the dispatch order) exceeds 1e-5 must route
alike, and its values are held where its routing and its slots agree.
``record_routing`` and ``routed_alike`` hold model runs the same way
(``test_torch_mla.py``, ``test_torch_lm.py``).
"""
import contextlib
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import BlockCfg as JBlockCfg
from repro.configs.base import ModelConfig as JModelConfig
from repro.models import moe as JMOE

from repro_torch.configs.base import BlockCfg, ModelConfig
from repro_torch.models import moe as MOE

RTOL, ATOL = 1e-4, 1e-5
GAP = 1e-5

# tests/test_models.py's MLA config (its MoE: 4 experts, top-2, 1 shared,
# capacity factor 8)
MLA_KW = dict(name="mla", d_model=64, n_heads=4, head_dim=16,
              rope_head_dim=8, v_head_dim=16, kv_lora_rank=32,
              q_lora_rank=24, d_ff=128, vocab_size=128, pattern_repeats=2,
              n_experts=4, moe_top_k=2, moe_d_ff=64, n_shared_experts=1,
              capacity_factor=8.0)
CFG_J = JModelConfig(**MLA_KW, pattern=(JBlockCfg("mla", "moe"),),
                     prologue=(JBlockCfg("mla", "dense"),))
CFG = ModelConfig(**MLA_KW, pattern=(BlockCfg("mla", "moe"),),
                  prologue=(BlockCfg("mla", "dense"),))


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL, err_msg=what)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _torch_tree(tree):
    return jax.tree.map(lambda a: _t(a), _np_tree(tree))


def topk_gaps(probs: np.ndarray, k: int) -> np.ndarray:
    """Per token, the smallest gap between neighbours among its k + 1
    largest probabilities: under it, rounding may change the top-k set
    (the k-th against the (k+1)-th) or its order (the dispatch order)."""
    s = -np.sort(-np.asarray(probs, np.float64), axis=-1)[..., :k + 1]
    return np.min(s[..., :-1] - s[..., 1:], axis=-1)


@contextlib.contextmanager
def record_routing():
    """Record ``(probs, topi)`` of every call of both packages'
    ``router_topk`` while the block runs, in call order: ``(jax_calls,
    torch_calls)``. The JAX side records through ``jax.debug.callback``,
    so calls inside ``jit`` and ``lax.scan`` (traced inside the block)
    are recorded too."""
    jrec, trec = [], []
    jorig, torig = JMOE.router_topk, MOE.router_topk

    def jwrapped(logits, k):
        out = jorig(logits, k)
        jax.debug.callback(
            lambda p, i: jrec.append((np.asarray(p), np.asarray(i))),
            out[0], out[2])
        return out

    def twrapped(logits, k):
        out = torig(logits, k)
        trec.append((out[0].detach().cpu().numpy(),
                     out[2].detach().cpu().numpy()))
        return out

    with mock.patch.object(JMOE, "router_topk", jwrapped), \
            mock.patch.object(MOE, "router_topk", twrapped):
        yield jrec, trec


def routed_alike(jrec, trec, k) -> int:
    """The number of leading calls in which both packages chose the same
    experts in the same order for every token. A token that chose
    otherwise must lie within :data:`GAP` of a boundary of the JAX
    package's probabilities (:func:`topk_gaps`); from that call on, the
    runs may part."""
    assert len(jrec) == len(trec), (len(jrec), len(trec))
    for n, ((pj, ij), (_, it)) in enumerate(zip(jrec, trec)):
        differ = (ij != it).any(-1)
        if differ.any():
            gaps = topk_gaps(pj, k)[differ]
            assert gaps.max() <= GAP, gaps
            return n
    return len(jrec)


# ---------------------------------------------------------------------------
# router, dispatch, aux loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("E,k", [(4, 2), (64, 6), (160, 6)])
def test_router_topk_matches_jax(E, k):
    rng = np.random.default_rng(E)
    logits = rng.standard_normal((97, E)).astype(np.float32) * 3
    pj, vj, ij = JMOE.router_topk(jnp.asarray(logits), k)
    pt, vt, it = MOE.router_topk(_t(logits), k)
    off = topk_gaps(np.asarray(pj), k) > GAP     # off every boundary
    assert off.mean() > 0.9
    np.testing.assert_array_equal(it.numpy()[off], np.asarray(ij)[off])
    _close(pt, pj, "probs")
    _close(vt[torch.from_numpy(off)], np.asarray(vj)[off], "topv")


def test_router_topk_orders_ties_as_jax_lax_top_k():
    """Equal probabilities: the lower expert first, bit for bit with
    ``jax.lax.top_k``, wherever the ties lie (inside the top k, across
    its boundary, all experts equal)."""
    rows = [
        [0.0, 1.0, 1.0, 0.5, 1.0, -2.0, 1.0, 0.0],     # a 4-way tie
        [3.0, 0.0, 3.0, 0.0, 3.0, 0.0, 3.0, 0.0],      # ties across k
        [0.0] * 8,                                     # all equal
        [-1.0, 2.0, -1.0, 2.0, 5.0, -1.0, 2.0, -1.0],  # ties after a top
        [1.0, 1.0, 7.0, 7.0, 1.0, 1.0, 7.0, 7.0],
    ]
    logits = np.asarray(rows, np.float32)
    for k in (1, 2, 3, 6):
        pj, vj, ij = JMOE.router_topk(jnp.asarray(logits), k)
        pt, vt, it = MOE.router_topk(_t(logits), k)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij),
                                      err_msg=f"k={k}")
        _close(vt, vj, f"topv k={k}")


@pytest.mark.parametrize("T,E,k,C", [(13, 4, 2, 3), (64, 4, 2, 40),
                                     (256, 64, 6, 30), (4, 64, 6, 1),
                                     (1, 8, 3, 1), (50, 8, 2, 100)])
def test_dispatch_positions_bit_exact(T, E, k, C):
    rng = np.random.default_rng(T * E + k)
    # skewed choices (distinct per token), so capacities overflow
    w = rng.dirichlet(np.full(E, 0.3))
    topi = np.stack([rng.choice(E, k, replace=False, p=w)
                     for _ in range(T)]).astype(np.int32)
    want = np.asarray(JMOE._dispatch_positions(jnp.asarray(topi), E, C))
    got = MOE._dispatch_positions(_t(topi), E, C).numpy()
    np.testing.assert_array_equal(got, want)
    if C < T:
        assert (got == E * C).any() or T * k <= C


def test_load_balance_loss_and_aux_total_match_jax():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((40, 8)).astype(np.float32)
    pj, _, ij = JMOE.router_topk(jnp.asarray(logits), 3)
    pt, _, it = MOE.router_topk(_t(logits), 3)
    _close(MOE.load_balance_loss(pt, it, 8),
           JMOE.load_balance_loss(pj, ij, 8))
    aux = {"moe_balance": np.float32(1.3), "moe_z": np.float32(4.5),
           "moe_drop_frac": np.float32(0.1)}
    _close(MOE.moe_aux_total(CFG, {k: _t(v) for k, v in aux.items()}),
           JMOE.moe_aux_total(CFG_J, {k: jnp.asarray(v)
                                      for k, v in aux.items()}))


# ---------------------------------------------------------------------------
# moe_forward
# ---------------------------------------------------------------------------

def test_moe_init_has_the_jax_tree():
    for lead in ((), (3,)):
        pt = MOE.moe_init(torch.Generator().manual_seed(0), CFG, lead=lead)
        pj = JMOE.moe_init(jax.random.PRNGKey(0), CFG_J)
        if lead:
            pj = jax.tree.map(lambda a: jnp.stack([a] * 3), pj)
        assert jax.tree.structure(jax.tree.map(lambda a: 0, pj)) == \
            jax.tree.structure(jax.tree.map(lambda a: 0, pt))
        for a, b in zip(jax.tree.leaves(_np_tree(pj)), jax.tree.leaves(
                jax.tree.map(lambda t: t.numpy(), pt))):
            assert a.shape == b.shape
    # the draws are those of the JAX package's init: N(0, 1) times its
    # scales (1/sqrt(d_in); the router 0.02)
    big = dataclasses.replace(CFG, d_model=256, moe_d_ff=512, n_experts=8)
    p = MOE.moe_init(torch.Generator().manual_seed(1), big)
    assert abs(float(p["wg"].std()) - 1 / 16) < 2e-3
    assert abs(float(p["router"].std()) - 0.02) < 2e-3
    assert abs(float(p["wd"].std()) - 1 / np.sqrt(512)) < 2e-3


def _moe_both(cf, router_gain, seed=4, B=4, S=16):
    """moe_forward of one input through both packages, with the JAX
    routing (probs, topi) and both slot tables."""
    pj = JMOE.moe_init(jax.random.PRNGKey(seed), CFG_J)
    # a sharper router than the init's 0.02 draws: imbalanced routing,
    # so capacity factor 1.25 drops pairs
    pj["router"] = pj["router"] * router_gain
    pt = _torch_tree(pj)
    x = np.random.default_rng(seed).standard_normal(
        (B, S, CFG.d_model)).astype(np.float32)
    # every token leans to expert 0, whose queue then overflows at 1.25
    r0 = np.asarray(pj["router"][:, 0])
    x = (x + r0 / np.linalg.norm(r0)).astype(np.float32)
    oj, aj = JMOE.moe_forward(pj, CFG_J, jnp.asarray(x), capacity_factor=cf)
    ot, at = MOE.moe_forward(pt, CFG, _t(x), capacity_factor=cf)
    xt = x.reshape(B * S, -1)
    lj = np.asarray(jnp.asarray(xt) @ pj["router"])
    probs, _, ij = JMOE.router_topk(jnp.asarray(lj), CFG.moe_top_k)
    _, _, it = MOE.router_topk(_t(xt) @ pt["router"], CFG.moe_top_k)
    C = MOE.capacity(CFG, B * S, cf)
    sj = np.asarray(JMOE._dispatch_positions(ij, CFG.n_experts, C))
    st = MOE._dispatch_positions(it, CFG.n_experts, C).numpy()
    return (oj, aj), (ot, at), (np.asarray(probs), np.asarray(ij),
                                it.numpy(), sj, st)


@pytest.mark.parametrize("cf", [8.0, 1.25])
def test_moe_forward_and_aux_match_jax(cf):
    (oj, aj), (ot, at), (probs, ij, it, sj, st) = _moe_both(cf, 60.0)
    gaps = topk_gaps(probs, CFG.moe_top_k)
    same = (ij == it).all(-1)
    # routing first: every token off the boundary routes alike
    assert same[gaps > GAP].all(), np.nonzero(~same & (gaps > GAP))
    if cf == 1.25:
        assert float(aj["moe_drop_frac"]) > 0       # drops occur
    else:
        assert float(aj["moe_drop_frac"]) == 0
    agree = same & (sj == st).all(-1)
    B, S = ot.shape[:2]
    _close(ot.reshape(B * S, -1)[torch.from_numpy(agree)],
           np.asarray(oj).reshape(B * S, -1)[agree], "out")
    if agree.all():
        for key in ("moe_balance", "moe_z", "moe_drop_frac"):
            _close(at[key], aj[key], key)
    assert agree.sum() >= 0.9 * agree.size


def test_moe_decode_capacity_one_drops_in_token_order():
    """A decode step of 4 tokens at DeepSeek-V2-Lite's routing (64
    experts, top-6, factor 1.25): C = max(1, ceil(30 / 64)) = 1, so a
    second token that picks an expert is dropped, in token order, as in
    the JAX package."""
    cfg = dataclasses.replace(CFG, n_experts=64, moe_top_k=6,
                              capacity_factor=1.25)
    assert MOE.capacity(cfg, 4) == 1
    topi = np.array([[0, 1, 2, 3, 4, 5], [5, 6, 7, 8, 9, 0],
                     [10, 11, 12, 13, 14, 15], [1, 16, 17, 18, 19, 20]],
                    np.int32)
    got = MOE._dispatch_positions(_t(topi), 64, 1).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(JMOE._dispatch_positions(jnp.asarray(topi), 64, 1)))
    # choice 0 of every token first: token 1 takes expert 5 and token 3
    # expert 1 before token 0's later choices reach them
    assert got[0, 1] == 64 and got[0, 5] == 64 and got[1, 5] == 64
    assert got[1, 0] == 5 and got[3, 0] == 1 and got[2, 5] == 15


# ---------------------------------------------------------------------------
# gradients: moe_forward + moe_aux_total against jax.grad
# ---------------------------------------------------------------------------

def _moe_grads_both(cfg_j, cfg, cf, seed=4, B=4, S=16, aux=True):
    """Gradients of ``sum(out * w) (+ moe_aux_total(aux))`` w.r.t. the
    input and every parameter through both packages, with the JAX routing
    and both slot tables (the sharp router of ``_moe_both``)."""
    pj = JMOE.moe_init(jax.random.PRNGKey(seed), cfg_j)
    pj["router"] = pj["router"] * 60.0
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    r0 = np.asarray(pj["router"][:, 0])
    x = (x + r0 / np.linalg.norm(r0)).astype(np.float32)
    w = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)

    def jloss(p, xx):
        o, a = JMOE.moe_forward(p, cfg_j, xx, capacity_factor=cf)
        out = jnp.sum(o * w)
        return out + JMOE.moe_aux_total(cfg_j, a) if aux else out

    gpj, gxj = jax.grad(jloss, argnums=(0, 1))(pj, jnp.asarray(x))
    pt = jax.tree.map(lambda a: a.requires_grad_(), _torch_tree(pj))
    xt = torch.tensor(x, requires_grad=True)
    o, a = MOE.moe_forward(pt, cfg, xt, capacity_factor=cf)
    loss = torch.sum(o * torch.from_numpy(w))
    if aux:
        loss = loss + MOE.moe_aux_total(cfg, a)
    loss.backward()
    flat = x.reshape(B * S, -1)
    probs, _, ij = JMOE.router_topk(jnp.asarray(flat) @ pj["router"],
                                    cfg.moe_top_k)
    _, _, it = MOE.router_topk(_t(flat) @ _t(pj["router"]), cfg.moe_top_k)
    C = MOE.capacity(cfg, B * S, cf)
    sj = np.asarray(JMOE._dispatch_positions(ij, cfg.n_experts, C))
    st = MOE._dispatch_positions(it, cfg.n_experts, C).numpy()
    return (gpj, np.asarray(gxj)), (pt, xt.grad.numpy()), \
        (np.asarray(probs), np.asarray(ij), it.numpy(), sj, st)


def _grad_close(got, want, what):
    """Within 1e-5 of the largest |grad| of the leaf (rtol 1e-4 on top)."""
    want = np.asarray(want)
    np.testing.assert_allclose(
        got, want, rtol=RTOL, atol=ATOL * max(1.0, float(np.abs(want).max())),
        err_msg=what)


NO_SHARED = dataclasses.replace(CFG, n_shared_experts=0)
NO_SHARED_J = dataclasses.replace(CFG_J, n_shared_experts=0)


@pytest.mark.parametrize("shared", [1, 0], ids=["shared", "no_shared"])
@pytest.mark.parametrize("cf", [8.0, 1.25])
def test_moe_grads_and_aux_grads_match_jax(cf, shared):
    """``torch.autograd`` through the router's top-k, the capacity scatter
    into the (E, C, D) buffer and its drop row, the three batched expert
    products, the weighted gather and the aux terms (balance and z)
    against ``jax.grad``, with drops (factor 1.25) and without (8); with
    one shared expert and with none (Jamba), which takes no shared
    branch. Held where the routing and the slots agree for every token
    (a token within 1e-5 of a top-k boundary may route otherwise)."""
    cfg_j, cfg = (CFG_J, CFG) if shared else (NO_SHARED_J, NO_SHARED)
    (gpj, gxj), (pt, gxt), (probs, ij, it, sj, st) = _moe_grads_both(
        cfg_j, cfg, cf)
    assert ("shared" in pt) == bool(shared)
    same = (ij == it).all(-1) & (sj == st).all(-1)
    assert same[topk_gaps(probs, CFG.moe_top_k) > GAP].all()
    assert same.all(), "a token routed otherwise: pick no such seed"
    assert ((sj == CFG.n_experts * MOE.capacity(CFG, 64, cf)).any()) == \
        (cf == 1.25)
    _grad_close(gxt, gxj, "dx")
    for (path, g), tg in zip(jax.tree_util.tree_flatten_with_path(gpj)[0],
                             jax.tree.leaves(jax.tree.map(
                                 lambda t: t.grad.numpy(), pt))):
        _grad_close(tg, g, jax.tree_util.keystr(path))


def test_moe_dropped_token_gets_exactly_zero_gradient():
    """A token whose every (token, choice) pair is dropped adds nothing to
    the output, so without shared experts and aux terms its input
    gradient is exactly 0 in both packages: the drop row's duplicate
    writes carry no gradient back (JAX: the ``.at[].set`` transpose). A
    factor of 0.25 (8 slots an expert for 128 pairs) drops both choices
    of the later tokens."""
    (_, gxj), (_, gxt), (_, ij, it, sj, st) = _moe_grads_both(
        NO_SHARED_J, NO_SHARED, 0.25, aux=False)
    np.testing.assert_array_equal(sj, st)
    dropped = (sj == NO_SHARED.n_experts * MOE.capacity(NO_SHARED, 64,
                                                        0.25)).all(-1)
    assert dropped.any()
    gj, gt = gxj.reshape(64, -1), gxt.reshape(64, -1)
    assert (gj[dropped] == 0).all() and (gt[dropped] == 0).all()
    assert (np.abs(gt[~dropped]).max(-1) > 0).all()
    _grad_close(gxt, gxj, "dx")
