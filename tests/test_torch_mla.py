"""The port's MLA (repro_torch/models/layers.py) and the DeepSeek-V2 model
path (mla + MoE blocks in repro_torch/models/transformer.py) against the
JAX package on the CPU: ``mla_forward``, the weight-absorbed
``mla_decode`` and the latent caches, with and without q-lora; the
attention at a value head narrower than the query/key head, forward and
backward (against ``jax.vjp``); prefill plus
teacher-forced decode of ``tests/test_models.py``'s MLA config; the value
of ``lm_loss`` with the MoE aux term; the converter on MLA / MoE trees.

Values at rtol 1e-4 / atol 1e-5 (XLA and torch sum in other orders). A
model run is held where its routing is the JAX package's: both packages'
MoE calls record their experts (``test_torch_moe.record_routing``), a
token routed otherwise must lie within 1e-5 of a JAX top-k boundary, and
the run is compared up to the step of the first such call.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import layers as JL
from repro.models import transformer as JT

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import flash
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from test_torch_moe import CFG, CFG_J, record_routing, routed_alike

RTOL, ATOL = 1e-4, 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL, err_msg=what)


def _cfgs(q_lora):
    return (CFG_J.replace(q_lora_rank=q_lora),
            dataclasses.replace(CFG, q_lora_rank=q_lora))


# ---------------------------------------------------------------------------
# the attention at Dv != Dh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("Sq,Sk,causal", [(9, 9, True), (70, 70, True),
                                          (5, 12, False)])
def test_attention_with_a_narrower_value_head_matches_jax(Sq, Sk, causal):
    rng = np.random.default_rng(Sq)
    q = rng.standard_normal((2, Sq, 3, 1, 24)).astype(np.float32)
    k = rng.standard_normal((2, Sk, 3, 24)).astype(np.float32)
    v = rng.standard_normal((2, Sk, 3, 16)).astype(np.float32)
    want = JL._attn_naive(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          scale=0.2, causal=causal, window=0, q_offset=0)
    got = L.grouped_attention(_t(q), _t(k), _t(v), scale=0.2,
                              causal=causal)
    assert got.shape == (2, Sq, 3, 1, 16)
    _close(got, want)


# Sq, Sk, G, causal, (q_block, k_block) of the JAX flash attention: equal
# blocks and causal take its triangle-ordered backward (``_bwd_tri``)
BWD_CASES = {"causal_ragged": (70, 70, 2, True, (32, 16)),
             "causal_tri": (64, 64, 1, True, (16, 16)),
             "non_causal": (9, 21, 2, False, (8, 8))}


@pytest.mark.parametrize("dims", [(24, 16), (48, 32)],
                         ids=["24_16", "48_32"])
@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_attention_backward_at_a_narrower_value_head_raises(case, dims,
                                                            monkeypatch):
    """The backward at a value head narrower than the query/key head
    (MLA's 192 / 128 at narrow widths) raises nothing and matches
    ``jax.vjp`` of the JAX package's ``_attn_naive`` and of its flash
    attention (``_bwd`` or ``_bwd_tri``): dq and dk (..., Dh), dv (...,
    Dv), each within 2e-6 of the largest |grad| on the JAX side (the
    class of ``test_torch_lm_train.py``'s attention backward)."""
    from repro.models import flash as jflash
    Sq, Sk, G, causal, (qb, kb) = BWD_CASES[case]
    Dh, Dv = dims
    rng = np.random.default_rng(Sq + Dh)
    q = rng.standard_normal((2, Sq, 2, G, Dh)).astype(np.float32)
    k = rng.standard_normal((2, Sk, 2, Dh)).astype(np.float32)
    v = rng.standard_normal((2, Sk, 2, Dv)).astype(np.float32)
    do = rng.standard_normal((2, Sq, 2, G, Dv)).astype(np.float32)
    scale = 1.0 / np.sqrt(Dh)
    _, vjp_f = jax.vjp(lambda a, b, c: jflash.flash_attention(
        a, b, c, scale=scale, causal=causal, qblk=qb, kblk=kb), q, k, v)
    _, vjp_n = jax.vjp(lambda a, b, c: JL._attn_naive(
        a, b, c, scale=scale, causal=causal, window=0, q_offset=0), q, k, v)
    monkeypatch.setattr(flash, "Q_BLOCK", 16)
    monkeypatch.setattr(flash, "K_BLOCK", 8)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    o = flash.flash_attention(tq, tk, tv, scale=scale, causal=causal)
    assert o.shape == (2, Sq, 2, G, Dv)
    o.backward(torch.from_numpy(do))
    assert (tq.grad.shape, tk.grad.shape, tv.grad.shape) == \
        (tq.shape, tk.shape, tv.shape)
    for want in (vjp_f(do), vjp_n(do)):
        for name, got, w in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
            w = np.asarray(w)
            assert got.shape == w.shape
            np.testing.assert_allclose(
                got.numpy(), w, rtol=0, atol=2e-6 * float(np.abs(w).max()),
                err_msg=f"{case} {dims}: d{name}")


# ---------------------------------------------------------------------------
# MLA layers
# ---------------------------------------------------------------------------

def _mla_params(cfg_j, seed=1):
    pj = JL.mla_init(jax.random.PRNGKey(seed), cfg_j, jnp.float32)
    for name in ("q_ln", "kv_ln"):           # non-trivial norm weights
        if name in pj:
            pj[name]["w"] = pj[name]["w"] * 1.3
    return pj, jax.tree.map(lambda a: _t(a), _np_tree(pj))


@pytest.mark.parametrize("q_lora", [24, 0], ids=["q_lora", "direct_q"])
def test_mla_init_has_the_jax_tree(q_lora):
    cfg_j, cfg = _cfgs(q_lora)
    pj = JL.mla_init(jax.random.PRNGKey(0), cfg_j, jnp.float32)
    pt = L.mla_init(torch.Generator().manual_seed(0), cfg, lead=(2,))
    assert set(pt) == set(pj)
    for k in pj:
        want = jax.tree.map(lambda a: (2,) + a.shape, pj[k])
        got = jax.tree.map(lambda t: tuple(t.shape), pt[k])
        assert got == want, k


@pytest.mark.parametrize("q_lora", [24, 0], ids=["q_lora", "direct_q"])
def test_mla_forward_matches_jax(q_lora):
    cfg_j, cfg = _cfgs(q_lora)
    pj, pt = _mla_params(cfg_j)
    rng = np.random.default_rng(2)
    B, S = 2, 13
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    oj, cj = JL.mla_forward(pj, cfg_j, jnp.asarray(x), jnp.asarray(pos))
    ot, ct = L.mla_forward(pt, cfg, _t(x), _t(pos))
    _close(ot, oj, "out")
    _close(ct["ckv"], cj["ckv"], "ckv")
    _close(ct["k_rope"], cj["k_rope"], "k_rope")
    np.testing.assert_array_equal(ct["len"], cj["len"])


@pytest.mark.parametrize("q_lora", [24, 0], ids=["q_lora", "direct_q"])
def test_mla_decode_and_latent_cache_match_jax(q_lora):
    """Prefill S positions, then decode 4 tokens against a cache of S + 4:
    the JAX package's padded cache and returned caches against the port's
    in-place one, the unwritten tail included."""
    cfg_j, cfg = _cfgs(q_lora)
    pj, pt = _mla_params(cfg_j, seed=3)
    rng = np.random.default_rng(4)
    B, S, n = 3, 7, 4
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    nxt = rng.standard_normal((n, B, 1, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    _, cj = JL.mla_forward(pj, cfg_j, jnp.asarray(x), jnp.asarray(pos))
    cj = {"ckv": jnp.pad(cj["ckv"], ((0, 0), (0, n), (0, 0))),
          "k_rope": jnp.pad(cj["k_rope"], ((0, 0), (0, n), (0, 0))),
          "len": cj["len"]}
    ct = L.mla_cache_init(cfg, B, S + n)
    cj0 = JL.mla_cache_init(cfg_j, B, S + n, jnp.float32)
    for key in ct:
        assert tuple(ct[key].shape) == cj0[key].shape, key
    _, c = L.mla_forward(pt, cfg, _t(x), _t(pos))
    ct["ckv"][:, :S], ct["k_rope"][:, :S] = c["ckv"], c["k_rope"]
    ct["len"].fill_(S)
    for t in range(n):
        oj, cj = JL.mla_decode(pj, cfg_j, jnp.asarray(nxt[t]), cj)
        ot, ct = L.mla_decode(pt, cfg, _t(nxt[t]), ct)
        _close(ot, oj, f"decode {t} out")
        for key in ("ckv", "k_rope"):
            _close(ct[key], cj[key], f"decode {t} {key}")
        np.testing.assert_array_equal(ct["len"], cj["len"])


# ---------------------------------------------------------------------------
# the model: prefill + decode, lm_loss, the converter
# ---------------------------------------------------------------------------

def _jax_dense(cfg_j, cfg, seed=0):
    dj = JT.init_dense(cfg_j, jax.random.PRNGKey(seed))
    return dj, convert.lm_dense_from_numpy(_np_tree(dj), cfg, device="cpu")


def _check_caches(tc, jc, what):
    for name in ("prologue_0",):
        for key in ("ckv", "k_rope"):
            _close(tc[name]["attn"][key], jc[name]["attn"][key],
                   f"{what}: {name} {key}")
    for key in ("ckv", "k_rope"):
        _close(tc["stack"]["0"]["attn"][key], jc["stack"]["0"]["attn"][key],
               f"{what}: stack {key}")
    np.testing.assert_array_equal(tc["stack"]["0"]["attn"]["len"],
                                  jc["stack"]["0"]["attn"]["len"])
    np.testing.assert_array_equal(tc["pos"], jc["pos"])


@pytest.mark.parametrize("q_lora", [24, 0], ids=["q_lora", "direct_q"])
def test_prefill_and_teacher_forced_decode_match_jax(q_lora):
    """tests/test_models.py's MLA config (an mla + dense prologue, 2 mla +
    MoE layers): prefill logits and latent caches, then 4 teacher-forced
    decode steps, each held while the routing is the JAX package's."""
    cfg_j, cfg = _cfgs(q_lora)
    dj, dt = _jax_dense(cfg_j, cfg)
    rng = np.random.default_rng(7)
    B, S, n_dec = 2, 11, 4
    acts = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    nxt = rng.standard_normal((n_dec, B, 1, cfg.d_model)).astype(np.float32)
    k, R = cfg.moe_top_k, cfg.pattern_repeats
    with record_routing() as (jrec, trec):
        lj, cj = JT.prefill(cfg_j, dj, jnp.asarray(acts), max_len=S + n_dec)
        lt, ct = T.prefill(cfg, dt, _t(acts), max_len=S + n_dec)
        assert len(trec) == R
        assert ct["stack"]["0"]["attn"]["ckv"].shape == \
            cj["stack"]["0"]["attn"]["ckv"].shape
        held = 0
        if routed_alike(jrec, trec, k) == R:
            _close(lt, lj, "prefill logits")
            _check_caches(ct, cj, "prefill")
            held += 1
        step = jax.jit(lambda c, a: JT.decode_step(cfg_j, dj, a, c))
        for t in range(n_dec):
            lj, cj = step(cj, jnp.asarray(nxt[t]))
            lt, ct = T.decode_step(cfg, dt, _t(nxt[t]), ct)
            jax.effects_barrier()
            if routed_alike(jrec, trec, k) < len(trec) or held <= t:
                break
            _close(lt, lj, f"decode {t} logits")
            _check_caches(ct, cj, f"decode {t}")
            held += 1
    assert held >= 1
    assert (lt[..., cfg.vocab_size:] == -1e30).all()


def test_lm_loss_with_the_moe_aux_term_matches_jax():
    cfg_j, cfg = CFG_J, CFG
    dj, dt = _jax_dense(cfg_j, cfg, seed=5)
    rng = np.random.default_rng(8)
    B, S = 2, 10
    acts = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    tg = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) < 0.8).astype(np.float32)
    with torch.no_grad(), record_routing() as (jrec, trec):
        lj, mj = JT.lm_loss(cfg_j, dj, jnp.asarray(acts), jnp.asarray(tg),
                            jnp.asarray(mask))
        lt, mt = T.lm_loss(cfg, dt, _t(acts), tg, mask)
        jax.effects_barrier()
    assert routed_alike(jrec, trec, cfg.moe_top_k) == len(trec) == \
        cfg.pattern_repeats
    assert set(mt) == set(mj) == {"loss", "ppl_log", "moe_balance", "moe_z",
                                  "moe_drop_frac"}
    _close(lt, lj, "loss")
    for k in mj:
        _close(mt[k], mj[k], k)
    # the aux term: the balance and z stats averaged over the 3 layers
    assert float(lt) > float(mt["loss"])


@pytest.mark.parametrize("arch", ["deepseek_v2_lite_16b", "deepseek_v2_236b"])
def test_lm_dense_from_numpy_takes_the_mla_and_moe_trees(arch):
    cfg_j, cfg = jget_config(arch, reduced=True), get_config(arch,
                                                              reduced=True)
    dj = JT.init_dense(cfg_j, jax.random.PRNGKey(0))
    tree = _np_tree(dj)
    got = convert.lm_dense_from_numpy(tree, cfg, device="cpu")
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(
            jax.tree.map(lambda t: t.numpy(), got))):
        np.testing.assert_array_equal(a, b)
    mixer = got["prologue_0"]["mixer"]
    assert ("wdq" in mixer) == (cfg.q_lora_rank > 0)
    assert got["stack"]["0"]["ffn"]["wg"].shape == (
        cfg.pattern_repeats, cfg.n_experts, cfg.d_model, cfg.moe_d_ff)
    tree["stack"]["0"]["ffn"].pop("shared")
    with pytest.raises(ValueError, match="keys"):
        convert.lm_dense_from_numpy(tree, cfg, device="cpu")
