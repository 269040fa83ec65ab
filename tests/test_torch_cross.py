"""Cross-attention, the encoder, logit soft-capping and the sliding-window
ring decode of the port (repro_torch/models) against the JAX package on
the CPU, from the same numpy inputs and one JAX-initialised state carried
through ``convert.lm_dense_from_numpy``: ``cross_attn_forward`` (Sq != Sk,
a memory narrower than d_model), ``encode`` on reduced whisper, the capped
attention (``grouped_attention`` against ``jax.vjp`` of the JAX package's
naive branch, ``_attn_blockwise`` against JAX's at several blocks,
``decode_attention`` and ``_decode_ring``), the non-causal attention
backward at Sq != Sk, decoding from a ring of 6 slots that wraps over 20
steps, and the ports of ``tests/test_models.py``'s
``test_prefill_decode_consistency`` at its VLM, ENCDEC and SLIDING configs
and of ``test_sliding_window_ring_long``. Every ``xgate`` is set to 0.5 in
the state given to both packages: at its init value 0 the gated
cross-attention adds nothing.

Tolerance classes (allclose: XLA and torch reduce matrix products and
softmax sums in other orders):
* layer outputs, K/V, logits and caches rtol 1e-4 / atol 1e-5, the
  class of ``test_torch_lm.py``;
* the attention's gradients within 2e-6 of the largest |grad| of the JAX
  side, the class of ``test_torch_lm_train.py``'s attention backward
  (blockwise: 1e-5, autograd through tiles of an online softmax in both);
* a model's prefill + decode against its own full forward within atol
  3e-5, the JAX test's bound.
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
from repro_torch.configs.base import BlockCfg, ModelConfig
from repro_torch.models import flash
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from test_models import ENCDEC, SLIDING, VLM
from test_torch_lm_train import _share

RTOL, ATOL = 1e-4, 1e-5


def _np(tree):
    return jax.tree.map(np.array, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, what="", rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


def port_cfg(cfg):
    """The port's ModelConfig with the fields of a JAX package's one."""
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    kw["pattern"] = tuple(BlockCfg(b.mixer, b.ffn, b.cross)
                          for b in cfg.pattern)
    kw["prologue"] = tuple(BlockCfg(b.mixer, b.ffn, b.cross)
                           for b in cfg.prologue)
    if cfg.encoder is not None:
        kw["encoder"] = port_cfg(cfg.encoder)
    return ModelConfig(**kw)


def open_gates(tree, value=0.5):
    """Every ``xgate`` of a numpy dense tree set to ``value`` (in place)."""
    for blk in tree["stack"].values():
        if "xgate" in blk:
            blk["xgate"][...] = value
    return tree


def jax_state(cfg_j, cfg, seed=0):
    """(JAX dense params, the port's) from one JAX init, gates open."""
    tree = open_gates(_np(JT.init_dense(cfg_j, jax.random.PRNGKey(seed))))
    return (jax.tree.map(jnp.asarray, tree),
            convert.lm_dense_from_numpy(tree, cfg, device="cpu"))


def memory_for(cfg, B, rng):
    """(B, M, d_memory) frames or patches, random normal x 0.1."""
    if cfg.is_encdec:
        shape = (B, cfg.encoder.n_memory_tokens, cfg.encoder.d_memory)
    else:
        shape = (B, cfg.n_memory_tokens, cfg.d_memory)
    return (rng.standard_normal(shape) * 0.1).astype(np.float32)


# ---------------------------------------------------------------------------
# cross-attention and the encoder
# ---------------------------------------------------------------------------

# d_model 64 over a memory of width 24: the key/value projections read
# the memory's width
CROSS = dict(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
             d_memory=24)


@pytest.mark.parametrize("qk_norm", [False, True])
def test_cross_attn_forward_matches_jax(qk_norm):
    cfg_j = jget_config("granite_3_2b", reduced=True).replace(
        qk_norm=qk_norm, **CROSS)
    cfg = port_cfg(cfg_j)
    pj = _np(JL.gqa_init(jax.random.PRNGKey(1), cfg_j, jnp.float32,
                         cross=True))
    if qk_norm:
        pj["q_norm"]["w"] *= 1.5
        pj["k_norm"]["w"] *= 0.5
    pt = jax.tree.map(_t, pj)
    assert pt["wk"].shape == (24, 32) and pt["wq"].shape == (64, 64)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 37, 64)).astype(np.float32)
    mem = rng.standard_normal((2, 23, 24)).astype(np.float32)
    oj, (kj, vj) = JL.cross_attn_forward(pj, cfg_j, jnp.asarray(x),
                                         jnp.asarray(mem))
    ot, (kt, vt) = L.cross_attn_forward(pt, cfg, _t(x), _t(mem))
    assert ot.shape == (2, 37, 64) and kt.shape == (2, 23, 2, 16)
    _close(ot, oj, "out")
    _close(kt, kj, "k")
    _close(vt, vj, "v")
    assert set(pt) == set(L.gqa_init(torch.Generator(), cfg, cross=True))


def test_encode_matches_jax():
    cfg_j = jget_config("whisper_medium", reduced=True)
    cfg = get_config("whisper_medium", reduced=True)
    dj, dt = jax_state(cfg_j, cfg)
    frames = memory_for(cfg, 2, np.random.default_rng(3))
    want = JT.encode(cfg_j, dj, jnp.asarray(frames))
    got = T.encode(cfg, dt, _t(frames))
    assert got.shape == (2, cfg.encoder.n_memory_tokens, cfg.d_model)
    _close(got, want, "encoder output")


# ---------------------------------------------------------------------------
# the attention: soft-capping and the non-causal backward at Sq != Sk
# ---------------------------------------------------------------------------

def _qkvd(rng, Sq, Sk, Hkv=2, G=2, Dh=16, x=1.0):
    q, do = (rng.standard_normal((2, Sq, Hkv, G, Dh)).astype(np.float32) * s
             for s in (x, 1.0))
    k, v = (rng.standard_normal((2, Sk, Hkv, Dh)).astype(np.float32) * s
            for s in (x, 1.0))
    return q, k, v, do


def _port_grads(fn, q, k, v, do, **kw):
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    o = fn(tq, tk, tv, **kw)
    o.backward(torch.from_numpy(do))
    return o.detach(), (tq.grad, tk.grad, tv.grad)


# q, k x3: with the scale 0.25 the scores reach past the cap of 5
SOFTCAP = dict(scale=0.25, softcap=5.0)


@pytest.mark.parametrize("causal,window,Sk", [(True, 0, 37), (True, 9, 37),
                                              (False, 0, 23)],
                         ids=["causal", "window", "cross"])
def test_softcapped_grouped_attention_matches_jax_vjp(causal, window, Sk):
    """A capped call is the port's blockwise attention on every device
    (here one tile), held against ``jax.vjp`` of the JAX package's
    ``grouped_attention`` (its naive branch at these lengths)."""
    q, k, v, do = _qkvd(np.random.default_rng(4), 37, Sk, x=3.0)
    kw = dict(causal=causal, window=window, **SOFTCAP)
    oj, vjp = jax.vjp(lambda a, b, c: JL.grouped_attention(a, b, c, **kw),
                      q, k, v)
    ot, grads = _port_grads(L.grouped_attention, q, k, v, do, **kw)
    _close(ot, oj, "out")
    for name, got, want in zip("qkv", grads, vjp(do)):
        _share(got.numpy(), want, 2e-6, f"d{name}")
    capped = L._attn_naive(*(_t(a) for a in (q, k, v)), q_offset=0, **kw)
    plain = L._attn_naive(*(_t(a) for a in (q, k, v)), q_offset=0,
                          **{**kw, "softcap": 0.0})
    _close(capped, oj, "naive, capped")
    assert float((plain - capped).abs().max()) > 1e-2     # the cap bites


@pytest.mark.parametrize("causal,window,Sq,Sk,qoff",
                         [(True, 0, 70, 70, 0), (True, 12, 70, 70, 0),
                          (False, 0, 45, 70, 0), (True, 0, 20, 70, 50)],
                         ids=["causal", "window", "cross", "q_offset"])
def test_attn_blockwise_matches_jax_over_many_blocks(causal, window, Sq,
                                                     Sk, qoff):
    """``_attn_blockwise`` at blocks of 16 queries and 16 keys (ragged
    last blocks, wholly masked tiles skipped) against JAX's, forward and
    ``jax.vjp``, capped."""
    q, k, v, do = _qkvd(np.random.default_rng(5), Sq, Sk, x=3.0)
    kw = dict(causal=causal, window=window, q_offset=qoff, qblk=16,
              kblk=16, **SOFTCAP)
    oj, vjp = jax.vjp(lambda a, b, c: JL._attn_blockwise(a, b, c, **kw),
                      q, k, v)
    ot, grads = _port_grads(L._attn_blockwise, q, k, v, do, **kw)
    _close(ot, oj, "out")
    for name, got, want in zip("qkv", grads, vjp(do)):
        _share(got.numpy(), want, 1e-5, f"d{name}")


def test_softcapped_decode_attention_and_ring_match_jax():
    rng = np.random.default_rng(6)
    q = rng.standard_normal((2, 1, 2, 3, 16)).astype(np.float32) * 3
    kc = rng.standard_normal((2, 20, 2, 16)).astype(np.float32) * 3
    vc = rng.standard_normal((2, 20, 2, 16)).astype(np.float32)
    n = np.array([5, 20], np.int32)
    for window in (0, 4):
        _close(L.decode_attention(_t(q), _t(kc), _t(vc), _t(n), scale=0.25,
                                  window=window, softcap=5.0),
               JL.decode_attention(*(jnp.asarray(a) for a in (q, kc, vc, n)),
                                   scale=0.25, window=window, softcap=5.0),
               f"decode_attention window {window}")
    for cap in (0.0, 5.0):
        cfg_j = SLIDING.replace(head_dim=16, attn_logit_softcap=cap)
        ring = kc[:, :6]
        for lens in ((3, 6), (7, 13), (20, 25)):        # filling, wrapped
            ln = np.array(lens, np.int32)
            _close(L._decode_ring(_t(q), _t(ring), _t(vc[:, :6]), _t(ln), 4,
                                  port_cfg(cfg_j)),
                   JL._decode_ring(*(jnp.asarray(a) for a in
                                     (q, ring, vc[:, :6], ln)), 4, cfg_j),
                   f"ring cap {cap} len {lens}")


def test_noncausal_attention_backward_matches_jax_vjp(monkeypatch):
    """The port's attention backward (the kernel's plain forward here, the
    recompute backward) at a non-causal Sq != Sk with ragged tiles,
    against ``jax.vjp`` of ``_attn_naive``."""
    q, k, v, do = _qkvd(np.random.default_rng(7), 50, 37)
    kw = dict(scale=0.25, causal=False, window=0)
    _, vjp = jax.vjp(lambda a, b, c: JL._attn_naive(a, b, c, q_offset=0,
                                                    **kw), q, k, v)
    monkeypatch.setattr(flash, "Q_BLOCK", 16)
    monkeypatch.setattr(flash, "K_BLOCK", 16)
    _, grads = _port_grads(flash.flash_attention, q, k, v, do, **kw)
    assert grads[1].shape == (2, 37, 2, 16)
    for name, got, want in zip("qkv", grads, vjp(do)):
        _share(got.numpy(), want, 2e-6, f"d{name}")


# ---------------------------------------------------------------------------
# serving: the ring decode, prefill + decode at VLM, ENCDEC and SLIDING
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cap", [0.0, 5.0], ids=["plain", "softcap"])
def test_ring_cache_decode_wraps_like_jax(cap):
    """Decode 20 steps from ``cache_init``'s ring of min(30, 6) = 6 slots
    (it wraps from step 7 on): logits and the ring, slot for slot, against
    the JAX package's ``decode_step`` token by token."""
    cfg_j = SLIDING.replace(attn_logit_softcap=cap)
    cfg = port_cfg(cfg_j)
    dj, dt = jax_state(cfg_j, cfg)
    cj = JT.cache_init(cfg_j, 2, 30, jnp.float32)
    ct = T.cache_init(cfg, 2, 30, device="cpu")
    assert ct["stack"]["0"]["attn"]["k"].shape[2] == 6
    acts = np.random.default_rng(8).standard_normal(
        (20, 2, 1, cfg.d_model)).astype(np.float32)
    step = jax.jit(lambda c, a: JT.decode_step(cfg_j, dj, a, c))
    for t in range(20):
        lj, cj = step(cj, jnp.asarray(acts[t]))
        lt, ct = T.decode_step(cfg, dt, _t(acts[t]), ct)
        _close(lt[..., :cfg.vocab_size], lj[..., :cfg.vocab_size],
               f"step {t} logits")
    for key in ("k", "v"):
        _close(ct["stack"]["0"]["attn"][key], cj["stack"]["0"]["attn"][key],
               f"ring {key}")
    np.testing.assert_array_equal(ct["stack"]["0"]["attn"]["len"],
                                  cj["stack"]["0"]["attn"]["len"])


def _consistency(cfg_j, S=12, extra=3, atol=3e-5):
    """``test_models._consistency`` on the port (prefill + decode against
    its own full forward, within the JAX test's atol), and its prefill
    and decode logits and caches against the JAX package's."""
    cfg = port_cfg(cfg_j)
    dj, dt = jax_state(cfg_j, cfg)
    rng = np.random.default_rng(9)
    acts = rng.standard_normal((2, S + extra, cfg.d_model)).astype(
        np.float32)
    mem = memory_for(cfg, 2, rng) if (cfg.is_encdec or
                                      cfg.n_memory_tokens) else None
    pos = torch.arange(S + extra)[None].repeat(2, 1)
    with torch.no_grad():
        memory = None if mem is None else _t(mem)
        if cfg.is_encdec:
            memory = T.encode(cfg, dt, memory)
        h, _ = T.forward(cfg, dt, _t(acts), pos, memory)
        full = h @ dt["lm_head"]
    jmem = None if mem is None else jnp.asarray(mem)
    lj, cj = JT.prefill(cfg_j, dj, jnp.asarray(acts[:, :S]), memory=jmem,
                        max_len=S + extra)
    lt, ct = T.prefill(cfg, dt, _t(acts[:, :S]), mem, max_len=S + extra)
    _close(lt, lj, "prefill logits")
    diffs = [float((lt[:, 0] - full[:, S - 1]).abs().max())]
    for name, jc in jax.tree_util.tree_flatten_with_path(cj["stack"])[0]:
        tc = ct["stack"]
        for p in name:
            tc = tc[p.key]
        _close(tc, jc, f"prefill cache {jax.tree_util.keystr(name)}")
    for i in range(extra):
        a = acts[:, S + i:S + i + 1]
        lj, cj = JT.decode_step(cfg_j, dj, jnp.asarray(a), cj)
        lt, ct = T.decode_step(cfg, dt, _t(a), ct)
        V = cfg.vocab_size
        _close(lt[..., :V], lj[..., :V], f"decode {i} logits")
        diffs.append(float((lt[:, 0, :V] - full[:, S + i, :V]).abs().max()))
    assert max(diffs) < atol, diffs


@pytest.mark.parametrize("cfg", [VLM, ENCDEC, SLIDING], ids=lambda c: c.name)
def test_prefill_decode_consistency(cfg):
    _consistency(cfg)


def test_sliding_window_ring_long():
    """Decode far beyond the window from a prefill's full-length cache."""
    _consistency(SLIDING.replace(pattern_repeats=1), S=16, extra=8)
