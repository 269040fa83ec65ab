"""The port's LM serving path (repro_torch/models, launch/serve) against the
JAX package on the CPU: layers, prefill and decode with their KV caches,
and the serve driver from the JAX package's own state (granite, and the
reduced variants of every other architecture: qwen3, phi3,
deepseek-coder, DeepSeek-V2's mla + MoE, held while their routing is the
JAX package's, as ``test_torch_mla.py`` holds it, Mamba-2, Jamba,
Llama-3.2-Vision and Whisper, the last two over the memory the JAX serve
draws).

Tolerance (allclose): XLA and torch reduce matmuls and softmax sums in
other orders, and the port's prefill attention runs the flash kernel's
plain version where the JAX package runs ``_attn_naive`` (the same
arithmetic), so layer outputs, logits and caches are held to rtol 1e-4 /
atol 1e-5. Greedy tokens must be equal wherever the JAX logits' top-2
margin exceeds 1e-3; after the first step of a row at or under that margin
the two trajectories may part, so the row is compared up to there.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.backend import create_backend as jcreate_backend
from repro.launch import serve as jserve
from repro.launch import shards as jshards
from repro.models import layers as JL
from repro.models import transformer as JT

from repro_torch import convert
from repro_torch.configs import ARCH_IDS, BlockCfg, get_config
from repro_torch.launch import serve as tserve
from repro_torch.launch import shards
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from test_torch_moe import record_routing, routed_alike

RTOL, ATOL = 1e-4, 1e-5
CFG_J = jget_config("granite_3_2b", reduced=True).replace(pattern_repeats=2)
CFG = get_config("granite_3_2b", reduced=True).replace(pattern_repeats=2)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL, err_msg=what)


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("name", [a for a in ARCH_IDS if a != "mamba2_1_3b"]
                         + ["granite-3-2b", "mamba2_1_3b"])
def test_configs_copy_the_jax_package(name, reduced):
    """Every architecture is the JAX package's configuration, field for
    field (the reduced variant too, and an encoder-decoder's encoder)."""
    t, j = get_config(name, reduced=reduced), \
        jget_config(name, reduced=reduced)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for f in ("padded_vocab", "n_layers", "is_encdec", "has_attention"):
        assert getattr(t, f) == getattr(j, f), f


@pytest.mark.parametrize("arg", [3, "2", "vocab=4,field_00=2", None])
def test_shards_grammar_matches_jax(arg):
    assert shards.parse_emb_shards(arg) == jshards.parse_emb_shards(arg)
    p = shards.parse_emb_shards(arg)
    assert shards.shards_for_table(p, "vocab") == \
        jshards.shards_for_table(p, "vocab")
    assert shards.default_cache_rows(49_155) == \
        jshards.default_cache_rows(49_155)


def test_build_embedding_spec_refuses_what_is_not_ported():
    spec = shards.build_embedding_spec(1024, 64, backend="dense+compressed")
    assert (spec.rows, spec.dim, spec.backend) == (1024, 64,
                                                   "dense+compressed")
    for arg in ("vocab=2", 3, "field_00=2"):
        assert shards.build_embedding_spec(1024, 64, emb_shards=arg) \
            .emb_shards == jshards.build_embedding_spec(
                1024, 64, emb_shards=arg).emb_shards
    spec = shards.build_embedding_spec(1024, 64, backend="host_lru")
    assert (spec.backend, spec.cache_rows) == (
        "host_lru", jshards.build_embedding_spec(
            1024, 64, backend="host_lru").cache_rows)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_rmsnorm_layernorm_and_rope_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 64)).astype(np.float32) * 3
    w = rng.standard_normal(64).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    _close(L.rmsnorm(_t(x), _t(w), 1e-5),
           JL.rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-5))
    _close(L.layernorm(_t(x), _t(w), _t(b), 1e-5),
           JL.layernorm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                        1e-5))
    pos = np.array([[0, 1, 7, 300, 2047]] * 2, np.int32)
    _close(L.apply_rope(_t(x), _t(pos), 10_000.0),
           JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0))


@pytest.mark.parametrize("qk_norm", [False, True])
def test_gqa_forward_and_mlp_match_jax(qk_norm):
    cfg_j, cfg = (c.replace(qk_norm=qk_norm) for c in (CFG_J, CFG))
    pj = JL.gqa_init(jax.random.PRNGKey(1), cfg_j, jnp.float32)
    if qk_norm:      # non-trivial norm weights
        pj["q_norm"]["w"] = pj["q_norm"]["w"] * 1.5
        pj["k_norm"]["w"] = pj["k_norm"]["w"] * 0.5
    pt = jax.tree.map(lambda a: _t(a), _np_tree(pj))
    rng = np.random.default_rng(2)
    B, S = 2, 37
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    oj, (kj, vj) = JL.gqa_forward(pj, cfg_j, jnp.asarray(x),
                                  jnp.asarray(pos))
    ot, (kt, vt) = L.gqa_forward(pt, cfg, _t(x), _t(pos))
    _close(ot, oj, "out")
    _close(kt, kj, "k")
    _close(vt, vj, "v")
    mj = JL.mlp_init(jax.random.PRNGKey(3), cfg_j)
    mt = jax.tree.map(lambda a: _t(a), _np_tree(mj))
    _close(L.mlp_forward(mt, cfg, _t(x)),
           JL.mlp_forward(mj, cfg_j, jnp.asarray(x)), "mlp")


def test_gelu_mlp_matches_jax():
    cfg_j, cfg = (c.replace(ffn_act="gelu") for c in (CFG_J, CFG))
    mj = JL.mlp_init(jax.random.PRNGKey(4), cfg_j)
    mt = jax.tree.map(lambda a: _t(a), _np_tree(mj))
    x = np.random.default_rng(5).standard_normal(
        (3, 4, cfg.d_model)).astype(np.float32)
    assert "wg" not in mt
    _close(L.mlp_forward(mt, cfg, _t(x)),
           JL.mlp_forward(mj, cfg_j, jnp.asarray(x)))


def test_decode_attention_matches_jax():
    rng = np.random.default_rng(6)
    q = rng.standard_normal((2, 1, 2, 3, 16)).astype(np.float32)
    kc = rng.standard_normal((2, 20, 2, 16)).astype(np.float32)
    vc = rng.standard_normal((2, 20, 2, 16)).astype(np.float32)
    n = np.array([5, 20], np.int32)
    for window in (0, 4):
        _close(L.decode_attention(_t(q), _t(kc), _t(vc), _t(n), scale=0.25,
                                  window=window),
               JL.decode_attention(*(jnp.asarray(a) for a in (q, kc, vc, n)),
                                   scale=0.25, window=window))


# every block kind of the JAX package in one narrow model: mixers x FFNs x
# the cross-attention sub-block
ALL_KINDS = [BlockCfg(m, f, c) for m in ("gqa", "mla", "mamba2",
                                         "cross_attn", "none")
             for f in ("dense", "moe", "none") for c in (False, True)]
KINDS = dict(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
             vocab_size=128, n_experts=4, moe_top_k=2, moe_d_ff=32,
             capacity_factor=8.0, kv_lora_rank=32, rope_head_dim=8,
             v_head_dim=16, ssm_state=16, ssm_head_dim=16, ssm_chunk=4,
             n_memory_tokens=8, d_memory=24, pattern_repeats=2)


def _shapes(tree):
    return jax.tree.map(lambda a: tuple(a.shape), tree)


def test_arch_ids_and_every_block_kind_are_ported():
    """The port's ``ARCH_IDS`` are the JAX package's, and ``init_dense``
    and ``cache_init`` build the JAX package's trees, key for key and
    shape for shape, for every block kind (each mixer, FFN and the
    cross-attention sub-block, the ``cross_attn`` mixer's gate); a
    prefill and decode steps through all of them give finite logits."""
    from repro.configs import ARCH_IDS as JARCH_IDS
    assert set(ARCH_IDS) == set(JARCH_IDS)
    cfg_j = jget_config("granite_3_2b").replace(pattern=tuple(ALL_KINDS),
                                                **KINDS)
    cfg = get_config("granite_3_2b").replace(pattern=tuple(ALL_KINDS),
                                             **KINDS)
    want = jax.eval_shape(lambda k: JT.init_dense(cfg_j, k),
                          jax.random.PRNGKey(0))
    dense = T.init_dense(cfg, torch.Generator().manual_seed(0))
    assert _shapes(dense) == _shapes(want)
    assert all(p["xgate"].shape == (2,) and not p["xgate"].any()
               for p in dense["stack"].values() if "xgate" in p)
    jc = jax.eval_shape(lambda: JT.cache_init(cfg_j, 2, 9, jnp.float32,
                                              memory_len=8))
    tc = T.cache_init(cfg, 2, 9, memory_len=8, device="cpu")
    assert _shapes(tc) == _shapes(jc)
    for p in dense["stack"].values():
        if "xgate" in p:
            p["xgate"].fill_(0.5)
    rng = np.random.default_rng(0)
    acts = torch.tensor(rng.standard_normal((2, 6, 64)), dtype=torch.float32)
    mem = rng.standard_normal((2, 8, 24)).astype(np.float32) * 0.1
    logits, caches = T.prefill(cfg, dense, acts, mem, max_len=9)
    for _ in range(3):
        logits, caches = T.decode_step(cfg, dense, acts[:, :1], caches)
        assert torch.isfinite(logits[..., :cfg.vocab_size]).all()
    assert int(caches["pos"][0]) == 9


# ---------------------------------------------------------------------------
# prefill + decode with KV caches
# ---------------------------------------------------------------------------

def _jax_dense(cfg_j, seed=0):
    dj = JT.init_dense(cfg_j, jax.random.PRNGKey(seed))
    return dj, convert.lm_dense_from_numpy(_np_tree(dj), CFG, device="cpu")


def _check_caches(tc, jc, what):
    """The whole (R, B, max_len, Hkv, Dh) caches, the unwritten tail
    (zeros on both sides) included, and the lengths exactly."""
    for key in ("k", "v"):
        _close(tc["stack"]["0"]["attn"][key],
               jc["stack"]["0"]["attn"][key], f"{what}: cache {key}")
    np.testing.assert_array_equal(tc["stack"]["0"]["attn"]["len"],
                                  jc["stack"]["0"]["attn"]["len"])
    np.testing.assert_array_equal(tc["pos"], jc["pos"])


def test_prefill_and_teacher_forced_decode_match_jax():
    dj, dt = _jax_dense(CFG_J)
    rng = np.random.default_rng(7)
    B, S, n_dec = 2, 11, 4
    acts = rng.standard_normal((B, S, CFG.d_model)).astype(np.float32)
    nxt = rng.standard_normal((n_dec, B, 1, CFG.d_model)).astype(np.float32)
    lj, cj = JT.prefill(CFG_J, dj, jnp.asarray(acts), max_len=S + n_dec)
    lt, ct = T.prefill(CFG, dt, _t(acts), max_len=S + n_dec)
    assert ct["stack"]["0"]["attn"]["k"].shape == \
        cj["stack"]["0"]["attn"]["k"].shape
    _close(lt, lj, "prefill logits")
    _check_caches(ct, cj, "prefill")
    step = jax.jit(lambda c, a: JT.decode_step(CFG_J, dj, a, c))
    for t in range(n_dec):
        lj, cj = step(cj, jnp.asarray(nxt[t]))
        lt, ct = T.decode_step(CFG, dt, _t(nxt[t]), ct)
        _close(lt, lj, f"decode {t} logits")
        _check_caches(ct, cj, f"decode {t}")
    # pad-vocab columns masked in decode, as in JAX
    assert (lt[..., CFG.vocab_size:] == -1e30).all()


def test_lm_dense_from_numpy_checks_the_tree():
    dj, _ = _jax_dense(CFG_J)
    tree = _np_tree(dj)
    tree["stack"]["0"]["ffn"].pop("wg")
    with pytest.raises(ValueError, match="keys"):
        convert.lm_dense_from_numpy(tree, CFG, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        convert.lm_dense_from_numpy(_np_tree(dj), CFG.replace(
            pattern_repeats=3), device="cpu")


# ---------------------------------------------------------------------------
# the serve driver from the JAX package's state
# ---------------------------------------------------------------------------

def _jax_state(cfg_j, seed, backend_name):
    """The state ``repro.launch.serve.serve`` builds (serve.py:29-36)."""
    key = jax.random.PRNGKey(seed)
    dense = JT.init_dense(cfg_j, key)
    spec = jshards.build_embedding_spec(cfg_j.vocab_size, cfg_j.d_model,
                                        backend=backend_name, table="vocab")
    backend = jcreate_backend(spec)
    emb = backend.init(jax.random.split(key, 1)[0])
    return dense, backend, emb


def _jax_margins(cfg_j, dense, backend, emb, prompts, tokens, memory=None):
    """Top-2 margin of JAX's logits at every generated step, along JAX's
    own greedy trajectory (teacher forcing ``tokens``), over ``memory``
    (the serve's) for a model with cross-attention."""
    def top2(logits):
        s = np.sort(np.asarray(logits), axis=-1)
        return s[:, -1] - s[:, -2]

    acts, _ = backend.lookup(emb, jnp.asarray(prompts))
    logits, caches = JT.prefill(cfg_j, dense, acts, memory=memory,
                                max_len=prompts.shape[1] + tokens.shape[1])
    out = [top2(logits[:, 0, :cfg_j.vocab_size])]
    for t in range(tokens.shape[1] - 1):
        acts, _ = backend.lookup(emb, jnp.asarray(tokens[:, t:t + 1]))
        logits, caches = JT.decode_step(cfg_j, dense, acts, caches)
        out.append(top2(logits[:, 0, :cfg_j.vocab_size]))
    return np.stack(out, axis=1)


# granite at its full depth, narrow: the JAX side scans the 40 layers, so
# its compile stays small
NARROW_40 = dict(pattern_repeats=40, d_model=64, n_heads=4, n_kv_heads=2,
                 head_dim=16, rope_head_dim=16, v_head_dim=16, d_ff=128,
                 d_memory=64)


@pytest.mark.parametrize("backend_name,layers",
                         [("dense", 2), ("dense+compressed", 2),
                          ("dense", 40)],
                         ids=["dense", "dense+compressed", "dense-40_layers"])
def test_serve_from_jax_state_matches_jax(backend_name, layers):
    B, P, G, seed = 2, 8, 6, 3
    cfg_j, cfg = (CFG_J, CFG) if layers == 2 else \
        (CFG_J.replace(**NARROW_40), CFG.replace(**NARROW_40))
    dense, jbackend, emb = _jax_state(cfg_j, seed, backend_name)
    spec = shards.build_embedding_spec(cfg.vocab_size, cfg.d_model,
                                       backend=backend_name)
    state = (convert.emb_from_numpy(_np_tree(emb), spec, device="cpu"),
             convert.lm_dense_from_numpy(_np_tree(dense), cfg,
                                         device="cpu"))
    want = jserve.serve(cfg_j, B, P, G, seed=seed, emb_backend=backend_name)
    got = tserve.serve(cfg, B, P, G, seed=seed, emb_backend=backend_name,
                       device="cpu", state=state)
    assert set(got) == set(want)
    assert got["tokens"].shape == want["tokens"].shape == (B, G)
    assert got["tokens"].dtype == np.int32
    prompts = tserve.make_prompts(cfg, B, P, seed)
    margins = _jax_margins(cfg_j, dense, jbackend, emb, prompts,
                           want["tokens"])
    compared = 0
    for b in range(B):
        for t in range(G):
            assert got["tokens"][b, t] == want["tokens"][b, t] or \
                margins[b, t] <= 1e-3, (b, t, margins[b])
            if margins[b, t] <= 1e-3:
                break
            compared += 1
    assert compared >= B      # at least each row's first token


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS
                                  if a != "granite_3_2b"])
def test_reduced_serve_matches_jax(arch):
    """``serve`` of each other architecture's reduced variant from the JAX
    serve's own state (its memory drawn as the JAX serve draws it), under
    the token-or-margin rule; a MoE
    model's rows are compared up to the step of its first MoE call that
    routed a token otherwise than the JAX package (within 1e-5 of a top-k
    boundary: ``test_torch_moe.routed_alike``)."""
    B, P, G, seed = 2, 8, 5, 3
    cfg_j, cfg = jget_config(arch, reduced=True), get_config(arch,
                                                              reduced=True)
    dense, jbackend, emb = _jax_state(cfg_j, seed, "dense")
    spec = shards.build_embedding_spec(cfg.vocab_size, cfg.d_model)
    state = (convert.emb_from_numpy(_np_tree(emb), spec, device="cpu"),
             convert.lm_dense_from_numpy(_np_tree(dense), cfg,
                                         device="cpu"))
    with record_routing() as (jrec, trec):
        want = jserve.serve(cfg_j, B, P, G, seed=seed)
        got = tserve.serve(cfg, B, P, G, seed=seed, device="cpu",
                           state=state)
        jax.effects_barrier()
    n_moe = sum(b.ffn == "moe" for b in cfg.pattern) * cfg.pattern_repeats
    assert len(trec) == n_moe * G
    routed = G if n_moe == 0 else \
        routed_alike(jrec, trec, cfg.moe_top_k) // n_moe
    assert got["tokens"].shape == want["tokens"].shape == (B, G)
    prompts, memory = tserve.make_inputs(cfg, B, P, seed)
    margins = _jax_margins(cfg_j, dense, jbackend, emb, prompts,
                           want["tokens"], memory)
    compared = 0
    for b in range(B):
        for t in range(routed):
            assert got["tokens"][b, t] == want["tokens"][b, t] or \
                margins[b, t] <= 1e-3, (b, t, margins[b])
            if margins[b, t] <= 1e-3:
                break
            compared += 1
    assert compared >= B      # at least each row's first token


def test_prompts_match_jax():
    rng = np.random.default_rng(11)
    want = rng.integers(0, CFG.vocab_size, (3, 5))
    np.testing.assert_array_equal(tserve.make_prompts(CFG, 3, 5, 11), want)


def test_serve_defaults_and_temperature_on_cpu():
    res = tserve.serve(CFG, 2, 5, 4, seed=1, temperature=0.8, device="cpu")
    assert res["tokens"].shape == (2, 4)
    assert ((res["tokens"] >= 0) & (res["tokens"] < CFG.vocab_size)).all()
    again = tserve.serve(CFG, 2, 5, 4, seed=1, temperature=0.8,
                         device="cpu")
    np.testing.assert_array_equal(res["tokens"], again["tokens"])
    assert res["decode_tok_per_s"] > 0
    lru = tserve.serve(CFG, 2, 5, 4, seed=1, temperature=0.8,
                       emb_backend="host_lru", device="cpu")
    np.testing.assert_array_equal(lru["tokens"], res["tokens"])
