"""The port's Mamba-2 mixer (repro_torch/models/mamba2.py) and the models
that use it (mamba2-1.3b, and the Jamba hybrid of mamba2, GQA and MoE
blocks in repro_torch/models/transformer.py) against the JAX package on
the CPU: the init's tree, the chunked SSD forward (a chunk multiple, a
ragged last chunk, a sequence under one chunk) with its decode state, the
recurrent decode, the step-by-step oracle, the gradients, and the models'
forward, prefill and teacher-forced decode with their SSM and KV caches;
the converter on both trees.

Inputs come from a numpy seed and go through both. Values at rtol 1e-4 /
atol 1e-5 (XLA and torch sum the SSD einsums in other orders); gradients
within 1e-5 of their leaf's largest |grad|. A Jamba run is held where it
routes as the JAX package does (``test_torch_moe.routed_alike``).

The JAX package's chunked SSD has NaN gradients at the published chunk of
256 (``src/repro/models/mamba2.py:120`` takes ``exp`` of the whole
segment-sum matrix before masking it; above the diagonal it overflows,
and the mask's gradient multiplies 0 by inf). The port masks before the
``exp``: at chunk 256 its gradients are finite and held against
``jax.grad`` of the JAX package's oracle, ``mamba2_reference_scan``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import mamba2 as JM
from repro.models import transformer as JT

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import mamba2 as M
from repro_torch.models import transformer as T
from test_torch_moe import record_routing, routed_alike

RTOL, ATOL = 1e-4, 1e-5
CFG_J = jget_config("mamba2_1_3b", reduced=True)
CFG = get_config("mamba2_1_3b", reduced=True)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL, err_msg=what)


def _share(got, want, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()),
                               err_msg=what)


def _params(cfg_j, seed=0):
    pj = JM.mamba2_init(jax.random.PRNGKey(seed), cfg_j)
    # a non-trivial norm weight, conv bias and skip
    pj["out_norm"]["w"] = pj["out_norm"]["w"] * 1.3
    pj["conv_b"] = pj["conv_b"] + 0.05
    pj["D"] = pj["D"] * 0.7
    return pj, jax.tree.map(lambda a: _t(a), _np_tree(pj))


# ---------------------------------------------------------------------------
# the mixer
# ---------------------------------------------------------------------------

def test_mamba2_init_has_the_jax_tree():
    pj = JM.mamba2_init(jax.random.PRNGKey(0), CFG_J)
    for lead in ((), (3,)):
        pt = M.mamba2_init(torch.Generator().manual_seed(0), CFG, lead=lead)
        want = jax.tree.map(lambda a: lead + a.shape, pj)
        got = jax.tree.map(lambda t: tuple(t.shape), pt)
        assert got == want
        assert all(t.dtype == torch.float32 for t in jax.tree.leaves(pt))
    pt = M.mamba2_init(torch.Generator().manual_seed(0), CFG, lead=(2,))
    # the deterministic leaves equal the JAX package's; the draws keep its
    # ranges (dt = softplus(dt_bias) in [1e-3, 1e-1])
    for k in ("A_log", "D", "conv_b"):
        np.testing.assert_allclose(pt[k][1].numpy(), np.asarray(pj[k]),
                                   rtol=1e-6)
    dt = torch.nn.functional.softplus(pt["dt_bias"])
    assert float(dt.min()) >= 1e-3 * 0.999 and float(dt.max()) <= 0.1001
    assert abs(float(pt["conv_w"].std()) - 0.2) < 0.02


@pytest.mark.parametrize("S", [64, 50, 3], ids=["chunks", "ragged", "short"])
def test_mamba2_forward_and_state_match_jax(S):
    """The chunked forward (chunk 32) and ``return_state``'s h and conv
    tail; the port's oracle against the JAX oracle and against its own
    chunked forward."""
    pj, pt = _params(CFG_J)
    x = np.random.default_rng(S).standard_normal(
        (2, S, CFG.d_model)).astype(np.float32)
    oj, sj = JM.mamba2_forward(pj, CFG_J, jnp.asarray(x), return_state=True)
    ot, st = M.mamba2_forward(pt, CFG, _t(x), return_state=True)
    _close(ot, oj, "out")
    _close(st["h"], sj["h"], "h")
    _close(st["conv"], sj["conv"], "conv")
    assert st["conv"].shape == (2, CFG.ssm_conv_width - 1,
                                2 * CFG.d_model + 2 * CFG.ssm_state)
    rt = M.mamba2_reference_scan(pt, CFG, _t(x))
    _close(rt, JM.mamba2_reference_scan(pj, CFG_J, jnp.asarray(x)), "oracle")
    _close(rt, ot, "oracle against chunked")


def test_mamba2_decode_matches_jax_and_updates_in_place():
    """Prefill's state, then 5 teacher-forced decode steps: outputs and
    the cache (h, conv) each step; the port writes the cache in place."""
    pj, pt = _params(CFG_J, seed=1)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 9, CFG.d_model)).astype(np.float32)
    nxt = rng.standard_normal((5, 2, 1, CFG.d_model)).astype(np.float32)
    _, cj = JM.mamba2_forward(pj, CFG_J, jnp.asarray(x), return_state=True)
    _, ct = M.mamba2_forward(pt, CFG, _t(x), return_state=True)
    cache = M.mamba2_cache_init(CFG, 2)
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {k: tuple(v.shape) for k, v in JM.mamba2_cache_init(
            CFG_J, 2, jnp.float32).items()}
    for k in cache:
        cache[k].copy_(ct[k])
    h_buf = cache["h"]
    for t in range(5):
        oj, cj = JM.mamba2_decode(pj, CFG_J, jnp.asarray(nxt[t]), cj)
        ot, cache = M.mamba2_decode(pt, CFG, _t(nxt[t]), cache)
        _close(ot, oj, f"decode {t}")
        for k in ("h", "conv"):
            _close(cache[k], cj[k], f"decode {t}: {k}")
    assert cache["h"] is h_buf
    # decoding a sequence token by token from zeros equals the forward
    cache = M.mamba2_cache_init(CFG, 2)
    outs = [M.mamba2_decode(pt, CFG, _t(x[:, i:i + 1]), cache)[0]
            for i in range(x.shape[1])]
    _close(torch.cat(outs, 1), M.mamba2_forward(pt, CFG, _t(x)),
           "token by token against the forward")


GRAD_CFG = dict(d_model=128, ssm_head_dim=32, ssm_state=16)


def _grads(cfg_j, cfg, fj, ft, S=256, seed=2):
    """jax.grad of ``fj`` and torch grads of ``ft`` (each a forward
    function) of ``sum(out * w)`` w.r.t. the parameters and the input."""
    pj, pt = _params(cfg_j, seed)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, S, cfg.d_model)).astype(np.float32)
    w = rng.standard_normal((1, S, cfg.d_model)).astype(np.float32)
    gj = jax.grad(lambda p, a: jnp.sum(fj(p, cfg_j, a) * w),
                  argnums=(0, 1))(pj, jnp.asarray(x))
    pt = jax.tree.map(lambda a: a.requires_grad_(), pt)
    xt = torch.tensor(x, requires_grad=True)
    torch.sum(ft(pt, cfg, xt) * torch.from_numpy(w)).backward()
    return gj, (jax.tree.map(lambda t: t.grad.numpy(), pt), xt.grad.numpy())


# against the step-by-step oracle (another algorithm), A_log and dt_bias
# within 1e-4 of their largest |grad|: they reach the output only through
# the decay's exponent, which the chunked form takes as a difference of
# fp32 cumulative sums over the chunk (|cum| 2^-24 of absolute error,
# growing with the chunk: measured 3.1e-6 at chunk 32, 3.2e-5 at 128,
# 5.4e-5 at 256, and JAX's chunked form 3.7e-6 at 32); every other leaf
# within 1e-5, as against the JAX chunked form
ORACLE_LOOSE = ("['A_log']", "['dt_bias']")


def _check_grads(got, want, what, loose=()):
    (gp, gx), (wp, wx) = got, want
    _share(gx, wx, f"{what}: dx")
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(wp)[0],
                            jax.tree.leaves(gp)):
        key = jax.tree_util.keystr(path)
        assert np.isfinite(g).all(), key
        w = np.asarray(w)
        share = 1e-4 if key in loose else 1e-5
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=share * float(np.abs(w).max()),
                                   err_msg=f"{what}: {key}")


def _finite(tree) -> bool:
    return all(np.isfinite(np.asarray(g)).all() for g in jax.tree.leaves(tree))


@pytest.mark.parametrize("chunk", [32, 128])
def test_mamba2_chunked_grads_match_jax(chunk):
    """The port's chunked gradients (S = 256: 8 or 2 chunks) against the
    JAX package's chunked gradients where those are finite (at chunk 32
    here), and always against ``jax.grad`` of the oracle. The JAX
    package's overflow depends on the data, not only on the chunk: a
    segment sum of -dt A over more than ~88 / (dt A) positions overflows,
    and at chunk 128 this input's largest dt A reach it (NaN there)."""
    cfg_j, cfg = (CFG_J.replace(ssm_chunk=chunk, **GRAD_CFG),
                  CFG.replace(ssm_chunk=chunk, **GRAD_CFG))
    want, got = _grads(cfg_j, cfg, JM.mamba2_forward, M.mamba2_forward)
    assert _finite(want) or chunk > 32
    if _finite(want):
        _check_grads(got, want, f"chunk {chunk}")
    oracle, _ = _grads(cfg_j, cfg, JM.mamba2_reference_scan,
                       M.mamba2_reference_scan)
    _check_grads(got, oracle, f"chunk {chunk} against the oracle",
                 ORACLE_LOOSE)


def test_mamba2_grads_at_chunk_256_are_finite_and_match_the_oracle():
    """At the published chunk of 256 the JAX package's chunked gradients
    are NaN (its fault, see the module doc); the port's are finite and
    match ``jax.grad`` of ``mamba2_reference_scan``."""
    cfg_j, cfg = (CFG_J.replace(ssm_chunk=256, **GRAD_CFG),
                  CFG.replace(ssm_chunk=256, **GRAD_CFG))
    oracle, got = _grads(cfg_j, cfg, JM.mamba2_reference_scan,
                         M.mamba2_forward)
    _check_grads(got, oracle, "chunk 256 against the oracle",
                 ORACLE_LOOSE)
    jchunked, _ = _grads(cfg_j, cfg, JM.mamba2_forward,
                         M.mamba2_reference_scan)
    bad = {jax.tree_util.keystr(p) for p, g in
           jax.tree_util.tree_flatten_with_path(jchunked[0])[0]
           if not np.isfinite(np.asarray(g)).all()}
    assert {"['in_proj']", "['A_log']", "['dt_bias']"} <= bad


# ---------------------------------------------------------------------------
# the models: mamba2-1.3b and Jamba, reduced
# ---------------------------------------------------------------------------

MODELS = ["mamba2_1_3b", "jamba_v0_1_52b"]


def _model(arch, seed=0):
    cfg_j, cfg = jget_config(arch, reduced=True), get_config(arch,
                                                              reduced=True)
    dj = JT.init_dense(cfg_j, jax.random.PRNGKey(seed))
    return cfg_j, cfg, dj, convert.lm_dense_from_numpy(_np_tree(dj), cfg,
                                                       device="cpu")


@pytest.mark.parametrize("arch", MODELS)
def test_lm_dense_from_numpy_takes_the_tree_leaf_for_leaf(arch):
    """Every leaf of the JAX tree (the mamba2 mixers' in_proj, conv_w,
    conv_b, A_log, dt_bias, D, out_norm and out_proj; no ffn_norm in a
    block without an FFN) arrives unchanged under its own key."""
    cfg_j, cfg, dj, dt = _model(arch)
    want = _np_tree(dj)
    assert jax.tree.structure(jax.tree.map(lambda a: 0, want)) == \
        jax.tree.structure(jax.tree.map(lambda a: 0, dt))
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(dt)):
        np.testing.assert_array_equal(b.numpy(), a)
    mixer = dt["stack"]["0"]["mixer"]
    assert set(mixer) == {"in_proj", "conv_w", "conv_b", "A_log", "dt_bias",
                          "D", "out_norm", "out_proj"}
    if arch == "mamba2_1_3b":
        assert set(dt["stack"]["0"]) == {"mixer_norm", "mixer"}
    own = T.init_dense(cfg, torch.Generator().manual_seed(0))
    assert jax.tree.map(lambda t: tuple(t.shape), own) == \
        jax.tree.map(lambda t: tuple(t.shape), dt)


def _n_moe(cfg):
    return sum(b.ffn == "moe" for b in cfg.pattern) * cfg.pattern_repeats


@pytest.mark.parametrize("arch", MODELS)
def test_forward_prefill_and_decode_match_jax(arch):
    """``forward`` (hidden states and aux), ``prefill`` (logits and every
    cache: SSM h and conv, the GQA layer's K/V and len) and 4
    teacher-forced ``decode_step``s against the JAX package; Jamba held
    while it routes alike."""
    cfg_j, cfg, dj, dt = _model(arch)
    rng = np.random.default_rng(7)
    B, S, n_dec = 2, 37, 4
    acts = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    nxt = rng.standard_normal((n_dec, B, 1, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    with record_routing() as (jrec, trec):
        xj, aj = JT.forward(cfg_j, dj, jnp.asarray(acts), jnp.asarray(pos))
        lj, cj = JT.prefill(cfg_j, dj, jnp.asarray(acts), max_len=S + n_dec)
        step = jax.jit(lambda c, a: JT.decode_step(cfg_j, dj, a, c))
        lj_dec = []
        for t in range(n_dec):
            lg, cj = step(cj, jnp.asarray(nxt[t]))
            lj_dec.append((lg, cj))
        jax.effects_barrier()
        with torch.no_grad():
            xt, at = T.forward(cfg, dt, _t(acts), _t(pos))
            lt, ct = T.prefill(cfg, dt, _t(acts), max_len=S + n_dec)
            lt_dec = []
            for t in range(n_dec):
                lg, ct = T.decode_step(cfg, dt, _t(nxt[t]), ct)
                lt_dec.append((lg.clone(), jax.tree.map(
                    lambda v: v.clone(), ct)))
    n = _n_moe(cfg)
    calls = 2 + n_dec                   # forward, prefill, each decode
    assert len(trec) == n * calls
    alike = calls if n == 0 else routed_alike(jrec, trec, cfg.moe_top_k) // n
    assert alike >= 2, "forward or prefill routed apart"
    _close(xt, xj, "forward")
    assert set(at) == set(aj)
    for k in aj:
        _close(at[k], aj[k], k)
    _close(lt, lj, "prefill logits")
    for i, blk in enumerate(cfg.pattern):
        assert set(ct["stack"][str(i)]) == \
            {"ssm" if blk.mixer == "mamba2" else "attn"}
    for t in range(min(n_dec, alike - 2)):
        (lg, cg), (lw, cw) = lt_dec[t], lj_dec[t]
        _close(lg, lw, f"decode {t} logits")
        for i, blk in enumerate(cfg.pattern):
            g, w = cg["stack"][str(i)], cw["stack"][str(i)]
            if blk.mixer == "mamba2":
                for k in ("h", "conv"):
                    _close(g["ssm"][k], w["ssm"][k], f"decode {t}: {i} {k}")
            else:
                for k in ("k", "v"):
                    _close(g["attn"][k], w["attn"][k], f"decode {t}: {i} {k}")
                np.testing.assert_array_equal(g["attn"]["len"],
                                              w["attn"]["len"])
        np.testing.assert_array_equal(cg["pos"], cw["pos"])
    assert (lt_dec[-1][0][..., cfg.vocab_size:] == -1e30).all()
