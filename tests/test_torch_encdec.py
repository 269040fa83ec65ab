"""LM training over a memory: the port's reduced whisper-medium (the
encoder-decoder: frames through the encoder, the decoder's
cross-attention over its output, learned decoder positions) and reduced
llama-3.2-vision-90b (tanh-gated cross-attention layers over image
patches) against the JAX package on the CPU, from one JAX-initialised
state with every ``xgate`` at 0.5 (at its init value 0 the gated layer
adds nothing): ``lm_loss`` value and gradients with ``memory`` (the
encoder's weights included), and 3 ``PersiaTrainer(lm_adapter)`` steps in
sync and hybrid(2) against the JAX trainer, the memory riding in each
batch as numpy.

Tolerance classes, those of ``test_torch_lm_models_train.py``: the loss
rtol 1e-5 and every gradient within 1e-5 of its leaf's largest |grad|
(allclose: XLA and torch reduce in other orders); after the steps the
losses and ``emb_grad_norm`` rtol 1e-5 a step and the trained state in
the trajectory class (Adam's updates agree in norm to 1e-3); the port's
checkpointed layers (decoder and encoder) give the no-remat gradients
bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import transformer as JT

from repro_torch.configs import get_config
from repro_torch.data.lm import lm_batches
from repro_torch.kernels import ops
from repro_torch.models import transformer as T
from repro_torch.utils import tree_leaves, tree_map
from test_torch_cross import _np, jax_state, memory_for, open_gates
from test_torch_lm_models_train import _check_trajectory, _trainers
from test_torch_lm_train import _carry, _close, _flat, _jb, _share

ARCHS = ["whisper_medium", "llama_3_2_vision_90b"]
B, S = 2, 16


def _cfgs(arch):
    return jget_config(arch, reduced=True), get_config(arch, reduced=True)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_with_memory_matches_jax(arch, monkeypatch):
    """``lm_loss`` over a memory and its gradients w.r.t. every dense leaf
    and the activations against ``jax.grad``; with remat off the port's
    gradients are the remat ones bit for bit, and a step makes one
    attention forward a layer more with remat (the recompute)."""
    cfg_j, cfg = _cfgs(arch)
    dj, dt = jax_state(cfg_j, cfg, seed=1)
    rng = np.random.default_rng(3)
    acts = (rng.standard_normal((B, S, cfg.d_model)) * 0.5).astype(
        np.float32)
    tg = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) < 0.8).astype(np.float32)
    mem = memory_for(cfg, B, rng)
    (lj, _), (gdj, gaj) = jax.value_and_grad(
        lambda d, a: JT.lm_loss(cfg_j, d, a, tg, mask, jnp.asarray(mem)),
        argnums=(0, 1), has_aux=True)(dj, jnp.asarray(acts))
    calls = []
    fwd = ops.flash_attention_fwd
    monkeypatch.setattr(ops, "flash_attention_fwd",
                        lambda *a, **kw: calls.append(1) or fwd(*a, **kw))
    runs = []
    for remat in (True, False):
        params = tree_map(lambda x: x.detach().clone().requires_grad_(), dt)
        ta = torch.tensor(acts, requires_grad=True)
        calls.clear()
        c = cfg.replace(remat=remat)
        if cfg.is_encdec:
            c = c.replace(encoder=cfg.encoder.replace(remat=remat))
        lt, mt = T.lm_loss(c, params, ta, tg, mask, mem)
        lt.backward()
        runs.append((lt.detach(), ta.grad, params, len(calls)))
    lt, ga, params, n_remat = runs[0]
    _close(float(lt), float(lj), 1e-5, 0, "loss")
    assert set(mt) == {"loss", "ppl_log"}
    _share(ga.numpy(), gaj, 1e-5, "acts grad")
    got = {k: p.grad.numpy() for k, p in _flat(params).items()}
    want = _flat(_np(gdj))
    assert set(got) == set(want)
    for k in want:
        _share(got[k], want[k], 1e-5, k)
    assert torch.equal(runs[1][0], lt) and torch.equal(runs[1][1], ga)
    for x, y in zip(tree_leaves(runs[1][2]), tree_leaves(params)):
        assert torch.equal(x.grad, y.grad)
    # attentions a step: encoder layers, the decoder's self- and cross-
    # attentions (one kernel call each), twice with remat
    n_attn = sum((b.mixer in ("gqa", "cross_attn")) + b.cross
                 for b in cfg.pattern) * cfg.pattern_repeats
    if cfg.is_encdec:
        n_attn += len(cfg.encoder.pattern) * cfg.encoder.pattern_repeats
    assert (n_remat, runs[1][3]) == (2 * n_attn, n_attn)


@pytest.mark.parametrize("mode", ["sync", "hybrid"])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_trainer_with_memory_matches_jax(arch, mode):
    """3 ``step``s of ``PersiaTrainer(lm_adapter)`` with a memory in each
    batch against the JAX trainer's from one JAX-initialised state (gates
    open): losses and ``emb_grad_norm`` each step, then the trained state
    in the trajectory class."""
    cfg_j, cfg = _cfgs(arch)
    jt, tt = _trainers(cfg_j, cfg, mode)
    it = lm_batches(cfg.vocab_size, B, S, seed=3)
    rng = np.random.default_rng(4)
    bs = [dict(next(it), memory=memory_for(cfg, B, rng)) for _ in range(4)]
    js = jt.init(jax.random.PRNGKey(0), _jb(bs[0]))
    js = js.replace(dense=jax.tree.map(jnp.asarray,
                                       open_gates(_np(js.dense))))
    start = _np(js)
    ts = _carry(tt, js)
    jl, jn, tl, tn = [], [], [], []
    for b in bs[1:]:
        js, m = jt.step(js, _jb(b))
        jl.append(float(m["loss"]))
        jn.append(float(m["emb_grad_norm"]))
        ts, m = tt.step(ts, b)
        tl.append(float(m["loss"]))
        tn.append(float(m["emb_grad_norm"]))
    assert all(np.isfinite(tl))
    _close(tl, jl, 1e-5, 0, "losses")
    _close(tn, jn, 1e-5, 0, "emb_grad_norm")
    _check_trajectory(ts, js, start, 3)
