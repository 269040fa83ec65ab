"""The port's training slice (repro_torch) against the JAX package, on the
CPU, from the same numpy inputs and the same starting state.

Tolerance classes (stated per comparison below):
* bit-exact: integer and ring logic (queue ids, ``ptr``, ``filled``, the
  step, Adam's ``t``), ``plan_segment_sum`` (occurrence-order sums on both
  sides), copies (checkpoints), and a step against the same step on the
  same device;
* allclose, the FFNN's class: XLA and torch pick different reduction
  orders inside the matrix products, and XLA's CPU ``rsqrt`` and ``pow``
  round differently from torch's. Per step: loss and ``emb_grad_norm``
  rtol 1e-5; after 4 steps: tables, dense params and queued grads rtol
  1e-5 atol 1e-6, accumulators rtol 1e-5 atol 1e-9, Adam m rtol 1e-4 atol
  1e-8 and v rtol 1e-4 atol 1e-12 (the moments of near-zero gradients
  carry the products' rounding at full relative weight).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs.base import ModelConfig as JConfig
from repro.core import adapters as jadapters
from repro.core import backend as jbackend
from repro.core import dedup as jdedup
from repro.core import embedding_ps as jps
from repro.core import hybrid as jhybrid
from repro.data import ctr as jctr
from repro.optim import optimizers as jopt

from repro_torch import convert
from repro_torch.checkpoint import ckpt
from repro_torch.configs import base as tbase
from repro_torch.core import adapters, backend, dedup, embedding_ps, hybrid
from repro_torch.core.embedding_ps import EmbeddingSpec
from repro_torch.core.hybrid import PersiaTrainer, TrainMode
from repro_torch.data import ctr
from repro_torch.optim import optimizers as topt

F, RPF, D, B = 3, 50, 8, 32
CFG = tbase.ModelConfig(name="slice", arch_type="recsys", n_id_fields=F,
                        ids_per_field=4, emb_dim=D, emb_rows=F * RPF,
                        n_dense_features=4, mlp_dims=(16,), n_tasks=2)
DS = ctr.CTRDataset("slice", n_rows=F * RPF, n_fields=F, ids_per_field=4,
                    n_dense=4, n_tasks=2)
EMB_LR, DENSE_LR = 5e-2, 3e-3
MODES = {"sync": ((), ()), "hybrid": ((3,), (3,)), "async": ((2, 2), (2, 2))}


def _modes(name):
    j = {"sync": jhybrid.TrainMode.sync, "hybrid": jhybrid.TrainMode.hybrid,
         "async": jhybrid.TrainMode.async_}[name]
    t = {"sync": TrainMode.sync, "hybrid": TrainMode.hybrid,
         "async": TrainMode.async_}[name]
    return j(*MODES[name][0]), t(*MODES[name][1])


def _trainers(mode):
    jm, tm = _modes(mode)
    jcfg = JConfig(**dataclasses.asdict(CFG))
    jds = jctr.CTRDataset(**dataclasses.asdict(DS))
    jt = jhybrid.PersiaTrainer(
        jadapters.recsys_adapter(jcfg, lr=EMB_LR, field_rows=jds.field_rows()),
        jm, jopt.OptConfig(kind="adam", lr=DENSE_LR))
    tt = PersiaTrainer(
        adapters.recsys_adapter(CFG, lr=EMB_LR, field_rows=DS.field_rows()),
        tm, topt.OptConfig(kind="adam", lr=DENSE_LR), device="cpu")
    return jt, tt


def _batches(n, seed=5):
    it = DS.sampler(B, seed=seed)
    return [next(it) for _ in range(n)]


def _to_np(t):
    return jax.tree.map(np.asarray, t)


def _carry(tt, js):
    """The port's state from a JAX state, through numpy."""
    return convert.state_from_numpy(
        tt, _to_np(js.dense), _to_np(js.emb), opt=_to_np(js.opt),
        emb_queue=_to_np(js.emb_queue), dense_queue=_to_np(js.dense_queue),
        step=int(js.step))


def _close(got, want, rtol, atol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


def _leaves(tree):
    return jax.tree.leaves(tree)


def _close_lossy(got, want, atol, what):
    """The FFNN's class through the lossy wire: the two packages' payloads
    differ in their last bits (the FFNN's class), so once in a while a value
    lies on an fp16 rounding boundary and rounds up on one side and down on
    the other, moving one element by one fp16 step of its block. At most 1%
    of the elements may leave rtol 1e-5 / atol 1e-6, each by at most
    ``atol``."""
    got, want = np.asarray(got), np.asarray(want)
    off = ~np.isclose(got, want, rtol=1e-5, atol=1e-6)
    assert off.mean() <= 0.01, f"{what}: {off.sum()} of {off.size} off"
    _close(got, want, 0, atol, what)


def _check_states(tstate, jstate, lossy=False):
    """Slice 2's bar. ``lossy``: the tables and queued grads crossed the
    compressed wire (``_close_lossy``; a table element within 1e-4, 2e-3
    of the embedding lr, a queued element within 2^-10 of the largest)."""
    got = convert.state_to_numpy(tstate)
    want = _to_np(jstate)
    assert int(got["step"]) == int(want.step)
    assert int(got["opt"]["t"]) == int(want.opt["t"])
    for g, w in zip(_leaves(got["dense"]), _leaves(want.dense)):
        _close(g, w, 1e-5, 1e-6, "dense")
    for g, w in zip(_leaves(got["opt"]["m"]), _leaves(want.opt["m"])):
        _close(g, w, 1e-4, 1e-8, "adam m")
    for g, w in zip(_leaves(got["opt"]["v"]), _leaves(want.opt["v"])):
        _close(g, w, 1e-4, 1e-12, "adam v")
    for n in want.emb:
        if lossy:
            _close_lossy(got["emb"][n]["table"], want.emb[n]["table"], 1e-4,
                         n)
        else:
            _close(got["emb"][n]["table"], want.emb[n]["table"], 1e-5, 1e-6,
                   n)
        _close(got["emb"][n]["acc"], want.emb[n]["acc"], 1e-5, 1e-9, n)
        gq, wq = got["emb_queue"][n], want.emb_queue[n]
        assert (gq is None) == (wq is None)
        if wq is not None:
            np.testing.assert_array_equal(gq["ids"], wq["ids"])
            assert gq["ids"].dtype == np.int32
            assert (int(gq["ptr"]), int(gq["filled"])) == \
                (int(wq["ptr"]), int(wq["filled"]))
            if lossy:
                _close_lossy(gq["grads"], wq["grads"],
                             2.0 ** -10 * np.abs(wq["grads"]).max(),
                             f"{n} queue")
            else:
                _close(gq["grads"], wq["grads"], 1e-5, 1e-6, f"{n} queue")
    gd, wd = got["dense_queue"], want.dense_queue
    assert (gd is None) == (wd is None)
    if wd is not None:
        assert (int(gd["ptr"]), int(gd["filled"])) == \
            (int(wd["ptr"]), int(wd["filled"]))
        for g, w in zip(_leaves(gd["grads"]), _leaves(wd["grads"])):
            _close(g, w, 1e-5, 1e-6, "dense queue")


# ---------------------------------------------------------------------------
# the dense optimizers
# ---------------------------------------------------------------------------

def _params(rng, scale=1.0):
    return {"mlp": [{"w": (rng.standard_normal((6, 5)) * scale)
                     .astype(np.float32),
                     "b": (rng.standard_normal(5) * scale).astype(np.float32)}
                    for _ in range(2)]}


def _t(tree):
    return jax.tree.map(torch.from_numpy, tree)


@pytest.mark.parametrize("kind,clip,gscale", [
    ("adam", 1.0, 10.0),      # the clip scales the gradients down
    ("adam", 1.0, 0.01),      # the clip is inactive
    ("adam", 0.0, 1.0),
    ("sgd", 0.0, 1.0),
])
def test_optimizer_steps_match_jax(kind, clip, gscale):
    rng = np.random.default_rng(0)
    params = _params(rng)
    cfg = dict(kind=kind, lr=3e-3, grad_clip=clip,
               momentum=0.9 if kind == "sgd" else 0.0)
    j_init, j_upd = jopt.make_optimizer(jopt.OptConfig(**cfg))
    t_init, t_upd = topt.make_optimizer(topt.OptConfig(**cfg))
    jp, js = jax.tree.map(jnp.asarray, params), None
    tp, ts = _t(params), None
    js, ts = j_init(jp), t_init(tp)
    for _ in range(3):
        grads = _params(rng, gscale)
        jp, js = j_upd(jp, jax.tree.map(jnp.asarray, grads), js)
        tp, ts = t_upd(tp, _t(grads), ts)
    for g, w in zip(jax.tree.leaves(jax.tree.map(lambda x: x.numpy(), tp)),
                    jax.tree.leaves(_to_np(jp))):
        _close(g, w, 1e-6, 1e-7, "params")
    assert ts["t"] == int(js["t"]) == 3
    if "m" in js:
        for g, w in zip(jax.tree.leaves(jax.tree.map(lambda x: x.numpy(),
                                                     ts["m"])),
                        jax.tree.leaves(_to_np(js["m"]))):
            _close(g, w, 1e-6, 1e-8, "m")


def test_global_norm_and_schedule_match_jax():
    rng = np.random.default_rng(1)
    params = _params(rng)
    _close(float(topt.global_norm(_t(params))),
           float(jopt.global_norm(jax.tree.map(jnp.asarray, params))),
           1e-6, 0, "global norm")
    for step in (0, 3, 10, 57, 100, 250):
        got = topt.linear_warmup_cosine(step, base_lr=3e-3, warmup=10,
                                        total=100)
        want = jopt.linear_warmup_cosine(jnp.int32(step), base_lr=3e-3,
                                         warmup=10, total=100)
        assert got.dtype == torch.float32
        _close(float(got), float(want), 1e-6, 0, f"lr at {step}")


# ---------------------------------------------------------------------------
# dedup helpers and queues
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width", [8, 32])
def test_plan_segment_sum_bit_exact_with_jax(width):
    rng = np.random.default_rng(width)
    inv = rng.integers(-1, width, (12, 5)).astype(np.int32)
    # magnitudes that expose the addition order
    grads = (rng.standard_normal((12, 5, 4))
             * 10.0 ** rng.integers(-6, 7, (12, 5, 1))).astype(np.float32)
    got = dedup.plan_segment_sum(torch.from_numpy(inv),
                                 torch.from_numpy(grads), width)
    want = jdedup.plan_segment_sum(jnp.asarray(inv), jnp.asarray(grads),
                                   width)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_occurrence_csr_groups_occurrences_in_order():
    inv = np.array([[2, -1, 0], [2, 7, 0]], np.int32)
    order, offsets = dedup.occurrence_csr(inv, 4)
    np.testing.assert_array_equal(order, [2, 5, 0, 3])
    np.testing.assert_array_equal(offsets, [0, 2, 2, 4, 4])
    assert order.dtype == offsets.dtype == np.int32


def test_pad_axis0_matches_jax():
    a = np.arange(6, dtype=np.int32).reshape(3, 2)
    for w in (3, 5):
        np.testing.assert_array_equal(
            dedup.pad_axis0(torch.from_numpy(a), w, -1).numpy(),
            np.asarray(jdedup.pad_axis0(jnp.asarray(a), w, -1)))


def test_migrate_queue_blob_equals_jax():
    rng = np.random.default_rng(2)
    q = {"ids": rng.integers(-1, 9, (3, 20)).astype(np.int32),
         "grads": rng.standard_normal((3, 20, 4)).astype(np.float32),
         "ptr": np.int32(1), "filled": np.int32(3)}
    got, want = dedup.migrate_queue_blob(q, 16), \
        jdedup.migrate_queue_blob(q, 16)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_queue_push_pop_bit_exact_with_jax():
    spec_t = EmbeddingSpec(rows=50, dim=4, staleness=3)
    spec_j = jps.EmbeddingSpec(rows=50, dim=4, staleness=3)
    tq = embedding_ps.queue_init(spec_t, (6,), 4)
    jq = jps.queue_init(spec_j, (6,), 4)
    rng = np.random.default_rng(3)
    for _ in range(5):
        ids = rng.integers(-1, 50, 6).astype(np.int32)
        g = rng.standard_normal((6, 4)).astype(np.float32)
        tq, t_ids, t_g = embedding_ps.queue_push_pop(
            tq, torch.from_numpy(ids), torch.from_numpy(g))
        jq, j_ids, j_g = jps.queue_push_pop(jq, jnp.asarray(ids),
                                            jnp.asarray(g))
        np.testing.assert_array_equal(t_ids.numpy(), np.asarray(j_ids))
        np.testing.assert_array_equal(t_g.numpy(), np.asarray(j_g))
        assert (tq["ptr"], tq["filled"]) == (int(jq["ptr"]),
                                             int(jq["filled"]))
    np.testing.assert_array_equal(tq["ids"].numpy(), np.asarray(jq["ids"]))


def test_dense_queue_push_pop_bit_exact_with_jax():
    rng = np.random.default_rng(4)
    dense = _params(rng)
    tq = hybrid._dense_queue_init(_t(dense), 2)
    jq = jhybrid._dense_queue_init(jax.tree.map(jnp.asarray, dense), 2)
    for _ in range(4):
        g = _params(rng)
        tq, t_old = hybrid._dense_queue_push_pop(tq, _t(g))
        jq, j_old = jhybrid._dense_queue_push_pop(
            jq, jax.tree.map(jnp.asarray, g))
        for a, b in zip(jax.tree.leaves(jax.tree.map(lambda x: x.numpy(),
                                                     t_old)),
                        jax.tree.leaves(_to_np(j_old))):
            np.testing.assert_array_equal(a, b)
        assert (tq["ptr"], tq["filled"]) == (int(jq["ptr"]),
                                             int(jq["filled"]))


def test_hybrid_emb_update_of_unique_ids_matches_jax():
    """The unique-width put (apply_put with assume_unique) through the
    staleness queue, against the JAX package's hybrid_emb_update."""
    spec_t = EmbeddingSpec(rows=50, dim=4, staleness=2, lr=0.1)
    spec_j = jps.EmbeddingSpec(rows=50, dim=4, staleness=2, lr=0.1)
    rng = np.random.default_rng(5)
    table = rng.standard_normal((50, 4)).astype(np.float32)
    acc = rng.random(50).astype(np.float32)
    ts = {"table": torch.from_numpy(table.copy()),
          "acc": torch.from_numpy(acc.copy())}
    js = {"table": jnp.asarray(table), "acc": jnp.asarray(acc)}
    tq = embedding_ps.queue_init(spec_t, (8,), 4)
    jq = jps.queue_init(spec_j, (8,), 4)
    for _ in range(4):
        ids = np.full(8, -1, np.int32)
        ids[:6] = rng.permutation(50)[:6]
        g = rng.standard_normal((8, 4)).astype(np.float32)
        ts, tq = embedding_ps.hybrid_emb_update(
            ts, tq, spec_t, torch.from_numpy(ids), torch.from_numpy(g),
            assume_unique=True)
        js, jq = jps.hybrid_emb_update(js, jq, spec_j, jnp.asarray(ids),
                                       jnp.asarray(g))
    _close(ts["table"].numpy(), np.asarray(js["table"]), 2e-6, 2e-6, "table")
    _close(ts["acc"].numpy(), np.asarray(js["acc"]), 2e-6, 2e-6, "acc")
    # the same ids, repeated, without assume_unique: aggregated first
    ids2, g2 = np.concatenate([ids, ids]), np.concatenate([g, g])
    ts = embedding_ps.apply_put(ts, spec_t, torch.from_numpy(ids2),
                                torch.from_numpy(g2))
    js = jps.apply_put(js, spec_j, jnp.asarray(ids2), jnp.asarray(g2))
    _close(ts["table"].numpy(), np.asarray(js["table"]), 2e-6, 2e-6, "table")
    _close(ts["acc"].numpy(), np.asarray(js["acc"]), 2e-6, 2e-6, "acc")


# ---------------------------------------------------------------------------
# colliding physical rows: the plan puts against the JAX backend
# ---------------------------------------------------------------------------

ROWS = 8375     # above 4,294 rows the shuffle wraps 2^32 and rows collide


def _colliding_ids():
    u = np.arange(ROWS, dtype=np.int64)
    pos = ((u * 1_000_003 + 12_345) & 0xFFFFFFFF) % ROWS
    first = {}
    for i, p in enumerate(pos):
        if p in first:
            return first[p], i
        first[p] = i
    raise AssertionError("no collision")


@pytest.mark.parametrize("staleness", [0, 2])
def test_plan_puts_with_colliding_rows_match_jax(staleness):
    a, b = _colliding_ids()
    spec_t = EmbeddingSpec(rows=ROWS, dim=8, staleness=staleness, lr=0.05)
    spec_j = jps.EmbeddingSpec(rows=ROWS, dim=8, staleness=staleness,
                               lr=0.05)
    tb, jb = backend.DenseBackend(spec_t), jbackend.DenseBackend(spec_j)
    rng = np.random.default_rng(6)
    table = rng.standard_normal((ROWS, 8)).astype(np.float32)
    ts = {"table": torch.from_numpy(table.copy()),
          "acc": torch.zeros(ROWS)}
    js = {"table": jnp.asarray(table), "acc": jnp.zeros(ROWS)}
    tq = tb.queue_init((6, 4))
    jq = jb.queue_init((6, 4))
    for step in range(4):
        ids = rng.integers(0, 60, (6, 4))
        ids[step % 6, :2] = (a, b)                  # two ids, one row
        ids[5, 3] = -1
        cap = dedup.dedup_cap(ids.size, ROWS)
        u_pad, inv, _, _ = dedup.make_plan(ids, ROWS, cap)
        order, offsets = dedup.occurrence_csr(inv, u_pad.size)
        plan_t = dedup.DedupPlan(
            dev=torch.from_numpy(u_pad.astype(np.int32)),
            inv=torch.from_numpy(inv), order=torch.from_numpy(order),
            offsets=torch.from_numpy(offsets))
        plan_j = jdedup.DedupPlan(dev=jnp.asarray(u_pad, jnp.int32),
                                  inv=jnp.asarray(inv))
        g = rng.standard_normal((6, 4, 8)).astype(np.float32)
        ts, tq, _ = tb.hybrid_update(ts, tq, plan_t, torch.from_numpy(g))
        js, jq, _ = jb.hybrid_update(js, jq, plan_j, jnp.asarray(g))
    rows = tb._logical_to_pos(torch.tensor([a, b]))
    assert rows[0] == rows[1]
    _close(ts["table"].numpy(), np.asarray(js["table"]), 2e-6, 2e-6, "table")
    _close(ts["acc"].numpy(), np.asarray(js["acc"]), 2e-6, 2e-6, "acc")
    if staleness:
        np.testing.assert_array_equal(tq["ids"].numpy(),
                                      np.asarray(jq["ids"]))


@pytest.mark.parametrize("staleness", [0, 2])
def test_fused_plan_put_equals_decomposed_put(staleness):
    """DenseBackend's fused plan put against the protocol's decomposition
    (``plan_segment_sum``, then the unique-width ``_put_unique`` /
    ``_hybrid_unique``), bit for bit, colliding rows included."""
    a, b = _colliding_ids()
    spec = EmbeddingSpec(rows=ROWS, dim=8, staleness=staleness, lr=0.05)
    tb = backend.DenseBackend(spec)
    rng = np.random.default_rng(7)
    table = torch.from_numpy(rng.standard_normal((ROWS, 8)).astype(np.float32))
    fused = {"table": table.clone(), "acc": torch.zeros(ROWS)}
    decomposed = {"table": table.clone(), "acc": torch.zeros(ROWS)}
    qf, qd = tb.queue_init((6, 4)), tb.queue_init((6, 4))
    for step in range(4):
        ids = rng.integers(0, 60, (6, 4))
        ids[step % 6, :2] = (a, b)
        ids[0, 3] = -1
        u_pad, inv, _, _ = dedup.make_plan(ids, ROWS,
                                           dedup.dedup_cap(ids.size, ROWS))
        plan = dedup.DedupPlan(dev=torch.from_numpy(u_pad.astype(np.int32)),
                               inv=torch.from_numpy(inv))
        g = torch.from_numpy(rng.standard_normal((6, 4, 8))
                             .astype(np.float32))
        fused, qf, _ = tb.hybrid_update(fused, qf, plan, g)
        decomposed, qd, _ = backend.EmbeddingBackend._hybrid_plan(
            tb, decomposed, qd, plan, g)
    for k in ("table", "acc"):
        assert torch.equal(fused[k], decomposed[k]), k
    if staleness:
        for k in ("ids", "grads"):
            assert torch.equal(qf[k], qd[k]), k
        assert (qf["ptr"], qf["filled"]) == (qd["ptr"], qd["filled"])


# ---------------------------------------------------------------------------
# the trainer: 4 steps from one JAX-initialised state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("how", ["step", "decomposed_step"])
@pytest.mark.parametrize("mode", ["sync", "hybrid", "async"])
def test_training_matches_jax_trainer(mode, how):
    jt, tt = _trainers(mode)
    batches = _batches(4)
    js = jt.init(jax.random.PRNGKey(0),
                 {k: jnp.asarray(v) for k, v in batches[0].items()})
    ts = _carry(tt, js)
    _check_states(ts, js)
    for b in batches:
        js, jm = getattr(jt, how)(js, b)
        ts, tm = getattr(tt, how)(ts, b)
        _close(float(tm["loss"]), float(jm["loss"]), 1e-5, 0, "loss")
        _close(float(tm["emb_grad_norm"]), float(jm["emb_grad_norm"]), 1e-5,
               0, "emb_grad_norm")
        for k, v in jm.items():
            if k.startswith("dedup/"):
                assert tm[k] == pytest.approx(float(v))
    _check_states(ts, js)


def test_run_is_decomposed_steps():
    _, tt = _trainers("hybrid")
    batches = _batches(3)
    a = tt.init(seed=0, batch_example=batches[0])
    b = a.to("cpu")
    a, ms = tt.run(a, batches, steps=2)
    for x in batches[:2]:
        b, _ = tt.decomposed_step(b, x)
    assert len(ms) == 2 and a.step == b.step == 2
    for n in a.emb:
        assert torch.equal(a.emb[n]["table"], b.emb[n]["table"])


def test_init_sizes_queues_and_needs_a_batch_under_staleness():
    _, tt = _trainers("async")
    with pytest.raises(ValueError, match="batch_example"):
        tt.init(seed=0)
    state = tt.init(seed=0, batch_example=_batches(1)[0])
    q = state.emb_queue["field_00"]
    # queue width: the dedup cap of B * L occurrences over RPF rows
    assert tuple(q["ids"].shape) == (2, dedup.dedup_cap(B * 4, RPF))
    assert (q["ptr"], q["filled"], state.step) == (0, 0, 0)
    assert state.dense_queue["grads"]["mlp"][0]["w"].shape[0] == 2
    assert set(state.opt) == {"m", "v", "t"} and state.opt["t"] == 0


def test_training_a_flat_table_raises():
    """A trainer with one occurrence-width table among plan tables trains
    as the JAX trainer does; what still raises is a flat table behind a
    backend the port does not build."""
    ad = adapters.recsys_adapter(CFG, lr=EMB_LR, field_rows=DS.field_rows())
    flat = lambda n, s: dataclasses.replace(  # noqa: E731
        s, batch_dedup=n != "field_01")
    tt = PersiaTrainer(dataclasses.replace(
        ad, collection=ad.collection.map_specs(flat)), TrainMode.sync(),
        topt.OptConfig(kind="adam", lr=DENSE_LR), device="cpu",
        per_table_staleness=True)
    jcfg = JConfig(**dataclasses.asdict(CFG))
    jad = jadapters.recsys_adapter(jcfg, lr=EMB_LR,
                                   field_rows=DS.field_rows())
    jt = jhybrid.PersiaTrainer(
        dataclasses.replace(jad, collection=jad.collection.map_specs(flat)),
        jhybrid.TrainMode.sync(), jopt.OptConfig(kind="adam", lr=DENSE_LR),
        per_table_staleness=True)
    js = jt.init(jax.random.PRNGKey(0))
    ts = _carry(tt, js)
    for b in _batches(2):
        js, jm = jt.step(js, b)
        ts, tm = tt.step(ts, b)
        _close(float(tm["loss"]), float(jm["loss"]), 1e-5, 0, "loss")
        assert "dedup/field_01/dup_factor" not in tm
    _check_states(ts, js)
    assert tt.predict(ts, _batches(1)[0]).shape == (B, CFG.n_tasks)
    with pytest.raises(ValueError, match="not ported yet"):
        PersiaTrainer(dataclasses.replace(
            ad, collection=ad.collection.map_specs(
                lambda n, s: dataclasses.replace(
                    flat(n, s), backend="host_lru"))), device="cpu")


# ---------------------------------------------------------------------------
# checkpoints: one on-disk format for both packages
# ---------------------------------------------------------------------------

def _manifest(path):
    import json
    import os
    step_dir = sorted(os.listdir(path))[-1]
    out = {}
    for blob in ("dense", "emb"):
        with open(os.path.join(path, step_dir, blob, "manifest.json")) as f:
            out[blob] = {k: (m["dtype"], m["shape"])
                         for k, m in json.load(f).items()}
    return out


def test_jax_checkpoint_restores_into_the_port(tmp_path):
    jt, tt = _trainers("async")
    batches = _batches(3)
    js = jt.init(jax.random.PRNGKey(1),
                 {k: jnp.asarray(v) for k, v in batches[0].items()})
    for b in batches:
        js, _ = jt.step(js, b)
    jt.save(str(tmp_path / "j"), js)
    ts = tt.restore(str(tmp_path / "j"))
    got, want = convert.state_to_numpy(ts), _to_np(js)
    for g, w in zip(jax.tree.leaves(got),
                    jax.tree.leaves({"dense": want.dense, "opt": want.opt,
                                     "emb": want.emb,
                                     "emb_queue": want.emb_queue,
                                     "dense_queue": want.dense_queue,
                                     "step": want.step})):
        np.testing.assert_array_equal(g, w)
    # and the port writes the same key paths, dtypes and shapes
    tt.save(str(tmp_path / "t"), ts)
    assert _manifest(tmp_path / "t") == _manifest(tmp_path / "j")


def test_port_checkpoint_restores_into_jax(tmp_path):
    jt, tt = _trainers("hybrid")
    batches = _batches(3)
    ts = tt.init(seed=3, batch_example=batches[0])
    for b in batches:
        ts, _ = tt.step(ts, b)
    path = tt.save(str(tmp_path), ts)
    assert path.endswith("step_00000003")
    js = jt.restore(str(tmp_path))
    got = convert.state_to_numpy(ts)
    assert int(js.step) == 3 and int(js.opt["t"]) == 3
    for g, w in zip(jax.tree.leaves({k: got[k] for k in
                                     ("dense", "opt", "emb", "emb_queue")}),
                    jax.tree.leaves(_to_np({"dense": js.dense,
                                            "opt": js.opt, "emb": js.emb,
                                            "emb_queue": js.emb_queue}))):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype


def test_save_restore_then_step_equals_step(tmp_path):
    _, tt = _trainers("async")
    batches = _batches(4)
    state = tt.init(seed=4, batch_example=batches[0])
    for b in batches[:3]:
        state, _ = tt.step(state, b)
    tt.save(str(tmp_path), state)
    restored = tt.restore(str(tmp_path))
    a, ma = tt.step(state, batches[3])
    b, mb = tt.step(restored, batches[3])
    assert float(ma["loss"]) == float(mb["loss"])
    for x, y in zip(jax.tree.leaves(convert.state_to_numpy(a)),
                    jax.tree.leaves(convert.state_to_numpy(b))):
        np.testing.assert_array_equal(x, y)


def test_restore_rejects_another_mode(tmp_path):
    _, tt = _trainers("hybrid")
    state = tt.init(seed=0, batch_example=_batches(1)[0])
    tt.save(str(tmp_path), state)
    _, sync = _trainers("sync")
    with pytest.raises(ValueError, match="staleness"):
        sync.restore(str(tmp_path))


def test_checkpoint_blobs_round_trip(tmp_path):
    tree = {"a": {"0": np.arange(3, dtype=np.int32)},
            "b": [np.ones((2, 2), np.float32), np.float32(2.5)]}
    path = ckpt.save_checkpoint(str(tmp_path), 7, tree, {"x": np.int32(4)})
    step, dense, emb = ckpt.load_checkpoint(str(tmp_path))
    j_step, j_dense, j_emb = jckpt.load_checkpoint(str(tmp_path))
    assert path.endswith("step_00000007") and step == j_step == 7
    np.testing.assert_array_equal(dense["b"][0], j_dense["b"][0])
    assert int(emb["x"]) == int(j_emb["x"]) == 4
