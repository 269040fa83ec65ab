"""The port's compressed wire (``dense+compressed``) and occurrence-width
(``batch_dedup=False``) training against the JAX package, on the CPU, from
the same numpy inputs and the same starting state.

Tolerance classes (stated per comparison below):
* bit-exact: backend names, queue ids and ring pointers, the wire's byte
  metrics, the codec (both packages round each operation once: the fp16
  payloads and the queued, roundtripped sums are equal bit for bit) and
  the roundtripped lookups;
* allclose, the classes of ``tests/test_torch_train.py``: a pooled bag
  (XLA's reduction over L against the kernels' in-order sums) rtol 1e-6;
  tables and accumulators after a backend's puts 2e-6 (XLA's ``rsqrt``
  against torch's ``1 / sqrt``); the trainer's 4-step runs to slice 2's
  bar (``_check_states``: loss rtol 1e-5, tables rtol 1e-5 atol 1e-6,
  accumulators atol 1e-9, Adam moments rtol 1e-4), except that through the
  wire the FFNN's last-bit differences now and then land a payload value
  on the other side of an fp16 rounding boundary: there at most 1% of the
  table and queue elements may move by one fp16 step (``_close_lossy``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JConfig
from repro.core import adapters as jadapters
from repro.core import backend as jbackend
from repro.core import dedup as jdedup
from repro.core import embedding_ps as jps
from repro.core import hybrid as jhybrid
from repro.data import ctr as jctr
from repro.models import recsys as jrecsys
from repro.optim import optimizers as jopt
from repro.serving import ServingConfig as JServingConfig
from repro.serving import ServingService as JServingService
from repro.serving import StateCell as JStateCell

from repro_torch import convert
from repro_torch.core import adapters, backend, dedup, embedding_ps, hybrid
from repro_torch.core.embedding_ps import EmbeddingSpec
from repro_torch.core.hybrid import PersiaTrainer
from repro_torch.kernels import ops
from repro_torch.optim import optimizers as topt
from repro_torch.serving import ServingConfig, ServingService, StateCell

from test_torch_train import (B, CFG, DENSE_LR, DS, EMB_LR, ROWS, _batches,
                              _carry, _check_states, _close,
                              _colliding_ids, _modes, _to_np)

VARIANTS = {  # name -> (EmbeddingSpec.backend, batch_dedup override)
    "compressed": ("dense+compressed", None),
    "flat": ("dense", False),
    "flat_compressed": ("dense+compressed", False),
}


def _trainers(mode, variant):
    jm, tm = _modes(mode)
    name, dedup_on = VARIANTS[variant]
    jcfg = JConfig(**dataclasses.asdict(CFG))
    jds = jctr.CTRDataset(**dataclasses.asdict(DS))
    jad = jadapters.recsys_adapter(jcfg, lr=EMB_LR,
                                   field_rows=jds.field_rows())
    jad = dataclasses.replace(jad,
                              collection=jad.collection.with_backend(name))
    jt = jhybrid.PersiaTrainer(jad, jm, jopt.OptConfig(kind="adam",
                                                       lr=DENSE_LR),
                               batch_dedup=dedup_on)
    ad = adapters.recsys_adapter(CFG, lr=EMB_LR, field_rows=DS.field_rows())
    ad = dataclasses.replace(ad, collection=ad.collection.with_backend(name))
    tt = PersiaTrainer(ad, tm, topt.OptConfig(kind="adam", lr=DENSE_LR),
                       batch_dedup=dedup_on, device="cpu")
    return jt, tt


# ---------------------------------------------------------------------------
# backend names and the factory
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [
    "dense", None, "  Dense ", "host_lru", "host_lru+disk",
    "dense+compressed", "host_lru+compressed", "host_lru+disk+compressed",
    "compressed", "compressed+compressed", "+compressed"])
def test_parse_backend_name_matches_jax(name):
    assert backend.parse_backend_name(name) == \
        jbackend.parse_backend_name(name)


@pytest.mark.parametrize("name", ["sparse", "host_lru+gzip", "dense+",
                                  "dense+disk", "disk", "compressed+disk"])
def test_parse_backend_name_rejects_what_jax_rejects(name):
    with pytest.raises(ValueError) as want:
        jbackend.parse_backend_name(name)
    with pytest.raises(ValueError) as got:
        backend.parse_backend_name(name)
    assert str(got.value) == str(want.value)


def test_create_backend_builds_dense_and_the_wire_only():
    spec = EmbeddingSpec(rows=64, dim=4)
    assert type(backend.create_backend(spec)) is backend.DenseBackend
    for name in ("dense+compressed", "compressed"):
        b = backend.create_backend(dataclasses.replace(spec, backend=name))
        assert isinstance(b, backend.CompressedWireBackend)
        assert type(b.inner) is backend.DenseBackend
        assert backend.unwrap(b) is b.inner
    for name in ("host_lru", "host_lru+disk", "host_lru+compressed"):
        b = backend.create_backend(dataclasses.replace(spec, backend=name,
                                                       cache_rows=8))
        assert type(backend.unwrap(b)) is backend.HostLRUBackend
        assert isinstance(b, backend.CompressedWireBackend) == \
            name.endswith("compressed")
    with pytest.raises(ValueError, match="block"):
        backend.create_backend(dataclasses.replace(
            spec, backend="dense+compressed", wire_kernel=True,
            wire_block=64))
    # wire_kernel selects nothing in the port: both run the same codec
    a = backend.create_backend(dataclasses.replace(
        spec, backend="dense+compressed", wire_kernel=True))
    assert a._block == 128 and isinstance(a, backend.CompressedWireBackend)
    coll = adapters.recsys_adapter(CFG, field_rows=DS.field_rows()) \
        .collection.with_backend("dense+compressed")
    assert all(s.backend == "dense+compressed" for _, s in coll.items())
    with pytest.raises(ValueError, match="unknown"):
        coll.with_backend("nope")


# ---------------------------------------------------------------------------
# the wire's lookup and puts against the JAX CompressedWireBackend
# ---------------------------------------------------------------------------

def _wire_pair(rows, dim, staleness=0, optimizer="adagrad", seed=0):
    kw = dict(rows=rows, dim=dim, staleness=staleness, lr=0.05,
              optimizer=optimizer, backend="dense+compressed")
    jb = jbackend.create_backend(jps.EmbeddingSpec(**kw))
    tb = backend.create_backend(EmbeddingSpec(**kw))
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((rows, dim)).astype(np.float32)
    acc = rng.random(rows).astype(np.float32) * 1e-3
    js = {"table": jnp.asarray(table)}
    ts = {"table": torch.from_numpy(table.copy())}
    if optimizer == "adagrad":
        js["acc"], ts["acc"] = jnp.asarray(acc), torch.from_numpy(acc.copy())
    return jb, js, tb, ts


def _ids(rng, shape, rows, collide=None):
    ids = rng.integers(0, min(rows, 60), shape)
    if collide is not None:
        ids.reshape(-1)[:2] = collide          # two ids, one physical row
    ids.reshape(-1)[-1] = -1
    return ids.astype(np.int32)


def _plans(ids, rows):
    cap = dedup.dedup_cap(ids.size, rows)
    u_pad, inv, _, info = dedup.make_plan(ids, rows, cap)
    tplan = dedup.DedupPlan(dev=torch.from_numpy(u_pad.astype(np.int32)),
                            inv=torch.from_numpy(inv),
                            n_unique=info["n_unique"])
    jplan = jdedup.DedupPlan(dev=jnp.asarray(u_pad, jnp.int32),
                             inv=jnp.asarray(inv))
    return tplan, jplan


def _same_metrics(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        assert float(got[k]) == float(want[k]), k


@pytest.mark.parametrize("form", ["plan", "flat"])
@pytest.mark.parametrize("dim", [16, 128])
def test_wire_lookup_matches_jax(dim, form):
    jb, js, tb, ts = _wire_pair(ROWS, dim)
    rng = np.random.default_rng(dim)
    ids = _ids(rng, (12, 5), ROWS, collide=_colliding_ids())
    tp, jp = _plans(ids, ROWS) if form == "plan" else \
        (torch.from_numpy(ids), jnp.asarray(ids))
    got, gm = tb.lookup(ts, tp)
    want, wm = jb.lookup(js, jp)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _same_metrics(gm, wm)
    pooled, pm = tb.lookup_pooled(ts, tp)
    _same_metrics(pm, wm)
    np.testing.assert_allclose(
        pooled.numpy(), np.asarray(jrecsys.pool_bag(want, jnp.asarray(ids))),
        rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("dim", [16, 128])
def test_wire_serve_read_matches_jax(dim):
    jb, js, tb, ts = _wire_pair(ROWS, dim, seed=1)
    ids = _ids(np.random.default_rng(3), (9, 4), ROWS)
    ids[0, 0] = ROWS + 2                        # past the end: a zero row
    want, want_info = jb.read_rows(js, ids)
    got, info = tb.read_rows(ts, ids)
    np.testing.assert_array_equal(got.numpy(), want)
    assert info == want_info
    pooled, info = tb.read_pooled(ts, ids)
    assert info == want_info
    np.testing.assert_allclose(
        pooled.numpy(),
        np.asarray(jrecsys.pool_bag(jnp.asarray(want), jnp.asarray(ids))),
        rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("optimizer", ["adagrad", "sgd"])
@pytest.mark.parametrize("staleness", [0, 2])
@pytest.mark.parametrize("form", ["plan", "flat"])
@pytest.mark.parametrize("dim", [16, 128])
def test_wire_puts_match_jax(dim, form, staleness, optimizer):
    """apply_put and hybrid_update of the wire, on a table above 4,295
    rows with two ids of one batch on one physical row. The wire dedups on
    (logical) device ids, so the two stay apart until the apply."""
    jb, js, tb, ts = _wire_pair(ROWS, dim, staleness, optimizer, seed=2)
    rng = np.random.default_rng(dim + staleness)
    shape = (10, 4)
    tq, jq = tb.queue_init(shape), jb.queue_init(shape)
    for step in range(4):
        ids = _ids(rng, shape, ROWS, collide=_colliding_ids())
        g = rng.standard_normal(shape + (dim,)).astype(np.float32)
        tp, jp = _plans(ids, ROWS) if form == "plan" else \
            (torch.from_numpy(ids), jnp.asarray(ids))
        if step == 0:
            ts, gm = tb.apply_put(ts, tp, torch.from_numpy(g))
            js, wm = jb.apply_put(js, jp, jnp.asarray(g))
        else:
            ts, tq, gm = tb.hybrid_update(ts, tq, tp, torch.from_numpy(g))
            js, jq, wm = jb.hybrid_update(js, jq, jp, jnp.asarray(g))
        _same_metrics(gm, wm)
    _close(ts["table"].numpy(), np.asarray(js["table"]), 2e-6, 2e-6, "table")
    if optimizer == "adagrad":
        _close(ts["acc"].numpy(), np.asarray(js["acc"]), 2e-6, 2e-6, "acc")
    assert (tq is None) == (staleness == 0) == (jq is None)
    if staleness:
        np.testing.assert_array_equal(tq["ids"].numpy(),
                                      np.asarray(jq["ids"]))
        np.testing.assert_array_equal(tq["grads"].numpy(),
                                      np.asarray(jq["grads"]))
        assert (tq["ptr"], tq["filled"]) == (int(jq["ptr"]),
                                             int(jq["filled"]))


def test_wire_queue_holds_deduped_roundtripped_puts():
    """The JAX package's own wire test, on the port: the staleness queue
    lives PS-side, after the wire, and holds one summed row per unique id,
    its width the dedup cap whatever batch_dedup says."""
    spec = EmbeddingSpec(rows=16, dim=4, optimizer="sgd", staleness=1,
                         backend="dense+compressed", batch_dedup=False)
    bk = backend.create_backend(spec)
    state = bk.init(torch.Generator().manual_seed(0))
    queue = bk.queue_init((6,))
    assert bk.queue_width(6) == dedup.dedup_cap(6, 16)
    ids = torch.tensor([3, 3, 5, 5, 5, -1], dtype=torch.int32)
    state, queue, m = bk.hybrid_update(state, queue, ids, torch.ones((6, 4)))
    qids = queue["ids"][0].numpy()
    assert sorted(qids[qids >= 0].tolist()) == [3, 5]
    qg = {int(i): queue["grads"][0][k].numpy()
          for k, i in enumerate(qids) if i >= 0}
    # lossy: 2 shares its block with 3, so it keeps 11 bits of 3's range
    np.testing.assert_allclose(qg[3], 2.0, rtol=1e-3)
    np.testing.assert_array_equal(qg[5], 3.0)   # the block max is exact
    assert float(m["put_bytes_raw"]) > float(m["put_bytes_wire"])


# ---------------------------------------------------------------------------
# occurrence-width puts of the dense backend
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dedup_on", [True, False])
@pytest.mark.parametrize("staleness", [0, 2])
def test_dense_flat_puts_match_jax(staleness, dedup_on):
    """DenseBackend puts of occurrence-width ids: the apply aggregates on
    PHYSICAL rows (two ids of one shuffled row are summed before acc sees
    them), and a unique-width queue dedups the ids before the push."""
    kw = dict(rows=ROWS, dim=8, staleness=staleness, lr=0.05,
              batch_dedup=dedup_on)
    tb = backend.DenseBackend(EmbeddingSpec(**kw))
    jb = jbackend.DenseBackend(jps.EmbeddingSpec(**kw))
    rng = np.random.default_rng(staleness)
    table = rng.standard_normal((ROWS, 8)).astype(np.float32)
    ts = {"table": torch.from_numpy(table.copy()), "acc": torch.zeros(ROWS)}
    js = {"table": jnp.asarray(table), "acc": jnp.zeros(ROWS)}
    shape = (6, 4)
    tq, jq = tb.queue_init(shape), jb.queue_init(shape)
    for step in range(4):
        ids = _ids(rng, shape, ROWS, collide=_colliding_ids())
        g = rng.standard_normal(shape + (8,)).astype(np.float32)
        ts, tq, _ = tb.hybrid_update(ts, tq, torch.from_numpy(ids),
                                     torch.from_numpy(g))
        js, jq, _ = jb.hybrid_update(js, jq, jnp.asarray(ids),
                                     jnp.asarray(g))
    _close(ts["table"].numpy(), np.asarray(js["table"]), 2e-6, 2e-6, "table")
    _close(ts["acc"].numpy(), np.asarray(js["acc"]), 2e-6, 2e-6, "acc")
    if staleness:
        np.testing.assert_array_equal(tq["ids"].numpy(),
                                      np.asarray(jq["ids"]))
        np.testing.assert_array_equal(tq["grads"].numpy(),
                                      np.asarray(jq["grads"]))
    # and apply_put of the same occurrence ids, straight to the table
    ts, _ = tb.apply_put(ts, torch.from_numpy(ids), torch.from_numpy(g))
    js, _ = jb.apply_put(js, jnp.asarray(ids), jnp.asarray(g))
    _close(ts["table"].numpy(), np.asarray(js["table"]), 2e-6, 2e-6, "table")
    _close(ts["acc"].numpy(), np.asarray(js["acc"]), 2e-6, 2e-6, "acc")


# ---------------------------------------------------------------------------
# the trainer: 4 steps from one JAX-initialised state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["sync", "hybrid", "async"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_training_matches_jax_trainer(variant, mode):
    jt, tt = _trainers(mode, variant)
    batches = _batches(4)
    js = jt.init(jax.random.PRNGKey(0),
                 {k: jnp.asarray(v) for k, v in batches[0].items()})
    ts = _carry(tt, js)
    lossy = variant.endswith("compressed")
    _check_states(ts, js)
    for b in batches:
        js, jm = jt.decomposed_step(js, b)
        ts, tm = tt.step(ts, b)
        _close(float(tm["loss"]), float(jm["loss"]), 1e-5, 0, "loss")
        _close(float(tm["emb_grad_norm"]), float(jm["emb_grad_norm"]), 1e-5,
               0, "emb_grad_norm")
        keys = {k for k in jm if k.startswith(("wire/", "dedup/"))}
        assert keys == {k for k in tm if k.startswith(("wire/", "dedup/"))}
        assert any(k.startswith("wire/") for k in keys) == \
            variant.endswith("compressed")
        for k in keys:
            assert float(tm[k]) == pytest.approx(float(jm[k])), k
    _check_states(ts, js, lossy)


# ---------------------------------------------------------------------------
# checkpoints and serving
# ---------------------------------------------------------------------------

def _same_trees(got, want):
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype


@pytest.mark.parametrize("variant", ["compressed", "flat"])
def test_jax_checkpoint_restores_into_the_port(tmp_path, variant):
    jt, tt = _trainers("hybrid", variant)
    batches = _batches(3)
    js = jt.init(jax.random.PRNGKey(1),
                 {k: jnp.asarray(v) for k, v in batches[0].items()})
    for b in batches:
        js, _ = jt.step(js, b)
    jt.save(str(tmp_path), js)
    ts = tt.restore(str(tmp_path))
    want = _to_np(js)
    width = np.shape(want.emb_queue["field_00"]["ids"])[1]
    assert width == (B * 4 if variant == "flat" else
                     dedup.dedup_cap(B * 4, DS.field_rows()[0]))
    _same_trees(convert.state_to_numpy(ts),
                {"dense": want.dense, "opt": want.opt, "emb": want.emb,
                 "emb_queue": want.emb_queue,
                 "dense_queue": want.dense_queue, "step": want.step})
    # and the restored state trains on as the JAX one does
    b = _batches(1, seed=9)[0]
    js, jm = jt.step(js, b)
    ts, tm = tt.step(ts, b)
    _close(float(tm["loss"]), float(jm["loss"]), 1e-5, 0, "loss")
    _check_states(ts, js)


@pytest.mark.parametrize("variant", ["compressed", "flat"])
def test_port_checkpoint_restores_into_jax(tmp_path, variant):
    jt, tt = _trainers("hybrid", variant)
    batches = _batches(3)
    ts = tt.init(seed=3, batch_example=batches[0])
    for b in batches:
        ts, _ = tt.step(ts, b)
    tt.save(str(tmp_path), ts)
    js = jt.restore(str(tmp_path))
    got = convert.state_to_numpy(ts)
    _same_trees({k: got[k] for k in ("dense", "opt", "emb", "emb_queue")},
                _to_np({"dense": js.dense, "opt": js.opt, "emb": js.emb,
                        "emb_queue": js.emb_queue}))


def test_flat_queue_blob_migrates_to_the_wire_width():
    """An occurrence-width queue restores into a wire trainer at the
    wire's width (the dedup cap over the table's rows), re-encoded as the
    JAX package does."""
    spec = EmbeddingSpec(rows=20, dim=4, staleness=2,
                         backend="dense+compressed")
    wire = backend.create_backend(spec)
    jwire = jbackend.create_backend(jps.EmbeddingSpec(
        rows=20, dim=4, staleness=2, backend="dense+compressed"))
    rng = np.random.default_rng(4)
    q = {"ids": rng.integers(-1, 20, (2, 2048)).astype(np.int32),
         "grads": rng.standard_normal((2, 2048, 4)).astype(np.float32),
         "ptr": np.int32(1), "filled": np.int32(2)}
    got = hybrid._migrate_queue_widths(wire, q)
    want = jhybrid._migrate_queue_widths(jwire, q)
    assert got["ids"].shape[1] == wire.queue_width(2048) < 2048
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_compressed_service_matches_jax_serve_lookup():
    """A ServingService over a dense+compressed trainer against the JAX
    trainer's serve_lookup -> predict (the FFNN's class: rtol 1e-5)."""
    jt, tt = _trainers("sync", "compressed")
    js = jt.init(jax.random.PRNGKey(2))
    ts = convert.state_from_numpy(tt, _to_np(js.dense), _to_np(js.emb))
    batch = _batches(1, seed=11)[0]
    want = np.asarray(jt.predict(js, batch))
    reqs = [{"ids": batch["ids"][i], "dense": batch["dense"][i]}
            for i in range(B)]
    ops.reset_launch_counts()
    with ServingService(tt, StateCell(ts, 0), ServingConfig(8, 20.0)) as svc:
        got = svc.predict_many(reqs)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    with JServingService(jt, JStateCell(js, 0),
                         JServingConfig(8, 20.0)) as jsvc:
        np.testing.assert_allclose(got, jsvc.predict_many(reqs), rtol=1e-5,
                                   atol=1e-6)
    assert sum(ops.launch_counts().values()) == 0      # CPU: plain versions


def test_apply_put_of_non_unique_ids_matches_jax():
    """embedding_ps.apply_put without assume_unique (ids repeat, two share
    a physical row, padding and ids past the end) and hybrid_emb_update
    with an occurrence-width queue, against the JAX package."""
    spec_t = EmbeddingSpec(rows=ROWS, dim=4, staleness=2, lr=0.1)
    spec_j = jps.EmbeddingSpec(rows=ROWS, dim=4, staleness=2, lr=0.1)
    rng = np.random.default_rng(8)
    table = rng.standard_normal((ROWS, 4)).astype(np.float32)
    acc = rng.random(ROWS).astype(np.float32)
    ts = {"table": torch.from_numpy(table.copy()),
          "acc": torch.from_numpy(acc.copy())}
    js = {"table": jnp.asarray(table), "acc": jnp.asarray(acc)}
    tq = embedding_ps.queue_init(spec_t, (16,), 4)
    jq = jps.queue_init(spec_j, (16,), 4)
    for _ in range(4):
        ids = _ids(rng, (16,), ROWS, collide=_colliding_ids())
        ids[3] = ROWS + 5
        g = rng.standard_normal((16, 4)).astype(np.float32)
        ts, tq = embedding_ps.hybrid_emb_update(
            ts, tq, spec_t, torch.from_numpy(ids), torch.from_numpy(g))
        js, jq = jps.hybrid_emb_update(js, jq, spec_j, jnp.asarray(ids),
                                       jnp.asarray(g))
    ts = embedding_ps.apply_put(ts, spec_t, torch.from_numpy(ids),
                                torch.from_numpy(g))
    js = jps.apply_put(js, spec_j, jnp.asarray(ids), jnp.asarray(g))
    _close(ts["table"].numpy(), np.asarray(js["table"]), 2e-6, 2e-6, "table")
    _close(ts["acc"].numpy(), np.asarray(js["acc"]), 2e-6, 2e-6, "acc")
    np.testing.assert_array_equal(tq["ids"].numpy(), np.asarray(jq["ids"]))
