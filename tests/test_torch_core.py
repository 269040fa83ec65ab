"""The port's serving slice (repro_torch) against the JAX package, on the
CPU, from the same numpy inputs.

Tolerance classes:
* bit-exact: integer and plan logic (``shuffle_pos``, ``_logical_to_pos``,
  ``make_plan``), gathers, and the copied numpy code (configs, datasets,
  traffic, AUC);
* ``read_pooled`` against JAX ``pool_bag(read_rows(...))``: rtol 1e-6,
  atol 1e-7. The port adds a bag's rows in l order; XLA's ``jnp.sum`` may
  reduce in another order, which moves the last bit;
* the FFNN (``predict``, ``eval``): rtol 1e-5, atol 1e-6. XLA and torch
  pick different reduction orders inside the matrix products.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import recsys_configs as jcfgs
from repro.core import adapters as jadapters
from repro.core import backend as jbackend
from repro.core import dedup as jdedup
from repro.core import embedding_ps as jps
from repro.core.hybrid import PersiaTrainer as JTrainer
from repro.core.hybrid import TrainMode as JMode
from repro.data import ctr as jctr
from repro.models import recsys as jrecsys
from repro.optim.optimizers import OptConfig
from repro.serving import traffic as jtraffic

from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.configs import recsys_configs as tcfgs
from repro_torch.core import adapters, backend, dedup, embedding_ps
from repro_torch.core.collection import EmbeddingCollection
from repro_torch.core.embedding_ps import EmbeddingSpec
from repro_torch.core.hybrid import PersiaTrainer, TrainMode
from repro_torch.data import ctr
from repro_torch.models import recsys
from repro_torch.serving import traffic

F, RPF, D = 3, 50, 8
CFG = tbase.ModelConfig(name="slice", arch_type="recsys", n_id_fields=F,
                        ids_per_field=4, emb_dim=D, emb_rows=F * RPF,
                        n_dense_features=4, mlp_dims=(16,), n_tasks=2)
DS = ctr.CTRDataset("slice", n_rows=F * RPF, n_fields=F, ids_per_field=4,
                    n_dense=4, n_tasks=2)


def _jcfg():
    from repro.configs.base import ModelConfig
    return ModelConfig(**dataclasses.asdict(CFG))


def _jds():
    return jctr.CTRDataset(**dataclasses.asdict(DS))


# ---------------------------------------------------------------------------
# shuffle placement and the physical row translation
# ---------------------------------------------------------------------------

WIDE_IDS = np.array([0, 1, 2, 4_294, 4_295, 62_499, 1 << 20, 2_147_483_647,
                     2_147_483_646, 123_456_789], np.int64)


@pytest.mark.parametrize("padded_rows", [1, 97, 1024, 62_500, 2_000_000])
def test_shuffle_pos_bit_exact_with_jax_including_wrap(padded_rows):
    """JAX multiplies in uint32, wrapping mod 2^32 for ids past ~4294."""
    rng = np.random.default_rng(padded_rows)
    ids = np.concatenate([WIDE_IDS, rng.integers(0, 2**31 - 1, 500)])
    want = np.asarray(jps.shuffle_pos(jnp.asarray(ids, jnp.int32),
                                      padded_rows)).astype(np.int64)
    got = embedding_ps.shuffle_pos(torch.from_numpy(ids), padded_rows)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("rows", [7, 62_500])
def test_logical_to_pos_bit_exact_with_jax(rows):
    ids = np.concatenate([WIDE_IDS % rows, [-1, -5, rows, rows + 3,
                                            2_147_483_647]])
    jb = jbackend.DenseBackend(jps.EmbeddingSpec(rows=rows, dim=4))
    want = np.asarray(jb._logical_to_pos(jnp.asarray(ids, jnp.int32)))
    tb = backend.DenseBackend(EmbeddingSpec(rows=rows, dim=4))
    got = tb._logical_to_pos(torch.from_numpy(ids))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy()[-4:] == -1).all()


# ---------------------------------------------------------------------------
# dedup plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,rows,floor", [((16, 4), 50, 32),
                                              ((64, 8), 62_500, 32),
                                              ((5, 3), 4, 2), ((1, 1), 9, 1)])
def test_make_plan_bit_exact_with_jax(shape, rows, floor):
    rng = np.random.default_rng(rows)
    ids = rng.integers(-2, rows + 3, shape)
    cap = dedup.dedup_cap(ids.size, rows)
    assert cap == jdedup.dedup_cap(ids.size, rows)
    got = dedup.make_plan(ids, rows, cap, floor)
    want = jdedup.make_plan(ids, rows, cap, floor)
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[3] == want[3]


def test_dedup_helpers_match_jax():
    for n in [0, 1, 31, 32, 33, 1000, 5000]:
        assert dedup.pow2_bucket(n) == jdedup.pow2_bucket(n)
        for r in [1, 50, 62_500]:
            assert dedup.dedup_cap(n, r) == jdedup.dedup_cap(n, r)
    with pytest.raises(ValueError, match="dedup capacity"):
        dedup.make_plan(np.arange(10), 10, cap=4)


def test_plan_scatter_matches_jax():
    rng = np.random.default_rng(0)
    acts = rng.standard_normal((8, D)).astype(np.float32)
    inv = rng.integers(-1, 8, (4, 3)).astype(np.int32)
    want = np.asarray(jdedup.plan_scatter(jnp.asarray(acts),
                                          jnp.asarray(inv)))
    got = dedup.plan_scatter(torch.from_numpy(acts), torch.from_numpy(inv))
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# backend reads
# ---------------------------------------------------------------------------

def _tables(rows=RPF, dim=D, dedup_on=True, seed=0):
    """A JAX DenseBackend state and the port's backend over the same
    physical table."""
    spec_j = jps.EmbeddingSpec(rows=rows, dim=dim, batch_dedup=dedup_on)
    jb = jbackend.DenseBackend(spec_j)
    jstate = jb.init(jax.random.PRNGKey(seed))
    tb = backend.DenseBackend(EmbeddingSpec(rows=rows, dim=dim,
                                            batch_dedup=dedup_on))
    tstate = {k: torch.from_numpy(np.array(v)) for k, v in jstate.items()}
    return jb, jstate, tb, tstate


def _serve_ids(rng, B=16, L=4, rows=RPF):
    ids = rng.integers(0, rows, (B, L))
    lens = rng.integers(0, L + 1, B)
    ids = np.where(np.arange(L)[None, :] < lens[:, None], ids, -1)
    ids[0, 0] = rows + 2                     # out of range: reads as zero
    return ids.astype(np.int32)


def test_read_rows_and_lookup_bit_exact_with_jax():
    jb, js, tb, ts = _tables()
    ids = _serve_ids(np.random.default_rng(1))
    want, want_info = jb.read_rows(js, ids)
    got, info = tb.read_rows(ts, ids)
    np.testing.assert_array_equal(got.numpy(), want)
    assert info == want_info
    # the plan form of the training lookup: unique gather + scatter
    u_pad, inv, _, _ = dedup.make_plan(ids, RPF, dedup.dedup_cap(ids.size,
                                                                 RPF))
    jplan = jdedup.DedupPlan(dev=jnp.asarray(u_pad, jnp.int32),
                             inv=jnp.asarray(inv))
    tplan = dedup.DedupPlan(dev=torch.from_numpy(u_pad),
                            inv=torch.from_numpy(inv))
    np.testing.assert_array_equal(tb.lookup(ts, tplan)[0].numpy(),
                                  np.asarray(jb.lookup(js, jplan)[0]))


@pytest.mark.parametrize("dedup_on", [True, False])
def test_read_pooled_matches_jax_pool_of_read_rows(dedup_on):
    jb, js, tb, ts = _tables(dedup_on=dedup_on)
    ids = _serve_ids(np.random.default_rng(2))
    rows, want_info = jb.read_rows(js, ids)
    want = np.asarray(jrecsys.pool_bag(jnp.asarray(rows), jnp.asarray(ids)))
    got, info = tb.read_pooled(ts, ids)
    assert got.shape == (ids.shape[0], D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    assert info == want_info
    # ids >= rows and padding read as zero: bag 0's first id is past the end
    ids2 = np.full_like(ids, -1)
    ids2[:, 0] = RPF + 1
    assert not tb.read_pooled(ts, ids2)[0].any()


def test_read_pooled_rejects_unbagged_ids():
    _, _, tb, ts = _tables()
    with pytest.raises(ValueError, match=r"\(B, L\)"):
        tb.read_pooled(ts, np.arange(4))


def test_collection_validates_names_and_backends():
    spec = EmbeddingSpec(rows=4, dim=2)
    coll = EmbeddingCollection.from_dict({"a": spec, "b": spec})
    assert coll.names == ("a", "b") and len(coll) == 2
    assert coll.with_staleness(3)["b"].staleness == 3
    assert set(coll.make_backends()) == {"a", "b"}
    for bad in ["", "x/y", "12"]:
        with pytest.raises(ValueError, match="invalid table name"):
            EmbeddingCollection.from_dict({bad: spec})
    with pytest.raises(ValueError, match="duplicate"):
        EmbeddingCollection((("a", spec), ("a", spec)))
    # the host_lru tiers are ported: the fail-fast builds their backends
    # (and still refuses a host_lru spec with no device cache)
    lru = EmbeddingCollection.from_dict(
        {"a": dataclasses.replace(spec, backend="host_lru+disk",
                                  cache_rows=2)})
    assert lru["a"].backend == "host_lru+disk"
    with pytest.raises(ValueError, match="cache_rows"):
        EmbeddingCollection.from_dict(
            {"a": dataclasses.replace(spec, backend="host_lru")})


# ---------------------------------------------------------------------------
# the whole slice from a JAX trainer's state
# ---------------------------------------------------------------------------

def _jax_trainer(dedup_on):
    jad = jadapters.recsys_adapter(_jcfg(), field_rows=_jds().field_rows())
    return JTrainer(jad, JMode.sync(), OptConfig(kind="adam", lr=1e-3),
                    batch_dedup=dedup_on)


def _port_trainer(dedup_on):
    ad = adapters.recsys_adapter(CFG, field_rows=DS.field_rows())
    return PersiaTrainer(ad, TrainMode.sync(), batch_dedup=dedup_on,
                         device="cpu")


def _carry(jt, jstate, tt):
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return convert.state_from_numpy(tt, to_np(jstate.dense),
                                    to_np(jstate.emb), device="cpu")


@pytest.mark.parametrize("dedup_on", [True, False])
def test_slice_matches_jax_trainer(dedup_on):
    jt, tt = _jax_trainer(dedup_on), _port_trainer(dedup_on)
    batch = next(DS.sampler(32, seed=5))
    jstate = jt.init(jax.random.PRNGKey(0),
                     {k: jnp.asarray(v) for k, v in batch.items()})
    tstate = _carry(jt, jstate, tt)

    want = np.asarray(jt.predict(jstate, batch))
    got = tt.predict(tstate, batch)
    assert got.shape == (32, CFG.n_tasks)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)

    jm, tm = jt.eval(jstate, batch), tt.eval(tstate, batch)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm["pred_mean"]),
                               float(jm["pred_mean"]), rtol=1e-5)

    _, jinfo = jt.serve_lookup(jstate, batch)
    pooled, tinfo = tt.serve_lookup(tstate, batch)
    assert tinfo == jinfo                                 # gauges exact
    jacts = jt.lookup(jstate, batch)
    tacts = tt.lookup(tstate, batch)
    for n in tt.collection.names:
        np.testing.assert_array_equal(tacts[n].numpy(),
                                      np.asarray(jacts[n]))
        assert pooled[n].shape == (32, D)


def test_forward_concatenates_tables_in_sorted_name_order():
    rng = np.random.default_rng(0)
    params_np = {"mlp": [{"w": rng.standard_normal((2 * 3 + 1, 2))
                          .astype(np.float32),
                          "b": np.zeros(2, np.float32)}]}
    pooled_np = {n: rng.standard_normal((4, 3)).astype(np.float32)
                 for n in ("b_tab", "a_tab")}
    dense = rng.standard_normal((4, 1)).astype(np.float32)
    cfg = CFG.replace(n_dense_features=1)
    jparams = jax.tree.map(jnp.asarray, params_np)
    want = np.asarray(jrecsys.recsys_forward_tables(
        _jcfg().replace(n_dense_features=1), jparams,
        {n: jnp.asarray(a)[:, None, :] for n, a in pooled_np.items()},
        {n: jnp.zeros((4, 1), jnp.int32) for n in pooled_np},
        jnp.asarray(dense)))
    got = recsys.recsys_forward_pooled(
        cfg, {"mlp": [{k: torch.from_numpy(v) for k, v in lyr.items()}
                      for lyr in params_np["mlp"]]},
        {n: torch.from_numpy(a) for n, a in pooled_np.items()}, dense)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_convert_checks_shapes_and_tables():
    tt = _port_trainer(True)
    state = tt.init(seed=0)
    dense = {"mlp": [{k: v.numpy() for k, v in lyr.items()}
                     for lyr in state.dense["mlp"]]}
    emb = {n: {k: v.numpy() for k, v in s.items()}
           for n, s in state.emb.items()}
    back = convert.state_from_numpy(tt, dense, emb)
    for n in emb:
        assert torch.equal(back.emb[n]["table"], state.emb[n]["table"])
    bad = {**emb, "field_00": {**emb["field_00"],
                               "table": emb["field_00"]["table"][:-1]}}
    with pytest.raises(ValueError, match="field_00.table"):
        convert.state_from_numpy(tt, dense, bad)
    with pytest.raises(ValueError, match="do not match"):
        convert.state_from_numpy(tt, dense, {"field_00": emb["field_00"]})
    with pytest.raises(ValueError, match="MLP layers"):
        convert.state_from_numpy(tt, {"mlp": dense["mlp"][:1]}, emb)


def test_trainer_init_is_seeded_and_sized():
    tt = _port_trainer(True)
    a, b, c = tt.init(seed=1), tt.init(seed=1), tt.init(seed=2)
    t = a.emb["field_00"]["table"]
    assert t.shape == (RPF, D) and a.emb["field_00"]["acc"].shape == (RPF,)
    assert torch.equal(t, b.emb["field_00"]["table"])
    assert not torch.equal(t, c.emb["field_00"]["table"])
    w = [lyr["w"].shape for lyr in a.dense["mlp"]]
    assert w == [(F * D + 4, 16), (16, CFG.n_tasks)]
    assert set(a.opt) == {"m", "v", "t"} and a.opt["t"] == 0 and a.step == 0
    assert torch.equal(a.opt["m"]["mlp"][0]["w"], torch.zeros(F * D + 4, 16))
    assert set(a.emb_queue) == set(tt.collection.names)


# ---------------------------------------------------------------------------
# copied JAX-free modules: configs, datasets, traffic, AUC
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["TAOBAO", "AVAZU", "CRITEO", "KWAI"])
def test_recsys_configs_equal_jax(name):
    assert dataclasses.asdict(getattr(tcfgs, name)) == \
        dataclasses.asdict(getattr(jcfgs, name))
    assert dataclasses.asdict(tcfgs.criteo_syn(1.0)) == \
        dataclasses.asdict(jcfgs.criteo_syn(1.0))


@pytest.mark.parametrize("name", sorted(ctr.CTR_BENCHMARKS))
def test_ctr_batches_equal_jax(name):
    tds, jds = ctr.CTR_BENCHMARKS[name], jctr.CTR_BENCHMARKS[name]
    assert dataclasses.asdict(tds) == dataclasses.asdict(jds)
    tb, jb = next(tds.sampler(8, seed=3)), next(jds.sampler(8, seed=3))
    assert tb.keys() == jb.keys()
    for k in tb:
        np.testing.assert_array_equal(tb[k], jb[k])


def test_traffic_requests_equal_jax():
    tm = traffic.TrafficModel.for_dataset(DS, n_users=500)
    jm = jtraffic.TrafficModel.for_dataset(_jds(), n_users=500)
    for (tu, tr), (ju, jr) in zip(tm.requests(20, seed=1),
                                  jm.requests(20, seed=1)):
        assert tu == ju
        for k in tr:
            np.testing.assert_array_equal(tr[k], jr[k])
    tg = traffic.TrafficGenerator(tm, qps=100.0)
    jg = jtraffic.TrafficGenerator(jm, qps=100.0)
    assert [t for t, _, _ in tg.arrivals(10)] == \
        [t for t, _, _ in jg.arrivals(10)]


def test_auc_equals_jax():
    rng = np.random.default_rng(0)
    labels = (rng.random(200) < 0.3).astype(np.float32)
    scores = np.round(rng.random(200), 2)                 # with ties
    assert adapters.auc(labels, scores) == jadapters.auc(labels, scores)
    assert adapters.auc(np.ones(4), scores[:4]) == 0.5


def test_train_mode_matches_jax():
    for t, j in [(TrainMode.sync(), JMode.sync()),
                 (TrainMode.hybrid(2), JMode.hybrid(2)),
                 (TrainMode.async_(2, 1), JMode.async_(2, 1))]:
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
