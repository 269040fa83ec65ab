"""The grouped kernels' wrappers (``ops.unique_bag_grouped``, with
occurrence-width ``embedding_bag`` tables among its plan tables,
``ops.blockscale_compress_grouped``, ``ops.blockscale_decompress_grouped``)
and the all-table functions built on them (``backend.lookup_all``,
``put_all``, ``read_pooled_all``) on the CPU.

Tolerance: bit-exact throughout. On the CPU a grouped wrapper loops its
plain version table by table, and the all-table functions compute each
table's result with the same operations as the per-table methods
(``lookup_pooled``, ``hybrid_update``, ``read_pooled``), only in another
order across tables, which share no state. The grouped results are held
against the JAX package's oracles per table too: the bag pools add in l
order and the codec rounds each operation once on both sides. The CUDA
kernels are held against these plain versions on the card
(``test_torch_cuda.py`` and ``chip_smoke.py``).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as JC
from repro.kernels import blockscale as JB
from repro.kernels import ref as jref

from repro_torch.core import adapters, backend
from repro_torch.core.embedding_ps import EmbeddingSpec
from repro_torch.core.hybrid import PersiaTrainer, TrainMode
from repro_torch.kernels import ops
from repro_torch.optim import optimizers as topt
from repro_torch.utils import tree_leaves

from test_torch_cuda import (_bag_group, _codec_group, _codec_tensors,
                             _compress_group, _compress_tensors, _flat_group,
                             _group_tensors)
from test_torch_train import CFG, DENSE_LR, DS, EMB_LR, _batches


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int16 if t.element_size() == 2
                               else torch.int32)


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and \
        torch.equal(_bits(a), _bits(b))


# ---------------------------------------------------------------------------
# the grouped wrappers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_tables", [None, 100])
def test_unique_bag_grouped_equals_per_table_and_jax(n_tables):
    """Unequal V, U, B, L and D (D % 4 != 0), B = 0, U = 0, L > 32,
    padding, ids past the end, the identity dev; 100 tables are more than
    one launch takes on the card. The JAX oracle holds the fixed group's
    bags of L <= 8 (XLA sums a longer axis in another order than one l at
    a time; each new shape is a compile, so not the 100 random tables)."""
    tables, devs, invs = _group_tensors(_bag_group(3, n_tables), "cpu")
    ops.reset_launch_counts()
    got = ops.unique_bag_grouped(tables, devs, invs)
    assert ops.launch_counts()["unique_bag"] == 0
    assert ops.table_counts()["unique_bag"] == 0
    assert len(got) == len(tables)
    for t, d, i, g in zip(tables, devs, invs, got):
        dev = torch.arange(t.shape[0], dtype=torch.int32) if d is None else d
        assert _same(g, ops.unique_bag(t, dev, i))
        if n_tables is None and t.shape[0] and i.numel() and dev.numel() \
                and i.shape[1] <= 8:
            want = np.asarray(jref.unique_bag_ref(
                *(jnp.asarray(x.numpy()) for x in (t, dev, i))))
            np.testing.assert_array_equal(g.numpy(), want)


@pytest.mark.parametrize("n_tables", [None, 100])
def test_decompress_grouped_equals_per_table_and_jax(n_tables):
    """Payloads of unequal length and block: empty, a partial last block,
    the scalar path's lengths and block, outputs given as shapes and as
    tensors written in place (one at an offset that misaligns it on the
    card). The JAX codec holds the fixed group."""
    comps, scales, outs, wants = _codec_tensors(_codec_group(4, n_tables),
                                                "cpu")
    ops.reset_launch_counts()
    got = ops.blockscale_decompress_grouped(comps, scales, outs)
    assert ops.launch_counts()["blockscale_decompress"] == 0
    for c, s, o, g, w in zip(comps, scales, outs, got, wants):
        if isinstance(o, torch.Tensor):
            assert g is o                     # written in place
        shape = tuple(o.shape) if isinstance(o, torch.Tensor) else o
        per_table = ops.blockscale_decompress(c, s, shape)
        assert _same(g, per_table) and _same(g, w)
        if n_tables is None and g.numel():
            jv = np.asarray(JC.blockscale_decompress(
                jnp.asarray(c.numpy()), jnp.asarray(s.numpy()), shape))
            np.testing.assert_array_equal(g.numpy(), jv)


def _same_or_both_nan(a: np.ndarray, b: np.ndarray) -> bool:
    """Bit-equal, except that a NaN may carry another payload on each side
    (torch and XLA propagate NaN bits differently on the CPU)."""
    a, b = np.asarray(a), np.asarray(b)
    view = np.uint16 if a.dtype == np.float16 else np.uint32
    nan = np.isnan(a)
    return a.shape == b.shape and np.array_equal(nan, np.isnan(b)) and \
        np.array_equal(a[~nan].view(view), b[~nan].view(view))


@pytest.mark.parametrize("n_tables", [None, 100])
def test_compress_grouped_equals_per_table_and_jax(n_tables):
    """Payloads of unequal length and block: empty, a partial last block,
    the scalar path's lengths and block, a block longer than 128, a NaN
    block, a misaligned view on the card; 100 payloads are more than one
    launch takes on the card. The fixed group is held against the JAX
    codec, and its block-128 payloads of whole 256-block tiles against the
    Pallas kernel in interpret mode too."""
    cases = _compress_group(6, n_tables)
    vs, blocks = _compress_tensors(cases, "cpu")
    ops.reset_launch_counts()
    got = ops.blockscale_compress_grouped(vs, blocks)
    assert ops.launch_counts()["blockscale_compress"] == 0
    assert ops.table_counts()["blockscale_compress"] == 0
    assert len(got) == len(vs)
    for v, b, (c, sc) in zip(vs, blocks, got):
        pc, ps = ops.blockscale_compress(v, b)
        assert _same(c, pc) and _same(sc, ps)
        if n_tables is not None:
            continue
        jc, js, _ = JC.blockscale_compress(jnp.asarray(v.numpy()), b)
        assert _same_or_both_nan(c.numpy(), jc)
        assert _same_or_both_nan(sc.numpy(), js)
        if b == 128 and v.numel() and v.numel() % (256 * 128) == 0:
            kc, ks = JB.compress(jnp.asarray(v.numpy().reshape(-1, 128)),
                                 interpret=True)
            assert _same_or_both_nan(c.numpy(), kc)
            assert _same_or_both_nan(sc.numpy(), ks)
    # one block for every payload
    same = ops.blockscale_compress_grouped(vs[:4], 64)
    for v, (c, sc) in zip(vs, same):
        pc, ps = ops.blockscale_compress(v, 64)
        assert _same(c, pc) and _same(sc, ps)


def test_bag_grouped_pools_occurrence_tables_as_embedding_bag():
    """Occurrence-width tables (``flat``: the identity dev, ids into the
    table) among the plan tables of one group: each equals
    ``embedding_bag`` and the JAX package's oracle."""
    tables, devs, invs = _group_tensors(_bag_group(3), "cpu")
    ft, fi = _flat_group(8, "cpu")
    ops.reset_launch_counts()
    got = ops.unique_bag_grouped(tables + ft, devs + [None] * len(ft),
                                 invs + fi,
                                 [False] * len(tables) + [True] * len(ft))
    assert ops.launch_counts()["embedding_bag"] == 0
    assert ops.table_counts()["embedding_bag"] == 0
    for g, t, d, i in zip(got, tables, devs, invs):
        dev = torch.arange(t.shape[0], dtype=torch.int32) if d is None else d
        assert _same(g, ops.unique_bag(t, dev, i))
    for g, t, i in zip(got[len(tables):], ft, fi):
        assert _same(g, ops.embedding_bag(t, i))
        if i.numel():
            want = np.asarray(jref.embedding_bag_ref(jnp.asarray(t.numpy()),
                                                     jnp.asarray(i.numpy())))
            np.testing.assert_array_equal(g.numpy(), want)


def test_grouped_wrappers_check_their_arguments():
    t = torch.ones((5, 4))
    i = torch.zeros((2, 3), dtype=torch.int32)
    assert ops.unique_bag_grouped([], [], []) == []
    assert ops.blockscale_decompress_grouped([], [], []) == []
    assert ops.blockscale_compress_grouped([]) == []
    with pytest.raises(ValueError, match="1 tables, 0 devs"):
        ops.unique_bag_grouped([t], [], [i])
    with pytest.raises(ValueError, match="takes no dev"):
        ops.unique_bag_grouped([t], [i[0]], [i], [True])
    with pytest.raises(ValueError, match="1 flat marks"):
        ops.unique_bag_grouped([t, t], [None, None], [i, i], [True])
    with pytest.raises(ValueError, match="2 payloads and 1 blocks"):
        ops.blockscale_compress_grouped([t, t], [4])
    with pytest.raises(ValueError, match="positive int"):
        ops.blockscale_compress_grouped([t], 0)
    with pytest.raises(ValueError, match="one CUDA device"):
        ops.blockscale_compress_grouped([t.to("meta")])
    with pytest.raises(ValueError, match=r"inv \(B, L\)"):
        ops.unique_bag_grouped([t], [None], [i[0]])
    with pytest.raises(ValueError, match="one CUDA device"):
        ops.unique_bag_grouped([t, t.to("meta")], [None, None], [i, i])
    c, s = ops.blockscale_compress(torch.ones(10), 4)
    with pytest.raises(ValueError, match="12 compressed elements"):
        ops.blockscale_decompress_grouped([c], [s], [(13,)])
    with pytest.raises(ValueError, match="one CUDA device"):
        ops.blockscale_decompress_grouped([c], [s], [torch.empty(
            4, device="meta")])


# ---------------------------------------------------------------------------
# lookup_all / put_all / read_pooled_all against the per-table methods
# ---------------------------------------------------------------------------

def _lookup_per_table(backends, states, dev_ids):
    pooled, metrics = {}, {}
    for n in dev_ids:
        pooled[n], m = backends[n].lookup_pooled(states[n], dev_ids[n])
        backend._tag(metrics, n, m)
    return pooled, metrics


def _put_per_table(backends, states, queues, dev_ids, grads):
    queues = queues or {}
    new_states, new_queues, metrics = dict(states), dict(queues), {}
    for n in dev_ids:
        new_states[n], new_queues[n], m = backends[n].hybrid_update(
            states[n], queues.get(n), dev_ids[n], grads[n])
        backend._tag(metrics, n, m)
    return new_states, new_queues, metrics


def _read_per_table(backends, states, ids, device):
    pooled, info = {}, {}
    for n, x in ids.items():
        pooled[n], info[n] = backends[n].read_pooled(states[n], x)
    return pooled, info


# name -> (rows, dim, backend, batch_dedup, ids per bag[, wire_block])
TABLES = {"a": (300, 16, "dense", True, 4),
          "b": (120, 13, "dense", True, 3),
          "c": (500, 16, "dense", False, 4),
          "d": (200, 128, "dense+compressed", True, 8),
          "e": (90, 16, "dense+compressed", False, 2),
          "f": (60, 12, "dense+compressed", True, 5)}
# groups of one kind each: every table at occurrence width (dense and
# behind the wire), and every table behind the wire (plan and occurrence
# width, blocks of 128, 64 and 12)
GROUPS = {"mixed": TABLES,
          "flat": {"c": TABLES["c"], "e": TABLES["e"],
                   "g": (80, 8, "dense", False, 3),
                   "h": (150, 24, "dense+compressed", False, 6, 64)},
          "wire": {"d": TABLES["d"], "e": TABLES["e"], "f": TABLES["f"],
                   "i": (140, 20, "dense+compressed", True, 4, 64),
                   "j": (70, 12, "dense+compressed", False, 3, 12)}}


def _collection(staleness, tables=TABLES):
    specs = {n: EmbeddingSpec(rows=r, dim=d, staleness=staleness, lr=0.05,
                              backend=bk, batch_dedup=dd,
                              wire_block=block[0] if block else 128)
             for n, (r, d, bk, dd, _, *block) in tables.items()}
    backends = {n: backend.create_backend(s) for n, s in specs.items()}
    rng = np.random.default_rng(staleness)
    states = {}
    for n, s in specs.items():
        table = rng.standard_normal((s.rows, s.dim)).astype(np.float32)
        states[n] = {"table": torch.from_numpy(table),
                     "acc": torch.from_numpy(
                         rng.random(s.rows).astype(np.float32))}
    return backends, states


def _ids(rng, n_bags, tables=TABLES):
    out = {}
    for n, (rows, _, _, _, L, *_) in tables.items():
        ids = rng.integers(0, rows + 3, (n_bags, L))    # some past the end
        ids[rng.random((n_bags, L)) < 0.2] = -1
        out[n] = ids
    return out


def _clone(states):
    return {n: {k: v.clone() for k, v in st.items()}
            for n, st in states.items()}


@pytest.mark.parametrize("staleness,group", [
    (0, "mixed"), (3, "mixed"), (0, "flat"), (3, "flat"), (0, "wire"),
    (3, "wire")], ids=["0", "3", "flat-0", "flat-3", "wire-0", "wire-3"])
def test_lookup_all_and_put_all_equal_the_per_table_path(staleness, group):
    tables = GROUPS[group]
    backends, states = _collection(staleness, tables)
    sides = {"grouped": (backend.lookup_all, backend.put_all),
             "per_table": (_lookup_per_table, _put_per_table)}
    st = {k: _clone(states) for k in sides}
    qs = {k: {n: b.queue_init((16, tables[n][4]), "cpu")
              for n, b in backends.items()} for k in sides}
    rng = np.random.default_rng(7)
    for _ in range(5):
        ids = _ids(rng, 16, tables)
        grads = {n: torch.from_numpy(rng.standard_normal(
            (16, tables[n][4], tables[n][1])).astype(np.float32))
            for n in tables}
        out = {}
        for k, (lookup, put) in sides.items():
            _, dev_ids, _ = backend.prepare_all(backends, st[k], ids, "cpu")
            pooled, gm = lookup(backends, st[k], dev_ids)
            st[k], qs[k], pm = put(backends, st[k], qs[k], dev_ids, grads)
            out[k] = pooled, gm, pm
        (pg, gg, pmg), (pp, gp, pmp) = out["grouped"], out["per_table"]
        assert list(pg) == list(tables)
        for n in tables:
            assert _same(pg[n], pp[n]), n
        for m, w in ((gg, gp), (pmg, pmp)):
            assert set(m) == set(w)
            for key in m:
                assert float(m[key]) == float(w[key]), key
    for n in tables:
        for key in ("table", "acc"):
            assert _same(st["grouped"][n][key], st["per_table"][n][key])
        qg, qp = qs["grouped"][n], qs["per_table"][n]
        assert (qg is None) == (qp is None) == (staleness == 0)
        if qg is not None:
            assert (qg["ptr"], qg["filled"]) == (qp["ptr"], qp["filled"])
            assert _same(qg["ids"], qp["ids"])
            assert _same(qg["grads"], qp["grads"])


def _read_pooled_all_equals_read_pooled(group):
    tables = GROUPS[group]
    backends, states = _collection(0, tables)
    rng = np.random.default_rng(9)
    ids = _ids(rng, 24, tables)
    first, wired = list(tables)[0], [n for n in tables if "compressed" in
                                      tables[n][2]]
    ids[first][0] = -5                     # all padding, another negative
    ids[wired[0]][1, 0] = 2**40            # past int32: still out of range
    got, info = backend.read_pooled_all(backends, states, ids, "cpu")
    want, winfo = _read_per_table(backends, states, ids, "cpu")
    assert list(got) == list(tables) and info == winfo
    for n in tables:
        assert _same(got[n], want[n]), n


def test_read_pooled_all_equals_read_pooled():
    _read_pooled_all_equals_read_pooled("mixed")


@pytest.mark.parametrize("group", ["flat", "wire"])
def test_read_pooled_all_equals_read_pooled_per_group(group):
    _read_pooled_all_equals_read_pooled(group)


VARIANTS = {"dense": lambda n, s: s,
            "compressed": lambda n, s: dataclasses.replace(
                s, backend="dense+compressed"),
            # one table of each kind: a plan, the wire's plan, the wire at
            # occurrence width
            "mixed": lambda n, s: dataclasses.replace(
                s, **[{}, {"backend": "dense+compressed"},
                      {"backend": "dense+compressed", "batch_dedup": False}
                      ][int(n.rsplit("_", 1)[1]) % 3])}


@pytest.mark.parametrize("mode", ["sync", "hybrid", "async"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_trainer_steps_equal_the_per_table_path(monkeypatch, variant, mode):
    """Four trainer steps and a serve read through the grouped stage
    functions and through the per-table methods, from one state: every
    tensor of the state and every pooled bag bit for bit."""
    tm = {"sync": TrainMode.sync(), "hybrid": TrainMode.hybrid(3),
          "async": TrainMode.async_(2, 2)}[mode]
    ad = adapters.recsys_adapter(CFG, lr=EMB_LR, field_rows=DS.field_rows())
    ad = dataclasses.replace(
        ad, collection=ad.collection.map_specs(VARIANTS[variant]))
    tt = PersiaTrainer(ad, tm, topt.OptConfig(kind="adam", lr=DENSE_LR),
                       device="cpu")
    batches = _batches(4, seed=11)
    start = tt.init(seed=0, batch_example=batches[0])
    runs = {}
    for side in ("grouped", "per_table"):
        with monkeypatch.context() as mp:
            if side == "per_table":
                mp.setattr(backend, "lookup_all", _lookup_per_table)
                mp.setattr(backend, "put_all", _put_per_table)
                mp.setattr(backend, "read_pooled_all", _read_per_table)
            s = start.to("cpu")
            for b in batches:
                s, _ = tt.step(s, b)
            pooled, _ = tt.serve_lookup(s, batches[0])
            runs[side] = s, pooled
    (sg, pg), (sp, pp) = runs["grouped"], runs["per_table"]
    assert sg.step == sp.step == 4
    for field in ("dense", "opt", "emb", "emb_queue", "dense_queue"):
        lg = tree_leaves(getattr(sg, field))
        lp = tree_leaves(getattr(sp, field))
        assert len(lg) == len(lp)
        for a, b in zip(lg, lp):
            if isinstance(a, torch.Tensor):
                assert _same(a, b), field
            else:
                assert a == b, field
    for n in pg:
        assert _same(pg[n], pp[n]), n
