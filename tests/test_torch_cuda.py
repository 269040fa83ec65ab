"""The port's CUDA kernels against their plain torch versions, bit for bit,
on the card. Every test here needs an NVIDIA GPU and nvcc and skips without
them; run them on the GPU machine with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

This file imports no JAX, so it runs where only the port is installed.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.dedup import occurrence_csr
from repro_torch.kernels import ops, ref

SHAPES = [  # (V, D, B, L)
    (1, 1, 1, 1),
    (50, 8, 4, 3),
    (200, 128, 16, 8),
    (300, 13, 8, 5),
    (97, 64, 33, 2),
    (62_500, 128, 64, 8),       # one table of the kwai-dlrm serving flush
]


def _bags(rng, B, L, V):
    ids = rng.integers(0, V, (B, L))
    lens = rng.integers(0, L + 1, B)
    return np.where(np.arange(L)[None, :] < lens[:, None], ids,
                    -1).astype(np.int32)


def _plan(ids, extra_pad):
    """Sorted unique ids padded with -1 and the occurrence inverse."""
    flat = ids.reshape(-1)
    valid = flat >= 0
    uniq, inv_v = np.unique(flat[valid], return_inverse=True)
    dev = np.concatenate([uniq, np.full(max(1, extra_pad), -1)])
    inv = np.full(flat.shape, -1)
    inv[valid] = inv_v
    return dev.astype(np.int32), inv.reshape(ids.shape).astype(np.int32)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("V,D,B,L", SHAPES)
def test_cuda_kernels_match_plain_versions(cuda_device, V, D, B, L):
    rng = np.random.default_rng(V + D)
    table = torch.from_numpy(
        rng.standard_normal((V, D)).astype(np.float32)).to(cuda_device)
    ids = _bags(rng, B, L, V)
    dev, inv = _plan(ids, extra_pad=3)
    ids_t, dev_t, inv_t = (torch.from_numpy(x).to(cuda_device)
                           for x in (ids, dev, inv))
    ops.reset_launch_counts()
    assert torch.equal(ops.embedding_bag(table, ids_t),
                       ref.embedding_bag_ref(table, ids_t))
    assert torch.equal(ops.unique_bag(table, dev_t, inv_t),
                       ref.unique_bag_ref(table, dev_t, inv_t))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert (counts["embedding_bag"], counts["unique_bag"]) == (1, 1)


@pytest.mark.cuda
def test_cuda_wrappers_reject_non_fp32(cuda_device):
    table = torch.ones((5, 4), dtype=torch.bfloat16, device=cuda_device)
    ids = torch.zeros((2, 3), dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError, match="fp32"):
        ops.embedding_bag(table, ids)
    with pytest.raises(TypeError, match="int32"):
        ops.embedding_bag(table.float(), ids.long())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["all_padding", "all_duplicate",
                                  "dev_padding", "past_end"])
def test_cuda_kernels_edge_cases(cuda_device, case):
    rng = np.random.default_rng(1)
    V, D, B, L = 40, 16, 6, 4
    table = torch.from_numpy(
        rng.standard_normal((V, D)).astype(np.float32)).to(cuda_device)
    ids = {"all_padding": np.full((B, L), -1, np.int32),
           "all_duplicate": np.full((B, L), 7, np.int32)}.get(
        case, _bags(rng, B, L, V))
    dev, inv = _plan(ids, extra_pad=4)
    if case == "dev_padding":
        n_u = int((dev >= 0).sum())
        inv = np.where((np.arange(L)[None, :] % 2 == 1) & (inv >= 0),
                       n_u + inv % 4, inv).astype(np.int32)
    if case == "past_end":
        ids[:, 0] = V + 3
        dev[0] = V
    ids_t, dev_t, inv_t = (torch.from_numpy(x).to(cuda_device)
                           for x in (ids, dev, inv))
    assert torch.equal(ops.embedding_bag(table, ids_t),
                       ref.embedding_bag_ref(table, ids_t))
    assert torch.equal(ops.unique_bag(table, dev_t, inv_t),
                       ref.unique_bag_ref(table, dev_t, inv_t))
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# the grouped kernels: the bag kernel (unique_bag and embedding_bag),
# blockscale_compress and blockscale_decompress, one launch for a group of
# tables (the case generators are shared with the CPU tests of
# test_torch_grouped.py)
# ---------------------------------------------------------------------------

BAG_TABLES = [  # (V, D, B, L, kind)
    (200, 128, 16, 8, "plan"),
    (300, 13, 8, 5, "plan"),            # D % 4 != 0: the scalar path
    (50, 8, 0, 3, "plan"),              # B = 0: no bag
    (40, 16, 6, 4, "empty_dev"),        # U = 0: every bag reads nothing
    (97, 64, 33, 2, "past_end"),        # inv >= U and dev >= V, clamped
    (60, 4, 5, 40, "plan"),             # L > 32: two index rounds a bag
    (30, 24, 7, 3, "identity"),         # dev None: the rows themselves
    (70, 32, 9, 6, "misaligned"),       # table 4 bytes off: scalar path
    (62_500, 128, 64, 8, "plan"),       # one kwai-dlrm serving table
]


def _bag_group(seed, n=None):
    """Host inputs of one grouped unique_bag: ``BAG_TABLES``, or ``n``
    tables of random shapes (several chunks of descriptors for n = 100).
    Each is (table, dev or None, inv, kind)."""
    rng = np.random.default_rng(seed)
    specs = BAG_TABLES if n is None else [
        (int(rng.integers(1, 400)), int(rng.choice([1, 3, 4, 8, 13, 128])),
         int(rng.integers(0, 40)), int(rng.integers(0, 10)),
         str(rng.choice(["plan", "past_end", "identity"])))
        for _ in range(n)]
    cases = []
    for V, D, B, L, kind in specs:
        table = rng.standard_normal((V, D)).astype(np.float32)
        ids = _bags(rng, B, L, V)
        dev, inv = _plan(ids, extra_pad=3)
        if kind == "past_end":
            dev[0] = V + 7
            inv[:, -1:] = dev.size + 5
        elif kind == "empty_dev":
            dev = dev[:0]
        elif kind == "identity":
            dev = None
            inv = rng.integers(-1, V + 3, (B, L)).astype(np.int32)
        cases.append((table, dev, inv, kind))
    return cases


def _group_tensors(cases, device):
    """(tables, devs, invs) on ``device``; a ``misaligned`` table starts 4
    bytes into its buffer."""
    tables, devs, invs = [], [], []
    for table, dev, inv, kind in cases:
        t = torch.from_numpy(table).to(device)
        if kind == "misaligned":
            buf = torch.empty(t.numel() + 1, device=device)
            buf[1:].copy_(t.reshape(-1))
            t = buf[1:].view(t.shape)
        tables.append(t)
        devs.append(None if dev is None else torch.from_numpy(dev).to(device))
        invs.append(torch.from_numpy(inv).to(device))
    return tables, devs, invs


CODEC_TABLES = [  # (n, block, out)
    (300 * 128, 128, "shape"),
    (1000, 64, "into"),
    (0, 128, "shape"),                  # empty
    (4096 - 76, 128, "into"),           # a partial last block
    (5000 - 77, 128, "shape"),          # n % 4 != 0: the scalar path
    (3000, 30, "shape"),                # block % 4 != 0: the scalar path
    (2048, 128, "misaligned"),          # out 4 bytes off: the scalar path
    (1030 * 128, 128, "into"),          # one table's unique rows
]


def _codec_group(seed, n=None):
    """Host payloads of one grouped decompress: ``CODEC_TABLES``, or ``n``
    of random lengths and blocks. Each is (v, block, out kind)."""
    rng = np.random.default_rng(seed)
    specs = CODEC_TABLES if n is None else [
        (int(rng.integers(0, 6000)), int(rng.choice([30, 64, 128])),
         str(rng.choice(["shape", "into", "misaligned"])))
        for _ in range(n)]
    return [((rng.standard_normal(m) * np.exp(rng.standard_normal(m) * 4))
             .astype(np.float32), block, kind) for m, block, kind in specs]


def _codec_tensors(cases, device):
    """(comps, scales, outs, wants) on ``device``: the plain compress of
    each payload, its output (a shape, a zeroed tensor, or one 4 bytes
    into its buffer) and the plain decompress it must equal."""
    comps, scales, outs, wants = [], [], [], []
    for v, block, kind in cases:
        c, s = ref.blockscale_compress_ref(torch.from_numpy(v), block)
        want = ref.blockscale_decompress_ref(c, s).reshape(-1)[:v.size]
        comps.append(c.to(device))
        scales.append(s.to(device))
        wants.append(want.to(device))
        if kind == "shape":
            outs.append((v.size,))
        elif kind == "into":
            outs.append(torch.zeros(v.size, device=device))
        else:
            outs.append(torch.zeros(v.size + 1, device=device)[1:])
    return comps, scales, outs, wants


COMPRESS_TABLES = [  # (n, block, kind)
    (300 * 128, 128, "plain"),
    (1000, 64, "plain"),
    (0, 128, "plain"),                  # empty
    (4096 - 76, 128, "plain"),          # a partial last block
    (5000 - 77, 128, "plain"),          # n % 4 != 0: the scalar path
    (3000, 30, "plain"),                # block % 4 != 0: the scalar path
    (2048, 128, "misaligned"),          # v 4 bytes off: the scalar path
    (1024, 128, "nan"),                 # a NaN in one block
    (3000, 200, "plain"),               # block > 128: each block read twice
    (1000, 20, "plain"),                # several blocks a warp, scalar
    (256 * 128, 128, "plain"),          # whole 256-block tiles (Pallas)
    (1030 * 128, 128, "plain"),         # one table's unique rows
]


def _compress_group(seed, n=None):
    """Host payloads of one grouped compress: ``COMPRESS_TABLES``, or ``n``
    of random lengths, blocks and kinds. Each is (v, block, kind)."""
    rng = np.random.default_rng(seed)
    specs = COMPRESS_TABLES if n is None else [
        (int(rng.integers(0, 6000)), int(rng.choice([20, 30, 64, 128, 200])),
         str(rng.choice(["plain", "misaligned", "nan"])))
        for _ in range(n)]
    cases = []
    for m, block, kind in specs:
        v = (rng.standard_normal(m) * np.exp(rng.standard_normal(m) * 4)) \
            .astype(np.float32)
        if kind == "nan" and m:
            v[rng.integers(0, m)] = np.nan
        cases.append((v, block, kind))
    return cases


def _compress_tensors(cases, device):
    """(vs, blocks) on ``device``; a ``misaligned`` payload starts 4 bytes
    into its buffer."""
    vs = []
    for v, _, kind in cases:
        t = torch.from_numpy(v).to(device)
        if kind == "misaligned":
            buf = torch.empty(t.numel() + 1, device=device)
            buf[1:].copy_(t)
            t = buf[1:]
        vs.append(t)
    return vs, [block for _, block, _ in cases]


FLAT_TABLES = [  # occurrence-width tables of a mixed bag group: (V, D, B, L)
    (200, 128, 16, 8),
    (300, 13, 8, 5),                    # the scalar path
    (50, 8, 0, 3),                      # B = 0: no bag
    (70, 32, 9, 6),                     # misaligned below: scalar path
    (62_500, 128, 512, 8),              # one kwai-dlrm training table
]


def _flat_group(seed, device):
    """(tables, ids) of occurrence-width tables: random ids with -1
    padding, some past the end (clamped); the fourth table starts 4 bytes
    into its buffer."""
    rng = np.random.default_rng(seed)
    tables, ids = [], []
    for k, (V, D, B, L) in enumerate(FLAT_TABLES):
        t = torch.from_numpy(rng.standard_normal((V, D)).astype(np.float32)) \
            .to(device)
        if k == 3:
            buf = torch.empty(t.numel() + 1, device=device)
            buf[1:].copy_(t.reshape(-1))
            t = buf[1:].view(V, D)
        i = _bags(rng, B, L, V)
        if B:
            i[0, 0] = V + 5
        tables.append(t)
        ids.append(torch.from_numpy(i).to(device))
    return tables, ids


def _chunks(sizes, per_launch):
    n = sum(1 for x in sizes if x)
    return -(-n // per_launch)


@pytest.mark.cuda
@pytest.mark.parametrize("n_tables", [None, 100])
def test_cuda_unique_bag_grouped_matches_plain_and_per_table(cuda_device,
                                                             n_tables):
    tables, devs, invs = _group_tensors(_bag_group(3, n_tables),
                                        cuda_device)
    ops.reset_launch_counts()
    got = ops.unique_bag_grouped(tables, devs, invs)
    torch.cuda.synchronize()
    counts = ops.launch_counts()["unique_bag"]
    served = [i.shape[0] * t.shape[1] for t, i in zip(tables, invs)]
    assert counts == _chunks(served, 56)          # kMaxTables in bag.cu
    assert ops.table_counts()["unique_bag"] == sum(1 for x in served if x)
    want = ref.unique_bag_grouped_ref(tables, devs, invs)
    for t, d, i, g, w in zip(tables, devs, invs, got, want):
        assert torch.equal(g, w)
        if i.shape[0]:
            dev = torch.arange(t.shape[0], dtype=torch.int32,
                               device=cuda_device) if d is None else d
            assert torch.equal(g, ops.unique_bag(t, dev, i))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_unique_bag_grouped_shares_one_buffer(cuda_device):
    """32 tables of one (B, D), the kwai-dlrm serving stage: one launch,
    the outputs are the rows of one (32, B, D) buffer."""
    cases = [c for c in _bag_group(5, None) if c[3] == "plan"][-1:] * 32
    tables, devs, invs = _group_tensors(cases, cuda_device)
    ops.reset_launch_counts()
    got = ops.unique_bag_grouped(tables, devs, invs)
    torch.cuda.synchronize()
    assert ops.launch_counts()["unique_bag"] == 1
    base = got[0].untyped_storage().data_ptr()
    assert all(g.untyped_storage().data_ptr() == base for g in got)
    want = ref.unique_bag_ref(tables[0], devs[0], invs[0])
    assert all(torch.equal(g, want) for g in got)


@pytest.mark.cuda
@pytest.mark.parametrize("n_tables", [None, 100])
def test_cuda_decompress_grouped_matches_plain_and_per_table(cuda_device,
                                                             n_tables):
    comps, scales, outs, wants = _codec_tensors(_codec_group(4, n_tables),
                                                cuda_device)
    ops.reset_launch_counts()
    got = ops.blockscale_decompress_grouped(comps, scales, outs)
    torch.cuda.synchronize()
    sizes = [w.numel() for w in wants]
    assert ops.launch_counts()["blockscale_decompress"] == \
        _chunks(sizes, 80)                        # kMaxCodecTables
    for c, s, o, g, w in zip(comps, scales, outs, got, wants):
        if isinstance(o, torch.Tensor):
            assert g is o
        assert _same_bits(g, w)
        if w.numel():
            assert _same_bits(g, ops.blockscale_decompress(c, s, w.shape))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("n_tables", [None, 100])
def test_cuda_compress_grouped_matches_plain_and_per_table(cuda_device,
                                                           n_tables):
    """Bit for bit (fp16 payload and scales, NaN blocks included) against
    the plain version and the one-table kernel; the outputs are views of
    one buffer per dtype, each on a 16-byte boundary."""
    vs, blocks = _compress_tensors(_compress_group(6, n_tables), cuda_device)
    ops.reset_launch_counts()
    got = ops.blockscale_compress_grouped(vs, blocks)
    torch.cuda.synchronize()
    sizes = [v.numel() for v in vs]
    assert ops.launch_counts()["blockscale_compress"] == \
        _chunks(sizes, 80)                        # kMaxCodecTables
    assert ops.table_counts()["blockscale_compress"] == \
        sum(1 for x in sizes if x)
    for v, b, (c, s) in zip(vs, blocks, got):
        pc, ps = ref.blockscale_compress_ref(v, b)
        assert _same_bits(c, pc) and _same_bits(s, ps)
        assert c.data_ptr() % 16 == 0 and s.data_ptr() % 16 == 0
        if v.numel():
            oc, os_ = ops.blockscale_compress(v, b)
            assert _same_bits(c, oc) and _same_bits(s, os_)
    for k, dtype in ((0, torch.float16), (1, torch.float32)):
        bases = {x[k].untyped_storage().data_ptr() for x in got}
        assert len(bases) == 1 and got[0][k].dtype == dtype
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_bag_grouped_mixes_plan_and_occurrence_tables(cuda_device):
    """Plan tables and occurrence-width tables (``embedding_bag`` as the
    bag kernel's identity case) in ONE launch, counted once, on
    ``unique_bag``; occurrence tables alone count on ``embedding_bag``."""
    tables, devs, invs = _group_tensors(_bag_group(3), cuda_device)
    ft, fi = _flat_group(8, cuda_device)
    n_plan = sum(1 for t, i in zip(tables, invs) if i.shape[0] * t.shape[1])
    n_flat = sum(1 for i in fi if i.shape[0])
    # interleaved: flat tables between the plan tables
    order = [("p", k) for k in range(len(tables))]
    for k in range(len(ft)):
        order.insert(2 * k + 1, ("f", k))
    args = [(tables[k], devs[k], invs[k], False) if kind == "p" else
            (ft[k], None, fi[k], True) for kind, k in order]
    ops.reset_launch_counts()
    got = ops.unique_bag_grouped(*(list(c) for c in zip(*args)))
    torch.cuda.synchronize()
    assert ops.launch_counts()["unique_bag"] == 1
    assert ops.launch_counts()["embedding_bag"] == 0
    assert ops.table_counts()["unique_bag"] == n_plan
    assert ops.table_counts()["embedding_bag"] == n_flat
    for (t, d, i, flat), g in zip(args, got):
        if flat:
            assert torch.equal(g, ref.embedding_bag_ref(t, i))
            if i.shape[0]:
                assert torch.equal(g, ops.embedding_bag(t, i))
        else:
            assert torch.equal(g, ref.unique_bag_grouped_ref([t], [d],
                                                             [i])[0])
    ops.reset_launch_counts()
    alone = ops.unique_bag_grouped(ft, [None] * len(ft), fi, [True] * len(ft))
    torch.cuda.synchronize()
    assert ops.launch_counts()["embedding_bag"] == 1
    assert ops.launch_counts()["unique_bag"] == 0
    for t, i, g in zip(ft, fi, alone):
        assert torch.equal(g, ref.embedding_bag_ref(t, i))


@pytest.mark.cuda
def test_cuda_grouped_launch_error_raises(cuda_device, monkeypatch):
    tables, devs, invs = _group_tensors(_bag_group(3)[:2], cuda_device)
    comps, scales, outs, _ = _codec_tensors(_codec_group(4)[:2], cuda_device)
    vs, blocks = _compress_tensors(_compress_group(6)[:2], cuda_device)
    ops.reset_launch_counts()
    monkeypatch.setattr(ops, "_fn", lambda name: lambda *args: 700)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        ops.unique_bag_grouped(tables, devs, invs)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        ops.blockscale_decompress_grouped(comps, scales, outs)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        ops.blockscale_compress_grouped(vs, blocks)
    assert ops.launch_counts()["unique_bag"] == 0
    assert ops.launch_counts()["blockscale_decompress"] == 0
    assert ops.launch_counts()["blockscale_compress"] == 0


# ---------------------------------------------------------------------------
# fused_backward: segment-sum + row-wise adagrad/sgd apply + queue payload
# ---------------------------------------------------------------------------

def _fb_case(seed, R, D, U, n_occ, cap, n_dup=0, sgd=False):
    """Inputs of one fused_backward call: half the plan live (at most R
    rows), ``n_dup`` apply positions naming a row another position names
    too (as colliding shuffled ids do), the rest -1."""
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((R, D)).astype(np.float32)
    acc = None if sgd else rng.random(R).astype(np.float32)
    inv = rng.integers(-1, U, n_occ).astype(np.int32)
    grads = rng.standard_normal((n_occ, D)).astype(np.float32)
    n_live = min(max(U // 2, 1), R)
    apply_idx = np.full(cap, -1, np.int32)
    apply_idx[:n_live] = rng.permutation(R)[:n_live]
    for k in range(min(n_dup, cap - n_live, n_live)):
        apply_idx[n_live + k] = apply_idx[k]
    apply_idx = apply_idx[rng.permutation(cap)]
    apply_g = rng.standard_normal((cap, D)).astype(np.float32)
    order, offsets = occurrence_csr(inv, U)
    return table, acc, order, offsets, grads, apply_idx, apply_g


FB_CASES = [  # (R, D, U, n_occ, cap, n_dup, sgd)
    (64, 16, 8, 24, 8, 0, False),
    (257, 64, 32, 128, 32, 0, False),
    (300, 13, 16, 40, 32, 0, False),          # scalar path, cap > U
    (8, 8, 32, 1, 32, 0, False),              # n_live capped at R
    (200, 128, 64, 400, 128, 9, False),       # shared rows
    (200, 128, 64, 400, 128, 9, True),        # sgd
    (62_500, 128, 1024, 4096, 4096, 4, False),  # one kwai-dlrm table
    (49_155, 2048, 3000, 4096, 4096, 4, False),  # granite's vocab put
]


@pytest.mark.cuda
@pytest.mark.parametrize("apply_self", [False, True])
@pytest.mark.parametrize("R,D,U,n_occ,cap,n_dup,sgd", FB_CASES)
def test_cuda_fused_backward_matches_plain_version(cuda_device, R, D, U,
                                                   n_occ, cap, n_dup, sgd,
                                                   apply_self):
    _fb_both(cuda_device, _fb_case(R + D + U, R, D, U, n_occ, cap, n_dup,
                                   sgd), apply_self)


def _fb_both(device, case, apply_self, lr=5e-2, eps=1e-8):
    """One fused_backward call through the kernel and through the plain
    version on the card, from the same numpy inputs; asserts payload,
    table and acc equal bit for bit."""
    outs = []
    for fn in (ops.fused_backward, ref.fused_backward_ref):
        table, acc, order, offsets, grads, idx, g = (
            None if a is None else torch.from_numpy(a).to(device)
            for a in case)
        push = fn(table, acc, order, offsets, grads, idx, g, lr=lr, eps=eps,
                  apply_self=apply_self)
        outs.append((push, table, acc))
    torch.cuda.synchronize()
    (p0, t0, a0), (p1, t1, a1) = outs
    assert torch.equal(p0, p1)
    assert torch.equal(t0, t1)
    assert (a0 is None and a1 is None) or torch.equal(a0, a1)


def _fb_shared(seed, R, D, U, n_occ, cap, ways, sgd=False, hot=0, past=0):
    """fused_backward inputs with one physical row named by ``ways``
    positions and a few by two (rows that colliding ids share), ``hot``
    occurrences of unique position 0 (a Zipf-hot id's segment) and
    ``past`` positions naming rows >= R (no-ops)."""
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((R, D)).astype(np.float32)
    acc = None if sgd else rng.random(R).astype(np.float32)
    inv = rng.integers(-1, U, n_occ).astype(np.int32)
    inv[rng.permutation(n_occ)[:hot]] = 0
    grads = rng.standard_normal((n_occ, D)).astype(np.float32)
    rows = rng.permutation(R)[:U].astype(np.int32)
    rows[1:ways] = rows[0]
    rows[ways:ways + 6:2] = rows[ways + 1:ways + 7:2]
    if past:
        rows[-past:] = R + np.arange(past)
    apply_idx = np.full(cap, -1, np.int32)
    apply_idx[:U] = rows
    apply_idx = apply_idx[rng.permutation(cap)]
    apply_g = rng.standard_normal((cap, D)).astype(np.float32)
    order, offsets = occurrence_csr(inv, U)
    return table, acc, order, offsets, grads, apply_idx, apply_g


FB_NEW_CASES = {  # name: _fb_shared arguments after the seed
    "hot_segment_1500": (1_000, 128, 64, 4_096, 128, 1, False, 1_500),
    "shared_by_3": (500, 128, 48, 300, 64, 3),
    "shared_by_4": (500, 128, 48, 300, 64, 4),
    "shared_by_4_scalar": (500, 13, 48, 300, 64, 4),
    "rows_past_R": (300, 64, 40, 200, 64, 2, False, 0, 7),
    "sgd_shared_by_3": (500, 128, 48, 300, 64, 3, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("apply_self", [False, True])
@pytest.mark.parametrize("name", list(FB_NEW_CASES))
def test_cuda_fused_backward_hot_segments_and_shared_rows(cuda_device, name,
                                                          apply_self):
    case = _fb_shared(len(name), *FB_NEW_CASES[name])
    if name == "hot_segment_1500":
        assert int(np.diff(case[3])[0]) >= 1_500
    _fb_both(cuda_device, case, apply_self)


@pytest.mark.cuda
def test_cuda_fused_backward_scratch_comes_back_clean(cuda_device):
    """Calls in a row on tables of two sizes (each with its own scratch),
    then two on one size (sharing it), every one bit-exact, and the
    scratch back at its sentinels after each."""
    for k, R in enumerate((400, 257, 400, 400)):
        _fb_both(cuda_device, _fb_shared(k, R, 64, 40, 200, 64, 3),
                 apply_self=bool(k % 2))
        buf = ops._fb_scratch[(torch.device(cuda_device), R)]
        assert bool((buf[0] == torch.iinfo(torch.int32).max).all())
        assert bool((buf[1] == -1).all())


@pytest.mark.cuda
def test_cuda_fused_backward_all_padding_and_counts(cuda_device):
    ops.reset_launch_counts()
    table = torch.ones((16, 8), device=cuda_device)
    acc = torch.ones(16, device=cuda_device)
    i32 = dict(dtype=torch.int32, device=cuda_device)
    push = ops.fused_backward(
        table, acc, torch.zeros(0, **i32), torch.zeros(5, **i32),
        torch.ones((6, 8), device=cuda_device), torch.full((4,), -1, **i32),
        torch.ones((4, 8), device=cuda_device), lr=0.1, eps=1e-8)
    torch.cuda.synchronize()
    assert not push.any() and bool((table == 1).all()) and \
        bool((acc == 1).all())
    assert ops.launch_counts()["fused_backward"] == 1


# ---------------------------------------------------------------------------
# blockscale: the §4.2.3 wire codec
# ---------------------------------------------------------------------------

def _codec_input(case, rows=300, seed=0):
    """(rows, 128) fp32 of lognormal magnitudes with one edge case planted;
    ``partial`` and ``odd`` trim the flat input (a partial last block; on
    the scalar path when the length is not a multiple of 4)."""
    rng = np.random.default_rng(seed)
    v = (rng.standard_normal((rows, 128))
         * np.exp(rng.standard_normal((rows, 1)) * 4)).astype(np.float32)
    if case == "zero_block":
        v[5] = 0.0
    elif case == "fp16_subnormal":
        v[7] = rng.standard_normal(128).astype(np.float32) * 1e-7
        v[7, 0] = 1e3
    elif case == "fp32_subnormal":
        v[3] = (rng.standard_normal(128) * 1e-39).astype(np.float32)
    elif case == "partial":
        return v.reshape(-1)[:rows * 128 - 76]
    elif case == "odd":
        return v.reshape(-1)[:rows * 128 - 77]
    return v


def _same_bits(a, b):
    view = torch.int16 if a.dtype == torch.float16 else torch.int32
    return a.shape == b.shape and torch.equal(a.view(view), b.view(view))


@pytest.mark.cuda
@pytest.mark.parametrize("block", [64, 128, 30])
@pytest.mark.parametrize("case", ["lognormal", "zero_block", "fp16_subnormal",
                                  "fp32_subnormal", "partial", "odd"])
def test_cuda_blockscale_matches_plain_versions(cuda_device, case, block):
    v = torch.from_numpy(_codec_input(case)).to(cuda_device)
    ops.reset_launch_counts()
    comp, s = ops.blockscale_compress(v, block)
    pc, ps = ref.blockscale_compress_ref(v, block)
    out = ops.blockscale_decompress(comp, s, v.shape)
    want = ref.blockscale_decompress_ref(pc, ps).reshape(-1)[:v.numel()] \
        .reshape(v.shape)
    torch.cuda.synchronize()
    assert _same_bits(comp, pc) and _same_bits(s, ps)
    assert _same_bits(out, want)
    counts = ops.launch_counts()
    assert (counts["blockscale_compress"],
            counts["blockscale_decompress"]) == (1, 1)


@pytest.mark.cuda
def test_cuda_blockscale_launch_error_raises(cuda_device, monkeypatch):
    ops.reset_launch_counts()
    monkeypatch.setattr(ops, "_fn", lambda name: lambda *args: 700)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        ops.blockscale_compress(torch.ones(256, device=cuda_device))
    assert ops.launch_counts()["blockscale_compress"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["plan", "flat"])
@pytest.mark.parametrize("staleness", [0, 2])
def test_cuda_wire_matches_cpu(cuda_device, form, staleness):
    """The compressed wire's pooled lookup and puts on the card and on the
    CPU, from the same inputs, bit for bit: every kernel equals its plain
    version and the ops around them (gathers, sorts, copies) are exact."""
    from repro_torch.core import backend, dedup
    from repro_torch.core.embedding_ps import EmbeddingSpec
    rows, dim = 9_000, 128
    spec = EmbeddingSpec(rows=rows, dim=dim, staleness=staleness, lr=0.05,
                         backend="dense+compressed")
    bk = backend.create_backend(spec)
    rng = np.random.default_rng(staleness)
    table = torch.from_numpy(rng.standard_normal((rows, dim))
                             .astype(np.float32))
    states = {d: {"table": table.to(d), "acc": torch.zeros(rows, device=d)}
              for d in ("cpu", cuda_device)}
    queues = {d: bk.queue_init((16, 8), d) for d in states}
    ops.reset_launch_counts()
    for _ in range(3):
        ids = _bags(rng, 16, 8, 300)
        g = rng.standard_normal((16, 8, dim)).astype(np.float32)
        out = {}
        for d in states:
            if form == "plan":
                u, inv, _, info = dedup.make_plan(
                    ids, rows, dedup.dedup_cap(ids.size, rows))
                order, offsets = occurrence_csr(inv, u.size)
                dev_ids = dedup.DedupPlan(
                    *(torch.from_numpy(a.astype(np.int32)).to(d)
                      for a in (u, inv)),
                    order=torch.from_numpy(order).to(d),
                    offsets=torch.from_numpy(offsets).to(d),
                    n_unique=info["n_unique"])
            else:
                dev_ids = torch.from_numpy(ids).to(d)
            pooled, _ = bk.lookup_pooled(states[d], dev_ids)
            states[d], queues[d], m = bk.hybrid_update(
                states[d], queues[d], dev_ids, torch.from_numpy(g).to(d))
            out[d] = pooled
        torch.cuda.synchronize()
        assert _same_bits(out[cuda_device].cpu(), out["cpu"])
    for k in ("table", "acc"):
        assert _same_bits(states[cuda_device][k].cpu(), states["cpu"][k])
    if staleness:
        for k in ("ids", "grads"):
            assert _same_bits(queues[cuda_device][k].cpu(), queues["cpu"][k])
    counts = ops.launch_counts()
    assert counts["blockscale_compress"] == counts["blockscale_decompress"] \
        == 6
    assert counts["fused_backward"] == (3 if staleness else 6)
    assert counts["unique_bag" if form == "plan" else "embedding_bag"] == 3


# ---------------------------------------------------------------------------
# embedding_sgd: bit for bit; flash_attention_fwd: allclose (o within 2e-5
# in fp32 and 4e-2 with bf16 inputs, lse within 1e-4: the kernel's
# exponentials and sums run in another order than the plain version's)
# ---------------------------------------------------------------------------

# embedding_sgd.cu puts one row on a warp until a put fills a wave of 132 SMs
# x 16 CTAs of 4 warps; past that two rows a warp, past four waves four
SGD_WAVE_ROWS = 132 * 16 * 4
SGD_CASES = [  # (V, D, T, case)
    (62_500, 128, 694, "plain"),     # the entry point's put
    (1_000, 13, 40, "plain"),
    (50, 4, 1, "plain"),
    # the scalar path (D 13) and rows narrower and wider than a warp's 32
    # float4s; part-filled warps and CTAs
    *[(5_000, D, T, "plain") for D in (4, 13, 64, 128, 256, 1000)
      for T in (1, 31, 694, 4096)],
    (5_000, 128, 694, "misaligned"),     # grads off 16 bytes: scalar path
    (5_000, 1000, 31, "misaligned"),
    (5_000, 128, 0, "plain"),
    (62_500, 128, 5, "plain"),           # the most rows a warp takes, + 1
    (62_500, 128, SGD_WAVE_ROWS + 1, "plain"),      # 2 rows a warp
    (62_500, 128, 4 * SGD_WAVE_ROWS + 1, "plain"),  # 4, past one wave
    # in one graph after the kernels that write their inputs; with wide
    # rows a put runs long enough that a read before its wait would race
    (62_500, 128, 694, "graph"),
    (1_000, 13, 40, "graph"),
    (5_000, 1000, 694, "graph"),
    (1_000, 4096, 40, "graph"),
]


def _sgd_id(case):
    return "-".join(str(c) for c in case[:3]) + \
        (f"-{case[3]}" if case[3] != "plain" else "")


@pytest.mark.cuda
@pytest.mark.parametrize("V,D,T,case", SGD_CASES, ids=map(_sgd_id, SGD_CASES))
def test_cuda_embedding_sgd_matches_plain_version(cuda_device, V, D, T, case):
    rng = np.random.default_rng(V + T)
    table = torch.from_numpy(rng.standard_normal((V, D)).astype(np.float32))
    ids = rng.permutation(V)[:T].astype(np.int32)
    ids[::7] = -1
    ids[1::11] = V + 3          # past the end: no-op
    grads = torch.from_numpy(rng.standard_normal((T, D)).astype(np.float32))
    ids_t = torch.from_numpy(ids)
    assert ops._fn("persia_embedding_sgd_rows_per_warp")(T) == \
        min(max(-(-T // SGD_WAVE_ROWS), 1), 4)
    if case == "graph":
        _sgd_in_one_graph(cuda_device, rng, table, ids_t, grads)
        return
    want = ops.embedding_sgd(table.clone(), ids_t, grads, 0.05,
                             assume_unique=True)
    grads_d = grads.to(cuda_device)
    if case == "misaligned":
        grads_d = torch.empty(T * D + 1, device=cuda_device)[1:].view(T, D)
        grads_d.copy_(grads)
        assert grads_d.data_ptr() % 16 != 0
    ops.reset_launch_counts()
    got = ops.embedding_sgd(table.to(cuda_device), ids_t.to(cuda_device),
                            grads_d, 0.05, assume_unique=True)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert ops.launch_counts()["embedding_sgd"] == (1 if T else 0)
    with pytest.raises(ValueError, match="duplicates"):
        ops.embedding_sgd(got, torch.zeros(2, dtype=torch.int32,
                                           device=cuda_device),
                          torch.ones((2, D), device=cuda_device))


def _sgd_in_one_graph(dev, rng, table, ids, grads):
    """Three puts in one captured graph, each reading what the kernel just
    before it wrote: copy kernels write the first put's ids and gradients,
    the first put writes the second's gradients (a (T, D) buffer taken as
    a table), the third reads the table rows the second wrote. A put lets
    its successor launch at once (PDL), so only its griddepcontrol.wait
    before the first read keeps it from reading early."""
    T, D = grads.shape
    perm = torch.from_numpy(rng.permutation(T).astype(np.int32))
    h = torch.from_numpy(rng.standard_normal((T, D)).astype(np.float32))
    want_g = ops.embedding_sgd(grads.clone(), perm, h, 0.05)
    want = table.clone()
    for _ in range(2):
        ops.embedding_sgd(want, ids, want_g, 0.05, assume_unique=True)
    table_d, g_d = table.to(dev), torch.zeros((T, D), device=dev)
    ids_src, g_src = ids.to(dev), grads.to(dev)
    ids_d = torch.full_like(ids_src, -1)
    perm_d, h_d = perm.to(dev), h.to(dev)

    def puts():
        ids_d.copy_(ids_src)
        g_d.copy_(g_src)
        ops.embedding_sgd(g_d, perm_d, h_d, 0.05, assume_unique=True)
        for _ in range(2):
            ops.embedding_sgd(table_d, ids_d, g_d, 0.05, assume_unique=True)

    puts()                          # builds and loads the kernel
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        puts()
    table_d.copy_(table)
    ids_d.fill_(-1)
    g_d.zero_()
    ops.reset_launch_counts()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(g_d.cpu(), want_g)
    assert torch.equal(table_d.cpu(), want)
    assert ops.launch_counts()["embedding_sgd"] == 0    # counted at capture


FLASH_CASES = [  # (B, Hq, Hkv, Sq, Sk, Dh, causal, window, q_offset, x)
    (2, 4, 2, 64, 64, 32, True, 0, 0, 1),
    (1, 4, 1, 1000, 1000, 64, True, 0, 0, 1),     # ragged tiles
    (1, 2, 2, 300, 300, 64, True, 64, 0, 1),      # window, Hq == Hkv
    (2, 4, 2, 130, 130, 96, False, 0, 0, 1),      # non-causal, Dh 96
    (1, 2, 1, 200, 200, 128, True, 24, 0, 1),     # Dh 128
    (1, 2, 1, 7, 90, 64, True, 0, 83, 1),         # q_offset
    (1, 2, 1, 100, 50, 16, True, 10, 0, 1),       # rows attending no key
    # q and k x30, the scale / 900: the split holds fp32's checks where
    # single-pass TF32 misses them (tests/test_torch_kernels.py emulates
    # both at this shape)
    (1, 4, 1, 256, 256, 64, True, 0, 0, 30),
    (1, 4, 2, 200, 200, 12, True, 0, 0, 1),       # Dh 12: bf16 by cp.async
    (2, 2, 1, 150, 150, 4, True, 0, 0, 1),        # Dh 4
    (1, 4, 2, 129, 129, 64, True, 0, 0, 1),       # one past a 128-row tile
    (1, 2, 1, 129, 129, 128, False, 0, 0, 1),     # ... and Dh 128's 64
    (1, 32, 8, 300, 300, 64, True, 0, 0, 1),      # granite's 32 / 8 heads
    (1, 16, 2, 300, 300, 64, True, 0, 0, 1),      # a GQA group of 8
    (1, 32, 8, 300, 300, 128, True, 0, 0, 1),     # Jamba's 32 / 8 of 128
    # cross-attention: non-causal, Sq != Sk, the last key tile ragged
    (1, 4, 4, 300, 190, 64, False, 0, 0, 1),
    # ... with a GQA group of 8 at a 128-wide head (Llama-3.2-Vision's)
    (1, 16, 2, 200, 160, 128, False, 0, 0, 1),
]


def _flash_id(case):
    """The case's id: its values joined by '-', with ``x`` only where it
    is not 1 (the ids of the cases that had no ``x`` stay as they were)."""
    return "-".join(str(c) for c in case[:9]) + \
        (f"-x{case[9]}" if case[9] != 1 else "")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,Dh,causal,window,q_offset,x",
                         [pytest.param(*c, id=_flash_id(c))
                          for c in FLASH_CASES])
def test_cuda_flash_attention_matches_plain_version(
        cuda_device, dtype, B, Hq, Hkv, Sq, Sk, Dh, causal, window,
        q_offset, x):
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda_device).manual_seed(Sq + Dh)
    q, k, v = (torch.randn(s, generator=g, device=cuda_device)
               for s in ((B, Hq, Sq, Dh), (B, Hkv, Sk, Dh),
                         (B, Hkv, Sk, Dh)))
    q, k, v = ((t * m).to(dtype) for t, m in ((q, x), (k, x), (v, 1)))
    scale = 0.125 / (x * x)
    ops.reset_launch_counts()
    o, lse = ops.flash_attention_fwd(q, k, v, scale, causal, window,
                                     q_offset)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention_fwd"] == 1
    po, plse = ref.flash_attention_fwd_ref(q, k, v, scale, causal, window,
                                           q_offset)
    assert o.dtype == dtype and lse.dtype == torch.float32
    atol = 2e-5 if dtype == torch.float32 else 4e-2
    assert torch.allclose(o.float(), po.float(), atol=atol, rtol=0)
    assert torch.allclose(lse, plse, atol=1e-4, rtol=1e-6)


# a value head of its own (MLA: query/key 192 = 128 + 64 rope, value 128)
FLASH_DV_CASES = [  # (B, Hq, Hkv, Sq, Sk, Dh, Dv, causal, window, q_offset)
    (1, 16, 16, 300, 300, 192, 128, True, 0, 0),    # DeepSeek-V2's heads
    (2, 4, 4, 64, 64, 192, 128, True, 0, 0),
    (1, 4, 2, 100, 77, 160, 72, True, 0, 23),       # ragged, both padded
    (1, 2, 2, 300, 300, 192, 128, True, 64, 0),     # window
    (1, 2, 1, 129, 129, 192, 128, False, 0, 0),
    (1, 4, 4, 70, 70, 24, 16, True, 0, 0),          # tests' MLA config
    (1, 2, 1, 129, 129, 128, 64, False, 0, 0),      # Dv < Dh at DP 128
    (2, 4, 2, 150, 90, 96, 40, True, 0, 60),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,Dh,Dv,causal,window,q_offset",
                         [pytest.param(*c, id="-".join(map(str, c)))
                          for c in FLASH_DV_CASES])
def test_cuda_flash_attention_value_head_matches_plain_version(
        cuda_device, dtype, B, Hq, Hkv, Sq, Sk, Dh, Dv, causal, window,
        q_offset):
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda_device).manual_seed(Sq + Dh + Dv)
    q, k, v = (torch.randn(s, generator=g, device=cuda_device).to(dtype)
               for s in ((B, Hq, Sq, Dh), (B, Hkv, Sk, Dh),
                         (B, Hkv, Sk, Dv)))
    scale = Dh ** -0.5
    ops.reset_launch_counts()
    o, lse = ops.flash_attention_fwd(q, k, v, scale, causal, window,
                                     q_offset)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention_fwd"] == 1
    po, plse = ref.flash_attention_fwd_ref(q, k, v, scale, causal, window,
                                           q_offset)
    assert o.shape == (B, Hq, Sq, Dv) and o.dtype == dtype
    atol = 2e-5 if dtype == torch.float32 else 4e-2
    assert torch.allclose(o.float(), po.float(), atol=atol, rtol=0)
    assert torch.allclose(lse, plse, atol=1e-4, rtol=1e-6)


# the differentiable attention (the kernel's forward, the recompute
# backward) on the card: (B, Hkv, G, S, Dh, Dv, window)
FLASH_GRAD_CASES = {
    "mla_192_128": (1, 16, 1, 300, 192, 128, 0),     # DeepSeek-V2's heads
    "mla_192_128_window": (1, 4, 1, 257, 192, 128, 64),
    "jamba_128_g4": (1, 8, 4, 300, 128, 128, 0),     # Jamba's GQA layer
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(FLASH_GRAD_CASES))
def test_cuda_flash_attention_grads_match_plain_version(cuda_device, case):
    """``flash.flash_attention``'s output and dq, dk, dv against autograd
    through the plain attention (``layers._attn_naive``) on the card: the
    output within 2e-5, each gradient within 1e-3 of its largest |grad|
    (the kernel's 3xTF32 forward moves o and the logsumexp the backward
    reads by its own rounding)."""
    from repro_torch.models import flash, layers
    torch.backends.cuda.matmul.allow_tf32 = False
    B, Hkv, G, S, Dh, Dv, window = FLASH_GRAD_CASES[case]
    g = torch.Generator(device=cuda_device).manual_seed(S + Dh + Dv)
    q = torch.randn((B, S, Hkv, G, Dh), generator=g, device=cuda_device)
    k = torch.randn((B, S, Hkv, Dh), generator=g, device=cuda_device)
    v = torch.randn((B, S, Hkv, Dv), generator=g, device=cuda_device)
    do = torch.randn((B, S, Hkv, G, Dv), generator=g, device=cuda_device)
    kw = dict(scale=Dh ** -0.5, causal=True, window=window)
    outs, grads = [], []
    for fn in (flash.flash_attention,
               lambda *a, **w: layers._attn_naive(*a, q_offset=0, **w)):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        o = fn(*leaves, **kw)
        outs.append(o.detach())
        grads.append(torch.autograd.grad(o, leaves, do))
    ops.reset_launch_counts()
    flash.flash_attention(*(t.clone().requires_grad_() for t in (q, k, v)),
                          **kw)
    assert ops.launch_counts()["flash_attention_fwd"] == 1
    assert outs[0].shape == (B, S, Hkv, G, Dv)
    assert torch.allclose(outs[0], outs[1], atol=2e-5, rtol=0)
    for name, a, b in zip("qkv", *grads):
        assert a.shape == b.shape
        share = float((a - b).abs().max() / b.abs().max())
        assert share <= 1e-3, (name, share)


# the differentiable attention at a cross-attention's shape (non-causal,
# Sq != Sk): (B, Hkv, G, Sq, Sk, Dh)
FLASH_CROSS_GRAD_CASES = {
    "whisper_cross": (1, 4, 1, 300, 190, 64),
    "vision_cross_g8": (1, 2, 8, 200, 160, 128),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(FLASH_CROSS_GRAD_CASES))
def test_cuda_flash_attention_cross_grads_match_plain_version(cuda_device,
                                                              case):
    """``flash.flash_attention`` non-causal at Sq != Sk (one launch):
    output within 2e-5 and dq, dk, dv within 1e-3 of the largest |grad|
    of autograd through the plain attention, as the causal cases."""
    from repro_torch.models import flash, layers
    torch.backends.cuda.matmul.allow_tf32 = False
    B, Hkv, G, Sq, Sk, Dh = FLASH_CROSS_GRAD_CASES[case]
    g = torch.Generator(device=cuda_device).manual_seed(Sq + Sk + Dh)
    q = torch.randn((B, Sq, Hkv, G, Dh), generator=g, device=cuda_device)
    k, v = (torch.randn((B, Sk, Hkv, Dh), generator=g, device=cuda_device)
            for _ in range(2))
    do = torch.randn((B, Sq, Hkv, G, Dh), generator=g, device=cuda_device)
    kw = dict(scale=Dh ** -0.5, causal=False, window=0)
    outs, grads = [], []
    ops.reset_launch_counts()
    for fn in (flash.flash_attention,
               lambda *a, **w: layers._attn_naive(*a, q_offset=0, **w)):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        o = fn(*leaves, **kw)
        outs.append(o.detach())
        grads.append(torch.autograd.grad(o, leaves, do))
    assert ops.launch_counts()["flash_attention_fwd"] == 1
    assert torch.allclose(outs[0], outs[1], atol=2e-5, rtol=0)
    for name, a, b in zip("qkv", *grads):
        assert a.shape == b.shape
        share = float((a - b).abs().max() / b.abs().max())
        assert share <= 1e-3, (name, share)


@pytest.mark.cuda
def test_cuda_flash_attention_rejects_what_it_cannot_run(cuda_device):
    q = torch.ones((1, 2, 8, 196), device=cuda_device)
    with pytest.raises(ValueError, match="multiple of 4 up to 192"):
        ops.flash_attention_fwd(q, q[:, :1], q[:, :1], 1.0)
    q = torch.ones((1, 2, 8, 192), device=cuda_device)
    for dv in (132, 30):
        v = torch.ones((1, 1, 8, dv), device=cuda_device)
        with pytest.raises(ValueError, match="value head dim"):
            ops.flash_attention_fwd(q, q[:, :1], v, 1.0)
    q = torch.ones((1, 2, 8, 64), device=cuda_device)
    with pytest.raises(ValueError, match="value head dim"):
        ops.flash_attention_fwd(q, q[:, :1],
                                torch.ones((1, 1, 8, 96), device=cuda_device),
                                1.0)
    h = torch.ones((1, 2, 8, 64), dtype=torch.float16, device=cuda_device)
    with pytest.raises(TypeError, match="fp32 or bf16"):
        ops.flash_attention_fwd(h, h[:, :1], h[:, :1], 1.0)
    f = torch.ones((1, 2, 64, 8), device=cuda_device).transpose(2, 3)
    with pytest.raises(TypeError, match="contiguous"):
        ops.flash_attention_fwd(f, f[:, :1].contiguous(),
                                f[:, :1].contiguous(), 1.0)


# ---------------------------------------------------------------------------
# the host_lru tier on the card: fault-in, eviction and slot puts bit for
# bit with the CPU (the scatter, gather and copies are exact; the kernels
# equal their plain versions)
# ---------------------------------------------------------------------------

def _lru_pair(device, rows=5_000, dim=128, cache=256, **kw):
    """One host_lru spec as a backend on the card and one on the CPU, from
    the same seeded init (the CPU's), carried as a checkpoint blob."""
    from repro_torch.convert import table_from_numpy
    from repro_torch.core import backend
    from repro_torch.core.embedding_ps import EmbeddingSpec
    spec = EmbeddingSpec(rows=rows, dim=dim, backend="host_lru",
                         cache_rows=cache, lr=0.05, **kw)
    cpu = backend.create_backend(spec)
    sc = cpu.init(torch.Generator().manual_seed(0))
    card = backend.create_backend(spec)
    sg = table_from_numpy(card, cpu.state_for_checkpoint(sc), device)
    return card, sg, cpu, sc


def _lru_same(card, sg, cpu, sc):
    for k in sc:
        assert _same_bits(sg[k].cpu(), sc[k]), k
    np.testing.assert_array_equal(card._id_for_slot, cpu._id_for_slot)
    assert (card.faults, card.writebacks, card.hits) == \
        (cpu.faults, cpu.writebacks, cpu.hits)
    a, b = card.store.serialize(), cpu.store.serialize()
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("staleness", [0, 2])
def test_cuda_host_lru_fault_in_and_eviction_match_cpu(cuda_device,
                                                       staleness):
    """Prepares that fault in and evict (written back through one
    device-to-host copy per prepare), then slot puts, on the card and on
    the CPU: caches, slot maps, counters and host stores bit for bit."""
    card, sg, cpu, sc = _lru_pair(cuda_device, staleness=staleness)
    queues = {"card": card.queue_init((32, 8), cuda_device),
              "cpu": cpu.queue_init((32, 8))}
    rng = np.random.default_rng(staleness)
    for _ in range(6):
        ids = rng.integers(0, 5_000, (32, 8))
        g = rng.standard_normal((32 * 8, 128)).astype(np.float32)
        sg, dg = card.prepare(sg, ids)
        sc, dc = cpu.prepare(sc, ids)
        np.testing.assert_array_equal(dg, dc)
        sg, queues["card"], _ = card.hybrid_update(
            sg, queues["card"], torch.from_numpy(dg).to(cuda_device),
            torch.from_numpy(g).to(cuda_device))
        sc, queues["cpu"], _ = cpu.hybrid_update(
            sc, queues["cpu"], torch.from_numpy(dc), torch.from_numpy(g))
    torch.cuda.synchronize()
    assert cpu.writebacks > 0 and cpu.faults > 256
    _lru_same(card, sg, cpu, sc)
    if staleness:
        for k in ("slots", "ids", "grads"):
            assert _same_bits(queues["card"][k].cpu(), queues["cpu"][k])


@pytest.mark.cuda
def test_cuda_host_lru_two_fault_ins_without_a_sync(cuda_device):
    """Two fault-ins into free slots (no eviction, so no synchronisation)
    enqueued behind a stream kept busy: each staging buffer must stay
    untouched until its copy has run, so both land their own rows."""
    card, sg, cpu, sc = _lru_pair(cuda_device, cache=512)
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)            # hold the stream ~tens of ms
    sg, d1 = card.prepare(sg, np.arange(0, 200))
    sg, d2 = card.prepare(sg, np.arange(1_000, 1_200))
    sc, _ = cpu.prepare(sc, np.arange(0, 200))
    sc, _ = cpu.prepare(sc, np.arange(1_000, 1_200))
    torch.cuda.synchronize()
    assert card.writebacks == 0
    _lru_same(card, sg, cpu, sc)
    want, _ = cpu.store.read_rows(np.arange(1_000, 1_200))
    np.testing.assert_array_equal(sg["table"][torch.from_numpy(d2).long()
                                              .to(cuda_device)].cpu(), want)


@pytest.mark.cuda
def test_cuda_host_lru_put_drops_recycled_slots(cuda_device):
    """A tau=1 put whose slots were recycled before it pops: the card's
    ``fused_backward`` applies only the slots that still hold their row,
    bit for bit with the plain version, and the recycled rows are left as
    the fault-in wrote them."""
    card, sg, cpu, sc = _lru_pair(cuda_device, rows=600, cache=64,
                                  staleness=1)
    qg, qc = card.queue_init((16,), cuda_device), cpu.queue_init((16,))
    g = np.full((16, 128), 0.5, np.float32)
    first = np.arange(16)
    sg, dg = card.prepare(sg, first)
    sc, dc = cpu.prepare(sc, first)
    sg, qg, _ = card.hybrid_update(sg, qg, torch.from_numpy(dg).to(
        cuda_device), torch.from_numpy(g).to(cuda_device))
    sc, qc, _ = cpu.hybrid_update(sc, qc, torch.from_numpy(dc),
                                  torch.from_numpy(g))
    # fill the 64 slots and evict ids 0..7; ids 8..15 keep theirs
    for lo in range(100, 156, 8):
        sg, _ = card.prepare(sg, np.arange(lo, lo + 8))
        sc, _ = cpu.prepare(sc, np.arange(lo, lo + 8))
    nxt = np.concatenate([first[8:], np.arange(300, 308)])
    sg, dg = card.prepare(sg, nxt)
    sc, dc = cpu.prepare(sc, nxt)
    old_slots = qc["slots"][0].numpy().copy()
    old_ids = qc["ids"][0].numpy().copy()
    live = old_slots >= 0
    recycled = live & (cpu._id_for_slot[np.clip(old_slots, 0, None)]
                       != old_ids)
    kept = live & ~recycled
    assert recycled.sum() == 8 and kept.sum() == 8
    before = sg["table"].clone()
    ops.reset_launch_counts()
    sg, qg, _ = card.hybrid_update(sg, qg, torch.from_numpy(dg).to(
        cuda_device), torch.zeros((16, 128), device=cuda_device))
    sc, qc, _ = cpu.hybrid_update(sc, qc, torch.from_numpy(dc),
                                  torch.zeros((16, 128)))
    torch.cuda.synchronize()
    assert ops.launch_counts()["fused_backward"] == 1
    _lru_same(card, sg, cpu, sc)
    for k in ("slots", "ids", "grads"):
        assert _same_bits(qg[k].cpu(), qc[k])
    gone = torch.from_numpy(old_slots[recycled]).long().to(cuda_device)
    held = torch.from_numpy(old_slots[kept]).long().to(cuda_device)
    assert torch.equal(sg["table"][gone], before[gone])
    assert not torch.equal(sg["table"][held], before[held])


# ---------------------------------------------------------------------------
# the pipelined trainer on the card
# ---------------------------------------------------------------------------

def _pipe_trainer(device, backend):
    """A 3-field CTR trainer (128 rows x dim 8 per table), hybrid(3); a
    host_lru one behind a 64-slot cache that a 16-row batch makes evict."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.core import adapters
    from repro_torch.core.hybrid import PersiaTrainer, TrainMode
    from repro_torch.data.ctr import CTRDataset
    from repro_torch.optim.optimizers import OptConfig
    cfg = ModelConfig(name="pl", arch_type="recsys", n_id_fields=3,
                      ids_per_field=3, emb_dim=8, emb_rows=3 * 128,
                      n_dense_features=4, mlp_dims=(16,), n_tasks=1)
    ds = CTRDataset("pl", n_rows=3 * 128, n_fields=3, ids_per_field=3,
                    n_dense=4)
    coll = adapters.ctr_collection(cfg, lr=5e-2, field_rows=ds.field_rows())
    if backend != "dense":
        coll = coll.with_backend(backend, 64)
    ad = adapters.recsys_adapter(cfg, field_rows=ds.field_rows(),
                                 collection=coll)
    return ds, PersiaTrainer(ad, TrainMode.hybrid(3),
                             OptConfig(kind="adam", lr=5e-3), device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["dense", "host_lru"])
def test_cuda_pipelined_inflight1_bit_exact_with_serial(cuda_device,
                                                        backend):
    """On the card, as on the CPU: one permit pins the serial dispatch
    order on the one stream, so 12 pipelined steps equal 12 serial steps
    bit for bit (losses, tables, accumulators, dense parameters), with the
    same launches per step."""
    from repro_torch.core.pipeline import PipelinedTrainer
    from repro_torch.utils import tree_leaves
    ds, ta = _pipe_trainer(cuda_device, backend)
    it = ds.sampler(16, seed=0)
    batches = [next(it) for _ in range(12)]
    ops.reset_launch_counts()
    sa, ma = ta.run(ta.init(0, batches[0]), batches)
    torch.cuda.synchronize()
    serial = ops.launch_counts()
    _, tb = _pipe_trainer(cuda_device, backend)
    ops.reset_launch_counts()
    sb, mb = PipelinedTrainer(tb, max_inflight=1).run(
        tb.init(0, batches[0]), batches)
    torch.cuda.synchronize()
    assert ops.launch_counts() == serial
    assert serial["fused_backward"] == 12 * 3
    assert [float(m["loss"]) for m in ma] == [float(m["loss"]) for m in mb]
    for n in sa.emb:
        for k in sa.emb[n]:
            assert torch.equal(sa.emb[n][k], sb.emb[n][k]), (n, k)
    for x, y in zip(tree_leaves(sa.dense), tree_leaves(sb.dense)):
        assert torch.equal(x, y)
    if backend != "dense":
        from repro_torch.core.backend import unwrap
        for n in ta.backends:
            a, b = unwrap(ta.backends[n]), unwrap(tb.backends[n])
            assert a.writebacks > 0
            assert np.array_equal(a._id_for_slot, b._id_for_slot)
            assert np.array_equal(a.store.vectors, b.store.vectors)


@pytest.mark.cuda
def test_cuda_pins_of_full_width_plans_make_no_sync(cuda_device):
    """kwai-dlrm's 32 host_lru tables (62,500 rows, 7,812 cache slots) at
    batch 512: pinning and unpinning the plans of a prepare_all read their
    host copies, so under the sync debug mode "error" nothing waits for
    the card."""
    from repro_torch.configs.recsys_configs import KWAI
    from repro_torch.core import adapters
    from repro_torch.core import backend as BK
    from repro_torch.data.ctr import CTR_BENCHMARKS
    from repro_torch.launch.shards import default_cache_rows
    ds = CTR_BENCHMARKS["kwai_video"]
    coll = adapters.ctr_collection(KWAI, field_rows=ds.field_rows()) \
        .with_backend("host_lru", default_cache_rows(ds.rows_per_field))
    backends = coll.make_backends()
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    states = {n: b.init(gen) for n, b in backends.items()}
    ids = next(ds.sampler(512, seed=1))["ids"]
    _, dev_ids, _ = BK.prepare_all(
        backends, states, {n: ids[:, i] for i, n in enumerate(coll.names)},
        cuda_device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for n, b in backends.items():
            b.pin_slots(dev_ids[n])
        pinned = {n: int(b._pin_count.sum()) for n, b in backends.items()}
        for n, b in backends.items():
            b.unpin_slots(dev_ids[n])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for n, b in backends.items():
        assert pinned[n] == dev_ids[n].n_unique > 0
        assert int(b._pin_count.sum()) == 0


# ---------------------------------------------------------------------------
# LM training: the attention backward and one trainer step
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("S,window", [(2048, 0), (1000, 256)])
def test_cuda_attention_backward_matches_autograd_through_plain(cuda_device,
                                                                S, window):
    """``flash.FlashAttention`` (the kernel's forward, the recompute
    backward) against autograd through the plain attention at one
    granite layer's shape (B=1, 32/8 heads of 64) and a ragged window
    case: dq, dk, dv within 1e-3 of the largest |grad|."""
    import math

    from repro_torch.models import flash, layers
    gen = torch.Generator(device=cuda_device).manual_seed(S)
    q = torch.randn((1, S, 8, 4, 64), generator=gen, device=cuda_device)
    k, v = (torch.randn((1, S, 8, 64), generator=gen, device=cuda_device)
            for _ in range(2))
    do = torch.randn(q.shape, generator=gen, device=cuda_device)
    kw = dict(scale=1.0 / math.sqrt(64), causal=True, window=window)
    ops.reset_launch_counts()
    got = torch.autograd.grad(flash.flash_attention(
        *(t.requires_grad_() for t in (q, k, v)), **kw), (q, k, v), do)
    assert ops.launch_counts()["flash_attention_fwd"] == 1
    want = torch.autograd.grad(layers._attn_naive(q, k, v, q_offset=0, **kw),
                               (q, k, v), do)
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-3 * float(b.abs().max())


@pytest.mark.cuda
def test_cuda_lm_trainer_step_matches_cpu(cuda_device):
    """One hybrid(1) step of a 2-layer reduced granite's
    PersiaTrainer(lm_adapter), card against CPU from one state (TF32 off):
    loss rtol 1e-4, vocab table rtol 1e-4 atol 1e-5, accumulator rtol
    1e-4 atol 1e-6, dense parameters within 2 lr of each other (Adam's
    normalised step) and their updates equal in norm to 1e-3; the card
    makes 2 attention launches per layer (forward, remat) and one put."""
    from repro_torch.configs import get_config
    from repro_torch.core import adapters
    from repro_torch.core.hybrid import PersiaTrainer, TrainMode
    from repro_torch.data.lm import lm_batches
    from repro_torch.optim.optimizers import OptConfig
    from repro_torch.utils import tree_leaves, tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("granite_3_2b", reduced=True).replace(pattern_repeats=2)
    lr = 3e-3

    def trainer(dev):
        return PersiaTrainer(adapters.lm_adapter(cfg, lr=5e-2),
                             TrainMode.hybrid(1),
                             OptConfig(kind="adam", lr=lr), device=dev)

    tg, tc = trainer(cuda_device), trainer("cpu")
    it = lm_batches(cfg.vocab_size, 2, 128, seed=1)
    b0, b1 = next(it), next(it)
    sg = tg.init(0, b0)
    sc = sg.to("cpu")
    start = tree_map(torch.clone, sc.dense)
    ops.reset_launch_counts()
    sg, mg = tg.step(sg, b1)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    sc, mc = tc.step(sc, b1)
    assert counts["flash_attention_fwd"] == 2 * cfg.n_layers
    assert counts["fused_backward"] == 1
    assert abs(float(mg["loss"]) - float(mc["loss"])) <= \
        1e-4 * abs(float(mc["loss"]))
    ge, ce = sg.emb["vocab"], sc.emb["vocab"]
    assert torch.allclose(ge["table"].cpu(), ce["table"], rtol=1e-4,
                          atol=1e-5)
    assert torch.allclose(ge["acc"].cpu(), ce["acc"], rtol=1e-4, atol=1e-6)
    diff2 = upd2 = 0.0
    for w0, x, y in zip(tree_leaves(start), tree_leaves(sg.dense),
                        tree_leaves(sc.dense)):
        x = x.cpu()
        assert float((x - y).abs().max()) <= 2 * lr
        diff2 += float(((x - y).double() ** 2).sum())
        upd2 += float(((y - w0).double() ** 2).sum())
    assert (diff2 / upd2) ** 0.5 <= 1e-3


# ---------------------------------------------------------------------------
# the sharded router: its decomposed put (one sum-only launch, then one
# apply-only launch per shard) and its block lookup, bit for bit
# ---------------------------------------------------------------------------

ROUTER_FB_CASES = {  # name: inputs of one put
    "rows_16384": lambda: _fb_case(1, 16_384, 128, 1024, 4096, 4096, 4),
    "rows_15625": lambda: _fb_case(2, 15_625, 128, 1024, 4096, 4096, 4),
    "shared_by_3": lambda: _fb_shared(3, 500, 128, 48, 300, 64, 3),
}


@pytest.mark.cuda
@pytest.mark.parametrize("apply_self", [False, True])
@pytest.mark.parametrize("name", list(ROUTER_FB_CASES))
def test_cuda_sum_only_then_apply_only_equals_fused(cuda_device, name,
                                                    apply_self):
    """The router's put against one shard's: ``csr_segment_sum`` (the
    sum-only launch) and then an apply-only launch of the popped put (or,
    in sync mode, of the sums) give the fused launch's payload, table and
    accumulator bit for bit, on a sub-shard's 16,384 and 15,625 rows and
    on a row that three positions share."""
    from repro_torch.core.dedup import csr_segment_sum
    case = ROUTER_FB_CASES[name]()
    fused = [None if a is None else torch.from_numpy(a).to(cuda_device)
             for a in case]
    table, acc, order, offsets, grads, idx, g = fused
    push = ops.fused_backward(table, acc, order, offsets, grads, idx, g,
                              lr=5e-2, eps=1e-8, apply_self=apply_self)
    split = [None if a is None else torch.from_numpy(a).to(cuda_device)
             for a in case]
    t2, a2, order2, offsets2, grads2, idx2, g2 = split
    ops.reset_launch_counts()
    sums = csr_segment_sum(order2, offsets2, grads2, idx2.shape[0])
    empty = torch.zeros(0, dtype=torch.int32, device=cuda_device)
    ops.fused_backward(t2, a2, empty, torch.zeros(1, dtype=torch.int32,
                                                  device=cuda_device),
                       grads2.new_zeros((0, grads2.shape[1])), idx2,
                       sums if apply_self else g2, lr=5e-2, eps=1e-8)
    torch.cuda.synchronize()
    assert ops.launch_counts()["fused_backward"] == 2
    assert torch.equal(sums, push)
    assert torch.equal(t2, table)
    assert torch.equal(a2, acc)


@pytest.mark.cuda
@pytest.mark.parametrize("backend_name,rows", [("dense", 5_000),
                                               ("dense", 62_500),
                                               ("host_lru", 5_000)])
@pytest.mark.parametrize("staleness", [0, 2])
def test_cuda_router_lookup_and_put_match_cpu(cuda_device, backend_name,
                                              rows, staleness):
    """A 4-shard router table on the card and on the CPU from one state:
    ``prepare_all``, ``lookup_all`` (the shards' unique rows gathered into
    one block, ONE bag launch) and ``put_all`` (ONE sum-only and 4
    apply-only ``fused_backward`` launches), 4 steps, the pooled bags,
    every shard's table, accumulator and queue bit for bit. At 62,500 rows
    a shard's 15,625 rows are past the shuffle's bijective range, so its
    puts name shared rows."""
    from repro_torch.convert import table_from_numpy
    from repro_torch.core import backend
    from repro_torch.core.embedding_ps import EmbeddingSpec
    dim, k = 128, 4
    spec = EmbeddingSpec(rows=rows, dim=dim, lr=0.05, staleness=staleness,
                         backend=backend_name, emb_shards=k,
                         cache_rows=1_024 if backend_name == "host_lru"
                         else 0)
    cpu, card = backend.create_backend(spec), backend.create_backend(spec)
    states = {"cpu": cpu.init(torch.Generator().manual_seed(0))}
    states["card"] = table_from_numpy(
        card, cpu.state_for_checkpoint(states["cpu"]), cuda_device)
    bks = {"cpu": {"t": cpu}, "card": {"t": card}}
    devs = {"cpu": "cpu", "card": cuda_device}
    queues = {d: {"t": bks[d]["t"].queue_init((32, 8), devs[d])}
              for d in devs}
    rng = np.random.default_rng(staleness)
    for step in range(4):
        ids = {"t": _bags(rng, 32, 8, rows)}
        g = rng.standard_normal((32, 8, dim)).astype(np.float32)
        out = {}
        for d in ("card", "cpu"):
            if d == "card":
                ops.reset_launch_counts()
            st, dev_ids, _ = backend.prepare_all(bks[d], {"t": states[d]},
                                                 ids, devs[d])
            pooled, _ = backend.lookup_all(bks[d], st, dev_ids)
            st, queues[d], _ = backend.put_all(
                bks[d], st, queues[d], dev_ids,
                {"t": torch.from_numpy(g).to(devs[d])})
            states[d], out[d] = st["t"], pooled["t"]
            if d == "card":
                torch.cuda.synchronize()
                counts = ops.launch_counts()
                assert counts["unique_bag"] == 1
                assert counts["fused_backward"] == 1 + k
        assert _same_bits(out["card"].cpu(), out["cpu"])
    for s in range(k):
        for key, v in states["cpu"][f"s{s}"].items():
            assert _same_bits(states["card"][f"s{s}"][key].cpu(), v), (s, key)
        if staleness:
            for key in ("ids", "grads"):
                assert _same_bits(queues["card"]["t"][f"s{s}"][key].cpu(),
                                  queues["cpu"]["t"][f"s{s}"][key])


# ---------------------------------------------------------------------------
# the multi-process embedding PS on the card: PS servers as threads of this
# process on the GPU, the remote trainer against the in-process trainer
# ---------------------------------------------------------------------------

def _remote_pair_trainer(device, backend, rows, shards=1):
    from repro_torch.configs.base import ModelConfig
    from repro_torch.core import adapters
    from repro_torch.core.hybrid import PersiaTrainer, TrainMode
    from repro_torch.data.ctr import CTRDataset
    from repro_torch.optim.optimizers import OptConfig
    cfg = ModelConfig(name="rc", arch_type="recsys", n_id_fields=2,
                      ids_per_field=3, emb_dim=16, emb_rows=2 * rows,
                      n_dense_features=4, mlp_dims=(32,), n_tasks=1)
    ds = CTRDataset("rc", n_rows=2 * rows, n_fields=2, ids_per_field=3,
                    n_dense=4)
    coll = adapters.ctr_collection(cfg, lr=5e-2, field_rows=ds.field_rows())
    if backend != "dense":
        coll = coll.with_backend(backend, 512 if "host_lru" in backend
                                 else None)
    if shards > 1:
        coll = coll.with_shards(shards)
    ad = adapters.recsys_adapter(cfg, field_rows=ds.field_rows(),
                                 collection=coll)
    return PersiaTrainer(ad, TrainMode.hybrid(2),
                         OptConfig(kind="adam", lr=5e-3),
                         device=device), ds


@pytest.mark.cuda
@pytest.mark.parametrize("backend,k,rows", [
    ("dense", 1, 15_625), ("host_lru", 1, 15_625),
    ("dense+compressed", 1, 15_625), ("dense", 4, 15_625),
    ("host_lru", 4, 15_625)])
def test_cuda_remote_bit_equal_with_in_process(cuda_device, backend, k,
                                               rows):
    """4 hybrid(2) steps over k PS threads on the card against the
    in-process trainer of the same geometry (the plain backend at k = 1,
    the router at k = 4; the lossy wire against ``dense+compressed``):
    losses, dense parameters, every logical row and accumulator bit for
    bit; each step one bag launch, 2 sum-only ``fused_backward`` launches
    here and 2 k apply-only ones in the PS threads."""
    from unittest import mock

    from repro_torch.core import backend as BK
    from repro_torch.core import dedup as D
    from repro_torch.net import connect_remote_backends
    from repro_torch.net.ps_server import PSServer
    from repro_torch.utils import tree_leaves
    t0, ds = _remote_pair_trainer(cuda_device, backend, rows, shards=k)
    it = ds.sampler(64, seed=3)
    bs = [next(it) for _ in range(4)]
    s0 = t0.init(0, bs[0])
    servers = [PSServer(device=cuda_device).start() for _ in range(k)]
    try:
        t1, _ = _remote_pair_trainer(cuda_device, backend, rows)
        connect_remote_backends(t1, [("127.0.0.1", s.port)
                                     for s in servers])
        s1 = t1.init(0, bs[0])
        for b in bs:
            s0, m0 = t0.step(s0, b)
            ops.reset_launch_counts()
            with mock.patch.object(D, "csr_segment_sum",
                                   wraps=D.csr_segment_sum) as sums:
                s1, m1 = t1.step(s1, b)
                for n, bk in t1.backends.items():
                    bk.sync(s1.emb[n])
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            assert float(m1["loss"]) == float(m0["loss"])
            assert counts["unique_bag"] == 1 and sums.call_count == 2
            assert counts["fused_backward"] == 2 + 2 * k
        for x, y in zip(tree_leaves(s0.dense), tree_leaves(s1.dense)):
            assert torch.equal(x, y)
        for n in t0.collection.names:
            spec = t0.collection[n]
            base = BK.parse_backend_name(spec.backend)[0]
            got = BK.extract_logical_rows(
                BK.unwrap(t1.backends[n]).state_for_checkpoint(s1.emb[n]),
                spec, base)
            want = BK.extract_logical_rows(
                BK.unwrap(t0.backends[n]).state_for_checkpoint(s0.emb[n]),
                spec, base)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
        for bk in t1.backends.values():
            bk.close()
    finally:
        for s in servers:
            s.stop()


# ---------------------------------------------------------------------------
# the mesh paths: a world of 2 gloo processes on the one card
# ---------------------------------------------------------------------------

MESH_CFG = dict(name="mesh", arch_type="recsys", n_id_fields=4,
                ids_per_field=8, emb_dim=128, emb_rows=4 * 4096,
                n_dense_features=4, mlp_dims=(64, 32), n_tasks=1)
MESH_B, MESH_STEPS = 128, 3

MESH_WORLD = """
import datetime, pickle, sys
import numpy as np
import torch
import torch.distributed as dist

rank, work = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method=f"file://{work}/rdzv",
                        rank=rank, world_size=2,
                        timeout=datetime.timedelta(seconds=120))
torch.backends.cuda.matmul.allow_tf32 = False
from repro_torch.sharding import partition as SP
from repro_torch.utils import Mesh, set_mesh
import test_torch_cuda as T

mesh = Mesh((2, 1), ("data", "model"))
with set_mesh(mesh):
    out = T._mesh_runs(mesh.device, lambda a: SP.local_block(
        mesh, SP.P(SP.BATCH), a).contiguous())
with open(f"{work}/rank{rank}.pkl", "wb") as f:
    pickle.dump(out, f)
dist.destroy_process_group()
print("RANK_OK", rank)
"""


def _mesh_runs(dev, block):
    """The full-mode lookup and put of one table, then MESH_STEPS hybrid(2)
    steps of a 4-table CTR trainer (``init`` keeps the rank's blocks under
    a mesh), on the rank's blocks (``block`` cuts a batch-sharded array)
    or, with the identity, in one process. Returns host arrays."""
    from repro_torch.core import adapters
    from repro_torch.core import embedding_ps as PS
    from repro_torch.core.hybrid import PersiaTrainer, TrainMode
    from repro_torch.data.ctr import CTRDataset
    from repro_torch.configs.base import ModelConfig
    from repro_torch.optim.optimizers import OptConfig
    from repro_torch.sharding import partition as SP
    from repro_torch.utils import get_mesh
    spec = PS.EmbeddingSpec(rows=4096, dim=128, mode="full", lr=0.05)
    gen = torch.Generator(device=dev).manual_seed(1)
    st = PS.ps_init(gen, spec, 2)
    mesh = get_mesh()
    if mesh is not None:
        st = {k: SP.local_block(mesh, SP.emb_state_specs(st, spec)[k], v)
              .clone() for k, v in st.items()}
    rng = np.random.default_rng(2)
    ids = torch.from_numpy(rng.integers(-1, 4096, (256, 8))).to(dev)
    g = torch.from_numpy(rng.standard_normal((256 * 8, 128)).astype(
        np.float32)).to(dev)
    out = {"lookup": PS.lookup(st, spec, block(ids)).cpu().numpy()}
    PS.apply_put(st, spec, block(ids).reshape(-1), block(g))
    out["put"] = {k: v.cpu().numpy() for k, v in st.items()}
    cfg = ModelConfig(**MESH_CFG)
    ds = CTRDataset("mesh", n_rows=cfg.emb_rows, n_fields=4, ids_per_field=8,
                    n_dense=4)
    tr = PersiaTrainer(adapters.recsys_adapter(
        cfg, lr=5e-2, field_rows=ds.field_rows()), TrainMode.hybrid(2),
        OptConfig(kind="adam", lr=3e-3), device=dev)
    it = ds.sampler(MESH_B, seed=4)
    batches = [next(it) for _ in range(MESH_STEPS)]
    blocks = [{k: block(torch.from_numpy(v)).numpy() for k, v in b.items()}
              for b in batches]
    s = tr.init(seed=3, batch_example=blocks[0])
    s, ms = tr.run(s, blocks)
    out["losses"] = [float(m["loss"]) for m in ms]
    out["emb"] = {n: {k: v.cpu().numpy() for k, v in e.items()}
                  for n, e in s.emb.items()}
    return out


@pytest.mark.cuda
def test_cuda_mesh_two_ranks_match_one_process(cuda_device, tmp_path):
    """Two gloo ranks on the one card, mesh (data 2, model 1): the
    full-mode lookup bit for bit with one process, the put and 3
    hybrid(2) steps of a 4-table trainer within 1e-5 (the second dedup
    sums a row's two ranks' puts in another order), the losses rtol
    1e-5."""
    import os
    import pickle
    import subprocess
    import sys
    from pathlib import Path
    from repro_torch.kernels import build
    from repro_torch.sharding import partition as SP
    from repro_torch.utils import MeshLayout
    build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    (tmp_path / "world.py").write_text(MESH_WORLD)
    here = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(here.parent / "src"), str(here),
         os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, str(tmp_path / "world.py"),
                               str(r), str(tmp_path)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, log in enumerate(logs):
        assert f"RANK_OK {r}" in log, log[-4000:]
    ranks = []
    for r in range(2):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    want = _mesh_runs(cuda_device, lambda a: a)
    layout = MeshLayout((2, 1), ("data", "model"))

    def join(fn, spec):
        return SP.from_blocks(layout, spec, [torch.from_numpy(fn(r))
                                             for r in ranks]).numpy()
    np.testing.assert_array_equal(join(lambda r: r["lookup"],
                                       SP.P(SP.BATCH)), want["lookup"])
    rows = SP.P(("data", "model"), None)
    for k, v in want["put"].items():
        np.testing.assert_allclose(join(lambda r: r["put"][k], rows), v,
                                   atol=1e-5, err_msg=k)
    np.testing.assert_allclose(ranks[0]["losses"], want["losses"],
                               rtol=1e-5)
    for n, e in want["emb"].items():
        for k, v in e.items():
            np.testing.assert_allclose(
                join(lambda r: r["emb"][n][k], rows), v, atol=1e-5,
                err_msg=f"{n}.{k}")
