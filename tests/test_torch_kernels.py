"""The port's bag kernels (repro_torch/kernels) against the JAX package's.

On the CPU the wrappers run their plain torch versions; these are held bit
for bit against the Pallas kernels in interpret mode (``repro.kernels.ops``)
and against the jnp oracles (``repro.kernels.ref``): both sides add the
rows of a bag one at a time, in l order, from zero, so no tolerance is
needed. The CUDA kernels themselves are held against the plain versions on
the card (``test_torch_cuda.py`` and ``chip_smoke.py``).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import ops as jops
from repro.kernels import ref as jref

from repro_torch.kernels import build, ops, ref


def _bags(rng, B, L, V, pad=True):
    ids = rng.integers(0, V, (B, L))
    if pad:
        lens = rng.integers(0, L + 1, B)
        ids = np.where(np.arange(L)[None, :] < lens[:, None], ids, -1)
    return ids.astype(np.int32)


def _jax_bag(table, ids):
    a = np.asarray(jops.embedding_bag(jnp.asarray(table), jnp.asarray(ids)))
    b = np.asarray(jref.embedding_bag_ref(jnp.asarray(table),
                                          jnp.asarray(ids)))
    return a, b


def _jax_unique(table, dev, inv):
    args = [jnp.asarray(x) for x in (table, dev, inv)]
    return (np.asarray(jops.unique_bag(*args)),
            np.asarray(jref.unique_bag_ref(*args)))


def _plan(ids, extra_pad=0):
    """Sorted unique ids padded with -1 (+ extra_pad more -1 slots) and
    the inverse, as the dedup plan builds them."""
    flat = ids.reshape(-1)
    valid = flat >= 0
    uniq, inv_v = np.unique(flat[valid], return_inverse=True)
    dev = np.concatenate([uniq, np.full(max(1, extra_pad), -1)])
    inv = np.full(flat.shape, -1)
    inv[valid] = inv_v
    return dev.astype(np.int32), inv.reshape(ids.shape).astype(np.int32)


SHAPES = [  # (V, D, B, L)
    (1, 1, 1, 1),
    (50, 8, 4, 3),
    (200, 128, 16, 8),
    (300, 13, 8, 5),
    (97, 64, 33, 2),
]


@pytest.mark.parametrize("V,D,B,L", SHAPES)
def test_embedding_bag_plain_matches_jax(V, D, B, L):
    rng = np.random.default_rng(V * 1000 + D)
    table = rng.standard_normal((V, D)).astype(np.float32)
    ids = _bags(rng, B, L, V)
    got = ops.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids))
    want_kernel, want_ref = _jax_bag(table, ids)
    np.testing.assert_array_equal(got.numpy(), want_kernel)
    np.testing.assert_array_equal(got.numpy(), want_ref)


@pytest.mark.parametrize("V,D,B,L", SHAPES)
@pytest.mark.parametrize("extra_pad", [0, 7])
def test_unique_bag_plain_matches_jax(V, D, B, L, extra_pad):
    rng = np.random.default_rng(V * 1000 + D + extra_pad)
    table = rng.standard_normal((V, D)).astype(np.float32)
    dev, inv = _plan(_bags(rng, B, L, V), extra_pad)
    got = ops.unique_bag(*(torch.from_numpy(x) for x in (table, dev, inv)))
    want_kernel, want_ref = _jax_unique(table, dev, inv)
    np.testing.assert_array_equal(got.numpy(), want_kernel)
    np.testing.assert_array_equal(got.numpy(), want_ref)


def _edge_case(case, rng, V=40, D=16, B=6, L=4):
    table = rng.standard_normal((V, D)).astype(np.float32)
    if case == "all_padding":
        ids = np.full((B, L), -1, np.int32)
    elif case == "all_duplicate":
        ids = np.full((B, L), 7, np.int32)
    else:
        ids = _bags(rng, B, L, V)
    dev, inv = _plan(ids, extra_pad=4)
    if case == "dev_padding":
        # odd occurrences point at plan slots that hold -1
        n_u = int((dev >= 0).sum())
        inv = np.where((np.arange(L)[None, :] % 2 == 1) & (inv >= 0),
                       n_u + inv % 4, inv).astype(np.int32)
    return table, ids, dev, inv


@pytest.mark.parametrize("case", ["all_padding", "all_duplicate",
                                  "dev_padding"])
def test_bag_edge_cases_match_jax(case):
    table, ids, dev, inv = _edge_case(case, np.random.default_rng(3))
    got = ops.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids))
    for want in _jax_bag(table, ids):
        np.testing.assert_array_equal(got.numpy(), want)
    got_u = ops.unique_bag(*(torch.from_numpy(x)
                             for x in (table, dev, inv)))
    for want in _jax_unique(table, dev, inv):
        np.testing.assert_array_equal(got_u.numpy(), want)
    if case == "all_padding":
        assert not got.any() and not got_u.any()
    if case == "all_duplicate":
        np.testing.assert_array_equal(
            got.numpy(), np.broadcast_to(
                table[7] + table[7] + table[7] + table[7], got.shape))


def test_plain_versions_sum_in_l_order():
    """Addition order is l order from zero: (((0 + r0) + r1) + r2)."""
    table = torch.tensor([[1e8], [1.0], [-1e8]], dtype=torch.float32)
    ids = torch.tensor([[0, 1, 2], [0, 2, 1]], dtype=torch.int32)
    out = ref.embedding_bag_ref(table, ids)
    assert out[0, 0].item() == 0.0          # 1e8 + 1 rounds back to 1e8
    assert out[1, 0].item() == 1.0


def test_ids_past_the_table_read_as_zero():
    """Negative ids stay padding (zero); an index past the end of the array
    it indexes reads its last entry, as the JAX oracle's gathers clamp:
    ids >= V read row V - 1, inv >= U reads dev[U - 1], a dev entry >= V
    reads row V - 1."""
    table = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    ids = torch.tensor([[1, 4, 9], [-1, -1, -1]], dtype=torch.int32)
    np.testing.assert_array_equal(
        ops.embedding_bag(table, ids).numpy(),
        np.stack([table[1] + table[3] + table[3], torch.zeros(3)]))
    dev = torch.tensor([2, 4, -1], dtype=torch.int32)
    inv = torch.tensor([[0, 1, 2, 3, -1]], dtype=torch.int32)
    np.testing.assert_array_equal(ops.unique_bag(table, dev, inv).numpy(),
                                  (table[2:3] + table[3:4]).numpy())


@pytest.mark.parametrize("case", ["ids_past_end", "inv_past_end",
                                  "dev_past_end", "mixed"])
def test_bag_clamping_matches_jax_oracle(case):
    """Out-of-range indices against the JAX oracles (jnp gathers clamp)
    and, where the Pallas kernels clamp too (embedding_bag), the
    kernels."""
    rng = np.random.default_rng(17)
    V, D, B, L = 12, 8, 5, 4
    table = rng.standard_normal((V, D)).astype(np.float32)
    ids = _bags(rng, B, L, V)
    dev, inv = _plan(ids, extra_pad=2)
    if case in ("ids_past_end", "mixed"):
        ids[:, 0] = V + np.arange(B)
    if case in ("inv_past_end", "mixed"):
        inv[:, -1] = dev.size + 3
    if case in ("dev_past_end", "mixed"):
        dev[0] = V + 5
    got = ops.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), _jax_bag(table, ids)[1])
    if case == "ids_past_end":
        np.testing.assert_array_equal(got.numpy(), _jax_bag(table, ids)[0])
    got_u = ops.unique_bag(*(torch.from_numpy(x)
                             for x in (table, dev, inv)))
    np.testing.assert_array_equal(got_u.numpy(),
                                  _jax_unique(table, dev, inv)[1])


def test_cpu_wrappers_run_plain_version_and_count_no_launch():
    ops.reset_launch_counts()
    table = torch.ones((5, 4))
    ops.embedding_bag(table, torch.zeros((2, 3), dtype=torch.int32))
    ops.unique_bag(table, torch.zeros(1, dtype=torch.int32),
                   torch.zeros((2, 3), dtype=torch.int32))
    ops.fused_backward(table, torch.ones(5), torch.zeros(0, dtype=torch.int32),
                       torch.zeros(2, dtype=torch.int32), torch.ones((3, 4)),
                       torch.full((1,), 2, dtype=torch.int32), None, lr=0.1,
                       eps=1e-8, apply_self=True)
    ops.blockscale_roundtrip(torch.ones((3, 5)), block=4)
    ops.embedding_sgd(table, torch.tensor([1, -1], dtype=torch.int32),
                      torch.ones((2, 4)))
    ops.flash_attention_fwd(torch.ones((1, 2, 3, 4)), torch.ones((1, 1, 3, 4)),
                            torch.ones((1, 1, 3, 4)), 0.5)
    assert ops.launch_counts() == {"embedding_bag": 0, "unique_bag": 0,
                                   "fused_backward": 0,
                                   "blockscale_compress": 0,
                                   "blockscale_decompress": 0,
                                   "embedding_sgd": 0,
                                   "flash_attention_fwd": 0}


def test_wrappers_reject_other_devices_and_bad_shapes():
    """Tensors off the CPU that are not all on one CUDA device raise —
    nothing reaches the plain version except CPU tensors."""
    meta = torch.empty((5, 4), device="meta")
    ids = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="one CUDA device"):
        ops.embedding_bag(meta, ids.to("meta"))
    with pytest.raises(ValueError, match="one CUDA device"):
        ops.embedding_bag(torch.ones((5, 4)), ids.to("meta"))
    with pytest.raises(ValueError, match="one CUDA device"):
        ops.unique_bag(meta, ids[0].to("meta"), ids.to("meta"))
    with pytest.raises(ValueError, match=r"\(B, L\)"):
        ops.embedding_bag(torch.ones((5, 4)), ids[0])
    with pytest.raises(ValueError, match=r"\(U,\)"):
        ops.unique_bag(torch.ones((5, 4)), ids, ids)


def test_build_names_sources_and_hashes_them(monkeypatch):
    assert set(build.sources()) == {"bag", "blockscale", "embedding_sgd",
                                    "flash_attention", "fused_backward"}
    path = build.library_path("bag")
    assert path.parent == build.BUILD and path.name.startswith("libbag-")
    assert path == build.library_path("bag")          # content-addressed
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-G",))
    assert build.library_path("bag") != path


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setattr(build.os, "access", lambda *_: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc()


# ---------------------------------------------------------------------------
# fused_backward against the JAX package's kernel (interpret mode) and oracle
# ---------------------------------------------------------------------------
#
# Tolerance: the payload g_push is a pure segment-sum in occurrence order on
# every side, so it is bit-exact. Table and acc sit in the JAX package's own
# class for this kernel (rtol = atol = 2e-6, tests/test_kernels.py): XLA
# reduces mean(g^2) in another order than the port's column order, and its
# CPU rsqrt is not correctly rounded (up to 2 ulp).

from repro_torch.core import dedup as tdedup  # noqa: E402


def _fb_inputs(seed, R, Dm, U, n_occ, cap, apply_self, n_dup=0, sgd=False):
    """The JAX harness's draw (tests/test_kernels.py), with the live count
    capped at R (the harness's U//2 > R case broadcasts 8 values into 16
    slots) and optional apply positions that repeat a live row."""
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((R, Dm)).astype(np.float32)
    acc = None if sgd else rng.random(R).astype(np.float32)
    inv = rng.integers(-1, U, n_occ).astype(np.int32)
    grads = rng.standard_normal((n_occ, Dm)).astype(np.float32)
    n_live = min(max(U // 2, 1), R)
    apply_idx = np.full(cap, -1, np.int32)
    apply_idx[:n_live] = rng.permutation(R)[:n_live]
    for k in range(min(n_dup, cap - n_live, n_live)):
        apply_idx[n_live + k] = apply_idx[k]
    apply_g = np.zeros((cap, Dm), np.float32) if apply_self else \
        rng.standard_normal((cap, Dm)).astype(np.float32)
    return table, acc, inv, grads, apply_idx, apply_g


def _port_fb(table, acc, inv, grads, apply_idx, apply_g, apply_self, U):
    order, offsets = tdedup.occurrence_csr(inv, U)
    t = torch.from_numpy(table.copy())
    a = None if acc is None else torch.from_numpy(acc.copy())
    push = ops.fused_backward(
        t, a, torch.from_numpy(order), torch.from_numpy(offsets),
        torch.from_numpy(grads), torch.from_numpy(apply_idx),
        torch.from_numpy(apply_g), lr=5e-2, eps=1e-8, apply_self=apply_self)
    return t.numpy(), None if a is None else a.numpy(), push.numpy()


def _jax_fb(table, acc, inv, grads, apply_idx, apply_g, apply_self,
            kernel):
    args = [None if x is None else jnp.asarray(x)
            for x in (table, acc, inv, grads, apply_idx, apply_g)]
    if kernel:
        out = jops.fused_backward(*args, lr=5e-2, eps=1e-8,
                                  apply_self=apply_self)
    else:
        out = jref.fused_backward_ref(*args, cap=apply_idx.shape[0],
                                      lr=5e-2, eps=1e-8,
                                      apply_self=apply_self)
    return [None if x is None else np.asarray(x) for x in out]


def _check_fb(got, want):
    np.testing.assert_array_equal(got[2], want[2])          # payload
    for g, w in zip(got[:2], want[:2]):
        if w is None:
            assert g is None
        else:
            np.testing.assert_allclose(g, w, rtol=2e-6, atol=2e-6)


FB_SWEEP = [  # (R, Dm, U, n_occ, apply_self): tests/test_kernels.py's
    (64, 16, 8, 24, False), (128, 32, 16, 96, False),
    (257, 64, 32, 128, True), (32, 8, 4, 4, True),
    (8, 8, 4, 1, False), (80, 64, 32, 128, True), (33, 16, 8, 50, False),
    (8, 8, 32, 1, False),                 # Hypothesis's case: U//2 > R
]


@pytest.mark.parametrize("R,Dm,U,n_occ,apply_self", FB_SWEEP)
def test_fused_backward_plain_matches_jax(R, Dm, U, n_occ, apply_self):
    case = _fb_inputs(R + n_occ, R, Dm, U, n_occ, U, apply_self)
    got = _port_fb(*case, apply_self, U)
    _check_fb(got, _jax_fb(*case, apply_self, kernel=False))
    _check_fb(got, _jax_fb(*case, apply_self, kernel=True))


@pytest.mark.parametrize("apply_self", [False, True])
def test_fused_backward_queue_wider_than_plan_and_scalar_width(apply_self):
    """cap > U (the hybrid put: queue width above the plan bucket) leaves
    the payload's extra rows zero; D = 13 is the kernel's scalar path."""
    R, Dm, U, n_occ, cap = 300, 13, 16, 40, 32
    case = _fb_inputs(7, R, Dm, U, n_occ, cap, apply_self)
    got = _port_fb(*case, apply_self, U)
    assert not got[2][U:].any()
    _check_fb(got, _jax_fb(*case, apply_self, kernel=False))


@pytest.mark.parametrize("sgd", [False, True])
@pytest.mark.parametrize("apply_self", [False, True])
def test_fused_backward_shared_rows_match_jax_oracle(sgd, apply_self):
    """Apply positions that name one row (colliding shuffled ids) take
    every increment into acc before any step, and the row adds the steps
    in position order, as the JAX oracle's scatter-adds do."""
    R, Dm, U, n_occ = 40, 16, 16, 60
    case = _fb_inputs(11, R, Dm, U, n_occ, U, apply_self, n_dup=5, sgd=sgd)
    assert len(set(case[4][case[4] >= 0])) < int((case[4] >= 0).sum())
    _check_fb(_port_fb(*case, apply_self, U),
              _jax_fb(*case, apply_self, kernel=False))


def test_fused_backward_shared_row_updates_add_in_position_order():
    """sgd at lr 0.05 on one row named twice, with updates -1e8 and +1:
    (1e8 - 1e8) + 1 = 1, while the other order would give 0 — the JAX
    oracle's order."""
    table = np.array([[1e8], [5.0]], np.float32)
    inv = np.array([0, 1], np.int32)
    grads = np.array([[2e9], [-20.0]], np.float32)
    apply_idx = np.array([0, 0], np.int32)
    got = _port_fb(table, None, inv, grads, apply_idx,
                   np.zeros((2, 1), np.float32), True, 2)
    want = _jax_fb(table, None, inv, grads, apply_idx,
                   np.zeros((2, 1), np.float32), True, kernel=False)
    assert got[0][0, 0] == 1.0
    np.testing.assert_array_equal(got[0], want[0])


def test_fused_backward_all_padding_matches_jax():
    table, acc = np.ones((16, 8), np.float32), np.ones(16, np.float32)
    inv = np.full(6, -1, np.int32)
    grads = np.ones((6, 8), np.float32)
    apply_idx = np.full(4, -1, np.int32)
    apply_g = np.ones((4, 8), np.float32)
    got = _port_fb(table, acc, inv, grads, apply_idx, apply_g, False, 4)
    assert (got[0] == 1).all() and (got[1] == 1).all() and not got[2].any()
    _check_fb(got, _jax_fb(table, acc, inv, grads, apply_idx, apply_g,
                           False, kernel=True))


def test_fused_backward_wrapper_checks_arguments():
    t = torch.ones((5, 4))
    i32 = lambda *a: torch.zeros(*a, dtype=torch.int32)  # noqa: E731
    with pytest.raises(ValueError, match="apply_g"):
        ops.fused_backward(t, None, i32(0), i32(2), torch.ones((3, 4)),
                           i32(2), None, lr=0.1, eps=1e-8)
    with pytest.raises(ValueError, match="one D"):
        ops.fused_backward(t, None, i32(0), i32(2), torch.ones((3, 5)),
                           i32(2), None, lr=0.1, eps=1e-8, apply_self=True)
    with pytest.raises(ValueError, match="acc"):
        ops.fused_backward(t, torch.ones(4), i32(0), i32(2),
                           torch.ones((3, 4)), i32(2), None, lr=0.1,
                           eps=1e-8, apply_self=True)
    with pytest.raises(ValueError, match="one CUDA device"):
        ops.fused_backward(t.to("meta"), None, i32(0), i32(2),
                           torch.ones((3, 4)), i32(2), None, lr=0.1,
                           eps=1e-8, apply_self=True)


# ---------------------------------------------------------------------------
# embedding_sgd against the JAX package's kernel (interpret mode) and oracle
# ---------------------------------------------------------------------------
#
# Bit-exact against the oracle: each applied element is row + (-lr * g),
# one rounded product and one rounded sum, in the oracle, the port's plain
# version and its CUDA kernel. The Pallas kernel in interpret mode is held
# within 1 ulp: XLA's CPU backend contracts its row - lr * g into one fused
# multiply-add, so it differs from its own oracle in the last bit of some
# elements. Ids >= V are held against the oracle only: the Pallas kernel's
# block index clamps them onto row V - 1, while the oracle's scatter drops
# them, and the port follows the oracle.

def _sgd_case(seed, T, V=40, D=16, pad=0, past_end=0, dup=0):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((V, D)).astype(np.float32)
    ids = rng.permutation(V)[:T].astype(np.int32)
    ids[:pad] = -1
    ids[pad:pad + past_end] = V + np.arange(past_end)
    if dup:
        ids[-dup:] = ids[pad + past_end]
    grads = rng.standard_normal((T, D)).astype(np.float32)
    return table, ids, grads


def _port_sgd(table, ids, grads, lr, **kw):
    t = torch.from_numpy(table.copy())
    out = ops.embedding_sgd(t, torch.from_numpy(ids), torch.from_numpy(grads),
                            lr, **kw)
    assert out is t                       # in place
    return out.numpy()


@pytest.mark.parametrize("T", [1, 4, 17])
@pytest.mark.parametrize("pad", [0, 1])
def test_embedding_sgd_matches_jax_kernel_and_oracle(T, pad):
    pad = min(pad, T - 1)
    table, ids, grads = _sgd_case(T * 10 + pad, T, pad=pad)
    got = _port_sgd(table, ids, grads, 0.05)
    args = [jnp.asarray(a) for a in (table, ids, grads)]
    np.testing.assert_array_equal(got, np.asarray(
        jref.embedding_sgd_ref(*args, lr=0.05)))
    np.testing.assert_array_max_ulp(got, np.asarray(
        jops.embedding_sgd(*args, lr=0.05)), maxulp=1)
    untouched = np.setdiff1d(np.arange(table.shape[0]), ids[ids >= 0])
    np.testing.assert_array_equal(got[untouched], table[untouched])


@pytest.mark.parametrize("T", [4, 17])
def test_embedding_sgd_ids_past_end_change_nothing(T):
    table, ids, grads = _sgd_case(T, T, pad=1, past_end=2)
    got = _port_sgd(table, ids, grads, 0.1)
    np.testing.assert_array_equal(got, np.asarray(jref.embedding_sgd_ref(
        *(jnp.asarray(a) for a in (table, ids, grads)), lr=0.1)))
    untouched = np.setdiff1d(np.arange(table.shape[0]), ids[ids >= 0])
    np.testing.assert_array_equal(got[untouched], table[untouched])


def test_embedding_sgd_duplicates_raise_like_jax_and_assume_unique_adds():
    table, ids, grads = _sgd_case(5, 17, pad=2, dup=3)
    args = [jnp.asarray(a) for a in (table, ids, grads)]
    with pytest.raises(ValueError) as want:
        jops.embedding_sgd(*args, lr=0.1)
    with pytest.raises(ValueError) as got:
        _port_sgd(table, ids, grads, 0.1)
    assert str(got.value) == str(want.value)
    # vouched for: the plain version accumulates, as the oracle does
    np.testing.assert_allclose(
        _port_sgd(table, ids, grads, 0.1, assume_unique=True),
        np.asarray(jref.embedding_sgd_ref(*args, lr=0.1)), rtol=0,
        atol=1e-6)
    with pytest.raises(ValueError, match="grads"):
        ops.embedding_sgd(torch.ones((4, 3)),
                          torch.zeros(2, dtype=torch.int32),
                          torch.ones((2, 4)))


# ---------------------------------------------------------------------------
# flash_attention_fwd's plain version against the Pallas kernel (interpret
# mode) and the JAX package's _attn_naive
# ---------------------------------------------------------------------------
#
# allclose, in the JAX test's classes (tests/test_kernels.py): o within
# atol 1e-5 in fp32 (4e-2 with bf16 inputs), lse within 1e-5: the softmax
# sums run in other orders.

from repro.kernels.flash_attention import \
    flash_attention_fwd as jflash_kernel  # noqa: E402
from repro.models.flash import flash_attention as jflash  # noqa: E402
from repro.models.layers import _attn_naive as jnaive  # noqa: E402

from repro_torch.models import flash as tflash  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402


def _qkv(seed, B, Hq, Hkv, Sq, Sk, Dh, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in
               ((B, Hq, Sq, Dh), (B, Hkv, Sk, Dh), (B, Hkv, Sk, Dh)))
    if dtype != np.float32:       # round through bf16 on both sides
        q, k, v = (np.asarray(jnp.asarray(a).astype(jnp.bfloat16))
                   for a in (q, k, v))
    return q, k, v


def _naive(q, k, v, scale, causal, window, q_offset=0):
    """The JAX _attn_naive in kernel layout."""
    B, Hq, Sq, Dh = q.shape
    Hkv = k.shape[1]
    qg = jnp.asarray(q).reshape(B, Hkv, Hq // Hkv, Sq, Dh).transpose(
        0, 3, 1, 2, 4)
    on = jnaive(qg, jnp.asarray(k).transpose(0, 2, 1, 3),
                jnp.asarray(v).transpose(0, 2, 1, 3), scale=scale,
                causal=causal, window=window, q_offset=q_offset)
    return np.asarray(on.transpose(0, 2, 3, 1, 4).reshape(q.shape),
                      np.float32)


def _port_flash(q, k, v, scale, causal, window, q_offset=0):
    tq, tk, tv = (torch.from_numpy(np.asarray(a, np.float32)) for a in
                  (q, k, v))
    if q.dtype != np.float32:
        tq, tk, tv = (t.to(torch.bfloat16) for t in (tq, tk, tv))
    o, lse = ops.flash_attention_fwd(tq, tk, tv, scale, causal, window,
                                     q_offset)
    assert o.dtype == tq.dtype and lse.dtype == torch.float32
    return o.float().numpy(), lse.numpy()


@pytest.mark.parametrize("causal,window,bf16",
                         [(True, 0, False), (True, 24, False),
                          (False, 0, False), (True, 0, True)])
def test_flash_ref_matches_pallas_kernel_and_naive(causal, window, bf16):
    dtype = jnp.bfloat16 if bf16 else np.float32
    B, Hq, Hkv, S, Dh = 2, 4, 2, 64, 32
    q, k, v = _qkv(0, B, Hq, Hkv, S, S, Dh, dtype)
    o, lse = _port_flash(q, k, v, 0.2, causal, window)
    jo, jlse = jflash_kernel(*(jnp.asarray(a) for a in (q, k, v)), scale=0.2,
                             causal=causal, window=window, qblk=16, kblk=16,
                             interpret=True)
    atol = 0.04 if bf16 else 1e-5
    np.testing.assert_allclose(o, np.asarray(jo, np.float32), atol=atol)
    np.testing.assert_allclose(o, _naive(q, k, v, 0.2, causal, window),
                               atol=atol)
    np.testing.assert_allclose(lse, np.asarray(jlse), atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("S,qblk,kblk", [(128, 32, 64), (96, 16, 32),
                                         (37, 37, 37)])
def test_flash_ref_block_shapes_and_ragged_lengths(S, qblk, kblk):
    """The JAX test's block shapes, plus a length that is a multiple of no
    tile of the CUDA kernel (37, one Pallas block)."""
    q, k, v = _qkv(S, 1, 2, 2, S, S, 16)
    o, lse = _port_flash(q, k, v, 0.25, True, 0)
    jo, jlse = jflash_kernel(*(jnp.asarray(a) for a in (q, k, v)),
                             scale=0.25, qblk=qblk, kblk=kblk,
                             interpret=True)
    np.testing.assert_allclose(o, np.asarray(jo), atol=1e-5)
    np.testing.assert_allclose(lse, np.asarray(jlse), atol=1e-5, rtol=1e-6)
    np.testing.assert_allclose(o, _naive(q, k, v, 0.25, True, 0), atol=1e-5)


@pytest.mark.parametrize("Sq,Sk,q_offset,causal,window",
                         [(70, 70, 0, True, 5), (1, 70, 69, True, 0),
                          (30, 50, 20, True, 16), (40, 25, 0, False, 0)])
def test_flash_ref_offsets_and_unequal_lengths_match_naive(Sq, Sk, q_offset,
                                                          causal, window):
    q, k, v = _qkv(Sq + Sk, 2, 6, 3, Sq, Sk, 8)
    o, _ = _port_flash(q, k, v, 0.3, causal, window, q_offset)
    np.testing.assert_allclose(
        o, _naive(q, k, v, 0.3, causal, window, q_offset), atol=1e-5)


@pytest.mark.parametrize("S", [50, 300])
def test_flash_layout_wrapper_matches_jax_flash_attention(S):
    """models.flash.flash_attention (grouped layout, through the kernel
    wrapper) against the JAX package's jnp flash attention, and the port's
    _attn_naive against the JAX one."""
    rng = np.random.default_rng(S)
    q = rng.standard_normal((2, S, 2, 3, 16)).astype(np.float32)
    k = rng.standard_normal((2, S, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, S, 2, 16)).astype(np.float32)
    want = np.asarray(jflash(*(jnp.asarray(a) for a in (q, k, v)),
                             scale=0.25, causal=True, window=0))
    got = tflash.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                 scale=0.25)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    naive = tlayers._attn_naive(*(torch.from_numpy(a) for a in (q, k, v)),
                                scale=0.25, causal=True, window=0,
                                q_offset=0)
    np.testing.assert_allclose(naive.numpy(), np.asarray(jnaive(
        *(jnp.asarray(a) for a in (q, k, v)), scale=0.25, causal=True,
        window=0, q_offset=0)), atol=1e-5)


def test_flash_wrapper_checks_arguments():
    q = torch.ones((1, 4, 3, 8))
    kv = torch.ones((1, 3, 3, 8))
    with pytest.raises(ValueError, match="Hkv dividing Hq"):
        ops.flash_attention_fwd(q, kv, kv, 1.0)
    with pytest.raises(ValueError, match="at least one key"):
        ops.flash_attention_fwd(q, kv[:, :2, :0], kv[:, :2, :0], 1.0)
    with pytest.raises(ValueError, match=">= 0"):
        ops.flash_attention_fwd(q, kv[:, :2], kv[:, :2], 1.0, window=-1)
    with pytest.raises(ValueError, match="one CUDA device"):
        ops.flash_attention_fwd(q.to("meta"), kv[:, :2].to("meta"),
                                kv[:, :2].to("meta"), 1.0)


# ---------------------------------------------------------------------------
# the CUDA kernel's fp32 numerics: 3xTF32 on the tensor cores
# ---------------------------------------------------------------------------
#
# flash_attention_fwd's kernel computes both fp32 products with wgmma .tf32:
# each operand x is split into big = tf32(x) and small = tf32(x - big), and
# a product is small.big + big.small + big.big. Emulated here with torch
# bit operations (round to nearest, ties away, at 10 mantissa bits, as
# cvt.rna.tf32.f32 does) inside the plain version's own arithmetic, at a
# granite-like shape: the split stays within the kernel's unchanged checks
# (o 2e-5, lse 1e-4) and single-pass TF32 does not. The x30 case scales q
# and k by 30 and the softmax scale down by 900, so the scores keep their
# range and the operands' magnitudes change; scaling v instead would put
# the fp32 plain version itself ~2e-5 from exact arithmetic (its o reaches
# ~70), below the check's resolution for any kernel.

def _tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _einsum_tf32(split: bool):
    einsum = torch.einsum

    def product(eq, a, b):
        ab, bb = _tf32(a), _tf32(b)
        if not split:
            return einsum(eq, ab, bb)
        return (einsum(eq, _tf32(a - ab), bb) + einsum(eq, ab, _tf32(b - bb))
                + einsum(eq, ab, bb))
    return product


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-11, 1.0 + 2**-10 + 2**-12, -3.0 - 2**-9,
                      1.0 + 2**-12])
    # a tie rounds away from zero, below half an ulp rounds down
    assert _tf32(x).tolist() == [1.0 + 2**-10, 1.0 + 2**-10, -3.0 - 2**-9,
                                 1.0]
    big = _tf32(x)
    assert torch.equal(big + _tf32(x - big), x)     # 2 halves hold fp32


@pytest.mark.parametrize("x", [1.0, 30.0])
def test_flash_3xtf32_meets_fp32_checks_and_single_tf32_misses(monkeypatch,
                                                                x):
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((1, 4, 256, 64), (1, 1, 256, 64), (1, 1, 256, 64)))
    q, k, scale = q * x, k * x, 0.125 / (x * x)
    po, plse = ref.flash_attention_fwd_ref(q, k, v, scale)
    out = {}
    for split in (True, False):
        monkeypatch.setattr(torch, "einsum", _einsum_tf32(split))
        out[split] = ref.flash_attention_fwd_ref(q, k, v, scale)
        monkeypatch.undo()
    (o3, lse3), (o1, lse1) = out[True], out[False]
    assert float((o3 - po).abs().max()) <= 2e-5
    assert torch.allclose(lse3, plse, atol=1e-4, rtol=1e-6)
    assert float((o1 - po).abs().max()) > 2e-5 * 10
