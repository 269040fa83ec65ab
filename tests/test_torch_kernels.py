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
    """An index past the end is padding in both the kernel and its plain
    version (the JAX kernel would clamp it; every caller in the port
    translates such ids to -1 first)."""
    table = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    ids = torch.tensor([[1, 4, 9]], dtype=torch.int32)
    np.testing.assert_array_equal(ops.embedding_bag(table, ids).numpy(),
                                  table[1:2].numpy())
    dev = torch.tensor([2, 4, -1], dtype=torch.int32)
    inv = torch.tensor([[0, 1, 2, 3, -1]], dtype=torch.int32)
    np.testing.assert_array_equal(ops.unique_bag(table, dev, inv).numpy(),
                                  table[2:3].numpy())


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
    assert ops.launch_counts() == {"embedding_bag": 0, "unique_bag": 0,
                                   "fused_backward": 0,
                                   "blockscale_compress": 0,
                                   "blockscale_decompress": 0}


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
    assert set(build.sources()) == {"bag", "blockscale", "fused_backward"}
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
