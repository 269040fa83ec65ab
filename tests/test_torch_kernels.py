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
    assert ops.launch_counts() == {"embedding_bag": 0, "unique_bag": 0}


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
    assert set(build.sources()) == {"bag"}
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
