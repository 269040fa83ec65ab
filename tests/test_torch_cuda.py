"""The port's CUDA kernels against their plain torch versions, bit for bit,
on the card. Every test here needs an NVIDIA GPU and nvcc and skips without
them; run them on the GPU machine with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

This file imports no JAX, so it runs where only the port is installed.
"""
import numpy as np
import pytest
import torch

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
    assert ops.launch_counts() == {"embedding_bag": 1, "unique_bag": 1}


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
