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
]


@pytest.mark.cuda
@pytest.mark.parametrize("apply_self", [False, True])
@pytest.mark.parametrize("R,D,U,n_occ,cap,n_dup,sgd", FB_CASES)
def test_cuda_fused_backward_matches_plain_version(cuda_device, R, D, U,
                                                   n_occ, cap, n_dup, sgd,
                                                   apply_self):
    case = _fb_case(R + D + U, R, D, U, n_occ, cap, n_dup, sgd)
    outs = []
    for _ in ("kernel", "plain"):
        table, acc, order, offsets, grads, idx, g = (
            None if a is None else torch.from_numpy(a).to(cuda_device)
            for a in case)
        fn = ops.fused_backward if not outs else ref.fused_backward_ref
        push = fn(table, acc, order, offsets, grads, idx, g, lr=5e-2,
                  eps=1e-8, apply_self=apply_self)
        outs.append((push, table, acc))
    torch.cuda.synchronize()
    (p0, t0, a0), (p1, t1, a1) = outs
    assert torch.equal(p0, p1)
    assert torch.equal(t0, t1)
    assert (a0 is None and a1 is None) or torch.equal(a0, a1)


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

@pytest.mark.cuda
@pytest.mark.parametrize("V,D,T", [(62_500, 128, 694), (1_000, 13, 40),
                                   (50, 4, 1)])
def test_cuda_embedding_sgd_matches_plain_version(cuda_device, V, D, T):
    rng = np.random.default_rng(V + T)
    table = torch.from_numpy(rng.standard_normal((V, D)).astype(np.float32))
    ids = rng.permutation(V)[:T].astype(np.int32)
    ids[::7] = -1
    ids[1::11] = V + 3          # past the end: no-op
    grads = torch.from_numpy(rng.standard_normal((T, D)).astype(np.float32))
    ids_t = torch.from_numpy(ids)
    want = ops.embedding_sgd(table.clone(), ids_t, grads, 0.05,
                             assume_unique=True)
    ops.reset_launch_counts()
    got = ops.embedding_sgd(table.to(cuda_device), ids_t.to(cuda_device),
                            grads.to(cuda_device), 0.05, assume_unique=True)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert ops.launch_counts()["embedding_sgd"] == 1
    with pytest.raises(ValueError, match="duplicates"):
        ops.embedding_sgd(got, torch.zeros(2, dtype=torch.int32,
                                           device=cuda_device),
                          torch.ones((2, D), device=cuda_device))


FLASH_CASES = [  # (B, Hq, Hkv, Sq, Sk, Dh, causal, window, q_offset)
    (2, 4, 2, 64, 64, 32, True, 0, 0),
    (1, 4, 1, 1000, 1000, 64, True, 0, 0),        # ragged tiles
    (1, 2, 2, 300, 300, 64, True, 64, 0),         # window, Hq == Hkv
    (2, 4, 2, 130, 130, 96, False, 0, 0),         # non-causal, Dh 96
    (1, 2, 1, 200, 200, 128, True, 24, 0),        # Dh 128
    (1, 2, 1, 7, 90, 64, True, 0, 83),            # q_offset
    (1, 2, 1, 100, 50, 16, True, 10, 0),          # rows attending no key
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,Dh,causal,window,q_offset",
                         FLASH_CASES)
def test_cuda_flash_attention_matches_plain_version(
        cuda_device, dtype, B, Hq, Hkv, Sq, Sk, Dh, causal, window,
        q_offset):
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda_device).manual_seed(Sq + Dh)
    q, k, v = (torch.randn(s, generator=g, device=cuda_device).to(dtype)
               for s in ((B, Hq, Sq, Dh), (B, Hkv, Sk, Dh),
                         (B, Hkv, Sk, Dh)))
    ops.reset_launch_counts()
    o, lse = ops.flash_attention_fwd(q, k, v, 0.125, causal, window,
                                     q_offset)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention_fwd"] == 1
    po, plse = ref.flash_attention_fwd_ref(q, k, v, 0.125, causal, window,
                                           q_offset)
    assert o.dtype == dtype and lse.dtype == torch.float32
    atol = 2e-5 if dtype == torch.float32 else 4e-2
    assert torch.allclose(o.float(), po.float(), atol=atol, rtol=0)
    assert torch.allclose(lse, plse, atol=1e-4, rtol=1e-6)


@pytest.mark.cuda
def test_cuda_flash_attention_rejects_what_it_cannot_run(cuda_device):
    q = torch.ones((1, 2, 8, 130), device=cuda_device)
    with pytest.raises(ValueError, match="multiple of 4 up to 128"):
        ops.flash_attention_fwd(q, q[:, :1], q[:, :1], 1.0)
    h = torch.ones((1, 2, 8, 64), dtype=torch.float16, device=cuda_device)
    with pytest.raises(TypeError, match="fp32 or bf16"):
        ops.flash_attention_fwd(h, h[:, :1], h[:, :1], 1.0)
    f = torch.ones((1, 2, 64, 8), device=cuda_device).transpose(2, 3)
    with pytest.raises(TypeError, match="contiguous"):
        ops.flash_attention_fwd(f, f[:, :1].contiguous(),
                                f[:, :1].contiguous(), 1.0)
