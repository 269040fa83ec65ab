"""The port's §4.2.3 compression (repro_torch/core/compression.py and the
blockscale codec of repro_torch/kernels) against the JAX package, on the
CPU, from the same numpy inputs.

Tolerance: bit-exact throughout. The codec is one correctly rounded IEEE
operation at a time on every side (the max, the scale division, the
product, the round-to-nearest-even fp16 cast, the decompressing division),
so fp16 bits, scales and outputs are equal, with one exception stated
where it is tested: XLA on the CPU flushes fp32 subnormals to zero, the
port (its plain version here, its CUDA kernel on the card) does not. The
dedup sums add each group in occurrence order from 0.0 on both sides, and
the index codec is the same numpy code.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as JC
from repro.kernels import ops as JK
from repro.kernels import ref as JR

from repro_torch.core import compression as C
from repro_torch.kernels import ops, ref

SUB32 = 3          # the row of the fp32-subnormal block in _codec_input


def _codec_input(case, rows=256, seed=0):
    """(rows, 128) fp32: lognormal magnitudes (the JAX kernel test's), and
    one edge case planted in a row; ``partial`` trims the flat input so its
    last block is partial."""
    rng = np.random.default_rng(seed)
    v = (rng.standard_normal((rows, 128))
         * np.exp(rng.standard_normal((rows, 1)) * 4)).astype(np.float32)
    if case == "zero_block":
        v[5] = 0.0
    elif case == "fp16_subnormal":
        # |v * s| < 6.1e-5: most of the row becomes fp16 subnormals
        v[7] = rng.standard_normal(128).astype(np.float32) * 1e-7
        v[7, 0] = 1e3
    elif case == "fp32_subnormal":
        v[SUB32] = (rng.standard_normal(128) * 1e-39).astype(np.float32)
    elif case == "partial":
        return v.reshape(-1)[:rows * 128 - 77]
    return v


CASES = ["lognormal", "zero_block", "fp16_subnormal", "fp32_subnormal",
         "partial"]


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16 if a.dtype == np.float16 else np.uint32)


def _flushed_blocks(v, block):
    """Blocks of flat ``v`` that hold an fp32 subnormal (which XLA on the
    CPU flushes to zero)."""
    flat = np.pad(v.reshape(-1), (0, (-v.size) % block)).reshape(-1, block)
    tiny = (flat != 0) & (np.abs(flat) < np.finfo(np.float32).tiny)
    return tiny.any(axis=1)


def _equal_but_flushed(got, want, flushed, what):
    """Bit-equal outside the flushed blocks; inside them the port keeps the
    IEEE result and XLA gives zeros."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(_bits(got[~flushed]), _bits(want[~flushed]),
                                  err_msg=what)
    if flushed.any():
        assert not np.any(want[flushed]), what
        assert np.any(got[flushed]), what


@pytest.mark.parametrize("block", [64, 128])
@pytest.mark.parametrize("case", CASES)
def test_plain_codec_matches_jax_codec(case, block):
    v = _codec_input(case)
    flushed = _flushed_blocks(v, block)
    assert flushed.any() == (case == "fp32_subnormal")
    jc, js, jshape = JC.blockscale_compress(jnp.asarray(v), block)
    tc, ts, tshape = C.blockscale_compress(torch.from_numpy(v), block)
    assert tshape == tuple(jshape) and tc.dtype == torch.float16
    _equal_but_flushed(tc.numpy(), jc, flushed, "fp16 payload")
    np.testing.assert_array_equal(_bits(ts.numpy()), _bits(js))
    # both decompress the port's payload: only XLA's flush differs
    out = C.blockscale_decompress(tc, ts, tshape).numpy()
    want = np.asarray(JC.blockscale_decompress(jnp.asarray(tc.numpy()),
                                               jnp.asarray(ts.numpy()),
                                               jshape))
    _equal_but_flushed(out.reshape(-1), want.reshape(-1),
                       np.repeat(flushed, block)[:v.size], "decompress")
    # the wrapper on CPU tensors is the plain codec
    wc, ws = ops.blockscale_compress(torch.from_numpy(v), block)
    assert torch.equal(wc, tc) and torch.equal(ws, ts)
    rt = ops.blockscale_roundtrip(torch.from_numpy(v), block)
    assert rt.shape == v.shape and rt.dtype == torch.float32
    np.testing.assert_array_equal(
        _bits(rt.numpy()), _bits(C.blockscale_roundtrip(torch.from_numpy(v),
                                                        block).numpy()))


@pytest.mark.parametrize("case", CASES)
def test_plain_codec_matches_pallas_kernels(case):
    """The JAX package's kernel oracle (``repro.kernels.ref``) and its
    Pallas kernels in interpret mode: ``compress``/``decompress`` on (n,
    128) blocks with n a multiple of 256, and the wrapper's padded
    roundtrip of any shape."""
    v = _codec_input(case)
    flushed = _flushed_blocks(v, 128)
    tc, ts = ref.blockscale_compress_ref(torch.from_numpy(v), 128)
    if case != "partial":
        for jc, js in (JR.blockscale_compress_ref(jnp.asarray(v)),
                       JK.blockscale_compress(jnp.asarray(v))):
            _equal_but_flushed(tc.numpy(), jc, flushed, "fp16 payload")
            np.testing.assert_array_equal(_bits(ts.numpy()), _bits(js))
        tcj, tsj = jnp.asarray(tc.numpy()), jnp.asarray(ts.numpy())
        got = ref.blockscale_decompress_ref(tc, ts).numpy()
        for want in (JR.blockscale_decompress_ref(tcj, tsj),
                     JK.blockscale_decompress(tcj, tsj)):
            _equal_but_flushed(got, want, flushed, "decompress")
    got = ops.blockscale_roundtrip(torch.from_numpy(v)).numpy()
    want = np.asarray(JK.blockscale_roundtrip(jnp.asarray(v)))
    _equal_but_flushed(got.reshape(-1), want.reshape(-1),
                       np.repeat(flushed, 128)[:v.size], "roundtrip")


def test_codec_edge_values():
    """An all-zero block scales by 32768 / 1e-30 and decompresses to 0; a
    NaN makes its block's scale NaN; the error bound of the JAX property
    test (|out - v| <= max|v| 2^-10) holds."""
    v = torch.zeros(300)
    v[200] = 1.5
    comp, s = ops.blockscale_compress(v, 128)
    assert comp.shape == (3, 128) and s.shape == (3,)
    assert float(s[0]) == np.float32(32768.0) / np.float32(1e-30)
    assert not comp[0].any() and not ops.blockscale_decompress(
        comp, s)[0].any()
    v[5] = float("nan")
    _, s = ops.blockscale_compress(v, 128)
    assert torch.isnan(s[0]) and not torch.isnan(s[1:]).any()
    rng = np.random.default_rng(1)
    w = (rng.standard_normal((5, 300)) * np.exp(8)).astype(np.float32)
    out = ops.blockscale_roundtrip(torch.from_numpy(w)).numpy()
    assert np.all(np.abs(out - w) <= np.abs(w).max() * 2 ** -10 + 1e-12)


def test_codec_wrappers_check_their_inputs():
    with pytest.raises(ValueError, match="block"):
        ops.blockscale_compress(torch.ones(4), 0)
    comp, s = ops.blockscale_compress(torch.ones(10), 4)
    assert comp.shape == (3, 4)
    with pytest.raises(ValueError, match="n_blocks"):
        ops.blockscale_decompress(comp, s[:2])
    with pytest.raises(ValueError, match="more than"):
        ops.blockscale_decompress(comp, s, (13,))
    assert ops.blockscale_decompress(comp, s, (2, 5)).shape == (2, 5)
    with pytest.raises(ValueError, match="one CUDA device"):
        ops.blockscale_compress(torch.ones(4, device="meta"))
    empty = ops.blockscale_roundtrip(torch.ones((0, 8)))
    assert empty.shape == (0, 8)


# ---------------------------------------------------------------------------
# dedup_put: the on-device put aggregation
# ---------------------------------------------------------------------------

def _put_case(case, T=40, D=6, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 12, T)
    if case == "padding":
        ids[rng.random(T) < 0.3] = -1
    elif case == "all_duplicate":
        ids[:] = 7
    elif case == "all_padding":
        ids[:] = -1
    elif case == "overflow":
        ids = rng.integers(0, 1000, T)      # more distinct ids than capacity
    # magnitudes that expose the order of the adds
    g = (rng.standard_normal((T, D))
         * 10.0 ** rng.integers(-6, 7, (T, 1))).astype(np.float32)
    cap = 8 if case == "overflow" else 16
    return ids.astype(np.int32), g, cap


@pytest.mark.parametrize("case", ["random", "padding", "all_duplicate",
                                  "all_padding", "overflow"])
def test_dedup_put_bit_exact_with_jax(case):
    ids, g, cap = _put_case(case)
    got_u, got_g = C.dedup_put(torch.from_numpy(ids), torch.from_numpy(g),
                               cap)
    want_u, want_g = JC.dedup_put(jnp.asarray(ids), jnp.asarray(g), cap)
    assert got_u.dtype == torch.int32 and got_g.shape == (cap, 6)
    np.testing.assert_array_equal(got_u.numpy(), np.asarray(want_u))
    np.testing.assert_array_equal(got_g.numpy(), np.asarray(want_g))


def test_dedup_plan_is_a_csr_of_its_groups():
    ids = np.array([5, -1, 2, 5, 9, 2, 5, -3, 11], np.int32)
    plan = C.dedup_plan(torch.from_numpy(ids), 3)    # 11 overflows
    np.testing.assert_array_equal(plan.dev.numpy(), [2, 5, 9])
    np.testing.assert_array_equal(plan.inv.numpy(),
                                  [1, -1, 0, 1, 2, 0, 1, -1, -1])
    np.testing.assert_array_equal(plan.offsets.numpy(), [0, 2, 5, 6])
    np.testing.assert_array_equal(plan.order.numpy()[:6], [2, 5, 0, 3, 6, 4])
    assert plan.order.dtype == plan.offsets.dtype == torch.int32


# ---------------------------------------------------------------------------
# the lossless index codec (numpy, copied)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_index_codec_equals_jax(seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 50, (16, 6))
    ids[rng.random(ids.shape) < 0.25] = -1
    got, want = C.compress_index_batch(ids), JC.compress_index_batch(ids)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    back = C.decompress_index_batch(*got, 16, 6)
    np.testing.assert_array_equal(back,
                                  JC.decompress_index_batch(*want, 16, 6))
    assert sorted(back[back >= 0]) == sorted(ids[ids >= 0])
    assert C.index_compression_ratio(ids) == JC.index_compression_ratio(ids)
    with pytest.raises(ValueError, match="65535"):
        C.compress_index_batch(np.zeros((65536, 1), np.int64))
