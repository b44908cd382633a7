"""The port's bf16 1-NN (K3) as it is on Hopper: the prepared-candidates
layout of nn1_bf16_prepare_plain against a numpy oracle of the stated
layout, nearest_1_bf16 on prepared candidates against raw rows and the
JAX package's _nn_call_bf16 in interpret mode, the candidate ranges at
this kernel's tiles, and the wrappers' checks. On the CPU the wrappers
run their plain torch versions; the CUDA kernels themselves are checked
on the card by chip_smoke.py."""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiler_tpu.ops.pallas_kernels import _nn_call_bf16
from tiler_tpu_torch.ops import nn_kernels as nk

BC, KC = 128, 64     # the kernel's candidate tile and K-chunk


def _bf16_bits(x: np.ndarray) -> np.ndarray:
    """f32 -> the 16 bits of the nearest bf16, ties to even (finite x)."""
    u = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)


def _oracle(c: np.ndarray, norms: np.ndarray) -> np.ndarray:
    """The stated layout, element by element: per 128-candidate tile,
    D_pad / 64 blocks [128, 64] bf16 whose row r keeps its 16-byte group g
    at g ^ (r % 8), then 128 f32 norms (+inf past n_c); zero elsewhere."""
    n_c, dim = c.shape
    chunks = -(-dim // KC)
    tiles, tile_bytes = -(-n_c // BC), BC * (2 * KC * chunks + 4)
    out = np.zeros((tiles, tile_bytes), np.uint8)
    bits = _bf16_bits(c)
    for i, k in itertools.product(range(n_c), range(dim)):
        r, kk = i % BC, k % KC
        at = (k // KC) * BC * 128 + r * 128 \
            + (((kk // 8) ^ (r % 8)) * 16) + (kk % 8) * 2
        out[i // BC, at] = bits[i, k] & 0xFF          # little endian
        out[i // BC, at + 1] = bits[i, k] >> 8
    pad = np.full(tiles * BC, np.inf, np.float32)
    pad[:n_c] = norms
    out[:, chunks * BC * 128:] = pad.view(np.uint8).reshape(tiles, BC * 4)
    return out


@pytest.mark.parametrize('dim', [3, 100, 192])
def test_prepare_plain_layout_matches_numpy_oracle(rng, dim):
    """Every element at its swizzled place for a ragged C; rows() gives
    bf16_round(c) back; the norms are nn1_prepare_plain's (one summation
    order for both prepare kernels), +inf in the padding."""
    n_c = 300                                  # 2 full tiles and 44 rows
    c = rng.normal(0, 3, (n_c, dim)).astype(np.float32)
    ct = torch.from_numpy(c)
    prep = nk.nn1_bf16_prepare_plain(ct)
    k1_norms = nk.nn1_prepare_plain(ct).norms()
    assert (prep.n_c, prep.dim, prep.dim_pad) == (n_c, dim, -(-dim // KC) * KC)
    assert prep.ct.dtype == torch.uint8 and prep.ct.is_contiguous()
    assert prep.ct.shape == (3, BC * (2 * prep.dim_pad + 4))
    np.testing.assert_array_equal(prep.ct.numpy(),
                                  _oracle(c, k1_norms.numpy()))
    assert torch.equal(prep.rows(), nk.bf16_round(ct))
    assert torch.equal(prep.norms(), k1_norms)
    tail = prep.ct[2, -BC * 4:].contiguous().view(torch.float32)
    assert torch.isinf(tail[n_c - 2 * BC:]).all()
    # prepare_bf16 on a CPU tensor is the plain version, and counts nothing
    before = nk.LAUNCHES_BF16_PREP
    assert torch.equal(nk.prepare_bf16(ct).ct, prep.ct)
    assert nk.LAUNCHES_BF16_PREP == before


def test_bf16_bits_oracle_rounds_as_torch(rng):
    """The oracle's rounding is torch's astype(bfloat16): ties to even."""
    x = np.concatenate([rng.normal(0, 100, 4096).astype(np.float32),
                        np.array([1 + 2 ** -8, 1 + 3 * 2 ** -8,
                                  -(1 + 2 ** -8), 0.0], np.float32)])
    want = torch.from_numpy(x).to(torch.bfloat16).view(torch.int16).numpy()
    np.testing.assert_array_equal(_bf16_bits(x).view(np.int16), want)


@pytest.mark.parametrize('dim', [64, 192])
def test_prepared_equals_raw_rows_and_pallas_on_integers(rng, dim):
    """Integer features in [-64, 64) are bf16-exact and every sum is
    exact: nearest_1_bf16 on a PreparedBf16 set equals it on raw rows and
    the Pallas kernel in interpret mode bit for bit, duplicates resolve
    to the lowest index and 1e9 padding rows never win."""
    c = rng.integers(-64, 64, (1024, dim)).astype(np.float32)
    c[512:768] = c[0:256]
    q = np.concatenate([c[:256], rng.integers(-64, 64, (256, dim))
                        .astype(np.float32)])
    cpad = np.concatenate([c, np.full((512, dim), 1e9, np.float32)])
    err_r, idx_r = _nn_call_bf16(jnp.asarray(q), jnp.asarray(cpad), 128,
                                 256, True)
    qt, ct = torch.from_numpy(q), torch.from_numpy(cpad)
    idx_raw, err_raw = nk.nearest_1_bf16(qt, ct)
    idx_p, err_p = nk.nearest_1_bf16(qt, nk.prepare_bf16(ct))
    assert torch.equal(idx_p, idx_raw) and torch.equal(err_p, err_raw)
    np.testing.assert_array_equal(idx_p.numpy(), np.asarray(idx_r))
    np.testing.assert_array_equal(err_p.numpy(), np.asarray(err_r))
    np.testing.assert_array_equal(idx_p[:256].numpy(), np.arange(256))
    assert (idx_p < 1024).all()


def test_prepared_on_normal_features_within_tolerance(rng):
    """Normal features: the prepared form sums the candidates' norms in
    the kernel's order, the raw form in torch's; err within rtol 1e-5 /
    atol 1e-4 of each other and winners apart only at near ties in the
    bf16 metric."""
    q = rng.normal(0, 1, (128, 192)).astype(np.float32)
    c = rng.normal(0, 1, (1500, 192)).astype(np.float32)
    qt, ct = torch.from_numpy(q), torch.from_numpy(c)
    idx_raw, err_raw = nk.nearest_1_bf16(qt, ct)
    idx_p, err_p = nk.nearest_1_bf16(qt, nk.prepare_bf16(ct))
    torch.testing.assert_close(err_p, err_raw, rtol=1e-5, atol=1e-4)
    bad = torch.nonzero(idx_p != idx_raw)[:, 0]
    qb, cb = nk.bf16_round(qt).double(), nk.bf16_round(ct).double()

    def dist(idx):
        dot = (qb[bad] * cb[idx[bad].long()]).sum(1)
        return (qt[bad].double() ** 2).sum(1) \
            + (ct[idx[bad].long()].double() ** 2).sum(1) - 2 * dot
    torch.testing.assert_close(dist(idx_p), dist(idx_raw), rtol=1e-4,
                               atol=0)


def test_candidate_ranges_at_the_bf16_tiles():
    """The wave model with 256-query blocks and 128-candidate tiles: the
    ranges cover the tiles, none is empty, a chunk of one query tile per
    SM keeps one range, the standard 16384-query chunk (64 query tiles on
    132 SMs) takes two, a short chunk many."""
    n_sm = 132
    for n_q, n_c in itertools.product(
            (1, 255, 256, 257, 2000, 9000, 12000, 16384, 256 * n_sm),
            (1, 127, 128, 129, 5013, 20000, 262144, 1 << 20)):
        n_range, per = nk.candidate_ranges_bf16(n_q, n_c, n_sm)
        c_tiles = -(-n_c // BC)
        assert n_range >= 1 and per >= 1
        assert n_range * per >= c_tiles > (n_range - 1) * per, (n_q, n_c)
    assert nk.candidate_ranges_bf16(256 * n_sm, 262144, n_sm) == (1, 2048)
    assert nk.candidate_ranges_bf16(16384, 262144, n_sm) == (2, 1024)
    assert nk.candidate_ranges_bf16(2000, 262144, n_sm)[0] >= 8
    assert nk.candidate_ranges_bf16(2000, 100, n_sm) == (1, 1)
    # K1's tiles stay the default
    assert nk.candidate_ranges(16384, 262144, n_sm) == \
        nk.candidate_ranges(16384, 262144, n_sm, 128, 256) == (1, 1024)


@pytest.mark.parametrize('case', ['dtype', 'device', 'width', 'width_limit',
                                  'shape', 'bytes_dtype', 'empty',
                                  'strided', 'foreign'])
def test_prepared_wrapper_checks(case):
    """nearest_1_bf16 and prepare_bf16 raise on what the kernels do not
    take; nothing is launched or counted on the way."""
    q = torch.zeros((4, 192))
    prep = nk.prepare_bf16(torch.ones((8, 192)))
    before = (nk.LAUNCHES_BF16, nk.LAUNCHES_BF16_PREP)
    if case == 'dtype':
        with pytest.raises(TypeError):
            nk.nearest_1_bf16(q.double(), prep)
        with pytest.raises(TypeError):
            nk.prepare_bf16(torch.ones((8, 192), dtype=torch.float64))
    elif case == 'device':
        with pytest.raises(ValueError, match='queries on'):
            nk.nearest_1_bf16(q, nk.PreparedBf16(prep.ct.to('meta'), 8, 192))
        with pytest.raises(ValueError, match='cuda or cpu'):
            nk.nearest_1_bf16(q.to('meta'), prep)
    elif case == 'width':
        with pytest.raises(ValueError, match='widths differ'):
            nk.nearest_1_bf16(torch.zeros((4, 100)), prep)
    elif case == 'width_limit':
        with pytest.raises(ValueError, match='257'):
            nk.prepare_bf16(torch.ones((8, 257)))
        with pytest.raises(ValueError, match='257'):
            nk.nearest_1_bf16(torch.zeros((4, 257)), torch.ones((8, 257)))
        assert nk.prepare_bf16(torch.ones((8, 256))).dim_pad == 256
    elif case == 'shape':
        bad = nk.PreparedBf16(prep.ct[:, :-4].contiguous(), 8, 192)
        with pytest.raises(ValueError, match='prepare_bf16'):
            nk.nearest_1_bf16(q, bad)
        with pytest.raises(ValueError, match='prepare_bf16'):
            nk.nearest_1_bf16(q, nk.PreparedBf16(prep.ct, 300, 192))
    elif case == 'bytes_dtype':
        bad = nk.PreparedBf16(prep.ct.to(torch.int16), 8, 192)
        with pytest.raises(ValueError, match='prepare_bf16'):
            nk.nearest_1_bf16(q, bad)
    elif case == 'empty':
        with pytest.raises(ValueError):
            nk.nearest_1_bf16(q, nk.PreparedBf16(prep.ct, 0, 192))
        with pytest.raises(ValueError, match='no candidates'):
            nk.prepare_bf16(torch.ones((0, 192)))
    elif case == 'strided':
        wide = torch.zeros((1, 2 * prep.ct.shape[1]), dtype=torch.uint8)
        with pytest.raises(ValueError, match='prepare_bf16'):
            nk.nearest_1_bf16(q, nk.PreparedBf16(wide[:, ::2], 8, 192))
    else:
        # K1's prepared set is not K3's, nor the other way round
        with pytest.raises(TypeError, match='prepare_bf16'):
            nk.nearest_1_bf16(q, nk.prepare(torch.ones((8, 192))))
        with pytest.raises(TypeError, match='prepare_bf16'):
            nk.nearest_1(q, prep)
    assert (nk.LAUNCHES_BF16, nk.LAUNCHES_BF16_PREP) == before


def test_cpu_path_counts_no_launch_and_empty_queries():
    """CPU tensors run the plain versions: no counter moves; no queries
    give empty results of the right types."""
    before = (nk.LAUNCHES, nk.LAUNCHES_PREP, nk.LAUNCHES_AUG,
              nk.LAUNCHES_BF16, nk.LAUNCHES_BF16_PREP)
    c = torch.ones((8, 192))
    prep = nk.prepare_bf16(c)
    for cand in (c, prep):
        idx, err = nk.nearest_1_bf16(torch.zeros((4, 192)), cand)
        assert idx.shape == (4,) and err.shape == (4,)
        assert idx.dtype == torch.int32 and err.dtype == torch.float32
        idx, err = nk.nearest_1_bf16(torch.zeros((0, 192)), cand)
        assert idx.shape == (0,) and err.shape == (0,)
    assert (nk.LAUNCHES, nk.LAUNCHES_PREP, nk.LAUNCHES_AUG,
            nk.LAUNCHES_BF16, nk.LAUNCHES_BF16_PREP) == before
