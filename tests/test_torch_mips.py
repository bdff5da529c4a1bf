"""Parity of the port's float dense scans (sessionsimilaritysearch_tpu_torch
/ops/mips.py) with the JAX package: the fused score + bucket-max op and
exact top-k (K1), the bucket-max-only op and ``bucketed_topk`` (K3), and the
score matmul (K6), against the Pallas kernels in interpret mode (as
tests/test_pallas.py runs them) and the XLA ``chunked_topk``. On the CPU the
port's wrappers run the kernels' plain PyTorch versions; the kernels
themselves are compared with them on the card by tests/test_torch_cuda.py
and chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from sessionsimilaritysearch_tpu.ops import pallas_mips
from sessionsimilaritysearch_tpu.ops import topk as jtopk
from sessionsimilaritysearch_tpu_torch.ops import mips
from sessionsimilaritysearch_tpu_torch.ops import topk as ttopk

BF16_TOL = 2 * 2.0**-8  # two bf16 ulps, relative to the per-query scale


@pytest.fixture(scope="module")
def data():
    # the tests/test_pallas.py shape, made with numpy from a seed
    rng = np.random.default_rng(0)
    q = rng.standard_normal((256, 256)).astype(np.float32)
    c = rng.standard_normal((8192, 256)).astype(np.float32)
    return q, c


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _contiguous_bmax(s: np.ndarray) -> np.ndarray:
    q, n = s.shape
    nb = -(-n // 128)
    pad = np.full((q, nb * 128), -np.inf, np.float32)
    pad[:, :n] = s
    return pad.reshape(q, nb, 128).max(axis=-1)


def _strided_as_contiguous(corpus: np.ndarray, rows_per_bucket: int) -> np.ndarray:
    """Permute corpus rows so that each of the port's contiguous 128-row
    buckets holds 128 / rows_per_bucket whole strided JAX buckets:
    [G, S, 128, d] -> [G, 128, S, d]."""
    n, d = corpus.shape
    s = rows_per_bucket
    return corpus.reshape(n // (128 * s), s, 128, d).transpose(0, 2, 1, 3).reshape(n, d)


_COUNTERS = ("launch_count", "wgmma_launch_count", "cp_async_launch_count",
             "bucket_max_launch_count", "scores_matmul_launch_count",
             "scores_matmul_wgmma_launch_count", "scores_matmul_cp_async_launch_count")


@pytest.fixture(autouse=True)
def _no_kernel_launch_on_cpu():
    before = [getattr(mips, c) for c in _COUNTERS]
    yield
    # CPU tensors never launch a kernel
    assert [getattr(mips, c) for c in _COUNTERS] == before


@pytest.mark.parametrize("device,dtype,d,ptrs,want", [
    ("cuda", torch.bfloat16, 1600, (0, 3200 * 65536), "wgmma"),    # a DenseIndex chunk
    ("cuda", torch.bfloat16, 200, (256, 512), "wgmma"),
    ("cuda", torch.bfloat16, 8, (16, 32), "wgmma"),                # the narrowest TMA row
    # bf16 rows TMA cannot describe, of even d at 4-byte-aligned bases: the
    # cp.async-fed wgmma kernel
    ("cuda", torch.bfloat16, 250, (0, 0), "cp_async"),             # BinaryIndex(sign) codes
    ("cuda", torch.bfloat16, 202, (0, 0), "cp_async"),
    ("cuda", torch.bfloat16, 2, (0, 0), "cp_async"),               # one 4-byte word a row
    ("cuda", torch.bfloat16, 1600, (8, 0), "cp_async"),            # queries off 16 bytes
    # odd d or a 2-byte-aligned base: the tile loop
    ("cuda", torch.bfloat16, 37, (0, 0), "tile"),                  # rows not 4-byte strided
    ("cuda", torch.bfloat16, 37, (16, 32), "tile"),
    ("cuda", torch.bfloat16, 1600, (0, 3200 + 2), "tile"),         # corpus off 4 bytes
    ("cuda", torch.bfloat16, 1600, (0, 2), "tile"),
    ("cuda", torch.float32, 1600, (0, 0), "wgmma"),                # the default f32 engine
    ("cuda", torch.float32, 200, (256, 512), "wgmma"),
    ("cuda", torch.float32, 36, (16, 32), "wgmma"),                # a zero-filled K tail
    ("cuda", torch.float32, 202, (0, 0), "tile"),                  # rows not 16-byte strided
    ("cuda", torch.float32, 1600, (8, 0), "tile"),                 # queries off 8 bytes
    ("cuda", torch.float32, 1600, (0, 6400 + 4), "tile"),          # corpus off 4 bytes
    ("cpu", torch.bfloat16, 1600, (0, 0), "plain"),
    ("cpu", torch.float32, 37, (4, 4), "plain"),
])
def test_k1_variant(device, dtype, d, ptrs, want):
    assert mips.k1_variant(device, dtype, d, ptrs) == want


@pytest.mark.parametrize("device,dtype,d,ptrs,want", [
    ("cuda", torch.bfloat16, 1600, (0, 3200 * 65536), "wgmma"),    # the bench point
    ("cuda", torch.bfloat16, 200, (256, 512), "wgmma"),            # the ragged case
    ("cuda", torch.bfloat16, 48, (16, 32), "wgmma"),
    ("cuda", torch.bfloat16, 37, (0, 0), "tile"),                  # rows not 4-byte strided
    ("cuda", torch.bfloat16, 1600, (8, 0), "cp_async"),            # queries off 16 bytes
    ("cuda", torch.bfloat16, 1600, (0, 3200 + 2), "tile"),         # corpus off 4 bytes
    ("cuda", torch.bfloat16, 250, (0, 0), "cp_async"),             # the ITQ codes' width
    ("cuda", torch.bfloat16, 202, (0, 0), "cp_async"),
    ("cuda", torch.bfloat16, 2, (0, 0), "cp_async"),
    ("cuda", torch.bfloat16, 1600, (0, 2), "tile"),
    ("cuda", torch.bfloat16, 37, (16, 32), "tile"),
    ("cuda", torch.float32, 200, (0, 0), "wgmma"),                 # f32: the 3xTF32 split
    ("cuda", torch.float32, 1600, (256, 512), "wgmma"),
    ("cuda", torch.float32, 202, (0, 0), "tile"),                  # f32 tile loop: exact FMA
    ("cuda", torch.float32, 1600, (8, 0), "tile"),                 # queries off 8 bytes
    ("cuda", torch.float32, 1600, (0, 6400 + 4), "tile"),          # corpus off 4 bytes
    ("cpu", torch.bfloat16, 1600, (0, 0), "plain"),
    ("cpu", torch.float32, 200, (4, 4), "plain"),
])
def test_k6_variant(device, dtype, d, ptrs, want):
    # K6 runs K1's Hopper kernels (TMA- or cp.async-fed) with a store-only
    # epilogue where K1's would run, the tile loop of csrc/scores_matmul.cu
    # elsewhere
    assert mips.k6_variant(device, dtype, d, ptrs) == want


class TestScoresWithBucketMax:
    def test_scores_match_pallas_kernel(self, data):
        q, c = data
        with pltpu.force_tpu_interpret_mode():
            s_jax, _ = pallas_mips.scores_with_bucket_max(
                jnp.asarray(q), jnp.asarray(c), rows_per_bucket=32,
                block_q=128, block_c=1024, score_dtype=jnp.float32,
            )
        s_jax = np.asarray(s_jax)
        s, bmax = mips.scores_with_bucket_max(_t(q), _t(c))
        # f32 sums of 256 terms in another order: atol 1e-3 on |s| ~ 16
        np.testing.assert_allclose(s.numpy(), s_jax, atol=1e-3, rtol=0)
        # the port's buckets are 128 contiguous rows (the JAX kernel's are
        # strided): bmax is the contiguous max of the same scores
        np.testing.assert_allclose(
            bmax.numpy(), _contiguous_bmax(s_jax), atol=1e-3, rtol=0
        )

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_ragged_shape_valid_count_and_penalty(self, dtype):
        rng = np.random.default_rng(1)
        q = _t(rng.standard_normal((37, 64)).astype(np.float32)).to(dtype)
        c = _t(rng.standard_normal((5003, 64)).astype(np.float32)).to(dtype)
        pen = np.where(rng.random(5003) < 0.1, -np.inf, 0.0).astype(np.float32)
        s, bmax = mips.scores_with_bucket_max(
            q, c, valid_count=4000, penalty=_t(pen), score_dtype=dtype
        )
        want = q.double().numpy() @ c.double().numpy().T
        want[:, 4000:] = -np.inf
        want = want + pen
        assert s.shape == (37, 5003) and s.dtype == dtype
        assert bmax.shape == (37, 40) and bmax.dtype == torch.float32
        got = s.float().numpy()
        np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
        fin = np.isfinite(want)
        # f32 accumulation vs f64; bf16 scores round to 2^-8 relative
        tol = 1e-4 if dtype == torch.float32 else 2.0**-8 * np.abs(want[fin]).max()
        np.testing.assert_allclose(got[fin], want[fin], atol=tol, rtol=0)
        # bmax is taken from the f32 values before rounding to score_dtype
        np.testing.assert_allclose(
            bmax.numpy(), _contiguous_bmax(want.astype(np.float32)),
            atol=1e-4, rtol=0,
        )

    @pytest.mark.parametrize("bad", ["dtype_mismatch", "depth", "penalty_len",
                                     "valid_count", "score_dtype",
                                     "not_contiguous"])
    def test_rejects_bad_inputs(self, bad):
        q = torch.zeros(4, 8)
        c = torch.zeros(300, 8)
        kw = {}
        if bad == "dtype_mismatch":
            c = c.to(torch.bfloat16)
        elif bad == "depth":
            c = torch.zeros(300, 9)
        elif bad == "penalty_len":
            kw["penalty"] = torch.zeros(299)
        elif bad == "valid_count":
            kw["valid_count"] = 301
        elif bad == "score_dtype":
            kw["score_dtype"] = torch.float16
        else:
            c = torch.zeros(8, 300).T
        with pytest.raises((TypeError, ValueError)):
            mips.scores_with_bucket_max(q, c, **kw)


class TestExactTopk:
    def test_matches_pallas_exact_topk_and_chunked(self, data):
        q, c = data
        with pltpu.force_tpu_interpret_mode():
            v_pl, _ = pallas_mips.pallas_exact_topk(
                jnp.asarray(q), jnp.asarray(c), 10, rows_per_bucket=32,
                score_dtype=jnp.float32,
            )
        v_x, _ = jtopk.chunked_topk(
            jnp.asarray(q), jnp.asarray(c), 10, chunk_size=8192, mode="exact"
        )
        v, i = mips.exact_topk(_t(q), _t(c), 10)
        v, i = v.numpy(), i.numpy()
        np.testing.assert_allclose(v, np.asarray(v_pl), atol=1e-3, rtol=0)
        np.testing.assert_allclose(v, np.asarray(v_x), atol=1e-3, rtol=0)
        # the returned ids carry their reported scores
        true = np.take_along_axis(q.astype(np.float64) @ c.T.astype(np.float64), i, 1)
        np.testing.assert_allclose(true, v, atol=1e-3, rtol=0)

    def test_ragged_shape_matches_chunked(self):
        rng = np.random.default_rng(2)
        q = rng.standard_normal((37, 48)).astype(np.float32)
        c = rng.standard_normal((5000, 48)).astype(np.float32)
        v_x, _ = jtopk.chunked_topk(jnp.asarray(q), jnp.asarray(c), 20,
                                    chunk_size=5000)
        v, i = mips.exact_topk(_t(q), _t(c), 20)
        np.testing.assert_allclose(v.numpy(), np.asarray(v_x), atol=1e-4, rtol=0)
        # f32 ranking vs the f64 oracle: near-ties within f32 rounding
        assert ttopk.value_recall_at_k(i.numpy(), q, c, 20, rel_tol=1e-5) == 1.0

    def test_valid_count_missing_slots(self, data):
        q, c = data
        with pltpu.force_tpu_interpret_mode():
            v_pl, i_pl = pallas_mips.pallas_exact_topk(
                jnp.asarray(q), jnp.asarray(c), 10, rows_per_bucket=32,
                valid_count=jnp.asarray(7), score_dtype=jnp.float32,
            )
        v, i = mips.exact_topk(_t(q), _t(c), 10, valid_count=7)
        v, i = v.numpy(), i.numpy()
        assert (i[:, 7:] == -1).all() and np.isneginf(v[:, 7:]).all()
        assert ((i[:, :7] >= 0) & (i[:, :7] < 7)).all()
        np.testing.assert_array_equal(i[:, 7:], np.asarray(i_pl)[:, 7:])
        np.testing.assert_allclose(v[:, :7], np.asarray(v_pl)[:, :7],
                                   atol=1e-3, rtol=0)

    def test_row_mask_penalty_matches_chunked(self, data):
        q, c = data
        mask = np.random.default_rng(3).random(c.shape[0]) < 0.3
        v_x, _ = jtopk.chunked_topk(
            jnp.asarray(q), jnp.asarray(c), 10, chunk_size=8192,
            row_mask=jnp.asarray(mask),
        )
        pen = _t(np.where(mask, 0.0, -np.inf).astype(np.float32))
        v, i = mips.exact_topk(_t(q), _t(c), 10, penalty=pen)
        np.testing.assert_allclose(v.numpy(), np.asarray(v_x), atol=1e-3, rtol=0)
        assert mask[i.numpy()].all()  # filtered rows never rank

    @pytest.mark.parametrize("in_dtype", [torch.float32, torch.bfloat16])
    def test_bf16_scores_value_recall(self, data, in_dtype):
        q, c = data
        qt, ct = _t(q).to(in_dtype), _t(c).to(in_dtype)
        _, i = mips.exact_topk(qt, ct, 10, score_dtype=torch.bfloat16)
        # judged against the rows as stored (bf16-rounded for bf16 input)
        recall = ttopk.value_recall_at_k(
            i.numpy(), qt.float().numpy(), ct.float().numpy(), 10,
            rel_tol=BF16_TOL,
        )
        assert recall == 1.0

    @pytest.mark.parametrize("k,n", [(10, 300), (10, 5), (3, 128)])
    def test_k_beyond_buckets_and_rows(self, k, n):
        rng = np.random.default_rng(4)
        q = rng.standard_normal((6, 16)).astype(np.float32)
        c = rng.standard_normal((n, 16)).astype(np.float32)
        v, i = mips.exact_topk(_t(q), _t(c), k)
        kk = min(k, n)
        want_v, want_i = ttopk.oracle_topk_np(q, c, kk)
        np.testing.assert_allclose(v.numpy()[:, :kk], want_v, atol=1e-4, rtol=0)
        np.testing.assert_array_equal(i.numpy()[:, :kk], want_i)
        assert (i.numpy()[:, kk:] == -1).all()
        assert np.isneginf(v.numpy()[:, kk:]).all()


class TestBucketMax:
    def test_bmax_matches_pallas_kernel(self, data):
        q, c = data
        with pltpu.force_tpu_interpret_mode():
            bm_j = pallas_mips.scores_bucket_max(
                jnp.asarray(q), jnp.asarray(c), rows_per_bucket=32,
                block_q=128, block_c=1024,
            )
        # on the permuted corpus each contiguous port bucket holds four whole
        # strided JAX buckets, so its max is theirs
        bm = mips.scores_bucket_max(_t(q), _t(_strided_as_contiguous(c, 32)))
        want = np.asarray(bm_j).reshape(256, -1, 4).max(axis=-1)
        # f32 sums of 256 terms in another order: atol 1e-3 on |s| ~ 16
        np.testing.assert_allclose(bm.numpy(), want, atol=1e-3, rtol=0)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_ragged_shape_and_valid_count(self, dtype):
        rng = np.random.default_rng(7)
        q = _t(rng.standard_normal((37, 64)).astype(np.float32)).to(dtype)
        c = _t(rng.standard_normal((5003, 64)).astype(np.float32)).to(dtype)
        bm = mips.scores_bucket_max(q, c, valid_count=4037)
        want = q.double().numpy() @ c.double().numpy().T
        want[:, 4037:] = -np.inf
        assert bm.shape == (37, 40) and bm.dtype == torch.float32
        assert np.isneginf(bm.numpy()[:, 32:]).all()  # buckets past 4037 + ragged
        np.testing.assert_allclose(bm.numpy(), _contiguous_bmax(want.astype(np.float32)),
                                   atol=1e-4, rtol=0)

    def test_bucketed_topk_matches_pallas(self, data):
        q, c = data
        with pltpu.force_tpu_interpret_mode():
            v_j, _ = pallas_mips.pallas_bucketed_topk(
                jnp.asarray(q), jnp.asarray(c), 10, rows_per_bucket=32,
            )
        v, i = mips.bucketed_topk(_t(q), _t(c), 10)
        np.testing.assert_allclose(v.numpy(), np.asarray(v_j), atol=1e-3, rtol=0)
        # the returned ids carry their reported scores
        true = np.take_along_axis(q.astype(np.float64) @ c.T.astype(np.float64),
                                  i.numpy(), 1)
        np.testing.assert_allclose(true, v.numpy(), atol=1e-3, rtol=0)

    @pytest.mark.parametrize("k,n,vc", [(10, 300, 300), (10, 5, 5), (10, 300, 7),
                                        (3, 700, 520)])
    def test_bucketed_topk_valid_count_and_missing_slots(self, k, n, vc):
        rng = np.random.default_rng(8)
        q = rng.standard_normal((6, 16)).astype(np.float32)
        c = rng.standard_normal((n, 16)).astype(np.float32)
        v, i = mips.bucketed_topk(_t(q), _t(c), k, valid_count=vc)
        kk = min(k, vc)
        want_v, want_i = ttopk.oracle_topk_np(q, c[:vc], kk)
        np.testing.assert_allclose(v.numpy()[:, :kk], want_v, atol=1e-4, rtol=0)
        np.testing.assert_array_equal(i.numpy()[:, :kk], want_i)
        assert (i.numpy()[:, kk:] == -1).all() and np.isneginf(v.numpy()[:, kk:]).all()

    def test_bucketed_topk_query_tiles(self, data, monkeypatch):
        # a gather budget of two queries' rows: the re-rank runs in tiles and
        # must return what one tile returns
        q, c = _t(data[0][:7]).to(torch.bfloat16), _t(data[1]).to(torch.bfloat16)
        v1, i1 = mips.bucketed_topk(q, c, 10)
        monkeypatch.setattr(mips, "GATHER_BYTES", 2 * 10 * 128 * 256 * (2 + 4))
        v2, i2 = mips.bucketed_topk(q, c, 10)
        # the product may sum in another order for another batch shape
        torch.testing.assert_close(v2, v1, atol=1e-4, rtol=0)
        true = q.double() @ c.double().T  # exact bf16 products
        torch.testing.assert_close(torch.gather(true, 1, i2).float(), v2,
                                   atol=1e-4, rtol=0)

    def test_bucketed_topk_rejects_int8(self):
        c = torch.zeros(300, 8, dtype=torch.int8)
        with pytest.raises(TypeError):
            mips.bucketed_topk(c[:4], c, 3)


class TestScoresMatmul:
    def test_matches_pallas_kernel(self, data):
        q, c = data
        with pltpu.force_tpu_interpret_mode():
            s_j = pallas_mips.scores_matmul(jnp.asarray(q), jnp.asarray(c),
                                            block_q=128, block_c=1024)
        s = mips.scores_matmul(_t(q), _t(c))
        assert s.dtype == torch.float32 and s.shape == (256, 8192)
        # f32 sums of 256 terms in another order: atol 1e-3 on |s| ~ 16
        np.testing.assert_allclose(s.numpy(), np.asarray(s_j), atol=1e-3, rtol=0)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_ragged_shape(self, dtype):
        # no divisibility constraint, unlike the Pallas kernel's q % block_q
        rng = np.random.default_rng(9)
        q = _t(rng.standard_normal((37, 48)).astype(np.float32)).to(dtype)
        c = _t(rng.standard_normal((5003, 48)).astype(np.float32)).to(dtype)
        s = mips.scores_matmul(q, c)
        want = q.double().numpy() @ c.double().numpy().T  # exact bf16 products
        assert s.shape == (37, 5003) and s.dtype == torch.float32
        np.testing.assert_allclose(s.numpy(), want, atol=1e-4, rtol=0)


class TestNumpyHelpers:
    """The port's copies of the numpy oracle and recall gates agree with
    the JAX package's."""

    def test_oracle_and_recall_agree(self):
        rng = np.random.default_rng(5)
        q = rng.standard_normal((9, 12)).astype(np.float32)
        c = rng.standard_normal((70, 12)).astype(np.float32)
        for metric in ("ip", "l2"):
            a = ttopk.oracle_topk_np(q, c, 5, metric)
            b = jtopk.oracle_topk_np(q, c, 5, metric)
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])
        found = rng.integers(-1, 70, (9, 5))
        _, true = jtopk.oracle_topk_np(q, c, 5)
        assert ttopk.recall_at_k(found, true) == jtopk.recall_at_k(found, true)
        for tol in (0.0, 0.05):
            assert ttopk.value_recall_at_k(found, q, c, 5, rel_tol=tol) == \
                jtopk.value_recall_at_k(found, q, c, 5, rel_tol=tol)

    def test_l2_normalize_and_merge_topk(self):
        rng = np.random.default_rng(6)
        x = rng.standard_normal((5, 7)).astype(np.float32)
        x[0] = 0.0  # clipped norm: an all-zero row stays zero
        np.testing.assert_allclose(
            ttopk.l2_normalize(_t(x)).numpy(),
            np.asarray(jtopk.l2_normalize(jnp.asarray(x))), atol=1e-6, rtol=0,
        )
        va, vb = rng.standard_normal((2, 3, 4)).astype(np.float32)
        ia, ib = rng.integers(0, 100, (2, 3, 4))
        tv, ti = ttopk.merge_topk(_t(va), _t(ia), _t(vb), _t(ib), 4)
        jv, ji = jtopk.merge_topk(jnp.asarray(va), jnp.asarray(ia),
                                  jnp.asarray(vb), jnp.asarray(ib), 4)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))

