"""Parity of the port's int8 serving path with the JAX package: per-row
quantization (sessionsimilaritysearch_tpu_torch/ops/mips_int8.py against
``index/dense.py:140``), K2's plain version against the Pallas kernel in
interpret mode (as tests/test_pallas.py runs it), ``int8_exact_topk``
against ``pallas_exact_topk_int8`` and ``chunked_topk``, and
``DenseIndex(quantize='int8'|'int8x8')`` against the JAX ``DenseIndex`` on
the same rows. On the CPU the port's wrapper runs K2's plain version; the
kernel itself is compared with it on the card by tests/test_torch_cuda.py
and chip_smoke.py.

Tolerances: quantization is bit for bit (the port computes the scale as
XLA does). Scores agree to rtol 1e-6 where both sides round the same exact
int32 dot to f32 and multiply by the same scale, and to 1e-5 relative where
the JAX side multiplies by the query scale before selection and the port
after. The port's ids must reach value-recall 1.0 at rel_tol 1e-5 against
the rows it stores (code x scale)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from sessionsimilaritysearch_tpu.index.dense import DenseIndex as JaxDenseIndex
from sessionsimilaritysearch_tpu.index.dense import _quantize_rows_int8
from sessionsimilaritysearch_tpu.ops import pallas_mips
from sessionsimilaritysearch_tpu.ops.topk import chunked_topk
from sessionsimilaritysearch_tpu_torch.index.dense import DenseIndex
from sessionsimilaritysearch_tpu_torch.ops import mips, mips_int8
from sessionsimilaritysearch_tpu_torch.ops.topk import l2_normalize, value_recall_at_k

S = 32  # the JAX kernel's rows per strided bucket in these tests


def _t(x):
    return torch.from_numpy(np.array(x))  # a writable copy


@pytest.fixture(scope="module")
def qdata():
    # the JAX side quantizes: its codes and scales feed both sides
    rng = np.random.default_rng(5)
    c = rng.standard_normal((4096, 64)).astype(np.float32)
    q = rng.standard_normal((128, 64)).astype(np.float32)
    cq, cs = _quantize_rows_int8(jnp.asarray(c))
    qq, qs = _quantize_rows_int8(jnp.asarray(q))
    return qq, qs, cq, cs


@pytest.fixture(autouse=True)
def _no_kernel_launch_on_cpu():
    before = (mips_int8.launch_count, mips_int8.wgmma_launch_count)
    yield
    # CPU tensors never launch K2
    assert (mips_int8.launch_count, mips_int8.wgmma_launch_count) == before


@pytest.mark.parametrize("device,d,ptrs,want", [
    ("cuda", 1600, (0, 1600 * 65536, 4 * 65536), "wgmma"),  # a DenseIndex chunk
    ("cuda", 208, (256, 512, 1024), "wgmma"),
    ("cuda", 144, (16, 32, 48), "wgmma"),
    ("cuda", 16, (16, 32, 48), "wgmma"),                    # the narrowest TMA row
    ("cuda", 200, (0, 0, 0), "tile"),                       # rows not 16-byte strided
    ("cuda", 37, (0, 0, 0), "tile"),
    ("cuda", 1600, (8, 0, 0), "tile"),                      # query codes off 16 bytes
    ("cuda", 1600, (0, 1600 + 8, 0), "tile"),               # corpus codes off 16 bytes
    ("cuda", 1600, (0, 1600 * 3, 4 * 3), "tile"),           # scales of a slice at row 3
    ("cpu", 1600, (0, 0, 0), "plain"),
    ("cpu", 37, (1, 1, 1), "plain"),
])
def test_k2_variant(device, d, ptrs, want):
    assert mips_int8.k2_variant(device, d, ptrs) == want


def test_int8x8_index_chunks_take_the_wgmma_variant(monkeypatch):
    # what DenseIndex.search hands K2 at Config() width: every chunk slice
    # of the codes and scales starts 16-byte aligned (base * 1600 and
    # base * 4 bytes on for chunk sizes that are multiples of 4)
    seen = []
    k2 = mips_int8.scores_with_bucket_max_int8

    def spy(queries, corpus, corpus_scales, *args, **kw):
        seen.append((queries.data_ptr(), corpus.data_ptr(), corpus_scales.data_ptr()))
        return k2(queries, corpus, corpus_scales, *args, **kw)

    monkeypatch.setattr(mips_int8, "scores_with_bucket_max_int8", spy)
    rows = np.random.default_rng(3).standard_normal((1300, 1600)).astype(np.float32)
    t = DenseIndex(1600, 2048, device="cpu", chunk_size=512, quantize="int8x8")
    t.add(rows)
    _, I = t.search(rows[:4], 5)
    np.testing.assert_array_equal(I[:, 0], np.arange(4))
    assert len(seen) == 3  # one per chunk
    assert all(mips_int8.k2_variant("cuda", 1600, p) == "wgmma" for p in seen)


def _strided_as_contiguous(corpus: np.ndarray) -> np.ndarray:
    """Permute rows so that each of the port's contiguous 128-row buckets
    holds 128 / S whole strided JAX buckets: [G, S, 128, d] -> [G, 128, S, d]."""
    n, d = corpus.shape
    return corpus.reshape(n // (128 * S), S, 128, d).transpose(0, 2, 1, 3).reshape(n, d)


@pytest.mark.parametrize("shape", [(300, 48), (7, 1600)])
def test_quantize_rows_matches_jax(shape):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(shape) * rng.uniform(0.01, 10, (shape[0], 1))).astype(np.float32)
    x[1] = 0.0  # a zero row: scale clamped at 1e-30, codes 0
    x[2, 3] = 127.5 * np.abs(x[2]).max() / 127.0  # a half-way code rounds to even
    cj, sj = _quantize_rows_int8(jnp.asarray(x))
    ct, st = mips_int8.quantize_rows_int8(_t(x))
    assert ct.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert (ct[1] == 0).all() and st[1].item() == np.float32(1e-30)


@pytest.mark.parametrize("score_dtype", ["float32", "bfloat16"])
def test_plain_k2_matches_pallas_kernel(qdata, score_dtype):
    qq, _, cq, cs = qdata
    with pltpu.force_tpu_interpret_mode():
        s_j, bm_j = pallas_mips.scores_with_bucket_max_int8(
            qq, cq, cs, rows_per_bucket=S, block_q=128, block_c=1024,
            score_dtype=getattr(jnp, score_dtype),
        )
    s_j = np.asarray(s_j.astype(jnp.float32))
    sd = getattr(torch, score_dtype)
    s, bm = mips_int8.scores_with_bucket_max_int8(_t(qq), _t(cq), _t(cs), score_dtype=sd)
    assert s.dtype == sd and bm.shape == (128, 4096 // 128)
    np.testing.assert_allclose(s.float().numpy(), s_j, rtol=1e-6, atol=0)
    # bmax: on the permuted corpus each contiguous port bucket is 128 / S
    # strided JAX buckets, so it is their max
    perm = _strided_as_contiguous(np.arange(4096)[:, None])[:, 0]
    _, bm_p = mips_int8.scores_with_bucket_max_int8(
        _t(qq), _t(np.asarray(cq)[perm]), _t(np.asarray(cs)[perm]), score_dtype=sd)
    want = np.asarray(bm_j).reshape(128, -1, 128 // S).max(axis=-1)
    np.testing.assert_allclose(bm_p.numpy(), want, rtol=1e-6, atol=0)


def test_plain_k2_valid_count_and_penalty(qdata):
    qq, _, cq, cs = qdata
    pen = np.where(np.random.default_rng(1).random(4096) < 0.2, -np.inf, 0.0)
    s, bm = mips_int8.scores_with_bucket_max_int8(
        _t(qq)[:37], _t(cq)[:3000], _t(cs)[:3000], valid_count=2050,
        penalty=_t(pen[:3000].astype(np.float32)))
    exact = np.asarray(qq, np.float64)[:37] @ np.asarray(cq, np.float64)[:3000].T
    want = exact.astype(np.float32) * np.asarray(cs)[:3000]
    want[:, 2050:] = -np.inf
    want = want + pen[:3000].astype(np.float32)
    np.testing.assert_array_equal(s.numpy(), want)
    assert bm.shape == (37, 24)
    np.testing.assert_array_equal(bm.numpy(), mips.bucket_max(_t(want)).numpy())


def test_int8_exact_topk_matches_pallas_and_chunked(qdata):
    qq, qs, cq, cs = qdata
    with pltpu.force_tpu_interpret_mode():
        v_pl, i_pl = pallas_mips.pallas_exact_topk_int8(
            qq, cq, 10, qs, cs, rows_per_bucket=S, block_q=128, block_c=1024,
            score_dtype=jnp.float32,
        )
    v_x, i_x = chunked_topk(qq, cq, 10, chunk_size=4096, metric="ip", mode="sort",
                            corpus_scales=cs, query_scales=qs)
    v, i = mips_int8.int8_exact_topk(_t(qq), _t(cq), 10, _t(qs), _t(cs))
    v, i = v.numpy(), i.numpy()
    for v_j, i_j in ((v_pl, i_pl), (v_x, i_x)):
        np.testing.assert_allclose(v, np.asarray(v_j), rtol=1e-5, atol=0)
        assert (i == np.asarray(i_j)).mean() > 0.95  # ties may swap
    # the returned ids carry their reported (dequantized) scores
    deq_q = np.asarray(qq, np.float64) * np.asarray(qs, np.float64)[:, None]
    deq_c = np.asarray(cq, np.float64) * np.asarray(cs, np.float64)[:, None]
    true = np.take_along_axis(deq_q @ deq_c.T, i, axis=1)
    np.testing.assert_allclose(true, v, rtol=1e-5, atol=0)


@pytest.mark.parametrize("vc", [3000, 7])  # mid-bucket; fewer rows than k
def test_int8_exact_topk_valid_count_and_missing_slots(qdata, vc):
    qq, qs, cq, cs = qdata
    with pltpu.force_tpu_interpret_mode():
        v_pl, i_pl = pallas_mips.pallas_exact_topk_int8(
            qq, cq, 10, qs, cs, rows_per_bucket=S, block_q=128, block_c=1024,
            valid_count=jnp.asarray(vc, jnp.int32), score_dtype=jnp.float32,
        )
    v, i = mips_int8.int8_exact_topk(_t(qq), _t(cq), 10, _t(qs), _t(cs), valid_count=vc)
    v, i = v.numpy(), i.numpy()
    live = i >= 0
    assert (i[live] < vc).all() and np.isneginf(v[~live]).all()
    np.testing.assert_array_equal(live, np.asarray(i_pl) >= 0)
    np.testing.assert_allclose(v[live], np.asarray(v_pl)[live], rtol=1e-5, atol=0)
    if vc == 7:  # 3 missing slots per query
        assert (i[:, 7:] == -1).all() and (i[:, :7] >= 0).all()


def test_kernel_inputs_are_checked():
    c = torch.zeros(300, 16, dtype=torch.int8)
    q = torch.zeros(4, 16, dtype=torch.int8)
    with pytest.raises(TypeError):
        mips_int8.scores_with_bucket_max_int8(q.float(), c, torch.ones(300))
    with pytest.raises(ValueError):
        mips_int8.scores_with_bucket_max_int8(q, c, torch.ones(299))
    with pytest.raises(ValueError):
        mips_int8.scores_with_bucket_max_int8(q, c, torch.ones(300, dtype=torch.float64))
    with pytest.raises(ValueError):
        mips_int8.int8_exact_topk(q, c, 3, torch.ones(5), torch.ones(300))


# ---------------------------------------------------------------------------
# DenseIndex(quantize=...) against the JAX DenseIndex

DIM, CAP, CHUNK = 32, 600, 256
BATCHES = (200, 150, 100)  # 450 rows: two full chunks and a ragged one
TOL = 1e-5


def _pair(quantize, metric):
    rng = np.random.default_rng(0)
    rows = rng.standard_normal((sum(BATCHES), DIM)).astype(np.float32)
    queries = rng.standard_normal((20, DIM)).astype(np.float32)
    j = JaxDenseIndex(DIM, CAP, metric=metric, chunk_size=CHUNK, quantize=quantize)
    t = DenseIndex(DIM, CAP, device="cpu", metric=metric, chunk_size=CHUNK,
                   quantize=quantize)
    start = 0
    for m in BATCHES:
        j.add(rows[start: start + m])
        t.add(rows[start: start + m])
        start += m
    return j, t, queries


def _scored_queries(t, queries) -> np.ndarray:
    """The queries as the port's quantized index ranks them: cast to bf16,
    normalized in bf16 under 'cos', and for 'int8x8' quantized per row and
    dequantized."""
    q = torch.from_numpy(queries).bfloat16()
    if t.metric == "cos":
        q = l2_normalize(q).bfloat16()
    if t.quantize == "int8x8":
        codes, scales = mips_int8.quantize_rows_int8(q)
        return (codes.double() * scales.double()[:, None]).numpy()
    return q.double().numpy()


def _check(j_res, t_res, t, queries, k, mask=None):
    (Dj, Ij), (Dt, It) = j_res, t_res
    assert Dt.shape == It.shape == (len(queries), k)
    assert Dt.dtype == np.float32 and It.dtype == np.int64
    missing = It < 0
    np.testing.assert_array_equal(missing, Ij < 0)
    assert np.isneginf(Dt[missing]).all()
    scale = np.abs(Dj[~missing]).max()
    np.testing.assert_allclose(Dt[~missing], Dj[~missing], atol=TOL * scale, rtol=0)
    # value-recall against the rows as the port stores them (code x scale)
    stored = t.reconstruct_batch(np.arange(t.ntotal))
    ids = It[:, : int((~missing).sum(axis=1).min())]
    if mask is not None:
        assert mask[It[~missing]].all()  # filtered rows never rank
        stored = stored[mask]
        ids = (np.cumsum(mask) - 1)[ids]
    q = _scored_queries(t, queries)
    assert value_recall_at_k(ids, q, stored, ids.shape[1], rel_tol=TOL) == 1.0


@pytest.mark.parametrize("metric", ["cos", "ip"])
@pytest.mark.parametrize("quantize", ["int8", "int8x8"])
class TestQuantizedDenseIndexParity:
    def test_search_streamed(self, quantize, metric):
        j, t, queries = _pair(quantize, metric)
        assert t.ntotal == j.ntotal == sum(BATCHES)
        assert t._buf.dtype == torch.int8 and t._scales.shape == (CAP,)
        _check(j.search(queries, 10), t.search(queries, 10), t, queries, 10)

    def test_search_k_beyond_size(self, quantize, metric):
        j, t, queries = _pair(quantize, metric)
        Dt, It = t.search(queries, 500)  # > 450 rows: 50 missing slots
        assert (It[:, 450:] == -1).all() and (It[:, :450] >= 0).all()
        _check(j.search(queries, 500), (Dt, It), t, queries, 500)

    def test_search_row_mask(self, quantize, metric):
        j, t, queries = _pair(quantize, metric)
        mask = np.random.default_rng(1).random(t.ntotal) < 0.4
        _check(j.search(queries, 10, row_mask=mask),
               t.search(queries, 10, row_mask=mask), t, queries, 10, mask=mask)

    def test_partial_fill(self, quantize, metric):
        # one add of 70 rows into 600 slots: a single ragged chunk
        rng = np.random.default_rng(2)
        rows = rng.standard_normal((70, DIM)).astype(np.float32)
        queries = rng.standard_normal((5, DIM)).astype(np.float32)
        j = JaxDenseIndex(DIM, CAP, metric=metric, chunk_size=CHUNK, quantize=quantize)
        t = DenseIndex(DIM, CAP, device="cpu", metric=metric, chunk_size=CHUNK,
                       quantize=quantize)
        j.add(rows)
        t.add(rows)
        _check(j.search(queries, 8), t.search(queries, 8), t, queries, 8)

    def test_reconstruct_batch(self, quantize, metric):
        j, t, _ = _pair(quantize, metric)
        ids = [0, 199, 200, 449, 7]
        got = t.reconstruct_batch(ids)
        assert got.dtype == np.float32 and got.shape == (5, DIM)
        # same codes and scales on both sides: code x scale is one f32 product
        np.testing.assert_array_equal(got, j.reconstruct_batch(ids))

    def test_reconstruct(self, quantize, metric):
        # the single-row FAISS form: the JAX index's dequantized row, bit for bit
        j, t, _ = _pair(quantize, metric)
        for i in (0, 7, 449):
            got = t.reconstruct(i)
            assert got.dtype == np.float32 and got.shape == (DIM,)
            np.testing.assert_array_equal(got, j.reconstruct(i))
        for bad in (-1, t.ntotal):
            with pytest.raises(IndexError):
                t.reconstruct(bad)


def test_quantize_rejects_l2_and_unknown_modes():
    with pytest.raises(ValueError, match="'ip'/'cos'"):
        DenseIndex(DIM, CAP, device="cpu", metric="l2", quantize="int8")
    with pytest.raises(ValueError, match="unknown quantize"):
        DenseIndex(DIM, CAP, device="cpu", quantize="int4")
