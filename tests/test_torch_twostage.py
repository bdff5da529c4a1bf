"""Parity of the port's two-stage serving (``index/twostage.py``, with
``ops/topk.py`` ``rerank_topk``) with the JAX package: the packed Hamming
stage 1 and the exact re-rank, for the 'binary' (SimHash, the JAX
projection carried across by ``weights.simhash_projection``) and 'itq'
(projector fitted once by the JAX ``fit_itq``) prefilters.

Tolerances: re-rank values 1e-5 (f32 sums in another order); an index
whose pool holds every row returns the exact dense top-k, value-recall 1.0
against the f64 oracle at two bf16 ulps (the rows are stored in bf16).
Stage-1 Hamming distances are integers and compared exactly, sorted per
query."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sessionsimilaritysearch_tpu.index import twostage as jts
from sessionsimilaritysearch_tpu.ops import topk as jtopk
from sessionsimilaritysearch_tpu.ops.projection import fit_itq
from sessionsimilaritysearch_tpu_torch.index.twostage import TwoStageIndex
from sessionsimilaritysearch_tpu_torch.ops import mips, packed, popcount
from sessionsimilaritysearch_tpu_torch.ops.topk import rerank_topk, value_recall_at_k
from sessionsimilaritysearch_tpu_torch.weights import simhash_projection

BF16_TOL = 2 * 2.0**-8
DIM, N, N_BITS = 64, 1000, 64


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _unit(x):
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.fixture(autouse=True)
def _no_kernel_launch_on_cpu():
    counts = (mips.launch_count, packed.launch_count, popcount.launch_count)
    yield
    assert (mips.launch_count, packed.launch_count, popcount.launch_count) == counts


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    c = rng.standard_normal((N, DIM)).astype(np.float32)
    q = (c[:20] + 0.3 * rng.standard_normal((20, DIM))).astype(np.float32)
    return q, c


def _pair(prefilter, c, pool=512, capacity=1024, seed=0):
    """The JAX index and the port's, over the same rows and the same code
    projection."""
    kw = dict(prefilter=prefilter, pool=pool, stage1="packed")
    if prefilter == "itq":
        proj = fit_itq(_unit(c), N_BITS)
        j = jts.TwoStageIndex(DIM, capacity, projector=proj, **kw)
        t = TwoStageIndex(DIM, capacity, device="cpu", projector=proj, **kw)
    else:
        R = jax.random.normal(jax.random.PRNGKey(seed), (DIM, N_BITS), jnp.float32)
        j = jts.TwoStageIndex(DIM, capacity, n_bits=N_BITS, seed=seed, **kw)
        t = TwoStageIndex(DIM, capacity, device="cpu", n_bits=N_BITS,
                          projection=simhash_projection(np.asarray(R)), **kw)
    j.add(c)
    t.add(c)
    return j, t


def _jax_q_codes(j, qn):
    if j.prefilter == "itq":
        return jts._centered_signs(qn, j._proj_mean, j._proj_comp)
    return jts._simhash_signs(qn, j.n_bits, j.seed)


class TestRerankTopk:
    @pytest.fixture(scope="class")
    def case(self):
        rng = np.random.default_rng(1)
        corpus = rng.standard_normal((500, 48)).astype(np.float32)
        queries = rng.standard_normal((37, 48)).astype(np.float32)
        cand = rng.integers(0, 500, (37, 64)).astype(np.int32)
        cand[:, -5:] = -1  # missing slots
        cand[3] = -1  # a query with no candidate at all
        return queries, corpus, cand

    @pytest.mark.parametrize("k,q_chunk", [(10, 128), (10, 8), (80, 16)])
    def test_matches_jax(self, case, k, q_chunk):
        queries, corpus, cand = case
        vj, ij = jtopk.rerank_topk(jnp.asarray(queries), jnp.asarray(corpus),
                                   jnp.asarray(cand), k, q_chunk=q_chunk)
        vj, ij = np.asarray(vj), np.asarray(ij)
        v, i = rerank_topk(_t(queries), _t(corpus), _t(cand), k, q_chunk=q_chunk)
        v, i = v.numpy(), i.numpy()
        assert v.shape == i.shape == (37, k) and i.dtype == np.int64
        np.testing.assert_array_equal(i < 0, ij < 0)
        np.testing.assert_allclose(v[i >= 0], vj[ij >= 0], atol=1e-5, rtol=0)
        assert np.isneginf(v[i < 0]).all()
        # ids agree wherever the value has no tie (a candidate may repeat)
        for r in range(37):
            for c in range(k):
                if i[r, c] >= 0 and np.sum(np.abs(v[r] - v[r, c]) < 1e-6) == 1:
                    assert i[r, c] == ij[r, c]

    @pytest.mark.parametrize("kw", [{"metric": "l2"}, {"corpus_scales": np.ones(5)}])
    def test_unported_options_raise(self, kw):
        x = torch.zeros(2, 4)
        with pytest.raises(NotImplementedError, match="Queue 1 item 2"):
            rerank_topk(x, x, torch.zeros(2, 2, dtype=torch.int64), 1, **kw)


class TestTwoStageIndex:
    @pytest.mark.parametrize("prefilter", ["binary", "itq"])
    def test_full_pool_is_exact_dense(self, data, prefilter):
        q, c = data
        j, t = _pair(prefilter, c)
        Dj, Ij = j.search(q, 10, pool=N)
        D, I = t.search(q, 10, pool=N)
        qn, cn = _unit(q), _unit(c)
        for ids in (I, Ij):
            assert value_recall_at_k(ids, qn, cn, 10, rel_tol=BF16_TOL) == 1.0
        np.testing.assert_allclose(D, Dj, atol=1e-5, rtol=0)
        assert D.dtype == np.float32 and I.dtype == np.int64

    @pytest.mark.parametrize("prefilter", ["binary", "itq"])
    def test_small_pool_stage1_and_rerank(self, data, prefilter):
        q, c = data
        pool = 40
        j, t = _pair(prefilter, c, pool=pool)
        qn = _unit(q)
        # stage 1: the same codes, so the same Hamming distances
        q_codes = t._codes(_t(qn))
        jq_codes = np.asarray(_jax_q_codes(j, jnp.asarray(qn))).astype(np.float32)
        np.testing.assert_array_equal(q_codes.float().numpy(), jq_codes)
        dj, _ = j._codes_index.search(jq_codes, pool)
        d, cand = t._codes_index.search_device(q_codes, pool)
        np.testing.assert_array_equal(np.sort(d.numpy(), 1), np.sort(np.asarray(dj), 1))
        # stage 2: the top-k is the exact re-rank of the port's own pool
        D, I = t.search(q, 10)
        stored = t.reconstruct_batch(np.arange(N)).astype(np.float64)
        exact = np.einsum("qd,qpd->qp", qn.astype(np.float64), stored[cand.numpy()])
        want = -np.sort(-exact, axis=1)[:, :10]
        np.testing.assert_allclose(D, want, atol=1e-5, rtol=0)
        assert np.isin(I, cand.numpy()).all()

    def test_row_mask_inside_stage1(self, data):
        q, c = data
        j, t = _pair("binary", c, pool=30)
        mask = np.random.default_rng(2).random(N) < 0.3
        for m in (mask, np.pad(mask, (0, 24))):  # length size and capacity
            D, I = t.search(q, 5, row_mask=m)
            assert mask[I[I >= 0]].all()
        Dj, Ij = j.search(q, 5, pool=N, row_mask=mask)
        D, I = t.search(q, 5, pool=N, row_mask=mask)
        np.testing.assert_allclose(D, Dj, atol=1e-5, rtol=0)
        assert (I >= 0).all()

    def test_streaming_adds_and_reconstruct(self, data):
        q, c = data
        j, t = _pair("itq", c)
        t2 = TwoStageIndex(DIM, 1024, device="cpu", projector=fit_itq(_unit(c), N_BITS),
                           prefilter="itq", stage1="packed")
        for lo, hi in ((0, 333), (333, 700), (700, N)):
            t2.add(c[lo:hi])
        assert t2.ntotal == N
        np.testing.assert_array_equal(t2._codes_index._buf, t._codes_index._buf)
        D, I = t.search(q, 10, pool=200)
        D2, I2 = t2.search(q, 10, pool=200)
        np.testing.assert_array_equal(D, D2)
        ids = np.array([0, 17, 999])
        np.testing.assert_array_equal(t.reconstruct_batch(ids), j.reconstruct_batch(ids))
        np.testing.assert_array_equal(t.reconstruct(17), j.reconstruct(17))

    def test_k_beyond_rows_pads_missing(self, data):
        _, c = data
        t = TwoStageIndex(DIM, 64, device="cpu", n_bits=64, stage1="packed")
        t.add(c[:10])
        D, I = t.search(c[:3], 15)
        assert (I[:, 10:] == -1).all() and np.isneginf(D[:, 10:]).all()
        np.testing.assert_array_equal(I[:, 0], np.arange(3))

    def test_default_projection_is_seeded(self, data):
        _, c = data
        a, b, other = (TwoStageIndex(DIM, 8, device="cpu", n_bits=64, stage1="packed",
                                     seed=s) for s in (3, 3, 4))
        assert torch.equal(a._projection, b._projection)
        assert not torch.equal(a._projection, other._projection)

    @pytest.mark.parametrize("kw", [{"stage1": "matmul"},
                                    {"stage1": "packed", "prefilter": "int8x8"},
                                    {"stage1": "packed", "prefilter": "pca"}])
    def test_approximate_stage1_options_raise(self, kw):
        with pytest.raises(NotImplementedError, match="Queue 1 item 2"):
            TwoStageIndex(DIM, 8, device="cpu", **kw)

    @pytest.mark.parametrize("call", ["remove_ids", "merge_from", "snapshot",
                                      "save", "load"])
    def test_maintenance_and_snapshots_raise(self, call):
        t = TwoStageIndex(DIM, 8, device="cpu", stage1="packed")
        args = {"remove_ids": ([0],), "merge_from": (t,), "snapshot": (),
                "save": ("x",), "load": ("x",)}[call]
        with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
            getattr(t if call != "load" else TwoStageIndex, call)(*args)

    def test_bad_arguments_raise(self):
        with pytest.raises(ValueError, match="projector"):
            TwoStageIndex(DIM, 8, device="cpu", prefilter="itq", stage1="packed")
        with pytest.raises(ValueError, match="projection"):
            TwoStageIndex(DIM, 8, device="cpu", n_bits=32, stage1="packed",
                          projection=np.zeros((DIM, 16), np.float32))
        with pytest.raises(ValueError):
            simhash_projection(np.zeros(4))
