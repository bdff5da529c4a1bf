"""Parity of the port's DenseIndex maintenance and persistence verbs
(sessionsimilaritysearch_tpu_torch/index/dense.py) with the JAX DenseIndex
on the same seeded rows: compaction_plan and remove_ids (int8x8 scales
included), range_search (cos, ip, l2), merge_from, centered cosine,
metric='l2' (f32/bf16 storage x score dtype), search(out='device'),
build_index, and npz snapshots in both directions (JAX saves and the port
loads, the port saves and JAX loads).

Tolerances: f32 scores 1e-5 of the per-query scale (sums in another
order); bf16 storage or scores two bf16 ulps of that scale, as
tests/test_torch_index.py has. l2 distances are taken relative to
|q|^2 + max|c|^2: 1e-5 in f32 and four bf16 ulps in bf16, because JAX
rounds q.c, |q|^2 and |c|^2 to bf16 separately (ops/topk.py:294-296)
where the port's K1 rounds (2q).c - |c|^2 once. Top-k ids are compared with
value_recall_at_k at the same tolerance, since ties may resolve to
different rows. Snapshots must hold the stored rows bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sessionsimilaritysearch_tpu.index.dense import DenseIndex as JaxDenseIndex
from sessionsimilaritysearch_tpu.index.dense import build_index as jax_build_index
from sessionsimilaritysearch_tpu.index.dense import compaction_plan as jax_compaction_plan
from sessionsimilaritysearch_tpu_torch.index.dense import DenseIndex, build_index, compaction_plan
from sessionsimilaritysearch_tpu_torch.ops import mips
from sessionsimilaritysearch_tpu_torch.ops.topk import value_recall_at_k

DIM = 16
F32_TOL = 1e-5
BF16_TOL = 2 * 2.0**-8
L2_BF16_TOL = 4 * 2.0**-8


def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _rows(seed, n, d=DIM):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def apply_plan(rows, size, ids):
    """Host-side oracle of the compaction: survivors in planned order."""
    src, dst, new_size = compaction_plan(size, ids)
    out = rows[:size].copy()
    out[dst] = out[src]
    return out[:new_size]


def _pair(rows, metric="cos", capacity=None, dtype="float32", score_dtype="float32",
          **kw):
    """The same rows in a JAX and a port index of the same configuration."""
    cap = capacity or len(rows)
    j = JaxDenseIndex(DIM, cap, metric=metric, dtype=getattr(jnp, dtype),
                      score_dtype=getattr(jnp, score_dtype), **kw)
    t = DenseIndex(DIM, cap, device="cpu", metric=metric, dtype=getattr(torch, dtype),
                   score_dtype=getattr(torch, score_dtype), **kw)
    j.add(rows)
    t.add(rows)
    return j, t


def _same_results(j_res, t_res, atol):
    (Dj, Ij), (Dt, It) = j_res, t_res
    assert Dt.dtype == np.float32 and It.dtype == np.int64
    missing = It < 0
    np.testing.assert_array_equal(missing, Ij < 0)
    np.testing.assert_array_equal(Dt[missing], Dj[missing])  # the same +-inf
    np.testing.assert_allclose(Dt[~missing], Dj[~missing], atol=atol, rtol=0)


def _recall(t, q, ids, tol, metric="ip"):
    """Value-recall of ``ids`` against the rows the port stores."""
    stored = t.reconstruct_batch(np.arange(t.ntotal))
    return value_recall_at_k(ids, q, stored, ids.shape[1], metric=metric, rel_tol=tol)


class TestCompactionPlan:
    def test_moves_place_survivors(self):
        r = np.random.default_rng(0)
        rows = r.standard_normal((100, 4))
        ids = r.choice(100, size=37, replace=False)
        got = apply_plan(rows, 100, ids)
        assert got.shape[0] == 63
        keep = np.setdiff1d(np.arange(100), ids)
        assert sorted(map(tuple, got.tolist())) == sorted(map(tuple, rows[keep].tolist()))
        # rows below new_size that were not removed never move
        for u in keep[keep < 63]:
            np.testing.assert_array_equal(got[u], rows[u])

    @pytest.mark.parametrize("size,ids", [
        (10, [7, 8, 9]),        # tail removal needs no moves
        (10, [3, 3, 3]),        # duplicates collapse
        (10, []),               # no-op
        (5, [0, 1, 2, 3, 4]),   # remove all
        (50, [0, 1, 2, 40, 49]),
    ])
    def test_edge_cases_match_jax(self, size, ids):
        got, want = compaction_plan(size, ids), jax_compaction_plan(size, ids)
        assert got[2] == want[2]
        for a, b in zip(got[:2], want[:2]):
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)

    @pytest.mark.parametrize("bad", [[10], [-1]])
    def test_out_of_range_raises(self, bad):
        with pytest.raises(ValueError):
            compaction_plan(10, bad)


class TestDenseRemove:
    @pytest.mark.parametrize("metric", ["cos", "ip", "l2"])
    def test_search_matches_rebuilt_and_jax(self, metric):
        rows = _rows(1, 96)
        j, t = _pair(rows, metric, capacity=128)
        ids = np.random.default_rng(2).choice(96, size=30, replace=False)
        assert t.remove_ids(ids) == j.remove_ids(ids) == 30
        assert t.ntotal == 66
        stored = rows if metric != "cos" else t.reconstruct_batch(np.arange(66))
        fresh = DenseIndex(DIM, 66, device="cpu", metric=metric)
        fresh.add(apply_plan(rows, 96, ids) if metric != "cos" else stored)
        q = _rows(3, 7)
        Dt, It = t.search(q, 5)
        Df, If = fresh.search(q, 5)
        np.testing.assert_array_equal(It, If)
        np.testing.assert_allclose(Dt, Df, rtol=1e-6)
        scale = 1.0 if metric != "l2" else np.abs(Dt).max()
        _same_results(j.search(q, 5), (Dt, It), F32_TOL * scale)
        # the compacted rows are the JAX index's, slot for slot (under 'cos'
        # the two normalizations may differ in the last bit)
        np.testing.assert_allclose(t.reconstruct_batch(np.arange(66)),
                                   j.reconstruct_batch(np.arange(66)), atol=1e-6, rtol=0)

    def test_removed_rows_never_returned(self):
        rows = _rows(4, 96)
        _, t = _pair(rows, capacity=128)
        _, I = t.search(rows[3:4], 1)
        hit = int(I[0, 0])
        gone = t.reconstruct(hit)
        t.remove_ids([hit])
        _, I2 = t.search(rows[3:4], t.ntotal)
        assert (I2 >= 0).all()
        got = t.reconstruct_batch(I2[0])
        assert not np.any(np.all(got == gone, axis=1))

    def test_capacity_reusable_after_remove(self):
        rows = _rows(5, 10, 8)
        t = DenseIndex(8, 10, device="cpu", metric="ip")
        t.add(rows)
        with pytest.raises(ValueError):
            t.add(rows[:1])
        t.remove_ids([0, 5, 9])
        t.add(_rows(6, 3, 8))
        assert t.ntotal == 10
        np.testing.assert_array_equal(t.reconstruct_batch([7, 8, 9]), _rows(6, 3, 8))

    def test_int8x8_scales_move_with_rows(self):
        rows = _rows(7, 96)
        j, t = _pair(rows, capacity=128, quantize="int8x8")
        ids = [0, 1, 50, 95]
        j.remove_ids(ids)
        t.remove_ids(ids)
        np.testing.assert_array_equal(t._buf[:92].numpy(), np.asarray(j._buf[:92]))
        # the scales carry the two normalizations' last-bit differences
        np.testing.assert_allclose(t._scales[:92].numpy(), np.asarray(j._scales[:92]),
                                   rtol=1e-6)
        q = _rows(8, 5)
        _same_results(j.search(q, 5), t.search(q, 5), F32_TOL)


class TestDenseRangeSearch:
    @pytest.mark.parametrize("metric,radius", [("cos", 0.25), ("ip", 4.0), ("l2", 20.0)])
    def test_matches_bruteforce_and_jax(self, metric, radius):
        corpus = _rows(10, 300)
        queries = _rows(11, 7)
        if metric == "l2":
            queries = corpus[:7] + 0.5 * queries
        j, t = _pair(corpus, metric)
        lims, d, i = t.range_search(queries, radius, k0=8)
        lj, dj, ij = j.range_search(queries, radius, k0=8)
        np.testing.assert_array_equal(lims, lj)
        if metric == "l2":
            score = ((queries[:, None, :] - corpus[None]) ** 2).sum(-1)
            inside = score <= radius
        else:
            qc = _unit(queries) @ _unit(corpus).T if metric == "cos" else queries @ corpus.T
            score, inside = qc, qc >= radius
        for q in range(7):
            dq, iq = d[lims[q]: lims[q + 1]], i[lims[q]: lims[q + 1]]
            assert set(iq.tolist()) == set(np.flatnonzero(inside[q]).tolist())
            assert set(iq.tolist()) == set(ij[lj[q]: lj[q + 1]].tolist())
            scale = np.abs(score[q]).max()
            np.testing.assert_allclose(dq, score[q, iq], atol=F32_TOL * scale, rtol=0)
            step = np.diff(dq)  # best-first
            assert (step >= -F32_TOL * scale).all() if metric == "l2" else (
                step <= F32_TOL * scale).all()

    def test_adaptive_doubling_reaches_full_corpus(self):
        corpus = _unit(_rows(12, 64, 8))
        t = build_index(corpus, device="cpu")
        lims, d, i = t.range_search(corpus[:3], -2.0, k0=8)
        assert np.all(np.diff(lims) == 64)
        assert sorted(i[: lims[1]].tolist()) == list(range(64))

    def test_empty_results_and_empty_index(self):
        corpus = _unit(_rows(13, 50, 8))
        t = build_index(corpus, device="cpu")
        lims, d, i = t.range_search(corpus[:2], 2.0)
        assert np.all(lims == 0) and d.size == 0 and i.size == 0
        lims, d, i = DenseIndex(8, 16, device="cpu").range_search(corpus[:2], -2.0)
        assert np.all(lims == 0) and d.size == 0 and lims.dtype == np.int64

    def test_row_mask(self):
        corpus = _rows(14, 200)
        t = build_index(corpus, device="cpu")
        mask = np.random.default_rng(15).random(200) < 0.5
        lims, d, i = t.range_search(corpus[:4], 0.1, k0=8, row_mask=mask)
        assert mask[i].all() and lims[-1] > 0
        full = _unit(corpus[:4]) @ _unit(corpus).T
        for q in range(4):
            want = np.flatnonzero((full[q] >= 0.1) & mask)
            assert set(i[lims[q]: lims[q + 1]].tolist()) == set(want.tolist())


class TestDenseMergeFrom:
    @pytest.mark.parametrize("metric", ["cos", "l2"])
    def test_matches_single_build(self, metric):
        a, b = _rows(20, 40), _rows(21, 25)
        merged = DenseIndex(DIM, 80, device="cpu", metric=metric)
        merged.add(a)
        other = build_index(b, metric=metric, device="cpu")
        assert merged.merge_from(other) == 25
        assert merged.ntotal == 65 and other.ntotal == 25  # other left intact
        ref = build_index(np.concatenate([a, b]), metric=metric, device="cpu")
        q = _rows(22, 6)
        dm, im = merged.search(q, 10)
        dr, ir = ref.search(q, 10)
        np.testing.assert_array_equal(im, ir)
        np.testing.assert_array_equal(dm, dr)
        # ids shifted by the pre-merge ntotal (FAISS convention)
        np.testing.assert_array_equal(merged.reconstruct(40), other.reconstruct(0))
        jm = JaxDenseIndex(DIM, 80, metric=metric)
        jm.add(a)
        jm.merge_from(jax_build_index(b, metric=metric))
        scale = 1.0 if metric == "cos" else np.abs(dm).max()
        _same_results(jm.search(q, 10), (dm, im), F32_TOL * scale)

    @pytest.mark.parametrize("quantize", ["int8", "int8x8"])
    def test_quantized_merge_carries_scales(self, quantize):
        a, b = _rows(23, 30), _rows(24, 20)
        merged = DenseIndex(DIM, 64, device="cpu", quantize=quantize)
        merged.add(a)
        merged.merge_from(build_index(b, quantize=quantize, device="cpu"))
        ref = DenseIndex(DIM, 64, device="cpu", quantize=quantize)
        ref.add(a)
        ref.add(b)
        assert torch.equal(merged._buf, ref._buf) and torch.equal(merged._scales, ref._scales)
        q = _rows(25, 4)
        dm, im = merged.search(q, 8)
        dr, ir = ref.search(q, 8)
        np.testing.assert_array_equal(im, ir)

    def test_mismatch_and_capacity_raise(self):
        a = build_index(_rows(26, 4, 8), device="cpu")
        with pytest.raises(ValueError, match="metric"):
            a.merge_from(build_index(_rows(27, 4, 8), metric="ip", device="cpu"))
        with pytest.raises(ValueError, match="full"):
            a.merge_from(build_index(_rows(28, 4, 8), device="cpu"))  # a is at capacity 4
        cen = build_index(_rows(29, 4, 8), center="auto", device="cpu")
        big = DenseIndex(8, 32, device="cpu")
        big.add(_rows(30, 2, 8))
        with pytest.raises(ValueError, match="center"):
            big.merge_from(cen)
        with pytest.raises(TypeError):
            big.merge_from(object())

    def test_auto_center_adopts_fitted_mean(self):
        other = build_index(_rows(31, 20, 8), center="auto", device="cpu")
        fresh = DenseIndex(8, 32, device="cpu", center="auto")
        fresh.merge_from(other)
        q = _rows(32, 3, 8)
        do, io = other.search(q, 5)
        df, if_ = fresh.search(q, 5)
        np.testing.assert_array_equal(io, if_)
        np.testing.assert_array_equal(do, df)


def _cone(seed, n=400, d=48, n_types=4, proto_s=0.05, noise_s=0.01):
    """Collapsed-cone corpus: a dominant shared direction, a small cluster
    signal and smaller noise (tests/test_topk_index.py TestCenteredCosine)."""
    r = np.random.default_rng(seed)
    common = np.ones((1, d), np.float32) / np.sqrt(d)
    labels = r.integers(0, n_types, size=n)
    proto = r.standard_normal((n_types, d)).astype(np.float32) * proto_s
    noise = r.standard_normal((n, d)).astype(np.float32) * noise_s
    return (common + proto[labels] + noise).astype(np.float32)


def _centered_np(x, mean=None):
    xn = _unit(x)
    mean = xn.mean(axis=0) if mean is None else mean
    return _unit(xn - mean), mean


class TestCenteredCosine:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_auto_center_matches_jax_and_oracle(self, dtype):
        x = _cone(40)
        q = x[:9]
        j = JaxDenseIndex(48, 400, dtype=getattr(jnp, dtype), center="auto")
        t = DenseIndex(48, 400, device="cpu", dtype=getattr(torch, dtype), center="auto")
        j.add(x)
        t.add(x)
        tol = F32_TOL if dtype == "float32" else BF16_TOL
        assert t.center_mode == "auto"
        np.testing.assert_allclose(t._center.float().numpy(),
                                   np.asarray(j._center, np.float32), atol=tol, rtol=0)
        Dt, It = t.search(q, 10)
        _same_results(j.search(q, 10), (Dt, It), tol)
        # the rows as stored are the centered rows (reconstruct_batch)
        np.testing.assert_allclose(t.reconstruct_batch(np.arange(400)),
                                   j.reconstruct_batch(np.arange(400)), atol=tol, rtol=0)
        cn, mean = _centered_np(x)
        qn, _ = _centered_np(q, mean)
        assert value_recall_at_k(It, qn, cn, 10, rel_tol=tol) == 1.0

    def test_fixed_center_equals_auto(self):
        x = _cone(41)
        a = build_index(x, center="auto", device="cpu")
        b = build_index(x, center=_unit(x).mean(axis=0), device="cpu")
        assert b.center_mode == "fixed"
        Da, Ia = a.search(x[:7], 5)
        Db, Ib = b.search(x[:7], 5)
        np.testing.assert_array_equal(Ia, Ib)
        np.testing.assert_allclose(Da, Db, rtol=1e-6)

    def test_quantize_composes(self):
        x = _cone(42)
        q = x[:9]
        t = build_index(x, center="auto", quantize="int8x8", device="cpu")
        j = jax_build_index(x, center="auto", quantize="int8x8")
        np.testing.assert_array_equal(t._buf.numpy(), np.asarray(j._buf))
        _, It = t.search(q, 10)
        cn, mean = _centered_np(x)
        qn, _ = _centered_np(q, mean)
        assert value_recall_at_k(It, qn, cn, 10, rel_tol=4 / 127) == 1.0

    def test_mean_frozen_after_first_add(self):
        x = _cone(43)
        t = DenseIndex(48, 800, device="cpu", center="auto")
        t.add(x)
        before = t._center.clone()
        t.add(_rows(44, 8, 48))
        assert torch.equal(t._center, before)

    def test_center_needs_cos_and_l2_refuses_quantize(self):
        with pytest.raises(ValueError, match="center"):
            DenseIndex(8, 8, device="cpu", metric="ip", center="auto")
        with pytest.raises(ValueError, match="center"):
            DenseIndex(8, 8, device="cpu", center="median")
        with pytest.raises(ValueError, match="int8"):
            DenseIndex(8, 8, device="cpu", metric="l2", quantize="int8x8")


L2_COMBOS = [(d, s) for d in ("float32", "bfloat16") for s in ("float32", "bfloat16")]


@pytest.mark.parametrize("dtype,score_dtype", L2_COMBOS)
def test_l2_search_ascending_matches_jax(dtype, score_dtype):
    # streamed adds, a multi-chunk scan, a row mask and k past the filled
    # rows, through K1's penalty -|c|^2 (its plain version on the CPU)
    rows = _rows(50, 450)
    queries = _rows(51, 20)
    kw = dict(metric="l2", chunk_size=256)
    j = JaxDenseIndex(DIM, 600, dtype=getattr(jnp, dtype),
                      score_dtype=getattr(jnp, score_dtype), **kw)
    t = DenseIndex(DIM, 600, device="cpu", dtype=getattr(torch, dtype),
                   score_dtype=getattr(torch, score_dtype), **kw)
    for s in (0, 200, 350):
        j.add(rows[s: s + (200 if s == 0 else 150 if s == 200 else 100)])
        t.add(rows[s: s + (200 if s == 0 else 150 if s == 200 else 100)])
    f32 = dtype == score_dtype == "float32"
    scale = (queries**2).sum(1).max() + (rows**2).sum(1).max()
    tol = F32_TOL if f32 else L2_BF16_TOL
    Dt, It = t.search(queries, 10)
    assert (np.diff(Dt, axis=1) >= 0).all()
    _same_results(j.search(queries, 10), (Dt, It), tol * scale)
    q = queries.astype(np.float32 if dtype == "float32" else jnp.bfloat16).astype(np.float32)
    assert _recall(t, q, It, tol, metric="l2") == 1.0
    mask = np.random.default_rng(52).random(450) < 0.4
    Dm, Im = t.search(queries, 10, row_mask=mask)
    assert mask[Im].all()
    _same_results(j.search(queries, 10, row_mask=mask), (Dm, Im), tol * scale)
    Dk, Ik = t.search(queries, 500)  # 50 missing slots per query: (+inf, -1)
    assert (Ik[:, 450:] == -1).all() and np.isposinf(Dk[:, 450:]).all()
    _same_results(j.search(queries, 500), (Dk, Ik), tol * scale)


def test_search_out_device():
    rows = _rows(53, 40)
    t = build_index(rows, device="cpu")
    D, I = t.search(rows[:3], 4, out="device")
    assert isinstance(D, torch.Tensor) and isinstance(I, torch.Tensor)
    assert D.device == I.device == t.device and I.dtype == torch.int64
    Dn, In = t.search(rows[:3], 4)
    np.testing.assert_array_equal(D.numpy(), Dn)
    np.testing.assert_array_equal(I.numpy(), In)
    with pytest.raises(ValueError, match="out"):
        t.search(rows[:3], 4, out="host")
    assert mips.launch_count == 0  # CPU tensors take the plain version


SNAP_CASES = {
    "f32": {},
    "bf16": {"dtype": "bfloat16"},
    "int8x8": {"quantize": "int8x8"},
    "centered": {"center": "auto"},
    "removed": {"remove": [0, 7, 33, 59]},
}


def _snap_pair(case):
    kw = dict(SNAP_CASES[case])
    remove = kw.pop("remove", None)
    rows = _rows(60, 60)
    j, t = _pair(rows, capacity=80, score_dtype="float32", chunk_size=32, **kw)
    if remove:
        j.remove_ids(remove)
        t.remove_ids(remove)
    return j, t


def _assert_same_index(got, want, q):
    """``got`` loaded from ``want``'s snapshot: the same configuration, the
    same stored rows bit for bit, the same top-k."""
    assert got.ntotal == want.ntotal and got.chunk_size == want.chunk_size == 32
    assert got.metric == want.metric and got.quantize == want.quantize
    assert got.center_mode == want.center_mode
    np.testing.assert_array_equal(got.reconstruct_batch(np.arange(got.ntotal)),
                                  want.reconstruct_batch(np.arange(want.ntotal)))
    tol = BF16_TOL if str(got.dtype).endswith("bfloat16") else F32_TOL
    Dg, Ig = got.search(q, 5)
    Dw, Iw = want.search(q, 5)
    np.testing.assert_allclose(Dg, Dw, atol=tol, rtol=0)
    return Ig, Iw


@pytest.mark.parametrize("case", list(SNAP_CASES))
def test_jax_snapshot_loads_in_port(case, tmp_path):
    j, _ = _snap_pair(case)
    path = str(tmp_path / "jax_snap")
    j.save(path)
    t = DenseIndex.load(path, device="cpu")
    assert t.dtype == {"bf16": torch.bfloat16, "int8x8": torch.int8}.get(case, torch.float32)
    q = _rows(61, 6)
    It, _ = _assert_same_index(t, j, q)
    tol = BF16_TOL if case == "bf16" else F32_TOL
    if case != "int8x8":  # int8x8 queries are codes: covered by the rows check
        assert _recall(t, _query_as_scored(t, q), It, tol) == 1.0


def _query_as_scored(t, q):
    """The float queries as the port's index scores them: cast to the
    storage dtype, normalized and centered."""
    x = torch.from_numpy(q).to(t.dtype if not t.quantize else torch.bfloat16).float()
    x = x / x.norm(dim=1, keepdim=True)
    if t._center is not None:
        x = x - t._center
        x = x / x.norm(dim=1, keepdim=True)
    return x.numpy()


@pytest.mark.parametrize("case", list(SNAP_CASES))
def test_port_snapshot_loads_in_jax(case, tmp_path):
    _, t = _snap_pair(case)
    path = str(tmp_path / "port_snap")
    t.save(path)
    j = JaxDenseIndex.load(path)
    assert np.dtype(j.dtype).name == {"bf16": "bfloat16", "int8x8": "int8"}.get(case, "float32")
    q = _rows(62, 6)
    _, It = _assert_same_index(j, t, q)
    Ij = j.search(q, 5)[1]
    stored = t.reconstruct_batch(np.arange(t.ntotal))
    tol = BF16_TOL if case == "bf16" else F32_TOL
    qs = _query_as_scored(t, q)
    if case != "int8x8":  # int8x8 queries are codes: covered by the rows check
        assert value_recall_at_k(Ij, qs, stored, 5, rel_tol=tol) == 1.0
        assert value_recall_at_k(It, qs, stored, 5, rel_tol=tol) == 1.0


def test_snapshot_is_a_copy(tmp_path):
    # add and remove_ids write the live buffer in place: a snapshot taken
    # before them must not see them
    rows = _rows(63, 40)
    t = DenseIndex(DIM, 64, device="cpu")
    t.add(rows)
    before = t.reconstruct_batch(np.arange(40))
    snap = t.snapshot()
    t.remove_ids([0, 1, 2])
    t.add(_rows(64, 10))
    DenseIndex.write_snapshot(snap, str(tmp_path / "s"))
    back = DenseIndex.load(str(tmp_path / "s"), device="cpu")
    assert back.ntotal == 40
    np.testing.assert_array_equal(back.reconstruct_batch(np.arange(40)), before)


def test_load_refuses_what_the_port_lacks(tmp_path):
    rows = _rows(65, 32, 8)
    j = JaxDenseIndex(8, 32, mode="approx", score_dtype=jnp.bfloat16, chunk_size=16)
    j.add(rows)
    path = str(tmp_path / "approx")
    j.save(path)
    # the selection mode travels with the snapshot; one the JAX package does
    # not have is refused
    assert DenseIndex.load(path, device="cpu").mode == "approx"
    with pytest.raises(ValueError, match="selection mode"):
        DenseIndex.load(path, device="cpu", mode="fast")
    t = DenseIndex.load(path, device="cpu", mode="exact")  # an explicit override wins
    assert t.mode == "exact"
    assert t.score_dtype == torch.bfloat16 and t.chunk_size == 16 and t.ntotal == 32
    q8 = build_index(rows, quantize="int8", device="cpu")
    q8.save(str(tmp_path / "q8"))
    assert DenseIndex.load(str(tmp_path / "q8"), device="cpu", quantize="int8").quantize == "int8"
    with pytest.raises(ValueError, match="quantize"):
        DenseIndex.load(str(tmp_path / "q8"), device="cpu", quantize=None)


def test_l2_snapshot_rebuilds_norms(tmp_path):
    rows = _rows(66, 50)
    t = build_index(rows, metric="l2", device="cpu")
    t.remove_ids([3, 4])
    t.save(str(tmp_path / "l2"))
    back = DenseIndex.load(str(tmp_path / "l2"), device="cpu")
    assert torch.equal(back._sqnorm[:48], t._sqnorm[:48])
    q = _rows(67, 5)
    for a, b in zip(back.search(q, 6), t.search(q, 6)):
        np.testing.assert_array_equal(a, b)
