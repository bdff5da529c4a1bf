"""Parity of the port's selection layer (``ops/topk.py``: ``chunked_topk``,
``exact_topk``, ``rerank_topk``) and of ``DenseIndex(mode=)`` with the JAX
package, on the CPU, where every kernel wrapper runs its plain version.

``chunked_topk`` runs in every mode ('exact', 'approx', 'exact_cert',
'sort') for every metric on f32 and bf16 rows, and for 'ip'/'cos' on an
int8 corpus (per-row scales, bf16 queries) and on int8 codes on both sides,
with ``valid_count``, ``row_mask`` and a ragged last chunk. The port runs
the exact selection for 'approx' and 'exact_cert'; JAX's
``lax.approx_max_k`` returns the exact top-k on the CPU, so both sides are
exact here.

Tolerances: values against JAX's within two bf16 ulps of the per-query
score scale for bf16 scores, 1e-5 relative for f32 scores (sums in another
order; the int8 x int8 scale is applied in another order); value-recall
1.0 at the same tolerance against the f64 oracle over the rows that may
rank (the dequantized rows and query codes for int8)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sessionsimilaritysearch_tpu.index.dense import DenseIndex as JaxDenseIndex
from sessionsimilaritysearch_tpu.index.dense import _quantize_rows_int8
from sessionsimilaritysearch_tpu.ops import hamming as jham
from sessionsimilaritysearch_tpu.ops import projection as jproj
from sessionsimilaritysearch_tpu.ops import topk as jtopk
from sessionsimilaritysearch_tpu_torch.index.dense import DenseIndex
from sessionsimilaritysearch_tpu_torch.ops import hamming, mips, mips_int8, packed, projection
from sessionsimilaritysearch_tpu_torch.ops import topk

BF16_TOL = 2 * 2.0**-8
F32_TOL = 1e-5
N, D, Q, K, CHUNK, VALID = 3000, 64, 12, 10, 1024, 2700


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(autouse=True)
def _no_kernel_launch_on_cpu():
    counts = (mips.launch_count, mips_int8.launch_count, packed.launch_count)
    yield
    assert (mips.launch_count, mips_int8.launch_count, packed.launch_count) == counts


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    c = rng.standard_normal((N, D)).astype(np.float32)
    q = (c[:Q] + 0.5 * rng.standard_normal((Q, D))).astype(np.float32)
    mask = rng.random(N) < 0.8
    return q, c, mask


def _unit(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _inputs(kind, metric, q, c):
    """(jax kwargs, port kwargs, f64 queries, f64 rows, score tolerance) of
    one case: the same data as each package takes it."""
    if metric == "cos":
        q, c = _unit(q), _unit(c)
    if kind in ("f32", "bf16"):
        jdt, tdt = ((jnp.float32, torch.float32) if kind == "f32"
                    else (jnp.bfloat16, torch.bfloat16))
        jq, jc = jnp.asarray(q, jdt), jnp.asarray(c, jdt)
        tq, tc = _t(q).to(tdt), _t(c).to(tdt)
        j = dict(queries=jq, corpus=jc, score_dtype=jdt)
        t = dict(queries=tq, corpus=tc, score_dtype=tdt)
        return (j, t, tq.double().numpy(), tc.double().numpy(),
                F32_TOL if kind == "f32" else BF16_TOL)
    codes, scales = _quantize_rows_int8(jnp.asarray(c))
    codes, scales = np.asarray(codes), np.asarray(scales)
    rows = codes.astype(np.float64) * scales[:, None]
    if kind == "int8":  # bf16 queries against int8 codes, f32 scores
        qb = jnp.asarray(q, jnp.bfloat16)
        j = dict(queries=qb, corpus=jnp.asarray(codes), corpus_scales=jnp.asarray(scales))
        t = dict(queries=_t(q).bfloat16(), corpus=_t(codes), corpus_scales=_t(scales))
        return j, t, np.asarray(qb.astype(jnp.float32), np.float64), rows, F32_TOL
    q8, qs = _quantize_rows_int8(jnp.asarray(q))  # int8 x int8, bf16 scores
    q8, qs = np.asarray(q8), np.asarray(qs)
    j = dict(queries=jnp.asarray(q8), corpus=jnp.asarray(codes), score_dtype=jnp.bfloat16,
             corpus_scales=jnp.asarray(scales), query_scales=jnp.asarray(qs))
    t = dict(queries=_t(q8), corpus=_t(codes), score_dtype=torch.bfloat16,
             corpus_scales=_t(scales), query_scales=_t(qs))
    return j, t, q8.astype(np.float64) * qs[:, None], rows, BF16_TOL


def _exact_scores(q64, c64, metric):
    if metric == "l2":
        return (2 * q64 @ c64.T - (q64**2).sum(1, keepdims=True) - (c64**2).sum(1)[None])
    return q64 @ c64.T


def _check(v, i, vj, exact, live, tol):
    """Values against JAX's, and value-recall 1.0 against the f64 oracle."""
    scale = np.abs(np.where(live[None], exact, 0.0)).max(axis=1, keepdims=True)
    assert np.all(np.abs(v - vj) <= tol * scale), np.abs(v - vj).max()
    assert (i >= 0).all() and live[i].all()
    got = np.take_along_axis(exact, i, axis=1)
    assert np.all(np.abs(got - v) <= tol * scale)
    oracle = -np.sort(-np.where(live[None], exact, -np.inf), axis=1)[:, : v.shape[1]]
    assert topk.value_recall_from_scores(got, oracle, tol * scale[:, 0]) == 1.0


CASES = [(kind, metric) for kind in ("f32", "bf16", "int8", "int8x8")
         for metric in ("ip", "cos", "l2") if not (kind.startswith("int8") and metric == "l2")]


@pytest.mark.parametrize("mode", topk.MODES)
@pytest.mark.parametrize("kind,metric", CASES)
def test_chunked_topk_matches_jax(data, kind, metric, mode):
    q, c, mask = data
    j, t, q64, c64, tol = _inputs(kind, metric, q, c)
    vj, _ = jtopk.chunked_topk(
        k=K, chunk_size=CHUNK, metric="ip" if metric == "cos" else metric, mode=mode,
        valid_count=jnp.asarray(VALID, jnp.int32), row_mask=jnp.asarray(mask),
        recall_target=0.9, **j)
    v, i = topk.chunked_topk(
        k=K, chunk_size=CHUNK, metric=metric, mode=mode, valid_count=VALID,
        row_mask=_t(mask), recall_target=0.9, **t)
    assert v.dtype == torch.float32 and i.dtype == torch.int64
    live = mask & (np.arange(N) < VALID)
    _check(v.numpy(), i.numpy(), np.asarray(vj, np.float64),
           _exact_scores(q64, c64, metric), live, tol)


@pytest.mark.parametrize("mode", ["exact", "sort"])
def test_chunked_topk_missing_slots_and_refusals(data, mode):
    q, c, _ = data
    mask = np.zeros(N, bool)
    mask[[5, 900, 2999]] = True
    v, i = topk.chunked_topk(_t(q), _t(c), 6, chunk_size=CHUNK, mode=mode, row_mask=_t(mask))
    assert (i[:, 3:] == -1).all() and torch.isneginf(v[:, 3:]).all()
    assert set(i[0, :3].tolist()) == {5, 900, 2999}
    v, i = topk.chunked_topk(_t(q), _t(c), 4, mode=mode, valid_count=0)
    assert (i == -1).all() and torch.isneginf(v).all()
    with pytest.raises(ValueError, match="selection mode"):
        topk.chunked_topk(_t(q), _t(c), 4, mode="fast")
    with pytest.raises(ValueError, match="'ip'/'cos' only"):
        topk.chunked_topk(_t(q).bfloat16(), _t(c).to(torch.int8), 4, metric="l2",
                          corpus_scales=torch.ones(N))
    with pytest.raises(ValueError, match="requires corpus_scales"):
        topk.chunked_topk(_t(q).to(torch.int8), _t(c).to(torch.int8), 4,
                          query_scales=torch.ones(Q))
    with pytest.raises(ValueError, match="valid_count"):
        topk.chunked_topk(_t(q), _t(c), 4, valid_count=N + 1)


@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_exact_topk_matches_jax(data, metric):
    q, c, _ = data
    vj, ij = jtopk.exact_topk(jnp.asarray(q), jnp.asarray(c[:700]), K, metric=metric)
    v, i = topk.exact_topk(_t(q), _t(c[:700]), K, metric=metric)
    np.testing.assert_allclose(v.numpy(), np.asarray(vj), rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ij))


@pytest.mark.parametrize("case", ["scales", "l2", "bf16_scores"])
def test_rerank_topk_options_match_jax(data, case):
    q, c, _ = data
    rng = np.random.default_rng(3)
    cand = rng.integers(0, N, (Q, 48)).astype(np.int32)
    cand[:, -4:] = -1
    jkw, tkw = {}, {}
    corpus_j, corpus_t = jnp.asarray(c), _t(c)
    if case == "scales":
        codes, scales = _quantize_rows_int8(jnp.asarray(c))
        corpus_j, corpus_t = codes, _t(np.asarray(codes))
        jkw["corpus_scales"], tkw["corpus_scales"] = scales, _t(np.asarray(scales))
    elif case == "l2":
        jkw["metric"] = tkw["metric"] = "l2"
    else:
        jkw["score_dtype"], tkw["score_dtype"] = jnp.bfloat16, torch.bfloat16
    vj, ij = jtopk.rerank_topk(jnp.asarray(q), corpus_j, jnp.asarray(cand), K, **jkw)
    v, i = topk.rerank_topk(_t(q), corpus_t, _t(cand), K, **tkw)
    vj, ij = np.asarray(vj), np.asarray(ij)
    scale = np.abs(vj).max(axis=1, keepdims=True)
    tol = BF16_TOL if case == "bf16_scores" else F32_TOL
    assert np.all(np.abs(v.numpy() - vj) <= tol * scale)
    assert np.isin(i.numpy(), cand).all() and (i.numpy() >= 0).all()
    if case != "bf16_scores":  # f32 scores: no ties, the same ids
        np.testing.assert_array_equal(i.numpy(), ij)


@pytest.mark.parametrize("mode", topk.MODES)
@pytest.mark.parametrize("quantize", [None, "int8x8"])
def test_dense_index_mode_matches_jax(data, mode, quantize, tmp_path):
    q, c, mask = data
    j = JaxDenseIndex(D, N, mode=mode, chunk_size=CHUNK, quantize=quantize)
    t = DenseIndex(D, N, device="cpu", mode=mode, chunk_size=CHUNK, quantize=quantize)
    j.add(c)
    t.add(c)
    Dj, _ = j.search(q, K, row_mask=mask)
    Dt, It = t.search(q, K, row_mask=mask)
    np.testing.assert_allclose(Dt, Dj, rtol=F32_TOL, atol=F32_TOL)
    assert mask[It].all()
    # the mode travels with the snapshot, both ways
    j.save(str(tmp_path / "j"))
    t.save(str(tmp_path / "t"))
    assert DenseIndex.load(str(tmp_path / "j"), device="cpu").mode == mode
    assert JaxDenseIndex.load(str(tmp_path / "t")).mode == mode
    if mode == "approx":  # range search refuses approx, as in JAX
        with pytest.raises(ValueError, match="exact selection mode"):
            t.range_search(q, 0.5)
    else:
        lims, _, _ = t.range_search(q[:2], -2.0, k0=8)  # every row: cosines >= -1
        assert lims[-1] == 2 * N


def test_unpack_bits_t_matches_jax():
    rng = np.random.default_rng(4)
    signs = np.where(rng.random((4096, 160)) < 0.5, 1.0, -1.0).astype(np.float32)
    words = jham.pack_bits_t_np(signs)
    want = np.asarray(jham.unpack_bits_t(jnp.asarray(words)).astype(jnp.float32))
    got = hamming.unpack_bits_t(_t(words))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    np.testing.assert_array_equal(want, signs)


def test_pca_projector_save_load_across_packages(data, tmp_path):
    _, c, _ = data
    pj = jproj.fit_pca(c, 16)
    pt = projection.fit_pca(c, 16)
    pj.save(str(tmp_path / "j"))
    pt.save(str(tmp_path / "t"))
    for back, src in ((projection.PCAProjector.load(str(tmp_path / "j")), pj),
                      (jproj.PCAProjector.load(str(tmp_path / "t.npz")), pt)):
        np.testing.assert_array_equal(back.mean, src.mean)
        np.testing.assert_array_equal(back.components, src.components)
        assert back.explained == src.explained
    np.testing.assert_allclose(pt.components, pj.components, atol=1e-5)
