"""Parity of the port's ``TwoStageIndex`` with the JAX index for every
prefilter x stage1 the JAX package allows ('binary' and 'itq' sign codes by
sign matmul or packed, 'int8x8', 'pca'): search, ``remove_ids``,
``merge_from``, snapshots across packages, ``build_twostage_index``, and
the two-stage engine's removal, expiry and save / restore. On the CPU every
kernel wrapper runs its plain version; the JAX packed stage 1 runs its XLA
twin (``use_pallas=False``).

Both packages code the rows alike: SimHash with the JAX projection carried
across (``weights.simhash_projection``), ITQ and PCA with one projector
fitted by the JAX package, int8 by the bit-equal row quantizer. The index
tests serve unit rows under ``metric='ip'``, so both packages store the
same bf16 rows (a cosine index normalizes again, and one f32 ulp there may
round to another bf16); PCA codes, a normalized f32 projection rounded to
bf16, are compared within one bf16 ulp. JAX selects
the matmul stage 1 with ``lax.approx_max_k``, which is exact on the CPU;
the port selects exactly. Stage-1 pools are compared by value recall over
the stage-1 scores (exact for sign codes, two bf16 ulps of the per-query
scale for the bf16-scored int8x8 and pca scans, whose near-ties at the
pool's edge may swap); final top-k values within 1e-5 (f32 re-rank sums in
another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sessionsimilaritysearch_tpu.engine import SessionSearchEngine as JaxEngine
from sessionsimilaritysearch_tpu.index import twostage as jts
from sessionsimilaritysearch_tpu.index.dense import DenseIndex as JaxDenseIndex
from sessionsimilaritysearch_tpu.ops.projection import fit_itq, fit_pca
from sessionsimilaritysearch_tpu_torch.engine import SessionSearchEngine
from sessionsimilaritysearch_tpu_torch.index.binary import BinaryIndex
from sessionsimilaritysearch_tpu_torch.index.dense import DenseIndex
from sessionsimilaritysearch_tpu_torch.index.twostage import (
    TwoStageIndex,
    build_twostage_index,
)
from sessionsimilaritysearch_tpu_torch.ops import mips, mips_int8, packed
from sessionsimilaritysearch_tpu_torch.ops.topk import value_recall_from_scores
from sessionsimilaritysearch_tpu_torch.weights import simhash_projection
from test_torch_slice import _port_side, parts  # noqa: F401  (fixture)

BF16_TOL = 2 * 2.0**-8
TOL = 1e-5
DIM, N, N_BITS, CAP = 64, 1000, 64, 1024
COMBOS = [("binary", "matmul"), ("binary", "packed"), ("itq", "matmul"),
          ("itq", "packed"), ("int8x8", "matmul"), ("pca", "matmul")]


def _t(x):
    return torch.from_numpy(np.array(x))


def _unit(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(autouse=True)
def _no_kernel_launch_on_cpu():
    counts = (mips.launch_count, mips_int8.launch_count, packed.launch_count)
    yield
    assert (mips.launch_count, mips_int8.launch_count, packed.launch_count) == counts


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    c = _unit(rng.standard_normal((N, DIM)))
    q = _unit(c[:16] + 0.3 * rng.standard_normal((16, DIM)))
    return q, c


@pytest.fixture(scope="module")
def projectors(data):
    _, c = data
    return {"itq": fit_itq(c, N_BITS), "pca": fit_pca(c, 16)}


def _kw(prefilter, stage1, projectors, seed=0):
    """Constructor arguments of the JAX index and of the port's, coding the
    rows alike."""
    kw = dict(prefilter=prefilter, stage1=stage1, pool=64, n_bits=N_BITS, seed=seed,
              metric="ip")
    tkw = {}
    if prefilter in projectors:
        kw["projector"] = projectors[prefilter]
    if prefilter == "binary":
        R = jax.random.normal(jax.random.PRNGKey(seed), (DIM, N_BITS), jnp.float32)
        tkw["projection"] = simhash_projection(np.asarray(R))
    jkw = dict(kw, use_pallas=False) if stage1 == "packed" else kw
    return jkw, dict(kw, **tkw)


def _pair(prefilter, stage1, projectors, rows=None, capacity=CAP):
    jkw, tkw = _kw(prefilter, stage1, projectors)
    j = jts.TwoStageIndex(DIM, capacity, **jkw)
    t = TwoStageIndex(DIM, capacity, device="cpu", **tkw)
    if rows is not None:
        j.add(rows)
        t.add(rows)
    return j, t


def _stage1_scores(t, qn):
    """[q, size] f64 stage-1 scores of the port's codes (what its stage 1
    ranks), and the tolerance their selection is compared at."""
    qn = _t(qn)
    rows = np.arange(t.size)
    if t.prefilter in ("binary", "itq"):
        codes = (t._codes_index._codes(rows) if t.stage1 == "packed"
                 else t._codes[: t.size].float())
        return (t._encode(qn)[0].double() @ codes.double().T).numpy(), 0.0
    if t.prefilter == "int8x8":
        q8, qs = mips_int8.quantize_rows_int8(qn)
        qd = q8.double() * qs.double()[:, None]
        cd = t._codes[: t.size].double() * t._scales[: t.size].double()[:, None]
        return (qd @ cd.T).numpy(), BF16_TOL
    return (t._project(qn).double() @ t._codes[: t.size].double().T).numpy(), BF16_TOL


def _same_final(j_res, t_res, tol=TOL):
    (Dj, Ij), (D, I) = j_res, t_res
    np.testing.assert_array_equal(I < 0, np.asarray(Ij) < 0)
    np.testing.assert_allclose(D, np.asarray(Dj), atol=tol, rtol=0)


def _same_state(j, t):
    """Rows, codes and scales equal between the packages."""
    assert j.size == t.size
    ids = np.arange(t.size)
    np.testing.assert_array_equal(t.reconstruct_batch(ids), j.reconstruct_batch(ids))
    if t.stage1 == "packed":
        tb, jb = t._codes_index._buf.numpy(), np.asarray(j._codes_index._buf)
        np.testing.assert_array_equal(tb, jb[: tb.shape[0]])
    else:
        np.testing.assert_allclose(t._codes[: t.size].float().numpy(),
                                   np.asarray(j._codes[: j.size].astype(jnp.float32)),
                                   atol=2.0**-8 if t.prefilter == "pca" else 0, rtol=0)
    if t.prefilter == "int8x8":
        np.testing.assert_array_equal(t._scales[: t.size].numpy(),
                                      np.asarray(j._scales[: j.size]))


@pytest.mark.parametrize("prefilter,stage1", COMBOS)
def test_search_matches_jax(data, projectors, prefilter, stage1):
    q, c = data
    j, t = _pair(prefilter, stage1, projectors, c)
    _same_state(j, t)
    # a pool of every row: both return the exact re-rank of the whole corpus
    _same_final(j.search(q, 10, pool=N), t.search(q, 10, pool=N))
    # a pool of 40: the same stage-1 pool (by value), then the exact re-rank
    qn = q
    pool = 40
    cand_j = np.asarray(j._stage1(jnp.asarray(qn), pool))
    cand = t._stage1(_t(qn), pool).numpy()
    assert (cand >= 0).all() and (cand_j >= 0).all()
    scores, tol = _stage1_scores(t, qn)
    scale = np.abs(scores).max(axis=1)
    got = np.take_along_axis(scores, cand, axis=1)
    want = np.take_along_axis(scores, cand_j, axis=1)
    assert value_recall_from_scores(got, want, tol * scale) == 1.0
    stored = t.reconstruct_batch(np.arange(N)).astype(np.float64)
    D, I = t.search(q, 10, pool=pool)
    exact = np.einsum("qd,qpd->qp", qn.astype(np.float64), stored[cand])
    np.testing.assert_allclose(D, -np.sort(-exact, axis=1)[:, :10], atol=TOL, rtol=0)
    assert all(set(I[r]) <= set(cand[r]) for r in range(len(q)))


@pytest.mark.parametrize("prefilter,stage1", COMBOS)
def test_remove_ids_matches_jax(data, projectors, prefilter, stage1):
    q, c = data
    j, t = _pair(prefilter, stage1, projectors, c)
    rng = np.random.default_rng(1)
    for ids in (rng.choice(N, 90, replace=False), np.arange(850, 910), [0, 1]):
        assert t.remove_ids(ids) == j.remove_ids(ids)
        _same_state(j, t)
        _same_final(j.search(q, 10, pool=CAP), t.search(q, 10, pool=CAP))
    j.add(c[:50])
    t.add(c[:50])
    _same_state(j, t)
    _same_final(j.search(q, 10, pool=CAP), t.search(q, 10, pool=CAP))
    # stage 1 and the re-rank stay aligned: each stored row finds itself
    ids = np.array([5, 100, 400, 700, t.size - 1])
    rows = t.reconstruct_batch(ids)
    D, I = t.search(rows, 1, pool=64)  # c[:50] came back: a row may find its twin
    np.testing.assert_array_equal(t.reconstruct_batch(I[:, 0]), rows)


@pytest.mark.parametrize("prefilter,stage1", COMBOS)
@pytest.mark.parametrize("source", ["twostage", "dense"])
def test_merge_from_matches_jax(data, projectors, prefilter, stage1, source):
    q, c = data
    j, t = _pair(prefilter, stage1, projectors, c[:500])
    if source == "dense":
        js = JaxDenseIndex(DIM, 500, metric="ip")
        ts = DenseIndex(DIM, 500, device="cpu", metric="ip")
    else:
        js, ts = _pair("binary", "matmul", projectors, capacity=500)
    js.add(c[500:])
    ts.add(c[500:])
    js.remove_ids([3])
    ts.remove_ids([3])
    assert t.merge_from(ts, batch=128) == j.merge_from(js, batch=128) == 499
    assert ts.size == 499
    _same_state(j, t)
    _same_final(j.search(q, 10, pool=CAP), t.search(q, 10, pool=CAP))


def test_merge_from_refusals(data):
    _, c = data
    t = TwoStageIndex(DIM, 64, device="cpu", n_bits=N_BITS)  # 'cos'
    with pytest.raises(TypeError, match="TwoStageIndex or DenseIndex"):
        t.merge_from(BinaryIndex(N_BITS, 8, device="cpu"))
    centered = DenseIndex(DIM, 8, device="cpu", center="auto")
    centered.add(c[:4])
    with pytest.raises(ValueError, match="centered"):
        t.merge_from(centered)
    with pytest.raises(ValueError, match="dim/metric"):
        t.merge_from(DenseIndex(DIM, 8, device="cpu", metric="ip"))
    big = DenseIndex(DIM, 100, device="cpu")
    big.add(c[:65])
    with pytest.raises(ValueError, match="full"):
        t.merge_from(big)


SNAP_CASES = [(p, s, d) for p, s in COMBOS for d in ("port_to_jax", "jax_to_port")
              if not (p == "binary" and d == "port_to_jax")]


@pytest.mark.parametrize("prefilter,stage1,direction", SNAP_CASES)
def test_snapshots_across_packages(data, projectors, prefilter, stage1, direction, tmp_path):
    q, c = data
    j, t = _pair(prefilter, stage1, projectors, c)
    for idx in (j, t):
        idx.remove_ids(np.arange(0, N, 9))
    path = str(tmp_path / "s")
    if direction == "port_to_jax":
        t.save(path)
        back = jts.TwoStageIndex.load(path, **({"use_pallas": False}
                                               if stage1 == "packed" else {}))
        _same_state(back, t)
        _same_final(back.search(q, 10, pool=CAP), t.search(q, 10, pool=CAP))
    else:
        j.save(path)
        kw = {}
        if prefilter == "binary":
            kw["projection"] = _kw(prefilter, stage1, projectors)[1]["projection"]
        back = TwoStageIndex.load(path, device="cpu", pool=32, **kw)
        assert back.pool == 32
        _same_state(j, back)
        _same_final(j.search(q, 10, pool=CAP), back.search(q, 10, pool=CAP))
    assert (back.stage1, back.prefilter, back.capacity) == (stage1, prefilter, CAP)


@pytest.mark.parametrize("stage1", ["matmul", "packed"])
def test_binary_snapshot_projection_contract(data, projectors, stage1, tmp_path):
    q, c = data
    j, t = _pair("binary", stage1, projectors, c)
    j.save(str(tmp_path / "j"))
    with pytest.raises(ValueError, match="projection="):
        TwoStageIndex.load(str(tmp_path / "j"), device="cpu")
    # the port's own file carries its projection and reloads the same codes
    t.save(str(tmp_path / "t"))
    with np.load(str(tmp_path / "t.npz")) as z:
        np.testing.assert_array_equal(z["projection"], t._projection.numpy())
    back = TwoStageIndex.load(str(tmp_path / "t"), device="cpu")
    assert torch.equal(back._projection, t._projection)
    for a, b in zip(back.search(q, 10, pool=40), t.search(q, 10, pool=40)):
        np.testing.assert_array_equal(a, b)
    seeded = TwoStageIndex(DIM, 64, device="cpu", n_bits=N_BITS, seed=3)
    seeded.add(c[:10])
    seeded.save(str(tmp_path / "seeded"))
    assert torch.equal(TwoStageIndex.load(str(tmp_path / "seeded"), device="cpu")._projection,
                       seeded._projection)


def test_legacy_row_major_packed_codes_load(data, projectors, tmp_path):
    from sessionsimilaritysearch_tpu.ops.hamming import pack_bits_np

    q, c = data
    j, t = _pair("itq", "packed", projectors, c)
    t.save(str(tmp_path / "t"))
    with np.load(str(tmp_path / "t.npz")) as z:
        legacy = {k: z[k] for k in z.files if k not in ("codes_packed_t", "codes_block_rows")}
    legacy["codes_packed"] = pack_bits_np(t._codes_index.reconstruct_batch(np.arange(N)))
    np.savez(str(tmp_path / "legacy"), **legacy)
    back = TwoStageIndex.load(str(tmp_path / "legacy"), device="cpu")
    _same_state(j, back)
    _same_final(j.search(q, 10, pool=CAP), back.search(q, 10, pool=CAP))


@pytest.mark.parametrize("prefilter", ["pca", "itq"])
def test_build_twostage_index_matches_jax(data, prefilter):
    q, c = data
    kw = dict(n_bits=32) if prefilter == "itq" else dict(pca_dim=16)
    j = jts.build_twostage_index(c, prefilter=prefilter, pool=64, **kw)
    t = build_twostage_index(c, prefilter=prefilter, device="cpu", pool=64, **kw)
    # the same fit on the same (normalized) rows, to the fits' tolerance
    np.testing.assert_allclose(t._proj_mean.numpy(), np.asarray(j._proj_mean), atol=1e-6)
    np.testing.assert_allclose(np.abs(t._proj_comp.numpy()),
                               np.abs(np.asarray(j._proj_comp)), atol=1e-4)
    assert t._proj_explained == pytest.approx(j._proj_explained, rel=1e-5)
    assert t.n_bits == j.n_bits and t.ntotal == N
    _same_final(j.search(q, 10, pool=N), t.search(q, 10, pool=N))
    D, I = t.search(c[:20], 1)
    np.testing.assert_array_equal(I[:, 0], np.arange(20))


# --- the two-stage engine -------------------------------------------------

@pytest.fixture(scope="module")
def engine_proj(parts):
    """One ITQ projector for both packages' engines, fitted by the JAX
    package on its own embeddings of the sessions."""
    cfg = parts[0]
    emb = JaxEngine(cfg, parts[1], parts[3], dim=cfg.session_emb_dim, capacity=64,
                    batch_size=8).embed(parts[2])
    return fit_itq(_unit(emb), 32)


def _engine_kw(parts, stage1, proj):
    return dict(dim=parts[0].session_emb_dim, capacity=64, batch_size=8, prefilter="itq",
                stage1=stage1, projector=proj, pool=64)


def _port_engine(parts, kw):
    return SessionSearchEngine(*_port_side(parts[0]), parts[4], device="cpu", **kw)


@pytest.mark.parametrize("stage1", ["matmul", "packed"])
def test_engine_removal_and_expiry_match_a_fresh_engine(parts, engine_proj, stage1):
    _, _, data, _, _ = parts
    kw = _engine_kw(parts, stage1, engine_proj)
    t = _port_engine(parts, kw)
    for b in range(4):
        t.add_sessions(data[10 * b: 10 * b + 10], stamp=float(b))
    assert t.remove_sessions(ids=[3, 17, 31]) == 3
    assert t.remove_sessions(data=[data[25]]) == 1
    assert t.expire(before=1.0) == 9  # batch 0 less the removed row 3
    assert len(t.sessions) == t.index.ntotal == 27
    fresh = _port_engine(parts, kw)
    fresh.add_sessions(t.sessions)
    for a, b in zip(t.search(data[:12], k=8), fresh.search(data[:12], k=8)):
        np.testing.assert_allclose(a, b, atol=TOL, rtol=0)
    D, I = t.search(data[:12], k=8)
    removed = {3, 17, 31, 25} | set(range(10))
    kept = [d[0] for i, d in enumerate(data[:40]) if i not in removed]  # (prefix, future)
    assert [t.sessions[i] for i in range(27)] == [fresh.sessions[i] for i in range(27)]
    assert all(t.sessions[i] in kept for i in I[I >= 0])


@pytest.mark.parametrize("stage1", ["matmul", "packed"])
@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_engine_save_restore_across_packages(parts, engine_proj, stage1, direction,
                                            tmp_path):
    cfg, tok, data, encode_fn, _ = parts
    kw = _engine_kw(parts, stage1, engine_proj)
    j = JaxEngine(cfg, tok, encode_fn, **kw)
    t = _port_engine(parts, kw)
    for eng in (j, t):
        eng.add_sessions(data[:30], stamp=1.0)
        eng.remove_sessions(ids=[4])
    prefix = str(tmp_path / "eng")
    if direction == "port_to_jax":
        t.save_async(prefix).join()
        back = JaxEngine(cfg, tok, encode_fn, **kw)
        back.restore(prefix)
        ref = t
    else:
        j.save(prefix)
        back = _port_engine(parts, kw)
        back.add_sessions(data[30:35])  # the live corpus goes
        back.restore(prefix)
        assert isinstance(back.index, TwoStageIndex) and back.index.stage1 == stage1
        ref = j
    assert back.index.ntotal == 29 and len(back.sessions) == 29
    assert [tuple(map(tuple, s)) for s in back.sessions] == [
        tuple(map(tuple, s)) for s in ref.sessions]
    Db, Ib = back.search(data[:10], k=5)
    Dr, Ir = ref.search(data[:10], k=5)
    np.testing.assert_allclose(Db, Dr, atol=TOL, rtol=0)
    assert back.expire(before=2.0) == 29  # the stamps came along


def test_engine_approx_mode_keeps_the_exact_index(parts):
    # the JAX single-device engine takes mode= and builds its DenseIndex
    # without it; the port does the same
    cfg, _, data, _, _ = parts
    kw = dict(dim=cfg.session_emb_dim, capacity=64, batch_size=8)
    a = _port_engine(parts, dict(kw, mode="approx"))
    e = _port_engine(parts, kw)
    assert isinstance(a.index, DenseIndex) and a.index.mode == "exact"
    for eng in (a, e):
        eng.add_sessions(data[:30])
    for x, y in zip(a.search(data[:8], k=6), e.search(data[:8], k=6)):
        np.testing.assert_array_equal(x, y)
    lims, _, _ = a.range_search(data[:2], 0.9)  # an exact index: range search works
    assert lims[-1] >= 2
