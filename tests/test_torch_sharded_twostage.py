"""Parity of the port's ``ShardedTwoStageIndex`` (``index/twostage.py``,
``parallel/collectives.py`` ``sharded_twostage_topk``) with the JAX package
for every prefilter x stage1 ('binary' / 'itq' x 'matmul' / 'packed',
'int8x8', 'pca'), on a mesh of 8 CPU shards (JAX: the 8 virtual CPU
devices; its packed stage 1 runs its XLA twin). Both packages code the rows
alike, as in ``test_torch_twostage_verbs.py``: SimHash with the JAX
projection carried across (``weights.simhash_projection``), ITQ and PCA
with one projector fitted by the JAX package, int8 by the bit-equal row
quantizer; unit rows under ``metric='ip'``, so both store the same bf16
rows.

Tolerances: per-shard rows, codes (packed words bit for bit) and scales are
equal (PCA codes within one bf16 ulp). With a pool of every row of a shard
both packages return the exact re-rank, values to 1e-5 (f32 sums in another
order) and ids equal wherever the values are more than that apart. With a
small pool the port's result equals, exactly, the unsharded port index's
search of each shard's rows merged by the stable sort: the same stage-1
pools, re-rank and merge."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sessionsimilaritysearch_tpu.index.twostage import ShardedTwoStageIndex as JaxSTS
from sessionsimilaritysearch_tpu.ops.projection import fit_itq, fit_pca
from sessionsimilaritysearch_tpu.parallel import create_mesh as jax_mesh
from sessionsimilaritysearch_tpu_torch.index.twostage import ShardedTwoStageIndex, TwoStageIndex
from sessionsimilaritysearch_tpu_torch.ops import mips, mips_int8, packed
from sessionsimilaritysearch_tpu_torch.ops.topk import rerank_topk
from sessionsimilaritysearch_tpu_torch.parallel import create_mesh
from sessionsimilaritysearch_tpu_torch.weights import simhash_projection

DIM, N, N_BITS = 64, 1024, 64
CAP = 8 * 2048  # whole 2048-slot pack blocks on 8 shards (and on 4)
TOL = 1e-5
COMBOS = [("binary", "matmul"), ("binary", "packed"), ("itq", "matmul"),
          ("itq", "packed"), ("int8x8", "matmul"), ("pca", "matmul")]
# one combination per snapshot layout that the JAX package loads from the
# port: packed words, int8 codes with scales, f16 codes with a projector
PORT_TO_JAX = {("itq", "packed"), ("int8x8", "matmul"), ("pca", "matmul")}


@pytest.fixture(autouse=True)
def _no_kernel_launch_on_cpu():
    counts = (mips.launch_count, mips_int8.launch_count, packed.launch_count)
    yield
    assert (mips.launch_count, mips_int8.launch_count, packed.launch_count) == counts


def _unit(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _meshes(n=8):
    return (jax_mesh(shape=(n,), devices=jax.devices()[:n]),
            create_mesh(devices=[torch.device("cpu")] * n))


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    c = _unit(rng.standard_normal((N, DIM)))
    q = _unit(c[:12] + 0.3 * rng.standard_normal((12, DIM)))
    return q, c


@pytest.fixture(scope="module")
def projectors(data):
    _, c = data
    return {"itq": fit_itq(c, N_BITS), "pca": fit_pca(c, 16)}


def _kw(prefilter, stage1, projectors):
    """Constructor arguments of the JAX index and of the port's."""
    kw = dict(prefilter=prefilter, stage1=stage1, pool=2048, n_bits=N_BITS, metric="ip")
    tkw = {}
    if prefilter in projectors:
        kw["projector"] = projectors[prefilter]
    if prefilter == "binary":
        R = jax.random.normal(jax.random.PRNGKey(0), (DIM, N_BITS), jnp.float32)
        tkw["projection"] = simhash_projection(np.asarray(R))
    return dict(kw, use_pallas=False), dict(kw, **tkw)


def _pair(prefilter, stage1, projectors, rows, n=8):
    jkw, tkw = _kw(prefilter, stage1, projectors)
    jm, tm = _meshes(n)
    j = JaxSTS(DIM, CAP, jm, **jkw)
    t = ShardedTwoStageIndex(DIM, CAP, tm, **tkw)
    for part in (rows[:512], rows[512:]):  # streamed in two stripes
        j.add(part)
        t.add(part)
    return j, t


@pytest.fixture(scope="module")
def built(data, projectors):
    return {combo: _pair(*combo, projectors, data[1]) for combo in COMBOS}


def _same_state(j, t):
    """Per-shard rows, codes, scales, ids and host bookkeeping equal."""
    np.testing.assert_array_equal(t._fill, j._fill)
    np.testing.assert_array_equal(t._host_ids, j._host_ids)

    def per_shard(x, dtype=None):
        a = np.asarray(x if dtype is None else x.astype(dtype))
        return a.reshape(t.ndev, -1, *a.shape[1:])

    jb, jc = per_shard(j._buf, jnp.float32), per_shard(
        j._codes, jnp.float32 if t.stage1 != "packed" and t.prefilter != "int8x8" else None)
    ji = per_shard(j._ids)
    for s in range(t.ndev):
        f = int(t._fill[s])
        np.testing.assert_array_equal(t._buf[s][:f].float().numpy(), jb[s][:f])
        np.testing.assert_array_equal(t._ids[s][:f].numpy(), ji[s][:f])
        if t.stage1 == "packed":
            np.testing.assert_array_equal(t._codes[s].numpy(), jc[s])
        else:
            np.testing.assert_allclose(t._codes[s][:f].float().numpy(), jc[s][:f],
                                       atol=2.0**-8 if t.prefilter == "pca" else 0, rtol=0)
        if t.prefilter == "int8x8":
            np.testing.assert_array_equal(t._scales[s][:f].numpy(),
                                          per_shard(j._scales)[s][:f])


def _same_final(j_res, t_res):
    (Dj, Ij), (Dt, It) = (np.asarray(x) for x in j_res), t_res
    assert Dt.dtype == np.float32 and It.dtype == np.int64
    missing = It < 0
    np.testing.assert_array_equal(missing, Ij < 0)
    np.testing.assert_allclose(Dt[~missing], Dj[~missing], atol=TOL, rtol=0)
    gap = np.abs(np.diff(Dj, axis=1)) > TOL
    ones = np.ones((Dj.shape[0], 1), bool)
    sure = np.concatenate([ones, gap], 1) & np.concatenate([gap, ones], 1) & ~missing
    np.testing.assert_array_equal(It[sure], Ij[sure])


def _per_shard_reference(t, tkw, rows, q, k, pool):
    """Each shard's ``rows`` (by global id) in an unsharded port index: its
    stage-1 pool and re-rank, merged by global id in shard order."""
    vals, ids = [], []
    for s in range(t.ndev):
        f = int(t._fill[s])
        gids = t._host_ids[s, :f]
        one = TwoStageIndex(DIM, 2048, device="cpu", **{key: v for key, v in tkw.items()})
        if f:
            one.add(rows[gids])
        # stage 1 of the f32 queries, the re-rank with them in bf16 (as JAX's
        # sharded index re-ranks, index/twostage.py:973)
        qt = torch.from_numpy(q)
        D, I = (x.numpy() for x in rerank_topk(qt.bfloat16(), one._buf,
                                                one._stage1(qt, pool), k))
        vals.append(D)
        ids.append(np.where(I >= 0, gids[np.maximum(I, 0)] if f else -1, -1))
    v, i = np.concatenate(vals, 1), np.concatenate(ids, 1)
    order = np.argsort(-v, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(v, order, 1), np.take_along_axis(i, order, 1)


@pytest.mark.parametrize("prefilter,stage1", COMBOS)
def test_search_matches_jax(built, data, projectors, prefilter, stage1):
    q, c = data
    j, t = built[(prefilter, stage1)]
    _same_state(j, t)
    # a pool of every row of a shard: both return the exact re-rank
    _same_final(j.search(q, 10, pool=2048), t.search(q, 10, pool=2048))
    # a small pool: the unsharded port index on each shard's rows, merged
    D, I = t.search(q, 10, pool=16)
    tkw = dict(_kw(prefilter, stage1, projectors)[1], pool=16)
    Dr, Ir = _per_shard_reference(t, tkw, c, q, 10, 16)
    np.testing.assert_array_equal(I, Ir)
    np.testing.assert_array_equal(D, Dr)
    # the stored rows find themselves under their global ids
    ids = np.array([0, 300, 700, 1023])
    np.testing.assert_array_equal(t.search(c[ids], 1, pool=32)[1][:, 0], ids)


@pytest.mark.parametrize("prefilter,stage1", COMBOS)
def test_gid_row_mask_and_reconstruct_match_jax(built, data, prefilter, stage1):
    q, _ = data
    j, t = built[(prefilter, stage1)]
    mask = np.random.default_rng(1).random(N) < 0.5
    _same_final(j.search(q, 10, pool=2048, row_mask=mask),
                t.search(q, 10, pool=2048, row_mask=mask))
    ids = [5, 129, 1000]
    np.testing.assert_array_equal(t.reconstruct_batch(ids), np.asarray(j.reconstruct_batch(ids)))
    with pytest.raises(KeyError):
        t.reconstruct(N)


@pytest.mark.parametrize("prefilter,stage1", COMBOS)
def test_remove_ids_and_snapshots_match_jax(data, projectors, prefilter, stage1, tmp_path):
    q, c = data
    j, t = _pair(prefilter, stage1, projectors, c)
    # all of shard 2 and 96 rows of the others: 224 rows, so the size
    # divides over 8 shards for the snapshots below
    shard2 = t._host_ids[2, : t._fill[2]]
    others = np.setdiff1d(np.arange(N), shard2)
    gone = np.concatenate([shard2, np.random.default_rng(2).choice(others, 96, replace=False)])
    assert t.remove_ids(gone) == j.remove_ids(gone) == 224
    _same_state(j, t)
    assert t._fill[2] == 0  # a shard emptied by removals
    _same_final(j.search(q, 10, pool=2048), t.search(q, 10, pool=2048))
    t.add(c[:64])
    j.add(c[:64])
    _same_state(j, t)
    _same_final(j.search(q, 10, pool=2048), t.search(q, 10, pool=2048))
    # JAX's 8-shard snapshot loaded by the port on 4 shards (re-striped in
    # insertion order), and for each snapshot layout the port's loaded by JAX
    size = t.size
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    j.save(jpath)
    kw = {}
    if prefilter == "binary":
        with pytest.raises(ValueError, match="projection"):
            ShardedTwoStageIndex.load(jpath, _meshes(4)[1])
        kw["projection"] = _kw(prefilter, stage1, projectors)[1]["projection"]
    back = ShardedTwoStageIndex.load(jpath, _meshes(4)[1], pool=64, **kw)
    assert (back.ndev, back.pool, back.size, back._next_id) == (4, 64, size, N + 64)
    _same_final(j.search(q, 10, pool=2048), back.search(q, 10, pool=2048))
    if (prefilter, stage1) not in PORT_TO_JAX:
        return
    t.save(tpath)
    jback = JaxSTS.load(tpath, _meshes(4)[0], **({"use_pallas": False}
                                                 if stage1 == "packed" else {}))
    assert (jback.ndev, jback.size) == (4, size)
    _same_final(jback.search(q, 10, pool=2048), t.search(q, 10, pool=2048))
    ids = t._host_ids[t._host_ids >= 0][:3]
    np.testing.assert_array_equal(np.asarray(jback.reconstruct_batch(ids)),
                                  t.reconstruct_batch(ids))


def test_emptied_index_keeps_its_next_id_through_a_snapshot(data, projectors, tmp_path):
    # every row removed: the snapshot still carries the ids issued, so a
    # restored index never hands them out again
    _, c = data
    _, tkw = _kw("itq", "matmul", projectors)
    t = ShardedTwoStageIndex(DIM, CAP, _meshes()[1], **tkw)
    t.add(c[:512])
    t.remove_ids(np.arange(512))
    path = str(tmp_path / "empty.npz")
    t.save(path)
    back = ShardedTwoStageIndex.load(path, _meshes(4)[1])
    assert (back.size, back._next_id) == (0, 512)
    back.add(c[:8])
    np.testing.assert_array_equal(np.sort(back._host_ids[back._host_ids >= 0]),
                                  np.arange(512, 520))
