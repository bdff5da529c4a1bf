"""Parity of the port's ``ShardedBinaryIndex`` (``index/sharded_binary.py``,
``parallel/collectives.py`` ``sharded_hamming_topk``) with the JAX package,
in both storage modes, on a mesh of 8 CPU shards (JAX: the 8 virtual CPU
devices). The JAX packed scan runs its XLA twin on the CPU; the port's runs
K4's plain version.

Tolerances: Hamming distances are integers and compared exactly. The
stored codes (sign rows, packed words) are equal word for word. Ids are
compared as the unsharded binary tests compare them: every returned id
scores its reported distance against the numpy oracle, and the ids
strictly nearer than each query's k-th distance are the same set as
JAX's (rows tied at the k-th distance may differ)."""

import jax
import numpy as np
import pytest
import torch

from sessionsimilaritysearch_tpu.index.sharded_binary import ShardedBinaryIndex as JaxBin
from sessionsimilaritysearch_tpu.parallel import collectives as jcol
from sessionsimilaritysearch_tpu.parallel import create_mesh as jax_mesh
from sessionsimilaritysearch_tpu_torch.index.sharded_binary import ShardedBinaryIndex
from sessionsimilaritysearch_tpu_torch.ops import hamming, mips, packed
from sessionsimilaritysearch_tpu_torch.parallel import collectives as tcol
from sessionsimilaritysearch_tpu_torch.parallel import create_mesh

N_BITS, CAP = 96, 2048  # 96 bits: packed words pad to 128 columns
MODES = ["sign", "packed"]


@pytest.fixture(autouse=True)
def _no_kernel_launch_on_cpu():
    counts = (mips.launch_count, packed.launch_count)
    yield
    assert (mips.launch_count, packed.launch_count) == counts


def _meshes(n=8):
    return (jax_mesh(shape=(n,), devices=jax.devices()[:n]),
            create_mesh(devices=[torch.device("cpu")] * n))


def _codes(rng, n):
    return np.sign(rng.standard_normal((n, N_BITS))).astype(np.float32)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    codes = _codes(rng, 1024)
    q = codes[:10].copy()
    q[:, :20] *= -1  # each query 20 bits from a stored code
    return codes, q


def _pair(mode, codes, n=8, batches=(512, 384, 128), sides="jax+port"):
    """The JAX and the port index on ``n`` shards, streamed the same codes;
    a side left out of ``sides`` is None."""
    jm, tm = _meshes(n)
    j = JaxBin(N_BITS, CAP, jm, mode=mode, use_pallas=False) if "jax" in sides else None
    t = ShardedBinaryIndex(N_BITS, CAP, tm, mode=mode) if "port" in sides else None
    start = 0
    for m in batches:
        for idx in (j, t):
            if idx is not None:
                idx.add(codes[start: start + m])
        start += m
    return j, t


def _same_state(j, t):
    """Codes, device ids and host bookkeeping equal between the packages."""
    np.testing.assert_array_equal(t._fill, j._fill)
    np.testing.assert_array_equal(t._host_ids, j._host_ids)
    jb = np.asarray(j._buf, np.float32 if t.mode == "sign" else np.int32)
    jb = jb.reshape(t.ndev, -1, jb.shape[1])
    ji = np.asarray(j._ids).reshape(t.ndev, -1)
    for s in range(t.ndev):
        f = int(t._fill[s])
        got = t._buf[s].float().numpy() if t.mode == "sign" else t._buf[s].numpy()
        np.testing.assert_array_equal(got, jb[s])
        np.testing.assert_array_equal(t._ids[s][:f].numpy(), ji[s][:f])


def _check(j_res, t_res, t, q):
    """Exact distances; every id at its distance; the ids nearer than the
    k-th distance equal as sets."""
    (Dj, Ij), (Dt, It) = (np.asarray(x) for x in j_res), t_res
    assert Dt.dtype == np.int32 and It.dtype == np.int64
    np.testing.assert_array_equal(Dt, Dj)
    np.testing.assert_array_equal(It < 0, Ij < 0)
    live = It >= 0
    if live.any():
        rows = t.reconstruct_batch(It[live])
        dist = ((rows > 0) != (q[np.nonzero(live)[0]] > 0)).sum(axis=1)
        np.testing.assert_array_equal(dist, Dt[live])
    for r in range(len(q)):
        kth = Dt[r, -1]
        assert set(It[r][Dt[r] < kth]) == set(Ij[r][Dj[r] < kth])


@pytest.fixture(scope="module")
def built(data):
    return {mode: _pair(mode, data[0]) for mode in MODES}


@pytest.mark.parametrize("mode", MODES)
def test_search_matches_jax(built, data, mode):
    j, t = built[mode]
    _, q = data
    _same_state(j, t)
    _check(j.search(q, 10), t.search(q, 10), t, q)
    # k beyond a shard's rows and past the corpus: missing slots
    _check(j.search(q, 2000), t.search(q, 2000), t, q)
    D, I = t.search(q, 3, out="device")
    assert isinstance(D, torch.Tensor) and D.dtype == torch.int32


@pytest.mark.parametrize("mode", MODES)
def test_gid_row_mask_and_range_search_match_jax(built, data, mode):
    j, t = built[mode]
    _, q = data
    mask = np.random.default_rng(2).random(t._next_id) < 0.5
    _check(j.search(q, 10, row_mask=mask), t.search(q, 10, row_mask=mask), t, q)
    (tl, td, ti), (jl, jd, ji) = t.range_search(q, 30, k0=8), j.range_search(q, 30, k0=8)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(td, jd)  # each slice nearest-first
    for r in range(len(q)):
        assert set(ti[tl[r]: tl[r + 1]]) == set(ji[jl[r]: jl[r + 1]])


@pytest.mark.parametrize("mode", MODES)
def test_sharded_hamming_topk_matches_jax(data, mode):
    codes, q = data
    jm, tm = _meshes()
    valid = [128, 0, 5, 128, 64, 127, 1, 128]
    if mode == "packed":
        # one 2048-slot pack block per shard, 128 codes at its head
        blocks = np.zeros((8, 2048, N_BITS), np.float32) - 1
        blocks[:, :128] = codes.reshape(8, 128, N_BITS)
        words = np.stack([hamming.pack_bits_t_np(np.pad(b, ((0, 0), (0, 32)))) for b in blocks])
        qp = np.pad(q, ((0, 0), (0, 32)))
        got = tcol.sharded_hamming_topk(
            torch.from_numpy(qp).bfloat16(), [torch.from_numpy(w) for w in words], 10, tm,
            N_BITS, valid_per_shard=valid, packed_bits=N_BITS)
        want = jcol.sharded_hamming_topk(
            jax.numpy.asarray(qp, jax.numpy.bfloat16),
            jcol.shard_corpus(jax.numpy.asarray(words.reshape(-1, 128)), jm), 10, jm, N_BITS,
            valid_per_shard=jax.numpy.asarray(valid, jax.numpy.int32), packed_bits=N_BITS,
            use_pallas=False)
    else:
        got = tcol.sharded_hamming_topk(torch.from_numpy(q), tcol.shard_corpus(codes, tm),
                                        10, tm, N_BITS, valid_per_shard=valid)
        want = jcol.sharded_hamming_topk(
            jax.numpy.asarray(q, jax.numpy.bfloat16),
            jcol.shard_corpus(jax.numpy.asarray(codes, jax.numpy.bfloat16), jm), 10, jm,
            N_BITS, valid_per_shard=jax.numpy.asarray(valid, jax.numpy.int32))
    Dt, It = got[0].numpy(), got[1].numpy()
    Dj, Ij = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(Dt, Dj)
    np.testing.assert_array_equal(It < 0, Ij < 0)
    rows, live = (128 if mode == "sign" else 2048), It >= 0
    assert (It[live] % rows < np.asarray(valid)[It[live] // rows]).all()  # valid slots only
    for r in range(len(q)):
        assert set(It[r][Dt[r] < Dt[r, -1]]) == set(Ij[r][Dj[r] < Dj[r, -1]])


@pytest.mark.parametrize("mode", MODES)
def test_remove_ids_keeps_ids_stable_and_matches_jax(data, mode):
    codes, q = data
    j, t = _pair(mode, codes)
    rng = np.random.default_rng(3)
    shard1 = t._host_ids[1, : t._fill[1]].copy()
    for gone in (rng.choice(1024, 150, replace=False), shard1):
        gone = gone[np.isin(gone, t._host_ids[t._host_ids >= 0])]
        assert t.remove_ids(gone) == j.remove_ids(gone) == gone.size
        _same_state(j, t)
        _check(j.search(q, 10), t.search(q, 10), t, q)
    assert t._fill[1] == 0  # a shard emptied by removals
    # survivors keep their ids; freed capacity refills with fresh ids
    keep = t._host_ids[2, :3]
    np.testing.assert_array_equal(t.search(codes[keep], 1)[1][:, 0], keep)
    t.add(codes[:256])
    j.add(codes[:256])
    _same_state(j, t)
    _check(j.search(q, 10), t.search(q, 10), t, q)
    with pytest.raises(ValueError, match="not present"):
        t.remove_ids([int(shard1[0])])


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_snapshots_across_packages(data, mode, direction, tmp_path):
    codes, q = data
    gone = np.arange(0, 1024, 11)
    path = str(tmp_path / "b.npz")
    if direction == "port_to_jax":
        _, t = _pair(mode, codes, sides="port")
        t.remove_ids(gone)
        t.save(path)
        back = JaxBin.load(path, _meshes()[0], use_pallas=False)
        _same_state(back, t)
        _check(back.search(q, 10), t.search(q, 10), t, q)
    else:
        j, _ = _pair(mode, codes, sides="jax")
        j.remove_ids(gone)
        j.save(path)
        back = ShardedBinaryIndex.load(path, _meshes()[1])
        _same_state(j, back)
        _check(j.search(q, 10), back.search(q, 10), back, q)
        np.testing.assert_array_equal(back.reconstruct_batch([5, 900]),
                                      np.asarray(j.reconstruct_batch([5, 900])))
    with pytest.raises(ValueError, match="shards"):
        ShardedBinaryIndex.load(path, _meshes(4)[1])
