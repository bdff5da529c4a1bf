"""Parity of the port's ``BinaryIndex`` maintenance verbs and snapshots with
the JAX index (its XLA twin, ``use_pallas=False``), in both storage modes,
on the CPU where every kernel wrapper runs its plain version.

- ``remove_ids``: after the same add / remove / add sequence the packed
  words equal JAX's word for word (bit 31 included) and every freed slot
  is zero; sign rows equal JAX's.
- ``range_search``: JAX's CSR triple; the hit sets are equal (a radius set
  is exact) and the Hamming distances equal per query, sorted.
- ``merge_from`` across modes, ``save`` in one package and ``load`` in the
  other, both directions, and the legacy row-major packed file.

Hamming distances are integers compared exactly; with ties, rows of equal
distance may be listed in another order, so top-k results are compared as
distances sorted per query."""

import numpy as np
import pytest
import torch

from sessionsimilaritysearch_tpu.index.binary import BinaryIndex as JaxBinaryIndex
from sessionsimilaritysearch_tpu.ops import hamming as jham
from sessionsimilaritysearch_tpu_torch.index.binary import BinaryIndex
from sessionsimilaritysearch_tpu_torch.ops import hamming, mips, packed

BITS, CAP = 96, 6000


def _signs(rng, n, bits=BITS):
    return np.where(rng.random((n, bits)) < 0.5, 1.0, -1.0).astype(np.float32)


@pytest.fixture(autouse=True)
def _no_kernel_launch_on_cpu():
    counts = (mips.launch_count, packed.launch_count)
    yield
    assert (mips.launch_count, packed.launch_count) == counts


def _pair(mode, bits=BITS, capacity=CAP):
    return (JaxBinaryIndex(bits, capacity, mode=mode, use_pallas=False),
            BinaryIndex(bits, capacity, mode, device="cpu"))


def _same_buffers(j, t):
    jb, tb = np.asarray(j._buf), t._buf
    if t.mode == "packed":
        # the port's buffer holds whole 2048-row pack blocks, JAX's whole
        # 16384-row grid groups: the port's words are a prefix of JAX's
        np.testing.assert_array_equal(tb.numpy(), jb[: tb.shape[0]])
        assert not jb[tb.shape[0]:].any()
    else:
        np.testing.assert_array_equal(tb[: t.size].float().numpy(),
                                      jb[: j.size].astype(np.float32))


def _freed_slots_zero(t):
    """Every slot at or past ``size`` holds no set bit (all -1 codes)."""
    rows = hamming.unpack_bits_t(t._buf).float()
    assert (rows[t.size:] == -1).all()


def _same_search(j, t, q, k=12):
    dj, _ = j.search(q, k)
    d, i = t.search(q, k)
    np.testing.assert_array_equal(np.sort(d, 1), np.sort(np.asarray(dj), 1))
    codes = t.reconstruct_batch(np.arange(t.size))
    true = ((BITS - np.einsum("qb,qkb->qk", q, codes[i])) / 2).astype(np.int32)
    np.testing.assert_array_equal(true, d)


@pytest.mark.parametrize("mode", ["packed", "sign"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_remove_then_add_matches_jax(mode, seed):
    rng = np.random.default_rng(seed)
    codes = _signs(rng, 5200)
    q = _signs(rng, 9)
    j, t = _pair(mode)
    j.add(codes[:4500])
    t.add(codes[:4500])
    # scattered ids, a run at the tail (pure-tail removals free slots too),
    # and ids whose slots are bit 31 of their words
    for ids in (rng.choice(4500, 300, replace=False), np.arange(4100, 4200),
                np.array([31, 63, 2047, 2079]), np.arange(3000, 4096)):
        assert t.remove_ids(ids) == j.remove_ids(ids)
        assert t.size == j.size
        _same_buffers(j, t)
        if mode == "packed":
            _freed_slots_zero(t)
        _same_search(j, t, q)
    j.add(codes[4500:])
    t.add(codes[4500:])
    _same_buffers(j, t)
    _same_search(j, t, q)
    np.testing.assert_array_equal(t.reconstruct_batch(np.arange(t.size)),
                                  j.reconstruct_batch(np.arange(j.size)))


def test_remove_everything_and_nothing():
    rng = np.random.default_rng(5)
    codes = _signs(rng, 3000)
    t = BinaryIndex(BITS, CAP, "packed", device="cpu")
    t.add(codes)
    assert t.remove_ids([]) == 0 and t.size == 3000
    assert t.remove_ids(np.arange(3000)) == 3000 and t.size == 0
    assert not t._buf.any()
    t.add(codes[:10])
    np.testing.assert_array_equal(t.reconstruct_batch(np.arange(10)), codes[:10])


@pytest.mark.parametrize("mode", ["packed", "sign"])
def test_range_search_matches_jax(mode):
    rng = np.random.default_rng(7)
    codes = _signs(rng, 4000)
    q = np.concatenate([codes[:3], _signs(rng, 3)])
    q[:3, :20] *= -1  # near-duplicates: each has rows near distance 20
    j, t = _pair(mode)
    j.add(codes)
    t.add(codes)
    mask = rng.random(4000) < 0.7
    for radius, kw in ((38, {}), (20, {}), (36, {"row_mask": mask})):
        lj, dj, ij = j.range_search(q, radius, k0=16, **kw)
        lims, d, i = t.range_search(q, radius, k0=16, **kw)
        np.testing.assert_array_equal(lims, lj)
        assert lims[-1] > 0 and d.dtype == np.int32 and i.dtype == np.int64
        for r in range(len(q)):
            seg = slice(lims[r], lims[r + 1])
            assert (np.diff(d[seg]) >= 0).all()  # nearest first
            np.testing.assert_array_equal(d[seg], np.sort(np.asarray(dj)[seg]))
            assert set(i[seg].tolist()) == set(np.asarray(ij)[seg].tolist())
        assert (d <= radius).all()
        if kw:
            assert mask[i].all()


@pytest.mark.parametrize("dst_mode,src_mode", [("packed", "sign"), ("sign", "packed"),
                                               ("packed", "packed")])
def test_merge_from_across_modes_matches_jax(dst_mode, src_mode):
    rng = np.random.default_rng(8)
    a, b, q = _signs(rng, 2500), _signs(rng, 2100), _signs(rng, 7)
    j, t = _pair(dst_mode)
    js, ts = _pair(src_mode, capacity=2500)
    for idx, rows in ((j, a), (t, a), (js, b), (ts, b)):
        idx.add(rows)
    ts.remove_ids([0, 5])
    js.remove_ids([0, 5])
    assert t.merge_from(ts, batch=1000) == j.merge_from(js, batch=1000) == 2098
    assert ts.size == 2098  # the source is left intact
    _same_buffers(j, t)
    _same_search(j, t, q)
    np.testing.assert_array_equal(t.reconstruct_batch(np.arange(2500, 4598)),
                                  ts.reconstruct_batch(np.arange(2098)))


@pytest.mark.parametrize("mode", ["packed", "sign"])
@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_snapshots_across_packages(mode, direction, tmp_path):
    rng = np.random.default_rng(9)
    codes, q = _signs(rng, 4500), _signs(rng, 6)
    j, t = _pair(mode)
    for idx in (j, t):
        idx.add(codes)
        idx.remove_ids(np.arange(0, 4500, 7))
    path = str(tmp_path / "b")
    if direction == "port_to_jax":
        t.save(path)
        back = JaxBinaryIndex.load(path, use_pallas=False)
        _same_buffers(back, t)
        _same_search(back, t, q)
    else:
        j.save(path)
        back = BinaryIndex.load(path, device="cpu")
        _same_buffers(j, back)
        _same_search(j, back, q)
    assert (back.size, back.capacity, back.mode) == (t.size, CAP, mode)
    with np.load(path + ".npz") as z:
        if mode == "packed":  # words trimmed to the used pack blocks
            assert z["buf"].shape == (-(-t.size // 2048) * 64, 128)
            assert str(z["layout"]) == "t" and int(z["block_rows"]) == 2048
        else:
            assert z["buf"].dtype == np.int8 and z["buf"].shape == (t.size, BITS)
    back.add(codes[:5])  # the freed tail takes new rows
    assert back.size == t.size + 5


def test_legacy_row_major_packed_file_loads(tmp_path):
    rng = np.random.default_rng(10)
    codes, q = _signs(rng, 3000), _signs(rng, 5)
    path = str(tmp_path / "legacy.npz")
    np.savez(path, buf=jham.pack_bits_np(codes), n_bits=BITS, capacity=CAP, mode="packed",
             selection="exact", recall_target=0.95, size=3000)
    back = BinaryIndex.load(path, device="cpu")
    fresh = BinaryIndex(BITS, CAP, "packed", device="cpu")
    fresh.add(codes)
    assert torch.equal(back._buf, fresh._buf) and back.size == 3000
    jback = JaxBinaryIndex.load(path, use_pallas=False)
    _same_buffers(jback, back)
    _same_search(jback, back, q)


def test_approx_selection_round_trips(tmp_path):
    rng = np.random.default_rng(11)
    codes, q = _signs(rng, 2000), _signs(rng, 4)
    t = BinaryIndex(BITS, 2000, "sign", device="cpu", selection="approx",
                    recall_target=0.9)
    t.add(codes)
    exact = BinaryIndex(BITS, 2000, "sign", device="cpu")
    exact.add(codes)
    np.testing.assert_array_equal(t.search(q, 10)[0], exact.search(q, 10)[0])
    t.save(str(tmp_path / "a"))
    back = JaxBinaryIndex.load(str(tmp_path / "a"))
    assert (back.selection, back.recall_target) == ("approx", 0.9)
    back = BinaryIndex.load(str(tmp_path / "a"), device="cpu")
    assert (back.selection, back.recall_target) == ("approx", 0.9)
