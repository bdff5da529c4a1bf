"""Parity of the port's packed binary tier with the JAX package.

- Packing (``ops/hamming.py``): the port's device packers against the JAX
  package's numpy ones, bit 31 included, and the index buffer after the
  same adds.
- K4's plain version (``ops/packed.py``) against the Pallas kernel in
  interpret mode (as tests/test_pallas.py runs it): scores equal exactly,
  bucket maxes equal to the contiguous max of the JAX scores.
- K5's plain version (``ops/popcount.py``) against ``pallas_hamming_topk``
  in interpret mode and the XLA ``hamming_topk``.
- ``BinaryIndex`` in both modes against the JAX index and the numpy oracle.
- SimHash and ITQ codes and the copied projector fits.

Hamming distances are integers with heavy ties, so results are compared as
distances sorted per query, never as ids. On the CPU every wrapper runs its
kernel's plain version; the kernels are held against those on the card by
tests/test_torch_cuda.py and chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from sessionsimilaritysearch_tpu.index.binary import BinaryIndex as JaxBinaryIndex
from sessionsimilaritysearch_tpu.ops import hamming as jham
from sessionsimilaritysearch_tpu.ops import pallas_mips
from sessionsimilaritysearch_tpu.ops import projection as jproj
from sessionsimilaritysearch_tpu_torch.index.binary import BinaryIndex
from sessionsimilaritysearch_tpu_torch.ops import (
    hamming,
    mips,
    packed,
    popcount,
    projection,
)

INT32_MAX = 2**31 - 1


def _signs(rng, n, bits):
    return np.where(rng.random((n, bits)) < 0.5, 1.0, -1.0).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _sorted(d):
    return np.sort(np.asarray(d), axis=1)


@pytest.fixture(autouse=True)
def _no_kernel_launch_on_cpu():
    counts = (mips.launch_count, packed.launch_count, popcount.launch_count)
    yield
    # CPU tensors never launch a kernel
    assert (mips.launch_count, packed.launch_count, popcount.launch_count) == counts


class TestPacking:
    def test_pack_bits_t_matches_jax(self):
        rng = np.random.default_rng(0)
        signs = _signs(rng, 4096, 250)  # two pack blocks: bit 31 is used
        want = jham.pack_bits_t_np(signs)
        got = hamming.pack_bits_t(_t(signs)).numpy()
        np.testing.assert_array_equal(got, want)
        assert (got < 0).any()  # words with bit 31 set
        np.testing.assert_array_equal(
            hamming.unpack_bits_t(_t(want)).float().numpy(), signs)
        np.testing.assert_array_equal(
            hamming.unpack_bits_t(_t(want)).float().numpy(),
            np.asarray(jham.unpack_bits_t(jnp.asarray(want))).astype(np.float32))

    def test_pack_bits_matches_jax(self):
        rng = np.random.default_rng(1)
        signs = _signs(rng, 300, 250)
        want = jham.pack_bits_np(signs)
        np.testing.assert_array_equal(hamming.pack_bits(_t(signs)).numpy(), want)
        np.testing.assert_array_equal(
            hamming.unpack_bits_np(want, 250), jham.unpack_bits_np(want, 250))

    @pytest.mark.parametrize("name", ["pack_bits_np", "pack_bits_t_np",
                                      "unpack_bits_t_np", "t_slot_coords",
                                      "oracle_hamming_np"])
    def test_copied_numpy_helpers(self, name):
        rng = np.random.default_rng(2)
        signs = _signs(rng, 2048, 96)
        args = {
            "pack_bits_np": (signs,),
            "pack_bits_t_np": (signs,),
            "unpack_bits_t_np": (jham.pack_bits_t_np(signs),),
            "t_slot_coords": (np.arange(0, 9000, 7),),
            "oracle_hamming_np": (signs[:9], signs, 5),
        }[name]
        for a, b in zip(np.atleast_1d(getattr(hamming, name)(*args)),
                        np.atleast_1d(getattr(jham, name)(*args))):
            np.testing.assert_array_equal(a, b)

    def test_index_buffer_matches_jax(self):
        rng = np.random.default_rng(3)
        signs = _signs(rng, 3000, 250)
        j = JaxBinaryIndex(250, 4096, mode="packed", use_pallas=False)
        t = BinaryIndex(250, 4096, "packed", device="cpu")
        for lo, hi in ((0, 1000), (1000, 3000)):
            j.add(signs[lo:hi])
            t.add(signs[lo:hi])
        used = 2 * (2048 // 32)  # the two pack blocks that hold rows
        got = t._buf[:used].numpy()
        np.testing.assert_array_equal(got, np.asarray(j._buf)[:used])
        assert (got < 0).any()  # slots 1984..2047 of a block are bit 31
        assert not t._buf[used:].any()


class TestPackedKernel:
    """K4's plain version against the Pallas kernel in interpret mode."""

    @staticmethod
    def _case(n_bits, seed=0):
        rng = np.random.default_rng(seed)
        bits_pad = -(-n_bits // 128) * 128
        c = _signs(rng, 6144, n_bits)  # three pack blocks
        q = np.zeros((64, bits_pad), np.float32)
        q[:, :n_bits] = _signs(rng, 64, n_bits)  # pad columns zero
        c_pad = -np.ones((6144, bits_pad), np.float32)
        c_pad[:, :n_bits] = c
        words = jham.pack_bits_t_np(c_pad)
        mask = rng.random(6144) < 0.9
        return q, c, words, mask

    @pytest.mark.parametrize("n_bits,score_dtype", [(128, "bfloat16"),
                                                    (384, "float32")])
    def test_scores_and_bmax_match_pallas(self, n_bits, score_dtype):
        q, _, words, mask = self._case(n_bits)
        vc = 5003  # mid-block
        live = mask & (np.arange(6144) < vc)
        with pltpu.force_tpu_interpret_mode():
            s_j, _ = pallas_mips.packed_scores_with_bucket_max(
                jnp.asarray(q, jnp.bfloat16), jnp.asarray(words), block_rows=2048,
                rows_per_bucket=16, block_q=64,
                penalties=jnp.asarray(np.where(live, 0.0, -np.inf)[None], jnp.float32),
                score_dtype=getattr(jnp, score_dtype),
            )
        s_j = np.asarray(s_j).astype(np.float32)
        s, bmax = packed.packed_scores_with_bucket_max(
            _t(q).bfloat16(), _t(words), vc,
            _t(np.where(mask, 0.0, -np.inf).astype(np.float32)),
            getattr(torch, score_dtype),
        )
        assert s.dtype == getattr(torch, score_dtype)
        np.testing.assert_array_equal(s.float().numpy(), s_j)
        # contiguous 128-row buckets of the same scores (the JAX kernel's
        # buckets are strided)
        np.testing.assert_array_equal(
            bmax.numpy(), s_j.reshape(64, -1, 128).max(axis=-1))

    @pytest.mark.parametrize("n_bits", [128, 384])
    def test_packed_topk_matches_pallas_and_oracle(self, n_bits):
        q, c, words, mask = self._case(n_bits, seed=1)
        with pltpu.force_tpu_interpret_mode():
            dj, _ = pallas_mips.pallas_packed_topk(
                jnp.asarray(q), jnp.asarray(words), 10, n_bits=n_bits,
                rows_per_bucket=16, block_q=64,
                valid_count=jnp.asarray(5003, jnp.int32),
                row_mask=jnp.asarray(mask),
            )
        live = mask & (np.arange(6144) < 5003)
        d, i = hamming.packed_t_topk(_t(q), _t(words), 10, n_bits,
                                     valid_count=5003, row_mask=_t(mask))
        np.testing.assert_array_equal(_sorted(d), _sorted(dj))
        ov, _ = hamming.oracle_hamming_np(q[:, :n_bits], c[live], 10)
        np.testing.assert_array_equal(d.numpy(), ov)
        assert live[i.numpy()].all()
        assert d.dtype == torch.int32 and i.dtype == torch.int64

    @pytest.mark.parametrize("bad", ["width", "rows", "dtype", "penalty",
                                     "valid_count", "score_dtype"])
    def test_rejects_bad_inputs(self, bad):
        q = torch.zeros(4, 128, dtype=torch.bfloat16)
        w = torch.zeros(64, 128, dtype=torch.int32)
        kw = {}
        if bad == "width":
            q, w = q[:, :96].contiguous(), w[:, :96].contiguous()
        elif bad == "rows":
            w = w[:32]
        elif bad == "dtype":
            q = q.float()
        elif bad == "penalty":
            kw["penalty"] = torch.zeros(100)
        elif bad == "valid_count":
            kw["valid_count"] = 2049
        else:
            kw["score_dtype"] = torch.float16
        with pytest.raises((TypeError, ValueError)):
            packed.packed_scores_with_bucket_max(q, w, **kw)


class TestHammingKernel:
    """K5's plain version and hamming_topk against the Pallas kernel in
    interpret mode and the XLA scan (the tests/test_pallas.py codes)."""

    @pytest.fixture(scope="class")
    def codes(self):
        rng = np.random.default_rng(3)
        c_signs = np.sign(rng.standard_normal((4096, 250))).astype(np.float32)
        q_signs = np.sign(rng.standard_normal((256, 250))).astype(np.float32)
        return q_signs, c_signs, jham.pack_bits_np(q_signs), jham.pack_bits_np(c_signs)

    def test_popcount32(self):
        x = np.random.default_rng(4).integers(-2**31, 2**31, 5000).astype(np.int32)
        x[:3] = [-2**31, -1, 0]
        want = np.unpackbits(x.view(np.uint8)).reshape(-1, 32).sum(-1)
        np.testing.assert_array_equal(popcount.popcount32(_t(x)).numpy(), want)

    def test_bucket_min_is_contiguous_min(self, codes):
        _, _, qc, cc = codes
        pen = np.where(np.arange(4096) < 3000, 0, popcount.PENALTY).astype(np.int32)
        bmin = popcount.hamming_bucket_min(_t(qc[:40]), _t(cc[:4000]), _t(pen[:4000]))
        x = np.bitwise_xor(qc[:40].view(np.uint32)[:, None, :],
                           cc[:4000].view(np.uint32)[None, :, :])
        dist = np.unpackbits(x.view(np.uint8), axis=-1).sum(-1) + pen[:4000]
        dist = np.pad(dist, ((0, 0), (0, 96)), constant_values=INT32_MAX)
        np.testing.assert_array_equal(bmin.numpy(), dist.reshape(40, -1, 128).min(-1))

    @pytest.mark.parametrize("valid", [None, 3000])
    def test_topk_matches_pallas_and_xla(self, codes, valid):
        q_signs, c_signs, qc, cc = codes
        vc = None if valid is None else jnp.asarray(valid, jnp.int32)
        with pltpu.force_tpu_interpret_mode():
            dp, _ = pallas_mips.pallas_hamming_topk(
                jnp.asarray(qc), jnp.asarray(cc), k=10, rows_per_bucket=16,
                block_q=256, block_c=2048, valid_count=vc)
        dx, _ = jham.hamming_topk(jnp.asarray(qc), jnp.asarray(cc), 10, valid_count=vc)
        d, i = hamming.hamming_topk(_t(qc), _t(cc), 10, valid_count=valid)
        np.testing.assert_array_equal(_sorted(d), _sorted(dp))
        np.testing.assert_array_equal(_sorted(d), _sorted(dx))
        # every id really has its distance
        true = ((q_signs > 0)[:, None, :] != (c_signs[i.numpy()] > 0)).sum(-1)
        np.testing.assert_array_equal(true, d.numpy())
        if valid is not None:
            assert i.max() < valid

    def test_hostile_tail(self, codes):
        # tests/test_pallas.py:226-252: every row past valid_count is a copy
        # of a query (distance 0), over more than one 2048-row group
        q_signs, c_signs, qc, _ = codes
        valid = 500
        hostile = np.concatenate([c_signs[:valid]] + [q_signs] * 15)[:4096]
        cc = jham.pack_bits_np(hostile)
        with pltpu.force_tpu_interpret_mode():
            dp, _ = pallas_mips.pallas_hamming_topk(
                jnp.asarray(qc), jnp.asarray(cc), k=10, rows_per_bucket=16,
                block_q=256, block_c=2048,
                valid_count=jnp.asarray(valid, jnp.int32))
        d, i = hamming.hamming_topk(_t(qc), _t(cc), 10, valid_count=valid)
        assert i.max() < valid
        ov, _ = hamming.oracle_hamming_np(q_signs, hostile[:valid], 10)
        np.testing.assert_array_equal(d.numpy(), ov)
        np.testing.assert_array_equal(_sorted(d), _sorted(dp))

    def test_row_mask_bait(self):
        # tests/test_filtered.py:289: every masked row is a copy of a query
        r = np.random.default_rng(3)
        q = np.where(r.random((256, 250)) < 0.5, 1.0, -1.0)
        c = np.where(r.random((4096, 250)) < 0.5, 1.0, -1.0)
        mask = r.random(4096) < 0.5
        c[~mask] = q[r.integers(0, 256, (~mask).sum())]
        qc, cc = jham.pack_bits_np(q), jham.pack_bits_np(c)
        with pltpu.force_tpu_interpret_mode():
            dp, _ = pallas_mips.pallas_hamming_topk(
                jnp.asarray(qc), jnp.asarray(cc), k=10, rows_per_bucket=16,
                block_q=256, block_c=2048, row_mask=jnp.asarray(mask))
        d, i = hamming.hamming_topk(_t(qc), _t(cc), 10, row_mask=_t(mask))
        assert mask[i.numpy()].all()
        ov, _ = hamming.oracle_hamming_np(q, c[mask], 10)
        np.testing.assert_array_equal(d.numpy(), ov)
        np.testing.assert_array_equal(_sorted(d), _sorted(dp))

    @pytest.mark.parametrize("k", [40, 70])  # beyond 32 buckets; beyond 60 rows
    def test_k_beyond_buckets_and_rows(self, codes, k):
        q_signs, c_signs, qc, cc = codes
        n = 4096 if k == 40 else 60
        dx, ix = jham.hamming_topk(jnp.asarray(qc[:8]), jnp.asarray(cc[:n]), k)
        d, i = hamming.hamming_topk(_t(qc[:8]), _t(cc[:n]), k)
        np.testing.assert_array_equal(_sorted(d), _sorted(dx))
        np.testing.assert_array_equal(i.numpy() < 0, np.asarray(ix) < 0)
        assert (d.numpy()[i.numpy() < 0] == INT32_MAX).all()
        ov, _ = hamming.oracle_hamming_np(q_signs[:8], c_signs[:n], k)
        np.testing.assert_array_equal(d.numpy()[:, : min(k, n)], ov)

    @pytest.mark.parametrize("bad", ["width", "dtype", "penalty"])
    def test_rejects_bad_inputs(self, bad):
        q = torch.zeros(4, 8, dtype=torch.int32)
        c = torch.zeros(300, 8, dtype=torch.int32)
        pen = None
        if bad == "width":
            c = torch.zeros(300, 9, dtype=torch.int32)
        elif bad == "dtype":
            c = c.long()
        else:
            pen = torch.zeros(300)
        with pytest.raises((TypeError, ValueError)):
            popcount.hamming_bucket_min(q, c, pen)


class TestSignTopk:
    def test_matches_jax_sign_topk(self):
        rng = np.random.default_rng(5)
        c = _signs(rng, 3000, 96)
        q = c[:6]
        mask = rng.random(3000) < 0.3
        dj, _ = jham.sign_topk(jnp.asarray(q), jnp.asarray(c), 7, n_bits=96,
                               row_mask=jnp.asarray(mask), valid_count=2500)
        d, i = hamming.sign_topk(_t(q), _t(c), 7, 96, row_mask=_t(mask),
                                 valid_count=2500)
        np.testing.assert_array_equal(_sorted(d), _sorted(dj))
        assert mask[i.numpy()].all() and i.max() < 2500

    def test_approx_mode_raises(self):
        # 'approx' runs the exact selection (the JAX CPU approx_max_k is
        # exact too); a mode JAX does not have raises
        rng = np.random.default_rng(6)
        c = _signs(rng, 2000, 64)
        q = c[:5]
        dj, _ = jham.sign_topk(jnp.asarray(q), jnp.asarray(c), 9, n_bits=64,
                               mode="approx", recall_target=0.9)
        d, _ = hamming.sign_topk(_t(q), _t(c), 9, 64, mode="approx", recall_target=0.9)
        np.testing.assert_array_equal(_sorted(d), _sorted(dj))
        de, _ = hamming.sign_topk(_t(q), _t(c), 9, 64, chunk_size=700)
        np.testing.assert_array_equal(_sorted(de), _sorted(dj))
        with pytest.raises(ValueError, match="selection mode"):
            hamming.sign_topk(_t(q), _t(c), 1, 64, mode="fast")
        with pytest.raises(ValueError, match="recall_target"):
            hamming.sign_topk(_t(q), _t(c), 1, 64, mode="approx", recall_target=1.5)


class TestBinaryIndex:
    @staticmethod
    def _pair(mode, n_bits=250, capacity=4096):
        j = JaxBinaryIndex(n_bits, capacity, mode=mode,
                           use_pallas=mode == "packed", interpret=True)
        return j, BinaryIndex(n_bits, capacity, mode, device="cpu")

    @pytest.mark.parametrize("mode", ["packed", "sign"])
    def test_streaming_adds_match_jax_and_oracle(self, mode):
        rng = np.random.default_rng(6)
        c = _signs(rng, 3001, 250)
        q = _signs(rng, 13, 250)
        j, t = self._pair(mode)
        for lo, hi in ((0, 1000), (1000, 3001)):  # odd sizes
            j.add(c[lo:hi])
            t.add(c[lo:hi])
            with pltpu.force_tpu_interpret_mode():
                dj, _ = j.search(q, 7)
            d, i = t.search(q, 7)
            assert d.dtype == np.int32 and i.dtype == np.int64
            np.testing.assert_array_equal(_sorted(d), _sorted(dj))
            ov, _ = hamming.oracle_hamming_np(q, c[:hi], 7)
            np.testing.assert_array_equal(d, ov)
            assert i.max() < hi
        assert t.ntotal == 3001

    @pytest.mark.parametrize("mode", ["packed", "sign"])
    def test_k_beyond_bucket_count(self, mode):
        rng = np.random.default_rng(7)
        c = _signs(rng, 3001, 64)
        t = BinaryIndex(64, 4096, mode, device="cpu")
        t.add(c)
        d, i = t.search(c[:5], 40)  # more than the 32 buckets scanned
        ov, _ = hamming.oracle_hamming_np(c[:5], c, 40)
        np.testing.assert_array_equal(d, ov)

    @pytest.mark.parametrize("mode", ["packed", "sign"])
    def test_k_beyond_size_pads_missing(self, mode):
        rng = np.random.default_rng(8)
        c = _signs(rng, 50, 250)
        j, t = self._pair(mode)
        j.add(c)
        t.add(c)
        with pltpu.force_tpu_interpret_mode():
            dj, _ = j.search(c[:4], 60)
        d, i = t.search(c[:4], 60)
        assert (i[:, 50:] == -1).all() and (d[:, 50:] == INT32_MAX).all()
        assert (i[:, :50] >= 0).all()
        ov, _ = hamming.oracle_hamming_np(c[:4], c, 50)
        np.testing.assert_array_equal(d[:, :50], ov)
        np.testing.assert_array_equal(d, np.asarray(dj))

    @pytest.mark.parametrize("mode", ["packed", "sign"])
    @pytest.mark.parametrize("length", ["size", "capacity"])
    def test_row_mask(self, mode, length):
        rng = np.random.default_rng(9)
        c = _signs(rng, 300, 64)
        mask = rng.random(300) < 0.3
        j, t = self._pair(mode, n_bits=64, capacity=512)
        j.add(c)
        t.add(c)
        full = mask if length == "size" else np.pad(mask, (0, 212))
        with pltpu.force_tpu_interpret_mode():
            dj, _ = j.search(c[:6], 5, row_mask=full)
        d, i = t.search(c[:6], 5, row_mask=full)
        assert mask[i].all()
        ov, _ = hamming.oracle_hamming_np(c[:6], c[mask], 5)
        np.testing.assert_array_equal(d, ov)
        np.testing.assert_array_equal(_sorted(d), _sorted(dj))

    def test_row_mask_of_wrong_length_raises(self):
        t = BinaryIndex(64, 512, "packed", device="cpu")
        t.add(np.ones((10, 64)))
        with pytest.raises(ValueError, match="row_mask"):
            t.search(np.ones((1, 64)), 3, row_mask=np.ones(11, bool))

    @pytest.mark.parametrize("mode", ["packed", "sign"])
    def test_reconstruct_matches_jax(self, mode):
        rng = np.random.default_rng(10)
        c = _signs(rng, 2100, 250)  # slots past one pack block
        j, t = self._pair(mode)
        j.add(c)
        t.add(c)
        ids = np.array([0, 63, 64, 1984, 2047, 2048, 2099])
        np.testing.assert_array_equal(t.reconstruct_batch(ids), c[ids])
        np.testing.assert_array_equal(t.reconstruct_batch(ids), j.reconstruct_batch(ids))
        np.testing.assert_array_equal(t.reconstruct(5), c[5])
        with pytest.raises(IndexError):
            t.reconstruct_batch([2100])

    def test_capacity_overflow_raises(self):
        t = BinaryIndex(64, 100, "packed", device="cpu")
        with pytest.raises(ValueError, match="full"):
            t.add(np.ones((101, 64)))

    @pytest.mark.parametrize("call", ["remove_ids", "range_search", "merge_from",
                                      "save", "load"])
    def test_unported_methods_raise(self, call, tmp_path):
        # every verb is ported; each still refuses what the JAX index refuses
        t = BinaryIndex(64, 100, "packed", device="cpu")
        t.add(np.ones((10, 64)))
        if call == "remove_ids":
            with pytest.raises(ValueError, match="remove ids"):
                t.remove_ids([10])
        elif call == "range_search":
            a = BinaryIndex(64, 100, "sign", device="cpu", selection="approx")
            with pytest.raises(ValueError, match="selection='exact'"):
                a.range_search(np.ones((1, 64)), 3.0)
        elif call == "merge_from":
            with pytest.raises(TypeError, match="BinaryIndex"):
                t.merge_from(object())
            with pytest.raises(ValueError, match="width"):
                t.merge_from(BinaryIndex(32, 10, device="cpu"))
        else:
            t.save(str(tmp_path / "b"))
            with pytest.raises(ValueError, match="capacity"):
                BinaryIndex.load(str(tmp_path / "b"), capacity=5, device="cpu")

    def test_approx_selection_raises(self):
        with pytest.raises(ValueError, match="sign-matmul"):
            BinaryIndex(64, 100, "packed", device="cpu", selection="approx")
        with pytest.raises(ValueError, match="selection"):
            BinaryIndex(64, 100, "sign", device="cpu", selection="fast")
        a = BinaryIndex(64, 100, "sign", device="cpu", selection="approx", recall_target=0.9)
        assert (a.selection, a.recall_target) == ("approx", 0.9)


class TestCodes:
    def test_simhash_codes_match_jax(self):
        rng = np.random.default_rng(11)
        emb = rng.standard_normal((500, 48)).astype(np.float32)
        want = jham.simhash_codes(emb, 96, seed=3)
        np.testing.assert_array_equal(hamming.simhash_codes(emb, 96, seed=3), want)
        # on a tensor: f32 products in another order may flip a near-zero
        # dot, so bits are compared where the f64 projection is not tiny
        got = hamming.simhash_codes(_t(emb), 96, seed=3).numpy()
        R = np.random.default_rng(3).standard_normal((48, 96)).astype(np.float32)
        firm = np.abs(emb.astype(np.float64) @ R.astype(np.float64)) > 1e-4
        np.testing.assert_array_equal(got[firm], want[firm])

    def test_fit_itq_matches_jax(self):
        rng = np.random.default_rng(12)
        emb = rng.standard_normal((3000, 64)).astype(np.float32)
        pj = jproj.fit_itq(emb, 32, iters=10, sample=2000)
        pt = projection.fit_itq(emb, 32, iters=10, sample=2000)
        np.testing.assert_allclose(pt.mean, pj.mean, atol=1e-6, rtol=0)
        np.testing.assert_allclose(pt.components, pj.components, atol=1e-6, rtol=0)
        assert abs(pt.explained - pj.explained) <= 1e-6
        # a tensor fits to the same projector
        pt2 = projection.fit_itq(_t(emb), 32, iters=10, sample=2000)
        np.testing.assert_allclose(pt2.components, pt.components, atol=1e-6, rtol=0)
        want = jproj.itq_codes(emb, pj)
        np.testing.assert_array_equal(projection.itq_codes(emb, pt), want)

    def test_fit_pca_and_projector_match_jax(self):
        rng = np.random.default_rng(13)
        emb = rng.standard_normal((400, 40)).astype(np.float32)
        pj = jproj.fit_pca(emb, 16)
        pt = projection.fit_pca(emb, 16)
        np.testing.assert_allclose(pt.components, pj.components, atol=1e-6, rtol=0)
        want = pj(emb)
        np.testing.assert_allclose(pt(emb), want, atol=1e-6, rtol=0)
        np.testing.assert_allclose(pt(_t(emb)).numpy(), want, atol=1e-5, rtol=0)
        # the JAX projector is accepted as it is by the port's code paths
        np.testing.assert_allclose(projection.PCAProjector(*pj)(emb), want,
                                   atol=1e-6, rtol=0)
