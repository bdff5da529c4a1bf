"""Card-only tests of the PyTorch port: the CUDA kernels (K1 scores_bmax,
K4 packed_scores_bmax, K5 hamming_bucket_min) against their plain PyTorch
versions, and the indexes and engine on the card against the CPU.

Every test here carries the ``cuda`` marker and skips where
``torch.cuda.is_available()`` is False. The file imports no JAX, so on a
machine with a card and no JAX it runs without the repository's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import sessionsimilaritysearch_tpu_torch as port
from sessionsimilaritysearch_tpu_torch.index.binary import BinaryIndex
from sessionsimilaritysearch_tpu_torch.index.dense import DenseIndex
from sessionsimilaritysearch_tpu_torch.index.twostage import TwoStageIndex
from sessionsimilaritysearch_tpu_torch.ops import hamming, mips, packed, popcount

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    # decided inside the fixture, never at import: every xdist worker then
    # collects the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [200, 37])  # 37: no 16-byte rows, scalar loads
def test_kernel_matches_plain(dev, dtype, d):
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(37, d, device=dev, generator=g).to(dtype)
    c = torch.randn(5003, d, device=dev, generator=g).to(dtype)
    pen = torch.where(torch.rand(5003, device=dev, generator=g) < 0.1,
                      float("-inf"), 0.0)
    before = mips.launch_count
    s, bmax = mips.scores_with_bucket_max(q, c, 4037, pen, dtype)
    torch.cuda.synchronize()
    assert mips.launch_count == before + 1
    s_ref, bmax_ref = mips.scores_with_bucket_max_ref(q, c, 4037, pen, dtype)
    # f32: another summation order. bf16 scores: both sides round the f32
    # value to nearest even, so they differ by at most one ulp (2^-7 rel)
    torch.testing.assert_close(bmax, bmax_ref, atol=1e-3, rtol=1e-5)
    rtol = 1e-5 if dtype == torch.float32 else 2.0**-7
    torch.testing.assert_close(s.float(), s_ref.float(), atol=1e-3, rtol=rtol)


def test_kernel_rejects_mismatched_dtypes(dev):
    q = torch.zeros(4, 16, device=dev)
    c = torch.zeros(300, 16, device=dev, dtype=torch.bfloat16)
    before = mips.launch_count
    with pytest.raises(TypeError):
        mips.scores_with_bucket_max(q, c)
    assert mips.launch_count == before


def test_dense_index_search_launches_kernel(dev):
    rng = np.random.default_rng(0)
    rows = rng.standard_normal((3000, 64)).astype(np.float32)
    on_card = DenseIndex(64, 4096, device=dev, chunk_size=1024)
    on_cpu = DenseIndex(64, 4096, device="cpu", chunk_size=1024)
    on_card.add(rows)
    on_cpu.add(rows)
    mask = rng.random(3000) < 0.5
    before = mips.launch_count
    D, I = on_card.search(rows[:16], 5, row_mask=mask)
    assert mips.launch_count == before + 3  # one launch per 1024-row chunk
    Dc, Ic = on_cpu.search(rows[:16], 5, row_mask=mask)
    np.testing.assert_allclose(D, Dc, atol=1e-5, rtol=0)
    assert mask[I].all()


def test_engine_on_card_matches_cpu(dev):
    cfg = port.tiny_test_config()
    tok = port.get_tokenizer(cfg.vocab_size)
    data = port.SyntheticSessionGenerator(asin_num=cfg.asin_num, seed=0).dataset(60)
    enc_cpu = port.build_graph_encoder(cfg, "cpu")
    enc_card = port.build_graph_encoder(cfg, dev)
    enc_card.load_state_dict(enc_cpu.state_dict())  # the same weights
    kw = dict(dim=cfg.session_emb_dim, capacity=128, batch_size=16)
    cpu = port.SessionSearchEngine(cfg, tok, enc_cpu, device="cpu", **kw)
    card = port.SessionSearchEngine(cfg, tok, enc_card, device=dev, **kw)
    cpu.add_sessions(data)
    card.add_sessions(data)
    before = mips.launch_count
    Dg, Ig = card.search(data[:10], k=5)
    assert mips.launch_count > before
    Dc, Ic = cpu.search(data[:10], k=5)
    np.testing.assert_allclose(Dg, Dc, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(Ig[:, 0], np.arange(10))


def _signs(g, rows, bits, dev):
    return torch.where(torch.rand(rows, bits, generator=g, device=dev) < 0.5, 1.0, -1.0)


@pytest.mark.parametrize("n_bits", [250, 384])
def test_packed_kernel_matches_plain(dev, n_bits):
    # q=37 (ragged tile), three pack blocks, valid_count mid-block, 10% masked
    g = torch.Generator(device=dev).manual_seed(0)
    bits_pad = -(-n_bits // 128) * 128
    words = hamming.pack_bits_t(torch.nn.functional.pad(
        _signs(g, 6144, n_bits, dev), (0, bits_pad - n_bits), value=-1.0))
    q = torch.nn.functional.pad(_signs(g, 37, n_bits, dev),
                                (0, bits_pad - n_bits)).bfloat16()
    pen = torch.where(torch.rand(6144, generator=g, device=dev) < 0.1,
                      float("-inf"), 0.0)
    sd = torch.bfloat16 if n_bits <= 256 else torch.float32
    before = packed.launch_count
    s, bmax = packed.packed_scores_with_bucket_max(q, words, 5003, pen, sd)
    torch.cuda.synchronize()
    assert packed.launch_count == before + 1
    s_ref, bmax_ref = packed.packed_scores_with_bucket_max_ref(q, words, 5003, pen, sd)
    # +-1 products are small integers: exact on both sides
    assert torch.equal(s, s_ref)
    assert torch.equal(bmax, bmax_ref)
    d, i = packed.packed_topk(q, words, 10, n_bits, 5003, pen)
    assert packed.launch_count == before + 2
    d_ref, _ = hamming.oracle_hamming_np(
        q.float().cpu().numpy()[:, :n_bits],
        hamming.unpack_bits_t(words).float().cpu().numpy()[:5003][
            (pen[:5003] == 0).cpu().numpy(), :n_bits], 10)
    np.testing.assert_array_equal(d.cpu().numpy(), d_ref)


def test_hamming_kernel_matches_plain(dev):
    g = torch.Generator(device=dev).manual_seed(1)
    c = hamming.pack_bits(_signs(g, 6144, 250, dev))
    q = hamming.pack_bits(_signs(g, 37, 250, dev))
    live = torch.rand(6144, generator=g, device=dev) < 0.9
    live[5003:] = False
    pen = torch.where(live, 0, popcount.PENALTY).to(torch.int32)
    before = popcount.launch_count
    bmin = popcount.hamming_bucket_min(q, c, pen)
    torch.cuda.synchronize()
    assert popcount.launch_count == before + 1
    assert torch.equal(bmin, popcount.hamming_bucket_min_ref(q, c, pen))
    # a ragged corpus (a partial last bucket and block), no penalty
    assert torch.equal(popcount.hamming_bucket_min(q, c[:5003]),
                       popcount.hamming_bucket_min_ref(q, c[:5003]))
    d, i = hamming.hamming_topk(q, c, 10, valid_count=5003, row_mask=live)
    d_ref, i_ref = hamming.hamming_topk(q.cpu(), c.cpu(), 10, valid_count=5003,
                                        row_mask=live.cpu())
    np.testing.assert_array_equal(d.cpu().numpy(), d_ref.numpy())
    assert live[i].all()


@pytest.mark.parametrize("mode", ["packed", "sign"])
def test_binary_index_launches_kernel(dev, mode):
    rng = np.random.default_rng(0)
    c = np.where(rng.random((5003, 250)) < 0.5, 1.0, -1.0).astype(np.float32)
    on_card = BinaryIndex(250, 6000, mode, device=dev)
    on_cpu = BinaryIndex(250, 6000, mode, device="cpu")
    for lo, hi in ((0, 1000), (1000, 5003)):
        on_card.add(c[lo:hi])
        on_cpu.add(c[lo:hi])
    assert torch.equal(on_card._buf.cpu(), on_cpu._buf)
    mask = rng.random(5003) < 0.5
    counter = packed if mode == "packed" else mips
    before = counter.launch_count
    D, I = on_card.search(c[:16], 10, row_mask=mask)
    assert counter.launch_count == before + 1
    Dc, _ = on_cpu.search(c[:16], 10, row_mask=mask)
    np.testing.assert_array_equal(D, Dc)
    assert mask[I].all()


def test_twostage_index_launches_kernel(dev):
    rng = np.random.default_rng(0)
    rows = rng.standard_normal((3000, 64)).astype(np.float32)
    proj = torch.from_numpy(rng.standard_normal((64, 128)).astype(np.float32))
    kw = dict(prefilter="binary", n_bits=128, stage1="packed", projection=proj)
    on_card = TwoStageIndex(64, 4096, device=dev, **kw)
    on_cpu = TwoStageIndex(64, 4096, device="cpu", **kw)
    on_card.add(rows)
    on_cpu.add(rows)
    before = packed.launch_count
    # the pool holds every row: the codes of a near-zero projection may
    # differ between the card's and the CPU's f32 sums, the result may not
    D, I = on_card.search(rows[:16], 5, pool=4096)
    assert packed.launch_count == before + 1
    Dc, _ = on_cpu.search(rows[:16], 5, pool=4096)
    np.testing.assert_allclose(D, Dc, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(I[:, 0], np.arange(16))
