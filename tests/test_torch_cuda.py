"""Card-only tests of the PyTorch port: the CUDA kernel against its plain
PyTorch version, and the index and engine on the card against the CPU.

Every test here carries the ``cuda`` marker and skips where
``torch.cuda.is_available()`` is False. The file imports no JAX, so on a
machine with a card and no JAX it runs without the repository's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import sessionsimilaritysearch_tpu_torch as port
from sessionsimilaritysearch_tpu_torch.index.dense import DenseIndex
from sessionsimilaritysearch_tpu_torch.ops import mips

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
