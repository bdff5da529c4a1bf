"""``dryrun.entry()``, the port's twin of ``__graft_entry__.entry()``: the
flagship encoder and 8 example sessions at the reduced widths, against
JAX's on carried weights, and the default device's refusal without a
card."""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__
from sessionsimilaritysearch_tpu_torch import dryrun
from sessionsimilaritysearch_tpu_torch.weights import flax_to_state_dict


def test_entry_matches_jax():
    fn, (params, batch) = __graft_entry__.entry()
    want = np.asarray(jax.jit(fn)(params, batch))
    tfn, (enc, graph) = dryrun.entry(device="cpu")
    assert graph.adj_qp.device.type == "cpu"
    np.testing.assert_array_equal(graph.adj_qp.numpy(), batch.adj_qp)
    enc.load_state_dict(flax_to_state_dict(params), strict=True)
    got = tfn(enc, graph).numpy()
    assert got.shape == want.shape == (8, 512)
    # tests/test_torch_models.py's whole-encoder tolerance: rounding grows
    # with the activations' scale, so atol is 1e-5 of the largest output
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=1e-4)


def test_entry_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: entry() runs on it")
    with pytest.raises(RuntimeError, match="cuda"):
        dryrun.entry()
