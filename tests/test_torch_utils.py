"""The port's utilities (sessionsimilaritysearch_tpu_torch.utils): a
counterpart of each JAX ``TestSanitizers`` case (tests/test_infra.py) on the
port's pretrain step and ops, the profiling helpers (``trace``,
``device_profile``, ``PhaseTimer.timed`` and its ``sync`` switch), and the
names the port's ``models`` and ``utils`` export beside the JAX package's.
Inputs are the tiny config's seeded synthetic sessions."""

import glob
import json
import os

import numpy as np
import pytest
import torch

import sessionsimilaritysearch_tpu.models as j_models
import sessionsimilaritysearch_tpu.utils as j_utils
import sessionsimilaritysearch_tpu_torch.models as t_models
import sessionsimilaritysearch_tpu_torch.utils as t_utils
from sessionsimilaritysearch_tpu_torch.config import tiny_test_config
from sessionsimilaritysearch_tpu_torch.data import SyntheticSessionGenerator, build_graph_batch
from sessionsimilaritysearch_tpu_torch.evalharness.harness import to_device
from sessionsimilaritysearch_tpu_torch.index.dense import DenseIndex
from sessionsimilaritysearch_tpu_torch.tokenizer import get_tokenizer
from sessionsimilaritysearch_tpu_torch.training.pretrain import (
    create_pretrain_state,
    make_train_step,
)
from sessionsimilaritysearch_tpu_torch.utils import (
    PhaseTimer,
    assert_donates,
    assert_pure,
    debug_nans,
    trace,
)
from sessionsimilaritysearch_tpu_torch.utils.profiling import device_profile

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these small tensors gain nothing from more, and
    the suite's workers share the machine's cores (oversubscribed, the
    training calls here ran ~8x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("pair", ["models", "utils"])
def test_port_exports_every_jax_name(pair):
    jax_mod, port_mod = {"models": (j_models, t_models), "utils": (j_utils, t_utils)}[pair]
    names = {n for n in vars(jax_mod) if not n.startswith("_")
             and not isinstance(getattr(jax_mod, n), type(os))}
    missing = sorted(n for n in names if not hasattr(port_mod, n))
    assert not missing, missing


@pytest.fixture(scope="module")
def pretrain():
    cfg = tiny_test_config()
    tok = get_tokenizer(cfg.vocab_size)
    data = SyntheticSessionGenerator(asin_num=cfg.asin_num, seed=0).dataset(4)
    batch = to_device(build_graph_batch(data, tok, cfg.dims), CPU)
    return cfg, batch


def _one_step(cfg, batch):
    """One pretrain step from the seed's state: the loss."""
    model, state = create_pretrain_state(cfg, CPU)
    return make_train_step(model)(state, batch)[1]["loss"]


def test_train_step_clean_under_debug_nans(pretrain):
    """The real pretrain step, forward and backward, makes no NaN with NaN
    trapping on (and anomaly mode off again afterwards)."""
    cfg, batch = pretrain
    before = torch.is_anomaly_enabled()
    with debug_nans():
        assert torch.is_anomaly_enabled()
        loss = _one_step(cfg, batch)
    assert torch.is_anomaly_enabled() == before
    assert np.isfinite(float(loss))


def test_debug_nans_traps():
    with debug_nans():
        with pytest.raises(FloatingPointError, match="log"):
            torch.log(torch.tensor(-1.0))
        # infinities pass, as under jax_debug_nans
        assert torch.isinf(torch.log(torch.tensor(0.0)))
        # a NaN made by the backward alone: d|x|^0.5/dx at 0 is inf * 0
        x = torch.tensor([0.0, 1.0], requires_grad=True)
        y = x.abs().pow(0.5).sum()
        with pytest.raises(FloatingPointError), pytest.warns(UserWarning):
            y.backward()
    # outside the scope nothing is trapped
    assert torch.isnan(torch.log(torch.tensor(-1.0)))
    with debug_nans(enable=False):
        assert torch.isnan(torch.log(torch.tensor(-1.0)))


def test_debug_nans_skips_unwritten_memory():
    with debug_nans():
        buf = torch.empty(64)
        buf.fill_(1.0)
        assert float(buf.sum()) == 64.0


def test_assert_pure_passes_and_catches():
    def pure(x):
        return {"y": x * 2.0 + 1.0, "n": [x.sum(), 3]}

    out = assert_pure(pure, torch.arange(4.0))
    assert torch.equal(out["y"], torch.tensor([1.0, 3.0, 5.0, 7.0]))

    counter = {"n": 0}

    def impure(x):
        counter["n"] += 1
        return x * counter["n"]

    with pytest.raises(AssertionError, match="impure"):
        assert_pure(impure, torch.arange(4.0))
    # a bit-level difference (-0.0 against 0.0) is caught too
    signs = iter([0.0, -0.0])
    with pytest.raises(AssertionError):
        assert_pure(lambda: torch.tensor(next(signs)))


def test_train_step_is_pure(pretrain):
    """Two steps from the same seeded state and batch give the same loss bit
    for bit; a step on a state carried over from the first call does not
    (the port's step updates its state in place)."""
    cfg, batch = pretrain
    assert_pure(_one_step, cfg, batch)
    model, state = create_pretrain_state(cfg, CPU)
    step = make_train_step(model)
    with pytest.raises(AssertionError):
        assert_pure(lambda: step(state, batch)[1]["loss"])


def test_assert_donates():
    idx = DenseIndex(4, 16, device=CPU)
    rows = torch.ones(2, 4)

    def write_rows(buf, rows):
        idx._append(rows, None)
        return idx._buf

    out = assert_donates(write_rows, idx._buf, rows)
    assert out[0, 0] == 1.0 and idx.size == 2

    def copies(buf, rows):  # the torch form of a dropped donation
        return buf + 0.0

    with pytest.raises(AssertionError, match="copy"):
        assert_donates(copies, torch.zeros(8, 4), rows)

    def reads(buf, rows):  # returns the buffer but never writes it
        return buf

    with pytest.raises(AssertionError):
        assert_donates(reads, torch.zeros(8, 4), rows)


def test_trace_spans_show_in_the_profile(tmp_path):
    with device_profile(str(tmp_path)) as prof:
        with trace("sss span"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    assert "sss span" in {e.key for e in prof.key_averages()}
    files = glob.glob(str(tmp_path / "trace_*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "sss span" for e in events)


@pytest.mark.parametrize("sync", [True, False])
def test_phase_timer_timed(sync):
    timer = PhaseTimer(CPU, sync=sync)
    out = timer.timed("mm", torch.matmul, torch.ones(4, 4), torch.ones(4, 4))
    assert torch.equal(out, torch.full((4, 4), 4.0))
    with timer("mm"):
        pass
    with timer("add"):
        torch.ones(3) + 1
    s = timer.summary()
    assert timer.sync is sync
    assert s["mm"]["count"] == 2 and s["add"]["count"] == 1
    assert s["mm"]["total_s"] >= 0 and s["mm"]["mean_ms"] >= 0
