"""The port's all-heads training soak
(``sessionsimilaritysearch_tpu_torch.examples.training_soak``), in-process
at tiny widths: the forced NaN reaches every loss term, ``run_training``
drops the poisoned update with the parameters and statistics restored bit
for bit, a fresh state resumes past the checkpoint, every logged loss is
finite, and the exit code says whether the drill and the resume held."""

import json

import numpy as np
import pytest
import torch

from sessionsimilaritysearch_tpu_torch.examples import training_soak


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # these cases run small tensors through many ops; under the suite's
    # parallel workers one intra-op thread each avoids oversubscribing
    # the cores
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _soak(tmp, *extra):
    out = tmp / "soak.json"
    rc = training_soak.main(["--device", "cpu", "--tiny", "--savedir", str(tmp / "run"),
                             "--out", str(out), *extra])
    return rc, json.loads(out.read_text())


@pytest.fixture(scope="module")
def soak(tmp_path_factory):
    return _soak(tmp_path_factory.mktemp("tsoak"))


def _events(result, kind):
    return [e for e in result["events"] if e["event"] == kind]


def test_exit_code_zero(soak):
    assert soak[0] == 0


def test_drill_reaches_every_loss_term(soak):
    _, result = soak
    (caught,) = _events(result, "nan_caught")
    assert caught["step"] == _events(result, "nan_injected")[0]["step"] == 8
    assert caught["finite_terms"] == []


def test_rollback_bit_for_bit(soak):
    _, result = soak
    (check,) = _events(result, "rollback_checked")
    assert check["step"] == 8 and check["bit_exact"]


def test_resume_continues_past_the_checkpoint(soak):
    _, result = soak
    # tiny: 16 steps, the checkpoint after step 5, the crash after 10 steps
    # (one dropped by the drill, so the state stood at 9)
    (crash,) = _events(result, "simulated_crash")
    assert crash["step"] == 9
    assert result["steps_total"] == 16 > 5


def test_logged_losses_finite(soak):
    _, result = soak
    assert result["loss_curve_every50"]
    values = result["loss_curve_every50"] + [result["loss_first20"], result["loss_last20"]]
    assert all(np.isfinite(values))
    assert result["loss_weights"] == training_soak.SOAK_WEIGHTS


def test_exit_code_one_without_the_drill(tmp_path):
    rc, result = _soak(tmp_path, "--nan-step", "999")
    assert rc == 1
    assert not _events(result, "nan_caught")


def test_soak_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is it")
    with pytest.raises(RuntimeError, match="cuda"):
        training_soak.main(["--tiny", "--savedir", str(tmp_path)])
