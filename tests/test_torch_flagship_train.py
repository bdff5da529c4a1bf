"""The port's flagship training run
(``sessionsimilaritysearch_tpu_torch.examples.flagship_train``), both
phases at a tiny config (the module's ``make_config`` patched: the script
has no width flag): the summary's keys are JAX's with ``compile_step_s`` ->
``first_step_s`` and ``platform`` -> ``device``; ``steps`` is the batch
count of JAX's loader on the same sessions; a fresh state restores the
saved step and continues to ``final + resume_steps``; the losses are
finite."""

import numpy as np
import pytest
import torch

from sessionsimilaritysearch_tpu.config import tiny_test_config as jax_tiny_config
from sessionsimilaritysearch_tpu.data.loader import SessionGraphLoader as JaxLoader
from sessionsimilaritysearch_tpu.data.synthetic import SyntheticSessionGenerator
from sessionsimilaritysearch_tpu.tokenizer import get_tokenizer as jax_tokenizer
from sessionsimilaritysearch_tpu_torch.config import tiny_test_config
from sessionsimilaritysearch_tpu_torch.examples import flagship_train

STEPS, RESUME_STEPS, BATCH, ASINS = 10, 4, 8, 1000
PHASES = ("pretrain", "subsession")
JAX_KEYS = ["phase", "asin_num", "batch_size", "params_m", "steps", "compile_step_s",
            "step_ms_median", "step_ms_p90", "sessions_per_s", "loss_first10_mean",
            "loss_last10_mean", "train_wall_s", "platform", "resume_check",
            "loss_resumed10_mean"]
RENAMED = {"compile_step_s": "first_step_s", "platform": "device"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # small tensors through many ops: one intra-op thread per suite worker
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def summaries(tmp_path_factory):
    savedir = tmp_path_factory.mktemp("flagship_train")
    mp = pytest.MonkeyPatch()
    mp.setattr(flagship_train, "make_config", lambda a: tiny_test_config(
        asin_num=a.asin_num, batch_size=a.batch_size, savedir=a.savedir, seed=a.seed))
    try:
        return {phase: flagship_train.main([
            "--device", "cpu", "--phase", phase, "--steps", str(STEPS),
            "--resume-steps", str(RESUME_STEPS), "--batch-size", str(BATCH),
            "--asin-num", str(ASINS), "--savedir", str(savedir)]) for phase in PHASES}
    finally:
        mp.undo()


@pytest.mark.parametrize("phase", PHASES)
def test_keys_are_jax_keys_renamed(summaries, phase):
    s = summaries[phase]
    assert list(s) == [RENAMED.get(k, k) for k in JAX_KEYS]
    assert s["phase"] == phase and s["device"] == "cpu"
    assert s["asin_num"] == ASINS and s["batch_size"] == BATCH and s["params_m"] > 0


@pytest.mark.parametrize("phase", PHASES)
def test_steps_are_jax_loaders_batch_count(summaries, phase):
    # the script's sessions: steps * batch + batch of the generator seeded
    # with the config's seed, in batches of `batch` without drop_last
    cfg = jax_tiny_config(asin_num=ASINS, batch_size=BATCH)
    data = SyntheticSessionGenerator(asin_num=ASINS, seed=cfg.seed).dataset(
        STEPS * BATCH + BATCH)
    loader = JaxLoader(data, jax_tokenizer(cfg.vocab_size), cfg.dims, BATCH,
                       ignore_query=cfg.ignore_query, seed=cfg.seed)
    assert summaries[phase]["steps"] == len(loader) == sum(1 for _ in loader) == STEPS + 1


@pytest.mark.parametrize("phase", PHASES)
def test_resume_restores_and_continues(summaries, phase):
    s = summaries[phase]
    final = s["steps"]
    assert s["resume_check"] == (f"restored step {final}, continued to "
                                 f"{final + RESUME_STEPS}")


@pytest.mark.parametrize("phase", PHASES)
def test_losses_and_times_finite(summaries, phase):
    s = summaries[phase]
    for key in ("loss_first10_mean", "loss_last10_mean", "loss_resumed10_mean",
                "first_step_s", "step_ms_median", "step_ms_p90", "sessions_per_s"):
        assert np.isfinite(s[key]), key
    assert s["step_ms_p90"] >= s["step_ms_median"] > 0
