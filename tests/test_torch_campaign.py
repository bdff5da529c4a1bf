"""The port's campaign script
(``sessionsimilaritysearch_tpu_torch.examples.flagship_campaign``): the
crash / resume drill of ``tests/test_campaign.py`` run as two real
subprocesses -- the first ends with ``os._exit(3)`` at step 18, between the
step-16 checkpoint and the next, the second restores it, fast-forwards the
shuffled order and finishes -- with exact step accounting, one monotone loss
curve across both processes and the replayed steps' losses reproduced; the
subprocesses load neither JAX nor the JAX package. In-process: the per-epoch
batch order against the JAX campaign's loader, the cached-text step's loss
against the uncached one's, and a resume that refuses checkpoints of two
different steps."""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from sessionsimilaritysearch_tpu.config import tiny_test_config as jax_tiny_config
from sessionsimilaritysearch_tpu.data.loader import SessionGraphLoader as JaxLoader
from sessionsimilaritysearch_tpu.data.synthetic import SyntheticSessionGenerator
from sessionsimilaritysearch_tpu.tokenizer import get_tokenizer as jax_tokenizer
from sessionsimilaritysearch_tpu_torch.config import tiny_test_config
from sessionsimilaritysearch_tpu_torch.examples import flagship_campaign as campaign
from sessionsimilaritysearch_tpu_torch.tokenizer import get_tokenizer
from sessionsimilaritysearch_tpu_torch.utils.checkpoint import CheckpointManager

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULE = "sessionsimilaritysearch_tpu_torch.examples.flagship_campaign"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # these cases run small tensors through many ops; under the suite's
    # parallel workers one intra-op thread each avoids oversubscribing
    # the cores
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _run(tmp, crash_at, out):
    # -X importtime lists every module the process imports on stderr
    cmd = [sys.executable, "-X", "importtime", "-m", MODULE, "--device", "cpu", "--tiny",
           "--savedir", str(tmp), "--out", str(out), "--crash-at-step", str(crash_at)]
    env = {**{k: v for k, v in os.environ.items() if k != "PYTHONPATH"}, "PYTHONPATH": REPO,
           "OMP_NUM_THREADS": "1"}
    return subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=REPO,
                          timeout=300)


@pytest.fixture(scope="module")
def campaign_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("campaign")
    out1, out2 = tmp / "s1.json", tmp / "s2.json"
    # step 18 is not a multiple of ckpt-every (4): the resume replays the
    # two steps since the step-16 checkpoint
    r1 = _run(tmp / "run", 18, out1)
    r2 = _run(tmp / "run", -1, out2)
    return r1, r2, out1, out2


def _stderr_text(r):
    return "\n".join(line for line in r.stderr.splitlines()
                     if not line.startswith("import time:"))


class TestCampaignCrashResume:
    def test_crash_exit_code(self, campaign_runs):
        r1, _, out1, _ = campaign_runs
        assert r1.returncode == 3, _stderr_text(r1)[-2000:]
        assert not out1.exists()  # died before writing a summary

    def test_resume_completes(self, campaign_runs):
        _, r2, _, out2 = campaign_runs
        assert r2.returncode == 0, _stderr_text(r2)[-2000:]
        s = json.loads(out2.read_text())
        assert s["steps_total"] == 2 * s["steps_per_epoch"]
        # resumed from the last checkpoint before the crash step
        assert s["resume_seams"] == [{"epoch": 0, "batch_idx": 16, "global_step": 16}]
        assert s["device"] == "cpu"
        assert s["flops_per_step_g"] > 0 and s["first_step_s"] > 0

    def test_loss_curve_spans_both_processes(self, campaign_runs):
        _, _, _, out2 = campaign_runs
        s = json.loads(out2.read_text())
        steps = [c[0] for c in s["loss_curve"]]
        assert steps == sorted(steps)
        assert steps[0] <= 4 and steps[-1] == s["steps_total"]
        losses = [c[1] for c in s["loss_curve"]]
        assert all(np.isfinite(v) and abs(v) < 1e3 for v in losses)

    def test_replayed_steps_reproduce(self, campaign_runs):
        # crash at 18, checkpoint at 16: step 18 ran in both processes from
        # the restored state, its seed and the same shuffle
        _, _, _, out2 = campaign_runs
        s = json.loads(out2.read_text())
        log = [json.loads(line) for line in
               open(os.path.join(out2.parent, "run", "campaign_log.jsonl"))]
        replayed = [e["step"] for e in log if e["event"] == "loss" and e["step"] == 18]
        assert len(replayed) == 2
        assert s["replay_loss_max_dev"] <= 1e-4, s["replay_loss_max_dev"]

    def test_subprocesses_load_no_jax(self, campaign_runs):
        r1, r2, _, _ = campaign_runs
        for r in (r1, r2):
            mods = re.findall(r"^import time:\s+\d+ \|\s+\d+ \|\s*(\S+)$", r.stderr, re.M)
            # the module itself runs as __main__; what it imports is listed
            assert "sessionsimilaritysearch_tpu_torch.training.pretrain" in mods
            assert "torch" in mods
            bad = [m for m in mods if m.split(".")[0] in
                   ("jax", "jaxlib", "flax", "optax", "sessionsimilaritysearch_tpu")]
            assert not bad, bad


@pytest.mark.parametrize("seed", [0, 3])
def test_batch_order_equals_jax(seed):
    # the JAX campaign's per-epoch loader (examples/flagship_campaign.py
    # make_loader) and the port's, on the same data
    jcfg = jax_tiny_config().replace(batch_size=32, seed=seed)
    cfg = tiny_test_config().replace(batch_size=32, seed=seed)
    data = SyntheticSessionGenerator(asin_num=jcfg.asin_num, seed=seed).dataset(160)
    for epoch in (0, 1):
        jl = JaxLoader(data, jax_tokenizer(jcfg.vocab_size), jcfg.dims, jcfg.batch_size,
                       shuffle=True, ignore_query=jcfg.ignore_query, drop_last=True,
                       cache=False, seed=seed * 1009 + epoch, prefetch=2)
        tl = campaign.make_loader(data, get_tokenizer(cfg.vocab_size), cfg, seed, epoch)
        want = [np.asarray(b.idx) for _, b in zip(range(3), jl)]
        got = [np.asarray(b.idx) for _, b in zip(range(3), tl)]
        jl.close()
        tl.close()
        assert len(got) == 3
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_step_seed_depends_on_seed_and_step_alone():
    assert campaign.step_seed(0, 5) == campaign.step_seed(0, 5)
    seeds = {campaign.step_seed(s, g) for s in range(3) for g in range(100)}
    assert len(seeds) == 300


def _first_loss(savedir):
    log = [json.loads(line) for line in open(os.path.join(savedir, "campaign_log.jsonl"))]
    return [e["loss"] for e in log if e["event"] == "loss" and e["step"] == 1][0]


def test_cached_text_first_step_equals_uncached(tmp_path):
    base = ["--device", "cpu", "--tiny", "--sessions", "64", "--epochs", "1"]
    campaign.main(base + ["--savedir", str(tmp_path / "plain")])
    s = campaign.main(base + ["--savedir", str(tmp_path / "cached"), "--cached-text"])
    assert s["steps_total"] == 2
    np.testing.assert_allclose(_first_loss(tmp_path / "cached"),
                               _first_loss(tmp_path / "plain"), rtol=1e-5)


def test_resume_refuses_checkpoints_of_two_steps(tmp_path):
    argv = ["--device", "cpu", "--tiny", "--sessions", "64", "--epochs", "1",
            "--savedir", str(tmp_path)]
    campaign.main(argv)
    ckpt = CheckpointManager(os.path.join(tmp_path, "ckpt"))
    meta = ckpt.restore("campaign_meta")
    ckpt.save("campaign_meta", {**meta, "global_step": meta["global_step"] - 1})
    with pytest.raises(RuntimeError, match="between the two saves"):
        campaign.main(argv)


def test_campaign_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is it")
    with pytest.raises(RuntimeError, match="cuda"):
        campaign.main(["--tiny", "--savedir", str(tmp_path)])
