"""The port's CLI (``sessionsimilaritysearch_tpu_torch.cli``) against the JAX
package's (``sessionsimilaritysearch_tpu.cli``), both run in-process on the
CPU (``--platform cpu`` / ``--device cpu``) with the tiny config and seeded
synthetic sessions:

- ``etl``: byte-identical CSVs and the same counts;
- ``evaluate --mode STAN|SKNN``: equal JSON apart from ``qps`` / ``search_s``;
- ``--save-results`` of one package read by ``--mode load`` of the other;
- ``evaluate --mode model|knn|hybrid`` (and ``knn --pairings``) with the
  port's encoders carried from JAX's ``enc.init(PRNGKey(seed))`` (and
  ``PRNGKey(seed + 1)``): equal reports to REPORT_ATOL (the metrics are
  rounded to 4 decimals; float32 embeddings that differ by rounding may
  swap near-tied neighbours);
- the training subcommands in the port alone (the JAX CLI's trainers are not
  run here): the JAX CLI's keys, ``steps`` counted as JAX's loop counts
  them, resume from their own ``ckpt/`` on a second call;
- the default device is the card (raises here), and a CLI run loads neither
  JAX nor the JAX package.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from sessionsimilaritysearch_tpu import cli as jcli
from sessionsimilaritysearch_tpu.config import Config as JConfig
from sessionsimilaritysearch_tpu.data import SyntheticSessionGenerator as JGen
from sessionsimilaritysearch_tpu.data.graph import batch_graphs, sequence_to_graph
from sessionsimilaritysearch_tpu.models import build_text_session_encoder as j_build
from sessionsimilaritysearch_tpu.tokenizer import get_tokenizer
from sessionsimilaritysearch_tpu_torch import cli
from sessionsimilaritysearch_tpu_torch.config import tiny_test_config
from sessionsimilaritysearch_tpu_torch.models import build_text_session_encoder
from sessionsimilaritysearch_tpu_torch.weights import flax_to_state_dict

REPO = Path(__file__).resolve().parent.parent
REPORT_ATOL = 1e-4  # one unit of the 4th decimal the CLI rounds to
TIMING = ("qps", "search_s")
EVAL = ["--tiny", "--num-sessions", "60", "--seed", "3"]
# the keys of the JAX CLI's JSON line per training subcommand (cli.py:123,
# :171, :264)
TRAIN_KEYS = {"best_valid_loss", "steps"}
FINETUNE_KEYS = {"final_loss", "triplets"}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these small tensors gain nothing from more, and
    the suite's workers share the machine's cores (oversubscribed, the
    training calls here ran ~8x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(main, argv) -> dict:
    """One in-process CLI call -> its last printed JSON line."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def jax_cli(*argv):
    return _run(jcli.main, ["--platform", "cpu", *argv])


def port_cli(*argv):
    return _run(cli.main, ["--device", "cpu", *argv])


def _untimed(rep):
    return {k: v for k, v in rep.items() if k not in TIMING}


def _carried_encoder(cfg, device, seed):
    """The port's text session encoder with the parameters JAX's CLI draws:
    ``enc.init(PRNGKey(seed), sample)`` (the shapes alone fix the tree)."""
    jcfg = JConfig.from_json(cfg.to_json())
    tok = get_tokenizer(jcfg.vocab_size)
    seq, fut = JGen(asin_num=jcfg.asin_num, seed=0).dataset(1)[0]
    sample = batch_graphs([sequence_to_graph(0, seq, fut, tok, jcfg.dims)])
    params = jax.tree.map(np.asarray, j_build(jcfg).init(jax.random.PRNGKey(seed), sample))
    enc = build_text_session_encoder(cfg, device)
    enc.load_state_dict(flax_to_state_dict(params), strict=True)
    return enc.eval()


def test_etl_writes_the_jax_csvs(tmp_path):
    argv = ["etl", "--tiny", "--num-sessions", "50", "--seed", "2"]
    want = jax_cli(*argv, "--out", str(tmp_path / "jax"))
    got = port_cli(*argv, "--out", str(tmp_path / "port"))
    assert got.pop("out") == str(tmp_path / "port")
    want.pop("out")
    assert got == want and got["sessions"] == 50
    for name in ("actions.csv", "asin.csv"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


@pytest.mark.parametrize("mode", ["STAN", "SKNN"])
def test_sparse_evaluate_equals_jax(mode):
    want = jax_cli("evaluate", "--mode", mode, *EVAL)
    got = port_cli("evaluate", "--mode", mode, *EVAL)
    assert set(got) == set(want) and got["mode"] == mode
    assert _untimed(got) == _untimed(want)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_saved_results_load_in_the_other_package(tmp_path, writer):
    path = str(tmp_path / "res.pkl")
    first, second = (jax_cli, port_cli) if writer == "jax" else (port_cli, jax_cli)
    run = first("evaluate", "--mode", "SKNN", "--k", "10", *EVAL, "--save-results", path)
    back = second("evaluate", "--mode", "load", "--results", path)
    assert back.pop("mode") == "load"
    assert back == {k: v for k, v in _untimed(run).items() if k != "mode"}
    # the writer's own reader gives the same report
    mine = (port_cli if writer == "jax" else jax_cli)("evaluate", "--mode", "load",
                                                      "--results", path)
    mine.pop("mode")
    assert mine == back


@pytest.mark.parametrize("mode", ["model", "hybrid", "knn", "knn --pairings"])
def test_dense_evaluate_equals_jax_on_carried_weights(monkeypatch, mode):
    args = ["evaluate", "--mode", *mode.split(), *EVAL]
    want = jax_cli(*args)
    seeds = []

    def carried(cfg, device, seed):
        seeds.append(seed)
        return _carried_encoder(cfg, device, seed)

    monkeypatch.setattr(cli, "text_encoder", carried)
    got = port_cli(*args)
    assert seeds == ([3, 4] if "--pairings" in mode else [3])
    assert set(got) == set(want)
    got, want = _untimed(got), _untimed(want)
    assert got.pop("mode") == want.pop("mode")
    np.testing.assert_allclose([got[k] for k in sorted(got)], [want[k] for k in sorted(want)],
                               atol=REPORT_ATOL, rtol=0)


def test_default_device_is_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks a machine without a card")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["etl", "--tiny", "--num-sessions", "4", "--out", str(tmp_path)])
    assert not (tmp_path / "actions.csv").exists()
    assert cli.build_parser().parse_args(["etl"]).device == "cuda"


def _train_batches(n_sessions, batch_size=4):
    """Batches a tiny run's train loader yields per epoch: the sessions past
    the 10% validation split, the last batch wrap-padded (JAX's loader)."""
    n_train = n_sessions - max(n_sessions // 10, 1)
    return -(-n_train // batch_size)


@pytest.mark.parametrize("cmd", ["pretrain", "pretrain --contrastive", "train-session",
                                 "train-subsession"])
def test_training_subcommand_runs_and_resumes(tmp_path, cmd):
    args = [*cmd.split(), "--tiny", "--num-sessions", "30", "--savedir", str(tmp_path)]
    first = port_cli(*args)
    assert set(first) == TRAIN_KEYS
    assert first["steps"] == _train_batches(30)
    if "--contrastive" in cmd:
        assert first["best_valid_loss"] is None  # no validation with the view objective
    else:
        assert np.isfinite(first["best_valid_loss"])
    assert (tmp_path / "ckpt" / "latest.pt").exists()
    assert (tmp_path / "config.json").exists()
    again = port_cli(*args)  # resumes from ckpt/latest.pt: one more epoch
    assert again["steps"] == 2 * first["steps"]


@pytest.fixture(scope="module")
def pretrain_dir(tmp_path_factory):
    run = tmp_path_factory.mktemp("pretrain")
    out = port_cli("pretrain", "--tiny", "--num-sessions", "20", "--savedir", str(run))
    assert out["steps"] == _train_batches(20)
    return run


@pytest.mark.parametrize("wiring", ["text", "from-pretrain"])
def test_finetune(tmp_path, pretrain_dir, wiring):
    extra = ["--from-pretrain", str(pretrain_dir)] if wiring == "from-pretrain" else []
    out = port_cli("finetune", "--tiny", "--num-sessions", "80", "--epochs", "2",
                   "--savedir", str(tmp_path), *extra)
    assert set(out) == FINETUNE_KEYS
    assert out["triplets"] > 0 and np.isfinite(out["final_loss"])
    assert "epoch 1" in (tmp_path / "finetune.log").read_text()


def test_finetune_from_pretrain_reads_best_then_latest(tmp_path, pretrain_dir, monkeypatch):
    from sessionsimilaritysearch_tpu_torch.utils import checkpoint

    tags = []
    real = checkpoint.CheckpointManager.restore

    def spy(self, tag, map_location=None):
        tags.append(tag)
        return real(self, tag, map_location)

    monkeypatch.setattr(checkpoint.CheckpointManager, "restore", spy)
    cfg, encode = cli._pretrained_encode_fn(str(pretrain_dir), torch.device("cpu"))
    assert tags == ["best"] and cfg.session_emb_dim == tiny_test_config().session_emb_dim
    (pretrain_dir / "ckpt" / "best.pt").rename(tmp_path / "best.pt")
    try:
        tags.clear()
        cli._pretrained_encode_fn(str(pretrain_dir), torch.device("cpu"))
        assert tags == ["latest"]
    finally:
        (tmp_path / "best.pt").rename(pretrain_dir / "ckpt" / "best.pt")


def test_finetune_from_an_orbax_run_raises(tmp_path):
    """A JAX run directory in Orbax format (``ckpt/<tag>/`` directories) is
    refused by the msgpack reader's ValueError, never skipped."""
    (tmp_path / "ckpt" / "latest").mkdir(parents=True)
    (tmp_path / "config.json").write_text(tiny_test_config().to_json())
    with pytest.raises(ValueError, match="Orbax"):
        port_cli("finetune", "--tiny", "--num-sessions", "80", "--savedir",
                 str(tmp_path / "ft"), "--from-pretrain", str(tmp_path))


def test_cli_run_loads_no_jax(tmp_path):
    code = (
        "import runpy, sys\n"
        "sys.argv = ['cli', '--device', 'cpu', 'evaluate', '--mode', 'model', '--tiny',\n"
        "            '--num-sessions', '30']\n"
        "runpy.run_module('sessionsimilaritysearch_tpu_torch.cli', run_name='__main__')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'optax', 'sessionsimilaritysearch_tpu'))\n"
        "assert not bad, bad\n"
        "print('no jax')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    env["OMP_NUM_THREADS"] = "1"
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[-1] == "no jax" and json.loads(lines[-2])["mode"] == "model"
