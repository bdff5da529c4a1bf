"""Package-level rules of the PyTorch port: it imports neither JAX nor the
JAX package, it has no CPU fallback for a CUDA device, its kernel build
fails loudly, and chip_smoke.py refuses to run without a card."""

import ast
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import sessionsimilaritysearch_tpu_torch as port
from sessionsimilaritysearch_tpu_torch.config import tiny_test_config
from sessionsimilaritysearch_tpu_torch.device import resolve_device
from sessionsimilaritysearch_tpu_torch.index.dense import DenseIndex
from sessionsimilaritysearch_tpu_torch.models.encoder import build_graph_encoder
from sessionsimilaritysearch_tpu_torch.ops import _build, mips

REPO = Path(__file__).resolve().parent.parent


def _port_modules():
    # from the .py files: the package directory also holds the native
    # library, which is no Python module
    root = Path(port.__path__[0])
    mods = []
    for f in sorted(root.rglob("*.py")):
        parts = f.relative_to(root.parent).with_suffix("").parts
        mods.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return mods


def test_port_never_imports_jax():
    mods = _port_modules()
    for name in ("engine", "weights", "native_build", "index.binary",
                 "index.twostage", "ops.hamming", "ops.packed", "ops.popcount",
                 "ops.projection", "ops.mips_int8", "config", "tokenizer",
                 "data.graph", "data.loader", "native", "evalharness.metrics",
                 "evalharness.harness", "evalharness.knn", "index.sparse", "data.etl",
                 "data.augment", "utils.logging", "utils.precision", "models.heads",
                 "training.losses", "training.train_state", "training.pretrain",
                 "training.loop", "utils.checkpoint"):
        assert f"sessionsimilaritysearch_tpu_torch.{name}" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def _jax_package_or_jax(name: str) -> bool:
    root = name.split(".")[0]
    return root in ("jax", "jaxlib", "flax", "optax", "msgpack", "orbax",
                    "sessionsimilaritysearch_tpu")


def test_serving_on_the_cpu_loads_no_jax_package():
    # a fresh interpreter builds and searches a tiny dense and int8x8 engine
    # on the CPU; neither the JAX package nor JAX may be loaded afterwards
    code = (
        "import sys\n"
        "import sessionsimilaritysearch_tpu_torch as port\n"
        "cfg = port.tiny_test_config()\n"
        "tok = port.get_tokenizer(cfg.vocab_size)\n"
        "data = port.SyntheticSessionGenerator(asin_num=cfg.asin_num, seed=0).dataset(24)\n"
        "enc = port.build_graph_encoder(cfg, 'cpu')\n"
        "for quantize in (None, 'int8x8'):\n"
        "    eng = port.SessionSearchEngine(cfg, tok, enc, dim=cfg.session_emb_dim,\n"
        "                                   capacity=32, batch_size=8, device='cpu',\n"
        "                                   quantize=quantize)\n"
        "    eng.add_sessions(data)\n"
        "    D, I = eng.search(data[:4], k=3)\n"
        "    assert (I[:, 0] == range(4)).all(), I\n"
        "    eng.report(data[:4], I, D)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'optax', 'sessionsimilaritysearch_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_flagship_serving_on_the_cpu_loads_no_jax_package():
    # bf16 serving parameters, catalog tables and the cached forward inside
    # a default engine, and the harness runners, in a fresh interpreter
    code = (
        "import sys\n"
        "import sessionsimilaritysearch_tpu_torch as port\n"
        "from sessionsimilaritysearch_tpu_torch.evalharness import harness as H\n"
        "from sessionsimilaritysearch_tpu_torch.utils.precision import serving_params\n"
        "cfg = port.tiny_test_config()\n"
        "tok = port.get_tokenizer(cfg.vocab_size)\n"
        "gen = port.SyntheticSessionGenerator(asin_num=cfg.asin_num, seed=0)\n"
        "data = [d for d in gen.dataset(40) if any(a[1] != 's' for a in d[0])][:16]\n"
        "enc = serving_params(port.build_graph_encoder(cfg, 'cpu'))\n"
        "title = H.build_title_table(cfg, tok, gen.titles, enc)\n"
        "kws = [a[2] or '' for s, _ in data for a in s if a[1] == 's']\n"
        "fn = H.make_cached_encode_fn(enc, title, *H.build_keyword_table(cfg, tok, kws, enc))\n"
        "eng = port.SessionSearchEngine(cfg, tok, fn, dim=cfg.session_emb_dim,\n"
        "                               capacity=32, batch_size=8, device='cpu')\n"
        "eng.add_sessions(data)\n"
        "D, I = eng.search(data[:4], k=3)\n"
        "assert (I[:, 0] == range(4)).all() and fn.oov_batches == 0, I\n"
        "H.evaluate_encoder(cfg, tok, fn, data[:12], data[12:], k=3, batch_size=8, device='cpu')\n"
        "H.evaluate_sparse(cfg, [s for s, _ in data[:12]], data[12:], k=3)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'optax', 'sessionsimilaritysearch_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_pretraining_on_the_cpu_loads_no_jax_package(tmp_path):
    # a fresh interpreter pretrains a tiny model through run_training with
    # checkpoints, resumes it, encodes and searches; neither the JAX package,
    # JAX nor a msgpack package may be loaded afterwards
    code = (
        "import sys\n"
        "import sessionsimilaritysearch_tpu_torch as port\n"
        "from sessionsimilaritysearch_tpu_torch.data.graph import build_graph_batch\n"
        "from sessionsimilaritysearch_tpu_torch.training import pretrain as tp\n"
        "from sessionsimilaritysearch_tpu_torch.training.loop import run_training\n"
        "from sessionsimilaritysearch_tpu_torch.utils.checkpoint import CheckpointManager\n"
        "cfg = port.tiny_test_config()\n"
        "tok = port.get_tokenizer(cfg.vocab_size)\n"
        "data = port.SyntheticSessionGenerator(asin_num=cfg.asin_num, seed=0).dataset(16)\n"
        "batches = [build_graph_batch(data[i:i + 4], tok, cfg.dims) for i in range(0, 16, 4)]\n"
        f"ckpt = CheckpointManager({str(tmp_path)!r})\n"
        "for epochs in (1, 1):\n"
        "    model, state = tp.create_pretrain_state(cfg, 'cpu')\n"
        "    state, best = run_training(state=state, step_fn=tp.make_train_step(model),\n"
        "                               eval_fn=tp.make_eval_step(model), train_loader=batches,\n"
        "                               valid_loader=batches[:1], epochs=epochs, ckpt=ckpt)\n"
        "assert state.step == 8, state.step\n"
        "enc = tp.make_encode_fn(model)\n"
        "eng = port.SessionSearchEngine(cfg, tok, lambda g: enc(state, g),\n"
        "                               dim=cfg.session_emb_dim, capacity=32, batch_size=8,\n"
        "                               device='cpu')\n"
        "eng.add_sessions(data)\n"
        "D, I = eng.search(data[:4], k=3)\n"
        "assert (I[:, 0] == range(4)).all(), I\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'optax', 'msgpack', 'orbax',\n"
        "              'sessionsimilaritysearch_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_no_source_imports_the_jax_package():
    # every module of the port and chip_smoke.py, read as source: no import
    # statement names JAX or the JAX package, at any depth of the file
    files = sorted(Path(port.__path__[0]).rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 30
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            bad += [f"{f.relative_to(REPO)}:{node.lineno} {n}" for n in names
                    if _jax_package_or_jax(n)]
    assert not bad, bad


def test_no_message_names_the_ported_roadmap_items():
    # Queue 1 items 2 (the selection modes) and 6 (the binary and two-stage
    # tiers) are ported: no source of the port may still refuse something
    # naming them, and no NotImplementedError may be left behind for them
    files = sorted(Path(port.__path__[0]).rglob("*.py"))
    bad = [f"{f.relative_to(REPO)}:{n}" for f in files
           for n, line in enumerate(f.read_text().splitlines(), 1)
           if re.search(r"Queue 1 items? [26]\b", line)]
    assert not bad, bad
    assert port.TwoStageIndex(8, 4, device="cpu").stage1 == "matmul"  # the JAX default


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the no-card refusal")
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        DenseIndex(8, 16, device="cuda")
    with pytest.raises(RuntimeError):
        build_graph_encoder(tiny_test_config(), "cuda")
    with pytest.raises(RuntimeError):
        port.SessionSearchEngine(tiny_test_config(), None, None, dim=8,
                                 capacity=8, device="cuda")


def test_unsupported_device_raises():
    with pytest.raises(ValueError):
        resolve_device("meta")
    q = torch.zeros(2, 8, device="meta")
    with pytest.raises(ValueError):
        mips.scores_with_bucket_max(q, q)


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._find_nvcc()


def test_failed_build_raises_with_compiler_output(monkeypatch, tmp_path):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'scores_bmax.cu(1): error: broken' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", str(tmp_path))
    so = tmp_path / "out" / "lib.so"
    with pytest.raises(RuntimeError, match="(?s)exit code 2.*error: broken"):
        _build._compile(so)
    assert not so.exists() and not list(so.parent.glob("*.tmp"))


def test_library_path_is_keyed_on_sources():
    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("libsss_kernels_") and path.suffix == ".so"
    assert path == _build.library_path()  # stable for unchanged sources
    for src in ("scores_bmax.cu", "packed_scores_bmax.cu", "hamming_bucket_min.cu",
                "scores_bmax_int8.cu", "bucket_max.cu", "scores_matmul.cu",
                "score_tile.cuh"):
        assert (_build.CSRC / src).exists()


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_refuses_without_a_card(tmp_path, where):
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run for real")
    script = REPO / "chip_smoke.py"
    cwd = REPO
    if where == "alone":  # a directory holding chip_smoke.py and nothing else
        cwd = tmp_path
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout

