"""Package-level rules of the PyTorch port: it never imports JAX, it has no
CPU fallback for a CUDA device, its kernel build fails loudly, and
chip_smoke.py refuses to run without a card."""

import os
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import sessionsimilaritysearch_tpu_torch as port
from sessionsimilaritysearch_tpu.config import tiny_test_config
from sessionsimilaritysearch_tpu_torch.device import resolve_device
from sessionsimilaritysearch_tpu_torch.index.dense import DenseIndex
from sessionsimilaritysearch_tpu_torch.models.encoder import build_graph_encoder
from sessionsimilaritysearch_tpu_torch.ops import _build, mips

REPO = Path(__file__).resolve().parent.parent


def _port_modules():
    return sorted(
        m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")
    )


def test_port_never_imports_jax():
    mods = _port_modules()
    for name in ("engine", "weights", "native_build", "index.binary",
                 "index.twostage", "ops.hamming", "ops.packed", "ops.popcount",
                 "ops.projection"):
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
    for src in ("scores_bmax.cu", "packed_scores_bmax.cu", "hamming_bucket_min.cu"):
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

