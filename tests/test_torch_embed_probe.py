"""The port's embed-pipeline probe
(``sessionsimilaritysearch_tpu_torch.examples.embed_pipeline_probe``): its
``--tiny`` run gives ``parity_max_abs_diff`` 0.0 between the host and the
device outputs of ``EmbeddingPipeline``, as JAX's does; the two indexes of
C (built from the device tensor and from the host array) hold the same rows
bit for bit; the report has JAX's keys (``platform`` -> ``device``). A
second run in a subprocess writes the same report to ``--out`` and loads
neither JAX nor the JAX package."""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from sessionsimilaritysearch_tpu_torch.examples import embed_pipeline_probe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULE = "sessionsimilaritysearch_tpu_torch.examples.embed_pipeline_probe"
JAX_KEYS = ["sessions", "embed_batch", "dim", "platform", "A_np_s", "A_np_sessions_per_s",
            "B_device_s", "B_device_sessions_per_s", "B_speedup_vs_A", "parity_max_abs_diff",
            "C_add_device_s", "C_add_np_s"]
BANNED = ("jax", "jaxlib", "flax", "optax", "sessionsimilaritysearch_tpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # small tensors through many ops: one intra-op thread per suite worker
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def probe():
    keep = {}
    report = embed_pipeline_probe.main(["--device", "cpu", "--tiny"], keep=keep)
    return report, keep


def test_parity_is_exact(probe):
    report, _ = probe
    assert report["parity_max_abs_diff"] == 0.0
    assert report["sessions"] == 1024 and report["embed_batch"] == 128 and report["dim"] == 64


def test_indexes_hold_the_same_rows(probe):
    _, keep = probe
    a, b = keep["index_device"], keep["index_np"]
    assert a.ntotal == b.ntotal == 1024
    assert a._buf.dtype == b._buf.dtype == torch.bfloat16
    assert torch.equal(a._buf[: a.ntotal], b._buf[: b.ntotal])
    norms = a._buf[: a.ntotal].float().norm(dim=1)
    assert torch.allclose(norms, torch.ones_like(norms), atol=1e-2)


def test_keys_are_jax_keys(probe):
    report, _ = probe
    assert list(report) == ["device" if k == "platform" else k for k in JAX_KEYS]
    assert report["device"] == "cpu"
    assert all(np.isfinite(v) for k, v in report.items() if k != "device")


def test_subprocess_writes_out_and_loads_no_jax(tmp_path, probe):
    out = tmp_path / "probe.json"
    env = {**{k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
           "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    r = subprocess.run([sys.executable, "-X", "importtime", "-m", MODULE, "--device", "cpu",
                        "--tiny", "--out", str(out)],
                       capture_output=True, text=True, env=env, cwd=str(tmp_path), timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    written = json.loads(out.read_text())
    assert list(written) == list(probe[0]) and written["parity_max_abs_diff"] == 0.0
    mods = re.findall(r"^import time:\s+\d+ \|\s+\d+ \|\s*(\S+)$", r.stderr, re.M)
    assert "sessionsimilaritysearch_tpu_torch.evalharness.harness" in mods
    bad = [m for m in mods if m.split(".")[0] in BANNED]
    assert not bad, bad
