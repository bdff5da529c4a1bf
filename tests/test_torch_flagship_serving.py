"""The port's flagship serving artifact
(``sessionsimilaritysearch_tpu_torch.examples.flagship_serving``) against
JAX's ``examples/flagship_serving.py`` on one shared ``--cache``: 2,048
corpus sessions and 64 query pairs of JAX's ``SyntheticSessionGenerator``
(pickled with JAX ``Action``s, as JAX's script pickles them) and seeded unit
rows at the tiny width around a few centers, so both scripts resume at the
serving ladder on the same embeddings. JAX's script runs whole in a
subprocess; the port's runs in a subprocess (which must load neither JAX
nor the JAX package) and in-process (for the ids of each mode). Then the
port's own tiny run without a cache writes one, and a second run hits it.

The bounds: equal value-recall@10 where both select exactly; the port's at
least JAX's where JAX selects approximately (the port runs its exact
selection there); ``ave_type_score10`` within 0.02 in the cosine-ranked
modes, for bf16 score ties that resolve to another equal-score row
(Hamming-ranked modes tie heavily at 32 bits and get no bound)."""

import json
import os
import pickle
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from sessionsimilaritysearch_tpu.config import tiny_test_config as jax_tiny_config
from sessionsimilaritysearch_tpu.data import SyntheticSessionGenerator
from sessionsimilaritysearch_tpu_torch.examples import flagship_serving

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULE = "sessionsimilaritysearch_tpu_torch.examples.flagship_serving"
SESSIONS, QUERIES, DIM, CENTERS = 2048, 64, 64, 24
MODES = ["exact_bf16", "exact_cert_bf16", "int8x8_exact", "int8x8_cert", "int8x8_approx",
         "pca64_exact", "binary_sign", "binary_approx", "twostage_pool256",
         "twostage_pool512", "twostage_itq_pool128", "twostage_itq_pool256",
         "binary_packed_itq", "twostage_packeditq_pool128"]
# the modes that select exactly in both packages, and the key of their recall
EXACT = {"exact_bf16": "value_recall10", "exact_cert_bf16": "value_recall10",
         "int8x8_exact": "value_recall10", "int8x8_cert": "value_recall10",
         "pca64_exact": "value_recall10_vs_fulldim", "binary_sign": "value_recall10",
         "binary_packed_itq": "value_recall10"}
# the modes whose selection (or stage 1) is approximate in JAX
APPROX = ["int8x8_approx", "binary_approx", "twostage_pool256", "twostage_pool512",
          "twostage_itq_pool128", "twostage_itq_pool256", "twostage_packeditq_pool128"]
TWOSTAGE = [m for m in MODES if m.startswith("twostage")]
COSINE_EXACT = ["exact_bf16", "exact_cert_bf16", "int8x8_exact", "int8x8_cert", "pca64_exact"]
TYPE_SCORE_TOL = 0.02
BANNED = ("jax", "jaxlib", "flax", "optax", "sessionsimilaritysearch_tpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # small tensors through many ops: one intra-op thread per suite worker
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _env():
    return {**{k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
            "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu"}


def _last_json(stdout: str) -> dict:
    return json.loads([line for line in stdout.splitlines() if line.startswith("{")][-1])


def _imported(stderr: str) -> list:
    return re.findall(r"^import time:\s+\d+ \|\s+\d+ \|\s*(\S+)$", stderr, re.M)


def _write_cache(prefix: str) -> None:
    """The JAX script's cache layout: ``.sessions.pkl`` holds (corpus
    sessions, query pairs) with JAX Actions; ``.npz`` holds ``cn``, ``qn``
    and ``meta`` (UTF-8 JSON bytes) with the keys its ladder reads."""
    cfg = jax_tiny_config()
    gen = SyntheticSessionGenerator(asin_num=cfg.asin_num, seed=0)
    data = gen.dataset(SESSIONS)
    test_data = gen.dataset(QUERIES)
    with open(prefix + ".sessions.pkl", "wb") as f:
        pickle.dump(([d[0] for d in data], test_data), f, protocol=pickle.HIGHEST_PROTOCOL)
    rng = np.random.default_rng(0)
    centers = rng.standard_normal((CENTERS, DIM))

    def rows(n):
        x = centers[rng.integers(0, CENTERS, n)] + 0.35 * rng.standard_normal((n, DIM))
        return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)

    meta = {"sessions": SESSIONS, "regime": "clustered", "asin_num": cfg.asin_num,
            "queries": QUERIES, "gen_s": 0.0, "train_steps": 0, "train_s": 0.0,
            "title_table_s": 0.0, "kw_table_s": 0.0, "embed_s": 0.0,
            "embed_sessions_per_s": 0.0}
    np.savez(prefix + ".npz", cn=rows(SESSIONS), qn=rows(QUERIES),
             meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8))


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    """JAX's report, the port's (subprocess) report with its import log,
    and the port's in-process report with each mode's ids, on one cache."""
    tmp = tmp_path_factory.mktemp("flagship_serving")
    prefix = str(tmp / "shared")
    _write_cache(prefix)
    jax_run = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", "flagship_serving.py"), "--tiny",
         "--platform", "cpu", "--cache", prefix],
        capture_output=True, text=True, env=_env(), cwd=str(tmp), timeout=600)
    assert jax_run.returncode == 0, jax_run.stderr[-3000:]
    assert "cache hit" in jax_run.stdout
    port_run = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", MODULE, "--device", "cpu", "--tiny",
         "--cache", prefix],
        capture_output=True, text=True, env=_env(), cwd=str(tmp), timeout=600)
    assert port_run.returncode == 0, port_run.stderr[-3000:]
    assert "cache hit" in port_run.stdout
    keep = {}
    in_process = flagship_serving.main(["--device", "cpu", "--tiny", "--cache", prefix],
                                       keep=keep)
    return {"jax": _last_json(jax_run.stdout), "port": _last_json(port_run.stdout),
            "imports": _imported(port_run.stderr), "in_process": in_process,
            "ids": keep["ids"]}


def test_same_fourteen_modes(shared):
    assert list(shared["jax"]["modes"]) == MODES
    assert list(shared["port"]["modes"]) == MODES
    for name in MODES:
        assert set(shared["port"]["modes"][name]) == set(shared["jax"]["modes"][name]), name
    assert set(shared["port"]) == set(shared["jax"])


@pytest.mark.parametrize("mode", sorted(EXACT))
def test_exact_modes_recall_equal(shared, mode):
    key = EXACT[mode]
    want = shared["jax"]["modes"][mode][key]
    assert want == 1.0, (mode, want)  # JAX's tiny run
    assert shared["port"]["modes"][mode][key] == want, mode


@pytest.mark.parametrize("mode", APPROX)
def test_approx_modes_recall_at_least_jax(shared, mode):
    got = shared["port"]["modes"][mode]["value_recall10"]
    assert got >= shared["jax"]["modes"][mode]["value_recall10"], mode


def test_binary_approx_returns_binary_sign_ids(shared):
    ids = shared["ids"]
    np.testing.assert_array_equal(ids["binary_approx"], ids["binary_sign"])
    assert ids["binary_sign"].shape == (QUERIES, 10)


def test_type_scores_close(shared):
    jm, pm = shared["jax"]["modes"], shared["port"]["modes"]
    checked = COSINE_EXACT + [m for m in TWOSTAGE if jm[m]["value_recall10"] == 1.0]
    for mode in checked:
        assert abs(pm[mode]["ave_type_score10"] - jm[mode]["ave_type_score10"]) \
            <= TYPE_SCORE_TOL, (mode, pm[mode]["ave_type_score10"],
                                jm[mode]["ave_type_score10"])
    assert len(checked) >= len(COSINE_EXACT) + 1


def test_pca_and_packed_layout(shared):
    jm, pm = shared["jax"]["modes"], shared["port"]["modes"]
    assert abs(pm["pca64_exact"]["explained_variance"]
               - jm["pca64_exact"]["explained_variance"]) <= 1e-4
    assert pm["binary_packed_itq"]["hbm_bytes_per_row"] \
        == jm["binary_packed_itq"]["hbm_bytes_per_row"]


def test_subprocess_loads_no_jax_and_matches_in_process(shared):
    mods = shared["imports"]
    assert "sessionsimilaritysearch_tpu_torch.engine" in mods and "torch" in mods
    bad = [m for m in mods if m.split(".")[0] in BANNED]
    assert not bad, bad
    # the same cache, the same ladder: every recall and type score agrees
    for name in MODES:
        a, b = shared["in_process"]["modes"][name], shared["port"]["modes"][name]
        assert {k: v for k, v in a.items() if k not in ("ms_per_batch", "qps")} == \
            {k: v for k, v in b.items() if k not in ("ms_per_batch", "qps")}, name


def test_own_run_writes_cache_and_resumes(tmp_path):
    prefix = str(tmp_path / "own")
    first = flagship_serving.main(["--device", "cpu", "--tiny", "--cache", prefix])
    assert os.path.exists(prefix + ".npz") and os.path.exists(prefix + ".sessions.pkl")
    assert first["train_steps"] == 30 and first["sessions"] == SESSIONS
    assert first["dim"] == DIM and list(first["modes"]) == MODES
    with np.load(prefix + ".npz") as z:
        cn = z["cn"]
        meta = json.loads(bytes(z["meta"]).decode())
    assert cn.shape == (SESSIONS, DIM) and np.isfinite(cn).all()
    np.testing.assert_allclose(np.linalg.norm(cn, axis=1), 1.0, atol=1e-5)
    assert meta["train_steps"] == 30
    second = flagship_serving.main(["--device", "cpu", "--tiny", "--cache", prefix])
    # the second run resumed at the ladder: the stage times are the cache's
    for key in ("gen_s", "train_s", "embed_s", "embed_sessions_per_s", "train_steps"):
        assert second[key] == first[key] == meta[key], key
    for name in MODES:
        assert second["modes"][name]["ave_type_score10"] == \
            first["modes"][name]["ave_type_score10"], name
    for name in ("exact_bf16", "int8x8_exact", "binary_sign", "binary_packed_itq"):
        assert first["modes"][name]["value_recall10"] == 1.0, name
