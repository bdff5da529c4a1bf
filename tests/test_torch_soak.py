"""The port's mixed-workload serving soak
(``sessionsimilaritysearch_tpu_torch.examples.serving_soak``) held to the
operator contract of ``tests/test_soak.py`` -- snapshot parity, every verb
ran, row accounting, nothing left pending -- unsharded and over 8 CPU
shards, with ``kernel_path_flat`` in place of ``jit_cache_flat``; its row
accounting and surviving sessions against the JAX soak's on the same
arguments."""

import os
import sys
import types

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

import examples.serving_soak as jax_soak  # noqa: E402
from sessionsimilaritysearch_tpu_torch.examples import serving_soak  # noqa: E402
from sessionsimilaritysearch_tpu_torch.index import DenseIndex, ShardedDenseIndex  # noqa: E402
from sessionsimilaritysearch_tpu_torch.parallel import create_mesh  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # these cases run small tensors through many ops; under the suite's
    # parallel workers one intra-op thread each avoids oversubscribing
    # the cores
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _args(workdir, **kw):
    # tests/test_soak.py's arguments; tiny=True overrides most sizes inside
    # run_soak, in both packages
    return types.SimpleNamespace(
        rows=512, asin_num=None, fill_chunk=128, batches=6, qbatch=32,
        ibatch=32, k=10, embed_batch=32, remove_every=2, expire_every=3,
        workdir=str(workdir), tiny=True, tiny_model=False, out=None, **kw,
    )


@pytest.fixture(scope="module")
def soak_report(tmp_path_factory):
    args = _args(tmp_path_factory.mktemp("soak"), device="cpu")
    keep = {}
    report = serving_soak.run_soak(args, keep)
    return report, args, keep["sessions_end"]


@pytest.fixture(scope="module")
def sharded_soak_report(tmp_path_factory):
    args = _args(tmp_path_factory.mktemp("soak8"), device="cpu", mesh=8)
    return serving_soak.run_soak(args), args


@pytest.fixture(scope="module")
def jax_report(tmp_path_factory):
    """JAX's soak on the same arguments, with the stored sessions captured
    just before its restore (the point where the port's run_soak hands them
    back)."""
    seen = {}

    class Recording(jax_soak.SessionSearchEngine):
        def restore(self, prefix, *a, **kw):
            seen["sessions_end"] = list(self.sessions)
            return super().restore(prefix, *a, **kw)

    original = jax_soak.SessionSearchEngine
    jax_soak.SessionSearchEngine = Recording
    try:
        report = jax_soak.run_soak(_args(tmp_path_factory.mktemp("jsoak"), platform=None))
    finally:
        jax_soak.SessionSearchEngine = original
    return report, seen["sessions_end"]


class TestServingSoak:
    def test_kernel_path_flat(self, soak_report):
        report, _, _ = soak_report
        assert report["kernel_path_flat"], report["k1_launches"]
        # on the CPU the plain version runs: no launch is counted or expected
        k1 = report["k1_launches"]
        assert k1["searches"] == report["mixed_batches"] + 2
        assert k1["per_search"] == k1["expected_per_search"] == [0]

    def test_snapshot_restore_parity(self, soak_report):
        report, _, _ = soak_report
        assert report["snapshot"] is not None
        assert report["snapshot"]["search_identical_after_restore"]
        assert report["snapshot"]["save_s"] is not None

    def test_maintenance_verbs_ran(self, soak_report):
        report, _, _ = soak_report
        assert report["removed_rows"] > 0
        assert report["expired_rows"] > 0
        assert set(report["ops_ms"]) >= {"ingest", "remove", "snapshot_capture"}

    def test_row_accounting(self, soak_report):
        report, _, sessions = soak_report
        expected = (report["rows"] + report["mixed_batches"] * 64
                    - report["removed_rows"] - report["expired_rows"])
        assert abs(report["ntotal_end"] - expected) <= 16
        assert report["engine_stats"]["pending"] == 0
        assert len(sessions) == report["ntotal_end"]

    def test_report_keys(self, soak_report):
        report, _, _ = soak_report
        assert report["device"] == "cpu"
        assert report["memory_allocated_after_warmup"] is None
        assert report["memory_allocated_end"] is None and report["memory_flat"] is None
        assert not any(k.startswith(("jit_cache", "hbm_bytes")) or k == "platform"
                       for k in report)


class TestShardedServingSoak:
    def test_kernel_path_flat(self, sharded_soak_report):
        report, _ = sharded_soak_report
        assert report["mesh_devices"] == 8
        assert report["kernel_path_flat"], report["k1_launches"]

    def test_snapshot_restore_parity(self, sharded_soak_report):
        report, _ = sharded_soak_report
        assert report["snapshot"] is not None
        assert report["snapshot"]["search_identical_after_restore"]

    def test_maintenance_verbs_ran(self, sharded_soak_report):
        report, _ = sharded_soak_report
        assert report["removed_rows"] > 0
        assert report["expired_rows"] > 0
        assert set(report["ops_ms"]) >= {"ingest", "remove", "snapshot_capture"}
        assert report["engine_stats"]["pending"] == 0


class TestParityWithJax:
    @pytest.mark.parametrize("key", ["rows", "capacity", "mixed_batches", "removed_rows",
                                     "expired_rows", "ntotal_end"])
    def test_row_accounting_equals_jax(self, soak_report, jax_report, key):
        assert soak_report[0][key] == jax_report[0][key]

    def test_snapshot_rows_equal_jax(self, soak_report, jax_report):
        assert soak_report[0]["snapshot"]["ntotal"] == jax_report[0]["snapshot"]["ntotal"]

    def test_surviving_sessions_equal_jax(self, soak_report, jax_report):
        # the same data in the same process (the generator's titles follow
        # the interpreter's string hashing): the same rows survive, in the
        # same order
        assert soak_report[2] == jax_report[1]


def test_expected_k1_launches():
    cuda = torch.device("cuda")
    idx = DenseIndex(4, 100, device="cpu", chunk_size=16)
    idx.add(np.random.default_rng(0).standard_normal((40, 4)).astype(np.float32))
    assert serving_soak.expected_k1_launches(idx, cuda) == 3  # ceil(40 / 16)
    assert serving_soak.expected_k1_launches(idx, torch.device("cpu")) == 0
    mesh = create_mesh(devices=[torch.device("cpu")] * 4)
    sh = ShardedDenseIndex(4, 64, mesh, chunk_size=4)
    sh.add(np.random.default_rng(1).standard_normal((24, 4)).astype(np.float32))
    assert serving_soak.expected_k1_launches(sh, cuda) == 8  # 6 rows a shard, chunks of 4


@pytest.mark.parametrize("rows, flat", [
    ([(16, 16, 0, 16), (17, 17, 0, 17)], True),     # every search one chunk per 65,536 rows
    ([(16, 16, 0, 16), (16, 15, 0, 16)], False),    # a launch of another variant
    ([(16, 16, 0, 16), (17, 17, 0, 16)], False),    # a launch more than the scan's chunks
    ([(4, 0, 4, 4), (4, 0, 4, 4)], True),           # all cp_async
])
def test_search_log_flatness(rows, flat):
    log = serving_soak._SearchLog(None, torch.device("cuda"))
    log.rows = rows
    assert log.summary()["flat"] is flat

