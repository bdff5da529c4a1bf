"""The port's multi-process layer (``parallel/multihost.py``) and its
cross-process merge (``parallel/collectives.py``): the single-process cases
of ``tests/test_multihost.py`` (the no-op, ``process_slice`` arithmetic with
the rank and world patched, ``global_mesh``), then two real processes that
form one gloo group, each holding 4 CPU shards of one 8-shard mesh.

The two-process case runs this file as a script (``__main__`` below): each
rank adds the same global rows to a ``ShardedDenseIndex`` and a
``ShardedTwoStageIndex`` on the global mesh and keeps its own shards' rows;
a search merges both ranks' candidates through ``dist.all_gather``. Each
rank holds the results equal, bit for bit, to the same index on an
in-process 8-shard mesh, and the dense ids to the f64 oracle at
value-recall 1.0 (f32 rows, rel_tol 1e-5); removal, reconstruction across
ranks and a save that gathers every shard follow."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

if __name__ == "__main__":  # a worker: the repository root on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sessionsimilaritysearch_tpu_torch.parallel import multihost  # noqa: E402

WORKER_TIMEOUT_S = 120


class TestInitializeDistributed:
    def test_single_process_is_noop(self):
        multihost.initialize_distributed()
        multihost.initialize_distributed(num_processes=1, process_id=0)
        multihost.initialize_distributed(num_processes=None)
        assert not dist.is_initialized()

    def test_group_arguments(self, monkeypatch):
        calls = {}
        monkeypatch.setattr(dist, "init_process_group", lambda **kw: calls.update(kw))
        multihost.initialize_distributed(coordinator_address="host0:1234", num_processes=4,
                                         process_id=2)
        backend = "cpu:gloo,cuda:nccl" if torch.cuda.is_available() else "gloo"
        assert (calls["init_method"], calls["world_size"], calls["rank"],
                calls["backend"]) == ("tcp://host0:1234", 4, 2, backend)
        assert calls["timeout"].total_seconds() == multihost.TIMEOUT_S
        with pytest.raises(ValueError, match="coordinator_address"):
            multihost.initialize_distributed(num_processes=4, process_id=0)


class TestGlobalMesh:
    def test_outside_a_group_is_the_local_mesh(self):
        mesh = multihost.global_mesh(local_devices=["cpu"] * 8)
        assert mesh.size == 8 and mesh.axis_names == ("data",) and not mesh.distributed
        assert mesh.local_shards() == list(range(8))

    def test_explicit_shape(self):
        mesh = multihost.global_mesh(axis_names=("data", "model"), shape=(4, 2),
                                     local_devices=["cpu"] * 8)
        assert dict(mesh.shape) == {"data": 4, "model": 2}

    def test_default_devices_need_a_card(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present: this checks the no-card refusal")
        with pytest.raises(RuntimeError):
            multihost.global_mesh()


class TestProcessSlice:
    def test_single_process_full_range(self):
        assert multihost.process_slice(17) == (0, 17)
        assert multihost.process_slice(0) == (0, 0)

    def _world(self, monkeypatch, rank, world):
        monkeypatch.setattr(dist, "is_initialized", lambda: True)
        monkeypatch.setattr(dist, "get_rank", lambda: rank)
        monkeypatch.setattr(dist, "get_world_size", lambda: world)

    def test_multi_process_arithmetic(self, monkeypatch):
        for pid, want in [(0, (0, 4)), (1, (4, 8)), (2, (8, 12)), (3, (12, 18))]:
            self._world(monkeypatch, pid, 4)
            assert multihost.process_slice(18) == want  # the last takes the remainder

    def test_slices_cover_without_overlap(self, monkeypatch):
        spans = []
        for pid in range(3):
            self._world(monkeypatch, pid, 3)
            spans.append(multihost.process_slice(10))
        assert spans[0][0] == 0 and spans[-1][1] == 10
        for (a0, a1), (b0, b1) in zip(spans, spans[1:]):
            assert a1 == b0


def test_two_gloo_processes_serve_one_eight_shard_index(tmp_path):
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(rank), "2", str(port), str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
    ) for rank in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-4000:]}"
        assert f"RANK_{rank}_OK" in out
    assert (tmp_path / "dense.npz").exists()  # rank 0 wrote the gathered snapshot


def _worker(rank: int, world: int, port: int, out_dir: str) -> None:
    from sessionsimilaritysearch_tpu_torch.index import ShardedDenseIndex, ShardedTwoStageIndex
    from sessionsimilaritysearch_tpu_torch.ops.topk import value_recall_at_k
    from sessionsimilaritysearch_tpu_torch.parallel import create_mesh

    torch.set_num_threads(1)
    multihost.initialize_distributed(f"localhost:{port}", world, rank)
    mesh = multihost.global_mesh(local_devices=["cpu"] * 4)
    assert mesh.shape["data"] == 8 and mesh.distributed
    assert mesh.local_shards() == list(range(4 * rank, 4 * rank + 4))
    assert multihost.process_slice(10) == ((0, 5), (5, 10))[rank]
    local = create_mesh(devices=["cpu"] * 8)
    rng = np.random.default_rng(0)
    rows = rng.standard_normal((512, 16)).astype(np.float32)
    q = (rows[:9] + 0.3 * rng.standard_normal((9, 16))).astype(np.float32)

    def build(cls, m, **kw):
        idx = cls(16, 1024, m, **kw)
        idx.add(rows[:256])  # every rank passes the whole batch
        idx.add(rows[256:])
        return idx

    dense, ref = (build(ShardedDenseIndex, m, chunk_size=32) for m in (mesh, local))
    assert sum(dense._fill[s] for s in dense._local) == 256  # this rank's rows only
    D, I = dense.search(q, 10)
    Dr, Ir = ref.search(q, 10)
    np.testing.assert_array_equal(I, Ir)
    np.testing.assert_array_equal(D, Dr)
    unit = rows / np.linalg.norm(rows, axis=1, keepdims=True)
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    assert value_recall_at_k(I, qn, unit, 10, rel_tol=1e-5) == 1.0
    gone = np.arange(0, 512, 5)
    assert dense.remove_ids(gone) == ref.remove_ids(gone) == gone.size
    D, I = dense.search(q, 10)
    np.testing.assert_array_equal(I, ref.search(q, 10)[1])
    assert not np.isin(I, gone).any()
    ids = [1, 301, 511, 64]  # survivors on both ranks' shards
    np.testing.assert_array_equal(dense.reconstruct_batch(ids), ref.reconstruct_batch(ids))
    path = os.path.join(out_dir, "dense.npz")
    dense.save(path)
    dist.barrier()
    back = ShardedDenseIndex.load(path, local)
    np.testing.assert_array_equal(back.search(q, 10)[1], I)
    two, ref2 = (build(ShardedTwoStageIndex, m, n_bits=64, pool=16) for m in (mesh, local))
    for a, b in zip(two.search(q, 10), ref2.search(q, 10)):
        np.testing.assert_array_equal(a, b)
    dist.barrier()
    dist.destroy_process_group()
    print(f"RANK_{rank}_OK", flush=True)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
