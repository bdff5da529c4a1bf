"""Sharded checkpoints (``utils.checkpoint.save_sharded`` /
``restore_sharded``) and the multi-process dry run.

- Two gloo processes (this file run as a script, ``__main__`` below): the
  data-parallel train state after one step is saved shard by shard,
  restored into a fresh state, and one more step equals the second step of
  an uninterrupted run, bit for bit (parameters, Adam moments, BatchNorm
  statistics, the step count and the generator's state, so the draws too);
  then a ``ShardedDenseIndex`` of two shards per rank saves and restores
  without a gather and searches the same.
- In one process: a JAX ``save_sharded`` directory of a
  ``ShardedDenseIndex.state_dict()`` restores into the port's index and
  searches the same, and the port's directory restores in JAX
  (``tests/test_infra.py:560-580``); a mismatched layout raises.
- ``dryrun_multichip(2)``: two gloo processes run the dry run's
  data-parallel step and every sharded retrieval check.
"""

import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

if __name__ == "__main__":  # a worker: the repository root on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sessionsimilaritysearch_tpu_torch.index import ShardedDenseIndex  # noqa: E402
from sessionsimilaritysearch_tpu_torch.parallel import create_mesh  # noqa: E402
from sessionsimilaritysearch_tpu_torch.parallel.sharding import ShardedTensor  # noqa: E402
from sessionsimilaritysearch_tpu_torch.utils.checkpoint import (  # noqa: E402
    load_sharded_state_tree,
    restore_sharded,
    save_sharded,
    sharded_state_tree,
)

WORKER_TIMEOUT_S = 120
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny shapes run best on one thread, and the suite's workers share
    the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _train_state_round_trip(mesh, out_dir: str) -> None:
    from sessionsimilaritysearch_tpu_torch.config import tiny_test_config
    from sessionsimilaritysearch_tpu_torch.data import SyntheticSessionGenerator
    from sessionsimilaritysearch_tpu_torch.data.graph import build_graph_batch
    from sessionsimilaritysearch_tpu_torch.parallel import shard_batch, shard_params
    from sessionsimilaritysearch_tpu_torch.tokenizer import get_tokenizer
    from sessionsimilaritysearch_tpu_torch.training import pretrain as tp

    cfg = tiny_test_config(node_w=0.1, ph_w=0.1)
    tok = get_tokenizer(cfg.vocab_size)
    data = SyntheticSessionGenerator(asin_num=cfg.asin_num, seed=5).dataset(16)
    batches = [shard_batch(build_graph_batch(data[i: i + 8], tok, cfg.dims), mesh)
               for i in (0, 8)]

    def fresh():
        model, state = tp.create_pretrain_state(cfg, CPU)
        shard_params(state, mesh, min_rows=512)
        return model, state, tp.make_train_step(model, mesh=mesh)

    model, state, step = fresh()
    step(state, batches[0])
    save_sharded(out_dir, sharded_state_tree(state))
    _, want = step(state, batches[1])

    model2, state2, step2 = fresh()
    load_sharded_state_tree(state2, restore_sharded(out_dir, sharded_state_tree(state2)))
    assert state2.step == 1
    _, got = step2(state2, batches[1])
    assert {k: float(v) for k, v in got.items()} == {k: float(v) for k, v in want.items()}
    a, b = sharded_state_tree(state), sharded_state_tree(state2)
    for kind in ("params", "batch_stats"):
        for n, t in a[kind].items():
            t2 = b[kind][n]
            if isinstance(t, ShardedTensor):
                t, t2 = t.local()[0], t2.local()[0]
            assert torch.equal(t, t2), (kind, n)
    for key in ("exp_avg", "exp_avg_sq"):
        for n, t in a["opt_state"][key].items():
            t2 = b["opt_state"][key][n]
            if isinstance(t, ShardedTensor):
                t, t2 = t.local()[0], t2.local()[0]
            assert torch.equal(t, t2), (key, n)
    assert torch.equal(a["generator"], b["generator"])


def _index_round_trip(rank: int, out_dir: str) -> None:
    from sessionsimilaritysearch_tpu_torch.parallel import multihost

    mesh = multihost.global_mesh(local_devices=[CPU] * 2)
    rows = np.random.default_rng(0).standard_normal((32, 16)).astype(np.float32)
    idx = ShardedDenseIndex(16, 64, mesh)
    idx.add(rows)
    idx.remove_ids([3, 17])
    want = idx.search(rows[:5], 3)
    save_sharded(out_dir, idx.state_dict())
    mine = sorted(f for f in os.listdir(out_dir) if f.endswith(".npy"))
    assert len(mine) == 4 * 2  # buf and ids of four shards, none gathered
    fresh = ShardedDenseIndex(16, 64, mesh)
    fresh.load_state(restore_sharded(out_dir, fresh.state_dict()))
    got = fresh.search(rows[:5], 3)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    assert fresh.remove_ids([int(want[1][4, 0])]) == 1


def _worker(rank: int, world: int, port: int, out_dir: str) -> None:
    import torch.distributed as dist

    from sessionsimilaritysearch_tpu_torch.parallel import multihost

    torch.set_num_threads(1)
    multihost.initialize_distributed(f"localhost:{port}", world, rank)
    mesh = multihost.global_mesh(local_devices=[CPU])
    _train_state_round_trip(mesh, os.path.join(out_dir, "state"))
    _index_round_trip(rank, os.path.join(out_dir, "index"))
    dist.barrier()
    dist.destroy_process_group()
    print(f"RANK_{rank}_OK", flush=True)


def test_two_ranks_round_trip_the_train_state_and_an_index(tmp_path):
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
    with open(tmp_path / "state" / "manifest.pkl", "rb") as f:
        leaves = pickle.load(f)["leaves"]
    sharded = [p for kind, p in leaves if kind == "sharded"]
    # the two tables and their two moments, each as two shards of rows
    assert len(sharded) == 6
    assert all(len(p["shards"]) == 2 and p["shards"][1]["index"][0] == (500, 1000)
               for p in sharded)


# ---------------------------------------------------------------------------
# one process: the JAX package's directories, and layouts that do not match
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rows():
    return np.random.default_rng(0).standard_normal((32, 16)).astype(np.float32)


def _jax_index(rows):
    from sessionsimilaritysearch_tpu.index.sharded import ShardedDenseIndex as JIndex
    from sessionsimilaritysearch_tpu.parallel import create_mesh as j_mesh

    idx = JIndex(dim=16, capacity=64, mesh=j_mesh())
    return idx, JIndex


def _port_index(rows, shards=8):
    return ShardedDenseIndex(16, 64, create_mesh(devices=[CPU] * shards))


def _filled(idx, rows):
    idx.add(rows)
    idx.remove_ids([3, 17])  # per-shard fills diverge
    return idx


def test_a_jax_directory_restores_into_the_port(rows, tmp_path):
    from sessionsimilaritysearch_tpu.utils.checkpoint import save_sharded as j_save

    jidx, _ = _jax_index(rows)
    _filled(jidx, rows)
    want = jidx.search(rows[:5], 3)
    j_save(str(tmp_path), jidx.state_dict())
    fresh = _port_index(rows)
    fresh.load_state(restore_sharded(str(tmp_path), fresh.state_dict()))
    got = fresh.search(rows[:5], 3)
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    np.testing.assert_allclose(got[0], np.asarray(want[0]), atol=1e-6)
    assert fresh.remove_ids([int(got[1][4, 0])]) == 1


def test_a_port_directory_restores_in_jax(rows, tmp_path):
    from sessionsimilaritysearch_tpu.utils.checkpoint import restore_sharded as j_restore

    idx = _filled(_port_index(rows), rows)
    want = idx.search(rows[:5], 3)
    save_sharded(str(tmp_path), idx.state_dict())
    assert sorted(os.listdir(tmp_path))[:2] == ["leaf00000_s00000.npy", "leaf00000_s00001.npy"]
    _, JIndex = _jax_index(rows)
    from sessionsimilaritysearch_tpu.parallel import create_mesh as j_mesh

    fresh = JIndex(dim=16, capacity=64, mesh=j_mesh())
    fresh.load_state(j_restore(str(tmp_path), fresh.state_dict()))
    got = fresh.search(rows[:5], 3)
    np.testing.assert_array_equal(np.asarray(got[1]), want[1])
    np.testing.assert_allclose(np.asarray(got[0]), want[0], atol=1e-6)


def test_a_mismatched_layout_raises(rows, tmp_path):
    idx = _filled(_port_index(rows), rows)
    save_sharded(str(tmp_path), idx.state_dict())
    four = _port_index(rows, shards=4)
    with pytest.raises(ValueError, match="no saved shard covers"):
        restore_sharded(str(tmp_path), four.state_dict())
    plain = dict(_port_index(rows).state_dict(), buf=torch.zeros(64, 16))
    with pytest.raises(ValueError, match="saved sharded"):
        restore_sharded(str(tmp_path), plain)
    wrong = dict(_port_index(rows).state_dict())
    wrong["size"] = ShardedTensor((8,), {0: torch.zeros(1)}, 8)
    with pytest.raises(ValueError, match="saved inline"):
        restore_sharded(str(tmp_path), wrong)


def test_dryrun_multichip_two_gloo_ranks():
    from sessionsimilaritysearch_tpu_torch.dryrun import dryrun_multichip

    out = dryrun_multichip(2)
    assert out["world"] == 2 and np.isfinite(out["loss"])
    assert out["sharded"] == ["encoder.query_node_embedder.tok_emb.weight",
                              "target_asin_embedding.weight"]


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
