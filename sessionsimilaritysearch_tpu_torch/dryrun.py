"""The entry points of ``__graft_entry__.py``, ported.

``entry()`` (``__graft_entry__.py:34``): the flagship ``GraphLevelEncoder``
and 8 example sessions, with the forward that embeds them.

The multi-process dry run (``dryrun_multichip`` :81): one data-parallel
pretrain step with the asin and token tables row-sharded, then every
sharded retrieval check of the JAX dry run, on one global mesh of one
shard per rank.

``dryrun_multichip(n)`` starts ``n`` gloo processes on the CPU (this file
run as a script, ``python -m sessionsimilaritysearch_tpu_torch.dryrun RANK
WORLD PORT``) and returns rank 0's result; ``dryrun_multichip(n,
device="cuda")`` runs in this process on the card, as one rank of the
``n``-rank process group that the caller has formed (over NCCL). On the
card the retrieval checks run through K1 (the dense index, the binary
prefilter's stage 1, ``range_search``, the binary index), K2 (the
``int8x8`` stage 1) and K4 (the packed stage 1).
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from typing import Optional

import numpy as np
import torch

# how long a CPU rank may take before the dry run fails
WORKER_TIMEOUT_S = 240


def _example_batch(cfg, batch_size: int):
    """Host numpy SessionGraph of ``batch_size`` synthetic sessions (JAX
    ``__graft_entry__.py:16``)."""
    from sessionsimilaritysearch_tpu_torch.data import (
        SyntheticSessionGenerator,
        batch_graphs,
        sequence_to_graph,
    )
    from sessionsimilaritysearch_tpu_torch.tokenizer import get_tokenizer

    gen = SyntheticSessionGenerator(asin_num=cfg.asin_num, seed=0)
    tok = get_tokenizer(cfg.vocab_size)
    return batch_graphs([sequence_to_graph(i, s, t, tok, cfg.dims, ignore_query=cfg.ignore_query)
                         for i, (s, t) in enumerate(gen.dataset(batch_size))])


# the reduced widths of entry(): a quick compile-and-run check
ENTRY_REDUCED = dict(asin_num=20_000, vocab_size=8192, text_encoder_dim=256,
                     query_embedder_nhid=512, gnn_nhid=256, gnn_nout=256, emb_len=128)


def entry(device="cuda"):
    """Returns ``(forward, (encoder, batch))``: ``forward(encoder, graph)``
    is the flagship ``GraphLevelEncoder``'s embedding [8, session_emb_dim]
    of ``batch``, 8 synthetic sessions. The widths are reduced from the
    reference's 768 / 800 (``ENTRY_REDUCED``); with ``SSS_ENTRY_FULL`` set
    they are ``Config(asin_num=50_000)``'s. The weights are drawn on the CPU
    (a generator seeded with 0), then the encoder and the batch are moved
    to ``device``: the card unless the caller asks for the CPU."""
    from sessionsimilaritysearch_tpu_torch.config import Config
    from sessionsimilaritysearch_tpu_torch.device import resolve_device
    from sessionsimilaritysearch_tpu_torch.evalharness.harness import to_device
    from sessionsimilaritysearch_tpu_torch.models import build_graph_encoder

    dev = resolve_device(device)
    cfg = Config(asin_num=50_000) if os.environ.get("SSS_ENTRY_FULL") else Config(**ENTRY_REDUCED)
    batch = _example_batch(cfg, batch_size=8)
    enc = build_graph_encoder(cfg, "cpu", torch.Generator().manual_seed(0)).to(dev)

    def forward(encoder, graph):
        with torch.no_grad():
            return encoder(graph)

    return forward, (enc, to_device(batch, dev))


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_checks(device, keep: Optional[dict] = None) -> dict:
    """Every check of the dry run, in a process of the current group (or
    alone): returns the step's loss and the retrieval results. ``keep``:
    a dict that receives each retrieval check's index and queries, by the
    check's name, for a caller that holds the kernels to their plain
    versions on the tensors the searches gave them."""
    from sessionsimilaritysearch_tpu_torch.config import tiny_test_config
    from sessionsimilaritysearch_tpu_torch.index import (
        ShardedBinaryIndex,
        ShardedDenseIndex,
        ShardedTwoStageIndex,
    )
    from sessionsimilaritysearch_tpu_torch.parallel import (
        global_mesh,
        process_count,
        shard_batch,
        shard_params,
    )
    from sessionsimilaritysearch_tpu_torch.parallel.sharding import row_shards
    from sessionsimilaritysearch_tpu_torch.training.pretrain import (
        create_pretrain_state,
        make_train_step,
    )

    n = process_count()
    dev = torch.device(device)
    mesh = global_mesh(local_devices=[dev])

    cfg = tiny_test_config(asin_num=1024, batch_size=2 * n, neg_sample_count=64)
    batch = _example_batch(cfg, 2 * n)
    model, state = create_pretrain_state(cfg, dev)
    # dp: the batch over the ranks; the asin and token tables row-sharded
    local = shard_batch(batch, mesh)
    shard_params(state, mesh, min_rows=512)
    step = make_train_step(model, has_view=False, mesh=mesh)
    state, metrics = step(state, local)
    loss = float(metrics["loss"])
    _check(np.isfinite(loss), f"non-finite loss {loss}")

    # corpus-sharded retrieval over the same mesh (every rank passes the
    # whole batch and keeps its shard's rows)
    emb_dim = 32
    rows = np.random.default_rng(0).standard_normal((8 * n, emb_dim)).astype(np.float32)
    index = ShardedDenseIndex(emb_dim, 16 * n, mesh, chunk_size=8)
    index.add(rows)
    _, I = index.search(rows[:4], k=3)
    _check((I[:, 0] == np.arange(4)).all(), "sharded self-retrieval failed")
    kept = {"dense": (index, rows[:4])}

    for what, kw, cap in (("binary prefilter", dict(n_bits=64), 16),
                          ("int8x8", dict(prefilter="int8x8"), 16),
                          ("packed", dict(n_bits=64, stage1="packed"), 2048)):
        ts = ShardedTwoStageIndex(emb_dim, cap * n, mesh, pool=8, **kw)
        ts.add(rows)
        _, I2 = ts.search(rows[:4], k=3)
        _check((I2[:, 0] == np.arange(4)).all(), f"two-stage {what} self-retrieval failed")
        kept[what] = (ts, rows[:4])

    lims, _, Ir = index.range_search(rows[:4], 0.999, k0=8)
    _check(all(q in Ir[lims[q]: lims[q + 1]] for q in range(4)),
           "sharded range_search missed the self hit")

    # stable global ids through a removal on the first and the last shard
    # (JAX removes ids 0 and n, which at n < 3 would remove a row that the
    # check below searches for)
    index.remove_ids([0, 8 * n - 1])
    _, I4 = index.search(rows[1:3], k=1)
    _check((I4[:, 0] == np.arange(1, 3)).all(), "post-remove ids unstable")

    sb = ShardedBinaryIndex(64, 16 * n, mesh)
    codes = np.sign(np.random.default_rng(1).standard_normal((8 * n, 64))).astype(np.float32)
    sb.add(codes)
    Db, Ib = sb.search(codes[:4], k=2)
    _check((Db[:, 0] == 0).all() and (Ib[:, 0] == np.arange(4)).all(),
           "sharded binary self-retrieval failed")
    sb.remove_ids([0])
    _, Ib2 = sb.search(codes[1:3], k=1)
    _check((Ib2[:, 0] == np.arange(1, 3)).all(), "sharded binary post-remove ids unstable")
    kept["binary"] = (sb, codes[1:3])
    if keep is not None:
        keep.update(kept)
    return {"world": n, "loss": loss, "sharded": sorted(row_shards(model))}


def dryrun_multichip(n_devices: int, device: str = "cpu", keep: Optional[dict] = None) -> dict:
    """One data-parallel pretrain step and the sharded retrieval checks
    over ``n_devices`` ranks: gloo processes on the CPU, or (``device=
    "cuda"``) this process on the card, as one rank of the caller's
    process group of ``n_devices`` ranks (one process per card: several
    ranks cannot share one card under NCCL). Returns rank 0's result (this
    rank's on the card); raises when a rank fails. ``keep``: as in
    :func:`run_checks`, on the card."""
    import torch.distributed as dist

    if device != "cpu":
        if not dist.is_initialized() or dist.get_world_size() != n_devices:
            raise ValueError(f"on the card the dry run is one rank of a process group of "
                             f"{n_devices}: form it first (multihost.initialize_distributed)")
        out = run_checks(device, keep)
        print(f"dryrun_multichip({n_devices}, {device!r}): OK, loss={out['loss']:.4f}")
        return out

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    port = _free_port()
    env = {**{k: v for k, v in os.environ.items() if k != "PYTHONPATH"}, "PYTHONPATH": root}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "sessionsimilaritysearch_tpu_torch.dryrun", str(rank),
         str(n_devices), str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=root,
    ) for rank in range(n_devices)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, text) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"dry-run rank {rank} failed:\n{text[-4000:]}")
    line = [x for x in outs[0].splitlines() if x.startswith("DRYRUN ")][-1]
    out = json.loads(line[len("DRYRUN "):])
    print(f"dryrun_multichip({n_devices}): OK, loss={out['loss']:.4f}, sharded search OK, "
          "sharded two-stage OK (binary + int8x8 + packed), sharded range_search OK, "
          "sharded remove OK, sharded binary (Hamming) OK")
    return out


def _rank_main(rank: int, world: int, port: int) -> None:
    import torch.distributed as dist

    from sessionsimilaritysearch_tpu_torch.parallel.multihost import initialize_distributed

    torch.set_num_threads(1)
    initialize_distributed(f"localhost:{port}", world, rank)
    try:
        out = run_checks("cpu")
        dist.barrier()
    finally:
        dist.destroy_process_group()
    print("DRYRUN " + json.dumps(out), flush=True)


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]))
