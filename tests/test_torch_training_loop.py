"""The port's checkpoints, training loop and reader of the JAX trainers'
checkpoints.

- ``utils.checkpoint.read_flax_msgpack`` against flax's own serializer and
  the ``msgpack`` package (every type flax writes, chunked arrays,
  bfloat16), leaf for leaf;
- a JAX ``CheckpointManager(use_orbax=False)`` ``latest`` file (and a
  ``train_state.save_state`` file) read without JAX equals the JAX state
  leaf for leaf; the port resumed from it takes JAX's next step (loss and
  metrics rtol 1e-5, Adam moments and BatchNorm statistics as
  tests/test_torch_pretrain.py, parameters atol 1e-6 where the update is
  determined); an Orbax directory raises a ``ValueError``;
- the port's ``CheckpointManager`` and ``state_to_tree`` / ``tree_to_state``:
  a restored state takes the uninterrupted run's next step bit for bit (the
  generator state rides along);
- ``run_training``: resume from ``latest``, ``best`` and ``loop_meta``, the
  replay of a resumed run equal to the uninterrupted one (the contract
  tests/test_campaign.py pins for JAX: replayed losses within 1e-4; on the
  CPU they are equal), and a non-finite step dropped or rolled back to the
  run's own ``latest``.
"""

import flax.serialization
import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from sessionsimilaritysearch_tpu.config import tiny_test_config as j_tiny
from sessionsimilaritysearch_tpu.data import SyntheticSessionGenerator as JGen
from sessionsimilaritysearch_tpu.data import build_graph_batch as j_build_batch
from sessionsimilaritysearch_tpu.tokenizer import get_tokenizer
from sessionsimilaritysearch_tpu.training import pretrain as jp
from sessionsimilaritysearch_tpu.training.train_state import TrainState as JState
from sessionsimilaritysearch_tpu.training.train_state import adam_with_clip as j_adam
from sessionsimilaritysearch_tpu.training.train_state import save_state as j_save_state
from sessionsimilaritysearch_tpu.utils import checkpoint as jck
from sessionsimilaritysearch_tpu_torch.config import tiny_test_config as t_tiny
from sessionsimilaritysearch_tpu_torch.data.graph import SessionGraph
from sessionsimilaritysearch_tpu_torch.evalharness.harness import to_device
from sessionsimilaritysearch_tpu_torch.training import pretrain as tp
from sessionsimilaritysearch_tpu_torch.training.loop import run_training
from sessionsimilaritysearch_tpu_torch.utils import checkpoint as tck
from sessionsimilaritysearch_tpu_torch.utils.logging import RunDir, read_metrics
from sessionsimilaritysearch_tpu_torch.weights import (
    _adam_state,
    load_flax_train_state,
    torch_key,
)

CPU = torch.device("cpu")


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _np(t):
    return t.detach().cpu().numpy()


def _layout(path, t):
    a = _np(t)
    return a.T if path[-1] == "kernel" else a


@pytest.fixture(scope="module")
def data():
    cfg = j_tiny()
    tok = get_tokenizer(cfg.vocab_size)
    sessions = JGen(asin_num=cfg.asin_num, seed=11).dataset(16)
    jb = [j_build_batch(sessions[i: i + 4], tok, cfg.dims) for i in range(0, 16, 4)]
    # the same host batches as the port's SessionGraph, which the loop uploads
    return {"jax_batches": jb, "batches": [SessionGraph(*b) for b in jb]}


def _t(batch):
    return to_device(SessionGraph(*(np.asarray(a) for a in batch)), CPU)


# ---------------------------------------------------------------------------
# the msgpack decoder
# ---------------------------------------------------------------------------

def test_decoder_reads_every_msgpack_type_flax_writes():
    obj = {"pos": [0, 127, 128, 255, 256, 65535, 65536, 2**32, 2**63 - 1],
           "neg": [-1, -32, -33, -128, -129, -32768, -32769, -2**31 - 1, -2**63],
           "float": [0.5, -1e300], "s": ["", "x" * 31, "y" * 32, "z" * 300, "é" * 40000],
           "b": [b"", b"a" * 300, b"b" * 70000], "none": None, "t": True, "f": False,
           "long_list": list(range(20)), "big_map": {str(i): i for i in range(20)}}
    assert tck._Reader(msgpack.packb(obj, use_bin_type=True)).value() == obj
    assert tck._Reader(msgpack.packb(np.float32(1.5).item(), use_single_float=True)
                       ).value() == 1.5


def test_decoder_reads_flax_arrays_and_chunks(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    tree = {"f32": rng.standard_normal((3, 5)).astype(np.float32),
            "i32": np.arange(7, dtype=np.int32), "scalar": np.asarray(3),
            "npscalar": np.float32(2.5), "empty": np.zeros((0, 4), np.float32),
            "bf16": jnp.asarray([1.0, -2.5, 3.0], jnp.bfloat16),
            "nested": {"u8": np.arange(5, dtype=np.uint8), "tuple": (np.ones(2), 4)}}
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 16)  # chunk the f32 leaf
    path = tmp_path / "tree.msgpack"
    path.write_bytes(flax.serialization.to_bytes(tree))
    back = tck.read_flax_msgpack(str(path))
    np.testing.assert_array_equal(back["f32"], tree["f32"])
    assert back["f32"].dtype == np.float32
    np.testing.assert_array_equal(back["i32"], tree["i32"])
    assert back["scalar"].shape == () and int(back["scalar"]) == 3
    assert back["npscalar"] == np.float32(2.5)
    assert back["empty"].shape == (0, 4)
    assert torch.equal(back["bf16"], torch.tensor([1.0, -2.5, 3.0], dtype=torch.bfloat16))
    np.testing.assert_array_equal(back["nested"]["u8"], tree["nested"]["u8"])
    np.testing.assert_array_equal(back["nested"]["tuple"]["0"], np.ones(2))
    assert back["nested"]["tuple"]["1"] == 4


def test_decoder_refuses_truncated_and_foreign_data(tmp_path):
    path = tmp_path / "bad.msgpack"
    path.write_bytes(flax.serialization.to_bytes({"a": np.ones(3)})[:-2])
    with pytest.raises(ValueError, match="truncated"):
        tck.read_flax_msgpack(str(path))
    path.write_bytes(msgpack.packb(msgpack.ExtType(9, b"xx")))
    with pytest.raises(ValueError, match="extension type 9"):
        tck.read_flax_msgpack(str(path))


# ---------------------------------------------------------------------------
# JAX trainer checkpoints
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_run(data, tmp_path_factory):
    """A JAX pretrain state after one step, saved by JAX's CheckpointManager
    (msgpack) and by save_state; and JAX's second step from it."""
    cfg = j_tiny()
    batches = [jax.tree.map(jnp.asarray, b) for b in data["jax_batches"]]
    model = jp.PretrainModel(cfg)
    v = jax.jit(lambda r, b: model.init(r, b, r, deterministic=True))(
        jax.random.PRNGKey(0), batches[0])
    state = JState.create(apply_fn=model.apply, params=v["params"],
                          tx=j_adam(cfg.lr, cfg.grad_clip_norm), batch_stats=v["batch_stats"])
    step = jp.make_train_step(model, has_view=False)
    state, _ = step(state, batches[0], jax.random.PRNGKey(1))
    d = tmp_path_factory.mktemp("jax_ckpt")
    jck.CheckpointManager(str(d), use_orbax=False).save("latest", jck.state_to_tree(state))
    j_save_state(str(d / "params.msgpack"), state)
    rng2 = jax.random.PRNGKey(2)
    after, metrics = step(state, batches[1], rng2)
    return {"cfg": cfg, "dir": str(d), "state": state, "after": after, "metrics": metrics,
            "rng2": rng2, "batch2": data["jax_batches"][1]}


def test_jax_latest_reads_leaf_for_leaf(jax_run):
    tree = tck.read_flax_checkpoint(jax_run["dir"], "latest")
    want = jax.tree.map(np.asarray, flax.serialization.to_state_dict(
        jck.state_to_tree(jax_run["state"])))
    got_leaves, want_leaves = dict(_leaves(tree)), dict(_leaves(want))
    assert set(got_leaves) == set(want_leaves)
    for key, w in want_leaves.items():
        np.testing.assert_array_equal(got_leaves[key], w, err_msg=str(key))
        assert np.asarray(got_leaves[key]).dtype == w.dtype, key


def test_orbax_directory_is_refused(tmp_path):
    (tmp_path / "latest").mkdir()  # the Orbax layout: a directory per tag
    with pytest.raises(ValueError, match="use_orbax=False"):
        tck.read_flax_checkpoint(str(tmp_path), "latest")
    with pytest.raises(FileNotFoundError):
        tck.read_flax_checkpoint(str(tmp_path), "best")


def _resumed(jax_run, tag_file=None):
    _, state = tp.create_pretrain_state(t_tiny(), CPU)
    tree = (tck.read_flax_checkpoint(jax_run["dir"], "latest") if tag_file is None
            else tck.read_flax_msgpack(tag_file))
    load_flax_train_state(state, tree)
    return state


def test_port_resumed_from_jax_takes_jax_next_step(jax_run):
    from test_torch_pretrain import jax_draws

    state = _resumed(jax_run)
    assert state.step == 1
    step = tp.make_train_step(state.model)
    draws = jax_draws(jax_run["cfg"], jax_run["batch2"], jax_run["rng2"])
    state, m = step(state, _t(jax_run["batch2"]), draws=draws)
    assert state.step == 2
    for k, v in jax_run["metrics"].items():
        np.testing.assert_allclose(_np(m[k]), np.asarray(v), rtol=1e-5, atol=1e-6)
    after = jax_run["after"]
    named = dict(state.model.named_parameters())
    buffers = dict(state.model.named_buffers())
    for path, v in _leaves(jax.tree.map(np.asarray, flax.core.unfreeze(after.batch_stats))):
        np.testing.assert_allclose(_np(buffers[torch_key(path)]), v, rtol=1e-5, atol=1e-6)
    adam = _adam_state(after.opt_state)
    assert int(adam["count"]) == 2
    mu = dict(_leaves(jax.tree.map(np.asarray, flax.core.unfreeze(adam["mu"]))))
    nu = dict(_leaves(jax.tree.map(np.asarray, flax.core.unfreeze(adam["nu"]))))
    new = dict(_leaves(jax.tree.map(np.asarray, flax.core.unfreeze(after.params))))
    gmax = max(float(np.abs(a).max()) for a in mu.values())
    checked = total = 0
    for path, p in ((k, named[torch_key(k)]) for k in new):
        st = state.optimizer.state[p]
        m_p, v_p = _layout(path, st["exp_avg"]), _layout(path, st["exp_avg_sq"])
        np.testing.assert_allclose(m_p, mu[path], rtol=1e-4, atol=2e-5 * gmax)
        np.testing.assert_allclose(v_p, nu[path], rtol=1e-3, atol=4e-10 * gmax * gmax * 100)

        def update(m1, v1):  # the second Adam step's update before the lr
            return (m1 / (1 - 0.9**2)) / (np.sqrt(v1 / (1 - 0.999**2)) + 1e-8)

        sure = np.abs(update(m_p, v_p) - update(mu[path], nu[path])) <= 1e-3
        np.testing.assert_allclose(_layout(path, p)[sure], new[path][sure], atol=1e-6,
                                   rtol=1e-6, err_msg=torch_key(path))
        checked, total = checked + int(sure.sum()), total + sure.size
    assert checked >= 0.9 * total


def test_save_state_file_loads_without_optimizer_state(jax_run):
    state = _resumed(jax_run, f"{jax_run['dir']}/params.msgpack")
    assert state.step == 1 and not state.optimizer.state  # no Adam state in the file
    p = dict(state.model.named_parameters())["target_asin_embedding.weight"]
    want = np.asarray(jax_run["state"].params["target_asin_embedding"]["embedding"])
    np.testing.assert_array_equal(_np(p), want)


# ---------------------------------------------------------------------------
# the port's checkpoints and loop
# ---------------------------------------------------------------------------

def _fresh():
    return tp.create_pretrain_state(t_tiny(), CPU)


def test_torch_key_of_the_pretrainer_names():
    assert torch_key(("next_product_head", "dense_1", "kernel")) == \
        "next_product_head.dense_1.weight"
    assert torch_key(("next_product_head", "bn_0", "scale")) == "next_product_head.bn_0.weight"
    assert torch_key(("next_product_head", "bn_0", "var")) == "next_product_head.bn_0.var"
    assert torch_key(("encoder", "cross_attention_transformer", "TransformerEncoder_0",
                      "layer_2", "MultiHeadAttention_0", "q_proj", "kernel")) == \
        "encoder.cross_attention_transformer.encoder.layers.2.self_attn.q_proj.weight"
    assert torch_key(("encoder", "pooling", "positional_emb", "embedding")) == \
        "encoder.pooling.positional_emb.weight"
    assert torch_key(("target_asin_embedding", "embedding")) == "target_asin_embedding.weight"


def test_checkpoint_manager_roundtrip(tmp_path):
    cm = tck.CheckpointManager(str(tmp_path / "ck"))
    assert not cm.has("latest") and cm.restore("latest") is None
    cm.save("latest", {"a": torch.arange(6.0).reshape(2, 3), "n": {"b": 3}})
    assert cm.has("latest") and not list((tmp_path / "ck").glob("*.tmp"))
    back = cm.restore("latest")
    assert torch.equal(back["a"], torch.arange(6.0).reshape(2, 3)) and back["n"]["b"] == 3


def test_restored_state_takes_the_same_next_step(data, tmp_path):
    batches = [_t(b) for b in data["batches"]]
    model, state = _fresh()
    step = tp.make_train_step(model)
    state, _ = step(state, batches[0])
    cm = tck.CheckpointManager(str(tmp_path))
    cm.save("latest", tck.state_to_tree(state))
    _, want = step(state, batches[1])

    model2, state2 = _fresh()
    tck.tree_to_state(state2, cm.restore("latest"))
    assert state2.step == 1
    state2, got = tp.make_train_step(model2)(state2, batches[1])
    assert float(got["loss"]) == float(want["loss"])
    for (n, a), (_, b) in zip(model.named_parameters(), model2.named_parameters()):
        assert torch.equal(a, b), n


def _recording(step_fn, losses):
    def step(state, batch):
        state, m = step_fn(state, batch)
        losses.append(float(m["loss"]))
        return state, m
    return step


def test_loop_resume_replays_the_uninterrupted_run(data, tmp_path):
    batches = data["batches"]
    model, state = _fresh()
    straight = []
    run_training(state=state, step_fn=_recording(tp.make_train_step(model), straight),
                 train_loader=batches, epochs=2)

    ckpt = tck.CheckpointManager(str(tmp_path / "ck"))
    model, state = _fresh()
    first = []
    run_training(state=state, step_fn=_recording(tp.make_train_step(model), first),
                 train_loader=batches, epochs=1, ckpt=ckpt)
    model, state = _fresh()  # a new process: the run resumes from 'latest'
    second = []
    state, _ = run_training(state=state, step_fn=_recording(tp.make_train_step(model), second),
                            train_loader=batches, epochs=1, ckpt=ckpt)
    assert state.step == 2 * len(batches)
    assert first + second == straight


def test_loop_keeps_best_and_loop_meta(data, tmp_path):
    ckpt = tck.CheckpointManager(str(tmp_path / "ck"))
    rd = RunDir(str(tmp_path / "run"), t_tiny(), "pretrain")
    model, state = _fresh()
    state, best = run_training(state=state, step_fn=tp.make_train_step(model),
                               eval_fn=tp.make_eval_step(model), train_loader=data["batches"],
                               valid_loader=data["batches"][:2], epochs=2, ckpt=ckpt,
                               rundir=rd, log_every=1)
    assert state.step == 8 and np.isfinite(best)
    assert ckpt.has("best") and ckpt.has("latest")
    assert ckpt.restore("loop_meta")["best_valid"] == best
    rows = read_metrics(rd.file("metrics.jsonl"))
    assert [r["step"] for r in rows if "loss" in r] == list(range(1, 9))
    assert sum("valid_loss" in r for r in rows) == 2
    # a restart carries best_valid and continues from 'latest'
    model2, fresh = _fresh()
    resumed, best2 = run_training(state=fresh, step_fn=tp.make_train_step(model2),
                                  train_loader=data["batches"], epochs=0, ckpt=ckpt)
    assert resumed.step == 8 and best2 == best


def _poisoned(batch):
    mask = np.array(batch.product_node_mask, np.float32)
    mask[0, 0] = np.nan
    return batch._replace(product_node_mask=mask)


def _snapshot(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _opt_snapshot(state):
    opt = state.optimizer.state_dict()["state"]
    return {(i, k): v.clone() for i, s in opt.items() for k, v in s.items()}


def test_nonfinite_step_is_dropped(data):
    """No checkpoint of its own: the loop drops the poisoned update (the
    step applies it, as JAX's does) and the next step starts from the
    state before it, BatchNorm statistics, Adam moments and step count
    included."""
    good = data["batches"][0]
    model, state = _fresh()
    seen = []

    def step(state, batch):
        seen.append((_snapshot(model), _opt_snapshot(state), state.step))
        return tp.make_train_step(model)(state, batch)

    state, _ = run_training(state=state, step_fn=step, epochs=1,
                            train_loader=[good, _poisoned(good), good])
    assert state.step == 2
    (before, opt_before, n_before), (after, opt_after, n_after) = seen[1], seen[2]
    assert n_before == n_after == 1
    assert all(torch.equal(before[k], after[k]) for k in before)
    assert all(torch.equal(opt_before[k], opt_after[k]) for k in opt_before)
    assert all(torch.isfinite(p).all() for p in model.parameters())


def test_nonfinite_first_step_is_dropped(data):
    """A poisoned first step: the loop returns to the initial parameters
    and to an optimizer with no state yet."""
    good = data["batches"][0]
    model, state = _fresh()
    init = _snapshot(model)
    state, _ = run_training(state=state, step_fn=tp.make_train_step(model), epochs=1,
                            train_loader=[_poisoned(good)])
    assert state.step == 0 and not state.optimizer.state
    final = _snapshot(model)
    assert all(torch.equal(init[k], final[k]) for k in init)


def test_nonfinite_update_stays_without_nan_recovery(data):
    """Without nan_recovery the poisoned update is applied, as JAX's step
    applies it and its loop keeps it."""
    good = data["batches"][0]
    model, state = _fresh()
    state, _ = run_training(state=state, step_fn=tp.make_train_step(model), epochs=1,
                            train_loader=[good, _poisoned(good)], nan_recovery=False)
    assert state.step == 2
    assert not all(torch.isfinite(p).all() for p in model.parameters())


def test_nonfinite_step_rolls_back_to_the_runs_latest(data, tmp_path):
    good = data["batches"][0]
    ckpt = tck.CheckpointManager(str(tmp_path / "ck"))
    rd = RunDir(str(tmp_path / "run"), None, "pretrain")
    model, state = _fresh()
    marks = {}

    def step(state, batch):
        state, m = tp.make_train_step(model)(state, batch)
        if state.step == 2 and "epoch1" not in marks:
            marks["epoch1"] = _snapshot(model)
        return state, m

    loader = _Epochs([[good, good], [good, _poisoned(good)]])
    state, _ = run_training(state=state, step_fn=step, train_loader=loader, epochs=2,
                            ckpt=ckpt, rundir=rd)
    # epoch 2's good step was rolled back with the poisoned one: the state is
    # epoch 1's 'latest'
    assert state.step == 2
    final = _snapshot(model)
    assert all(torch.equal(marks["epoch1"][k], final[k]) for k in final)
    log = open(rd.file("pretrain.log")).read()
    assert "non-finite loss at step 4; rolled back" in log


class _Epochs:
    """A loader that yields one given list of batches per epoch."""

    def __init__(self, epochs):
        self.epochs = iter(epochs)

    def __iter__(self):
        return iter(next(self.epochs))


def test_a_new_rundir_writes_only_to_its_own_log(tmp_path):
    """RunDir keys its logger on its log file's path: a RunDir made after
    another one of the same name was freed (Python hands the freed object's
    id to the new one) writes every message to its own file, none to the
    freed one's."""
    import gc

    for i in range(50):
        a = RunDir(str(tmp_path / f"a{i}"), None, "pretrain")
        a.logger.info("from a")
        del a
        gc.collect()
        b = RunDir(str(tmp_path / f"b{i}"), None, "pretrain")
        b.logger.warning(f"message {i}")
        for h in b.logger.handlers:
            h.flush()
        assert f"message {i}" in open(b.file("pretrain.log")).read(), i
        assert "message" not in open(tmp_path / f"a{i}" / "pretrain.log").read(), i


def test_a_rundir_reopened_on_a_recreated_directory_logs_there(tmp_path):
    import shutil

    rd = RunDir(str(tmp_path / "run"), None, "finetune")
    rd.logger.info("first")
    shutil.rmtree(tmp_path / "run")
    rd2 = RunDir(str(tmp_path / "run"), None, "finetune")
    rd2.logger.info("second")
    for h in rd2.logger.handlers:
        h.flush()
    assert "second" in open(rd2.file("finetune.log")).read()
