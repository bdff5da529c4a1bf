"""``correct`` at a size a CPU test holds: a sound run comes out correct;
the control (the reference in float8 in the program's place) and a run
whose timed path is broken underneath come out not correct, once per
fault a serving cell can have."""

import numpy as np
import pytest

from portbench import control, run
from portbench.tests.tiny import make_root

# the tiny cells' limits: sound CPU runs read score_err 0.002-0.004, miss
# 0.002-0.06 and pool_gap 0-1; the float8 control 0.02-0.05, 0.08-0.28, 5-6
LIMITS = {"bad_ids": 0, "score_err": 0.01, "miss": 0.5, "pool_gap": 3}
CELLS = ("tiny-dense", "tiny-twostage")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench"), LIMITS)


def _stale(index):
    search, last = index.search, []

    def stale(q, k, *a, **kw):
        out = search(q, k, *a, **kw)
        last.append(out)
        return last[-2] if len(last) > 1 else out  # the state of the step before

    index.search = stale


def _half_corpus(index):
    search = index.search

    def half(q, k, row_mask=None, **kw):
        return search(q, k, row_mask=np.arange(index.size) < index.size // 2, **kw)

    index.search = half


def _half_batch(index):
    search = index.search

    def half(q, k, *a, **kw):
        m = (q.shape[0] + 1) // 2
        D, I = search(q[:m], k, *a, **kw)
        rest = q.shape[0] - m
        return np.concatenate([D, D[:rest]]), np.concatenate([I, I[:rest]])

    index.search = half


def _altered(index):
    search = index.search

    def altered(q, k, *a, **kw):
        D, I = search(q, k, *a, **kw)
        I = I.copy()
        I[:, k // 2] = (I[:, k // 2] + 1) % index.size  # one answer of each session
        return D, I

    index.search = altered


FAULTS = {"stale": _stale, "half_corpus": _half_corpus, "half_batch": _half_batch,
          "altered": _altered}


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(root, cell):
    r = run.run_cell(run.load_cell(root, cell), 2**31 + 5, 1.0, False, "cpu")
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks"
    assert set(r) == {"correct", "attempted", "failed", "metrics", "device", "checks"}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_broken_timed_path_is_not_correct(root, cell, fault):
    r = run.run_cell(run.load_cell(root, cell), 2**31 + 6, 1.0, False, "cpu",
                     breaker=lambda eng: FAULTS[fault](eng.index))
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(root, cell):
    c = run.load_cell(root, cell)
    for seed in (11, 12, 13):
        nums = control.control_numbers(c, seed, "cpu", "fp8")
        assert not control.judge.verdict(nums, c.cfg["judge"]["limits"]), nums
        same = control.control_numbers(c, seed, "cpu", "f32")
        assert control.judge.verdict(same, c.cfg["judge"]["limits"]), same
