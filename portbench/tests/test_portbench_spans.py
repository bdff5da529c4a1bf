"""The metrics read from the program's own spans and counters: a traced
tiny cell of each semantics reports every one that needs no card, the
upload's megabytes equal a count from the shapes, the selection's host
time is the dense cell's alone, and an untraced run, or a program that
keeps no spans, gives none of them."""

import pytest

from portbench import program, run, spans
from portbench.tests.test_portbench_check import LIMITS
from portbench.tests.tiny import TINY_TRAFFIC, make_root

NEW = ("build_ms.bulk", "embed_wait_ms.bulk", "upload_ms.bulk", "upload_mb.bulk",
       "forward_device_ms.bulk", "select_host_ms.bulk")
CARD_ONLY = {"forward_device_ms.bulk"}  # CUDA events
DENSE_ONLY = {"select_host_ms.bulk"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench"), LIMITS)


def _traced(root, cell, seed, monkeypatch):
    """The result of a traced run and the readers' view of it."""
    c = run.load_cell(root, cell)
    seen = {}
    real = run.metric_reader

    def keep(root_, name):
        read = real(root_, name)

        def wrapped(rec):
            seen.setdefault("rec", rec)
            return read(rec)

        return wrapped

    monkeypatch.setattr(run, "metric_reader", keep)
    r = run.run_cell(c, seed, 1.0, True, "cpu")
    monkeypatch.undo()
    return c, r, seen["rec"]


def upload_bytes_a_session(cfg: dict) -> int:
    """The bytes of one session's graph fields and keyword ids, counted from
    the padded shapes (every field 4 bytes an element)."""
    d = program.program_config(cfg["model"]).dims
    T, Qn, P, O = d.token_len, d.max_query_nodes, d.max_product_nodes, d.max_occurrences
    TgP, TgQ, TXT = d.max_target_products, d.max_target_queries, d.max_text_sentences
    elements = (3 * Qn * T + 3 * Qn          # query tokens; pos, node and loss masks
                + 3 * P * T + 4 * P          # product tokens; asin, cnt, masks
                + 3 * O                      # occurrences
                + Qn * P + P * P             # adjacency
                + 3 * TgP * T + 3 * TgP      # product targets
                + 3 * TgQ * T + 2 * TgQ      # query targets
                + 3 * TXT * T + TXT          # whole-session text
                + 2                          # idx, n_actions
                + Qn)                        # keyword ids
    return 4 * elements


@pytest.mark.parametrize("cell", ["tiny-dense", "tiny-twostage"])
def test_a_traced_cell_reports_the_program_span_metrics(root, cell, monkeypatch):
    c, r, rec = _traced(root, cell, 2**31 + 21, monkeypatch)
    assert r["correct"], r["checks"]
    got = r["metrics"]
    want = set(NEW) - CARD_ONLY - (set() if cell == "tiny-dense" else DENSE_ONLY)
    assert want <= set(got), sorted(got)
    assert not (set(NEW) - want) & set(got)
    n = spans.requests(rec)
    assert n == rec.trace.count("index") > 0
    mb = upload_bytes_a_session(c.cfg) * TINY_TRAFFIC["request_sessions"] / 1e6
    assert got["upload_mb.bulk"]["value"] == pytest.approx(mb, rel=1e-12)
    assert got["upload_mb.bulk"]["unit"] == "MB"
    # the request waits at least as long as the loader builds
    assert got["embed_wait_ms.bulk"]["value"] >= got["build_ms.bulk"]["value"] > 0
    assert got["upload_ms.bulk"]["value"] > 0
    if cell == "tiny-dense":
        assert got["select_host_ms.bulk"]["value"] > 0


def test_the_flagship_request_uploads_its_hand_count():
    """The cells' request of 1,024 sessions at ``Config()``'s padded
    shapes: 29,064 bytes of graph fields and 84 of keyword ids a session."""
    cfg = {"model": {}}
    assert upload_bytes_a_session(cfg) == 29_064 + 84
    assert upload_bytes_a_session(cfg) * 1024 / 1e6 == pytest.approx(29.847552)


def test_an_untraced_run_gives_none_of_them(root):
    r = run.run_cell(run.load_cell(root, "tiny-dense"), 2**31 + 22, 0.5, False, "cpu")
    assert r["correct"]

    class Untraced:
        trace = None

    for name in NEW:
        assert run.metric_reader(root, name)(Untraced) is None


def test_a_program_without_spans_gives_none(root, monkeypatch):
    """A program from before the spans were added keeps none: the readers
    return None and do not raise."""
    _, _, rec = _traced(root, "tiny-dense", 2**31 + 23, monkeypatch)
    from sessionsimilaritysearch_tpu_torch.utils import profiling

    assert run.metric_reader(root, "build_ms.bulk")(rec) is not None
    monkeypatch.delattr(profiling, "records")
    for name in NEW:
        assert run.metric_reader(root, name)(rec) is None
