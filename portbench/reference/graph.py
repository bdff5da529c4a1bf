"""The session -> padded graph transform, for the fields the flagship
encoder reads: query nodes (a root ``''`` and one per search action),
distinct product nodes with their titles and ids, click edges query ->
product with multiplicity, product -> product transitions and the
last-clicked product. An action is ``(timestamp, type, keyword, asin,
product type, brand, title, asin id)``; type ``'s'`` is a search."""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from portbench.reference.tokenizer import encode


def session_graph(seq, max_seq_len: int, token_len: int, vocab_size: int,
                  ignore_query: bool) -> Dict[str, np.ndarray]:
    T, Q, P = token_len, max_seq_len + 1, max_seq_len
    if ignore_query:
        seq = [a for a in seq if a[1] != "s"]
    seq = list(seq)[:max_seq_len]

    words = [""] + [a[2] or "" for a in seq if a[1] == "s"]
    words = words[:Q]
    q_ids = np.zeros((Q, T), np.int32)
    for i, w in enumerate(words):
        q_ids[i] = encode(w, T, vocab_size)
    q_mask = np.zeros(Q, np.float32)
    q_mask[: len(words)] = 1.0

    items = list(dict.fromkeys(a[-1] for a in seq if a[1] != "s"))
    titles = []
    for it in items:
        a = next(a for a in seq if a[1] != "s" and a[-1] == it)
        titles.append(a[-2] or "")
    if not items:  # the unknown-product placeholder
        items, titles = [0], ["UNK"]
    items, titles = items[:P], titles[:P]
    pos = {it: i for i, it in enumerate(items)}
    p_ids = np.zeros((P, T), np.int32)
    for i, t in enumerate(titles):
        p_ids[i] = encode(t, T, vocab_size)
    asin = np.zeros(P, np.int64)
    asin[: len(items)] = items
    p_mask = np.zeros(P, np.float32)
    p_mask[: len(items)] = 1.0

    adj_qp = np.zeros((Q, P), np.float32)
    node = 0
    for a in seq:
        if a[1] == "s":
            node = min(node + 1, Q - 1)
        else:
            adj_qp[node, pos[a[-1]]] += 1.0
    clicks = [a[-1] for a in seq if a[1] != "s"] or [0]
    adj_pp = np.zeros((P, P), np.float32)
    last = 0
    for x, y in zip(clicks[:-1], clicks[1:]):
        adj_pp[pos[x], pos[y]] += 1.0
        last = pos[y]
    last_click = np.zeros(P, np.float32)
    last_click[last] = 1.0
    return {"query_ids": q_ids, "query_mask": q_mask, "product_asin": asin,
            "product_ids": p_ids, "product_mask": p_mask, "adj_qp": adj_qp,
            "adj_pp": adj_pp, "last_click": last_click}


def node_counts(seq, max_seq_len: int, ignore_query: bool) -> tuple:
    """The query and product nodes of ``seq``'s graph that ``session_graph``
    fills (its masks' sums): the work a session needs, padding left out."""
    if ignore_query:
        seq = [a for a in seq if a[1] != "s"]
    seq = list(seq)[:max_seq_len]
    n_q = min(1 + sum(1 for a in seq if a[1] == "s"), max_seq_len + 1)
    n_p = len(dict.fromkeys(a[-1] for a in seq if a[1] != "s")) or 1
    return n_q, min(n_p, max_seq_len)


def graph_batch(sessions: Sequence, max_seq_len: int, token_len: int, vocab_size: int,
                ignore_query: bool) -> Dict[str, np.ndarray]:
    graphs = [session_graph(s, max_seq_len, token_len, vocab_size, ignore_query)
              for s in sessions]
    return {k: np.stack([g[k] for g in graphs]) for k in graphs[0]}
