"""Session -> padded dense heterogeneous graph transform.

The reference builds a PyG ``HeteroData`` with ragged node/edge stores per
session (reference: util_amazon_filtered.py:98-230). On TPU, ragged sparse
graphs defeat XLA's static-shape compilation, so each session becomes a
fixed-shape bundle of dense arrays instead:

- node stores are padded to static maxima with validity masks;
- edge stores become dense adjacency matrices whose entries carry edge
  multiplicity / weight (``adj_qp`` holds click counts, ``adj_pp`` the merged
  transition weights of util_amazon_filtered.py:199-218);
- the per-occurrence ``repeat_interleave`` stream used by
  PositionalAttentionPooling (model/gnn.py:202-206) is pre-flattened into an
  ``occ_*`` store.

Sessions are tiny by construction (<=20 actions, config.py:5), so the padding
overhead is bounded and every encoder jits to one static shape. Batching is a
plain ``np.stack`` -- no PyG-style index-offset collation needed
(reference: DataLoader.py:12-54).
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence

import numpy as np

from sessionsimilaritysearch_tpu_torch.config import GraphDims
from sessionsimilaritysearch_tpu_torch.data import schema


class SessionGraph(NamedTuple):
    """One padded session graph (or a batch of them with a leading axis).

    All arrays are numpy on the host; JAX treats NamedTuples as pytrees so a
    batched SessionGraph moves to device as-is.
    """

    # query nodes [Q, T] / [Q]
    query_input_ids: np.ndarray
    query_type_ids: np.ndarray
    query_attention_mask: np.ndarray
    query_pos: np.ndarray          # reverse position id per node
    query_node_mask: np.ndarray    # 1 = real node (incl. root)
    query_loss_mask: np.ndarray    # reference 'query.mask': root zeroed

    # product nodes [P, T] / [P]
    product_asin: np.ndarray
    product_input_ids: np.ndarray
    product_type_ids: np.ndarray
    product_attention_mask: np.ndarray
    product_cnt: np.ndarray
    product_node_mask: np.ndarray
    last_click_mask: np.ndarray

    # occurrence stream [O] (pre-flattened repeat_interleave)
    occ_product: np.ndarray        # index into product rows
    occ_pos: np.ndarray
    occ_mask: np.ndarray

    # dense adjacency
    adj_qp: np.ndarray             # [Q, P] click-edge counts
    adj_pp: np.ndarray             # [P, P] merged transition weights

    # product targets [TgP]
    product_target_y: np.ndarray
    product_target_mask: np.ndarray
    product_target_click_type: np.ndarray
    product_target_input_ids: np.ndarray
    product_target_type_ids: np.ndarray
    product_target_attention_mask: np.ndarray

    # query targets [TgQ, T] / [TgQ]
    query_target_input_ids: np.ndarray
    query_target_type_ids: np.ndarray
    query_target_attention_mask: np.ndarray
    query_target_mask: np.ndarray       # 1 = real future query (placeholder=0)
    query_target_node_mask: np.ndarray  # 1 = row occupied (placeholder=1)

    # whole-session text [TXT, T] / [TXT]
    text_input_ids: np.ndarray
    text_type_ids: np.ndarray
    text_attention_mask: np.ndarray
    text_node_mask: np.ndarray

    # scalars
    idx: np.ndarray
    n_actions: np.ndarray

    @property
    def batch_size(self) -> int:
        return self.query_input_ids.shape[0] if self.query_input_ids.ndim == 3 else 1


def _pad_tokens(tok_out, rows: int, token_len: int):
    """Pad a tokenizer dict to [rows, token_len]."""
    ids = np.zeros((rows, token_len), dtype=np.int32)
    typ = np.zeros((rows, token_len), dtype=np.int32)
    att = np.zeros((rows, token_len), dtype=np.int32)
    n = min(tok_out["input_ids"].shape[0], rows)
    ids[:n] = tok_out["input_ids"][:n]
    typ[:n] = tok_out["token_type_ids"][:n]
    att[:n] = tok_out["attention_mask"][:n]
    return ids, typ, att


def sequence_to_graph(
    idx: int,
    seq,
    tar,
    tokenizer,
    dims: GraphDims,
    ignore_query: bool = False,
) -> SessionGraph:
    """Build one padded SessionGraph from a (prefix, future) session pair.

    Semantics mirror util_amazon_filtered.py:98-230; representation is dense
    padded (see module docstring). ``seq`` is the observed prefix, ``tar`` its
    future continuation (used only as labels).
    """
    T = dims.token_len
    Q, P, O = dims.max_query_nodes, dims.max_product_nodes, dims.max_occurrences
    TgP, TgQ, TXT = (
        dims.max_target_products,
        dims.max_target_queries,
        dims.max_text_sentences,
    )

    if ignore_query:
        seq = [a for a in seq if a[1] != "s"]
    seq = list(seq)[: dims.max_seq_len]
    n = len(seq)

    # ---- query nodes: root '' + one per search action (ref :7-22, 105-110)
    query_words = [""]
    query_pos_raw = [0]
    for i, action in enumerate(seq):
        if action[1] == "s":
            query_words.append(action[2] if action[2] is not None else "")
            query_pos_raw.append(i + 1)
    query_words = query_words[:Q]
    query_pos_raw = query_pos_raw[:Q]
    nq = len(query_words)
    qtok = tokenizer(query_words, max_length=T)
    q_ids, q_typ, q_att = _pad_tokens(qtok, Q, T)
    query_pos = np.zeros(Q, dtype=np.int32)
    # reverse position: len(seq) - pos (ref :22); clipped into the positional
    # embedding table (the reference indexes an Embedding(max_seq_len) with
    # values up to len(seq) -- we clip instead of risking overflow)
    query_pos[:nq] = np.clip(
        n - np.asarray(query_pos_raw, dtype=np.int32), 0, dims.max_seq_len
    )
    query_node_mask = np.zeros(Q, dtype=np.float32)
    query_node_mask[:nq] = 1.0
    query_loss_mask = query_node_mask.copy()
    query_loss_mask[0] = 0.0  # root excluded (ref :109-110)

    # ---- product nodes: distinct items (ref :128-158)
    distinct_item = list(dict.fromkeys(a[-1] for a in seq if a[1] != "s"))
    occ_pos_raw, item_cnt = schema.get_item_pos_cnt(seq, distinct_item)
    if not distinct_item:  # unknown-product placeholder (ref :132-135)
        distinct_item, item_cnt, occ_pos_raw = [0], [1], [0]
    distinct_item = distinct_item[:P]
    item_cnt = item_cnt[:P]
    np_nodes = len(distinct_item)
    pos = {item: i for i, item in enumerate(distinct_item)}

    title_list = schema.get_item_title(seq, distinct_item)
    if not title_list:
        title_list = ["UNK"]
    ptok = tokenizer(title_list, max_length=T)
    p_ids, p_typ, p_att = _pad_tokens(ptok, P, T)

    product_asin = np.zeros(P, dtype=np.int32)
    product_asin[:np_nodes] = distinct_item
    product_cnt = np.zeros(P, dtype=np.int32)
    product_cnt[:np_nodes] = item_cnt
    product_node_mask = np.zeros(P, dtype=np.float32)
    product_node_mask[:np_nodes] = 1.0

    # ---- occurrence stream (the repeat_interleave of model/gnn.py:202-206)
    occ_product_raw: List[int] = []
    for i, c in enumerate(item_cnt):
        occ_product_raw.extend([i] * c)
    occ_product_raw = occ_product_raw[:O]
    occ_pos_raw = occ_pos_raw[:O]
    no = len(occ_product_raw)
    occ_product = np.zeros(O, dtype=np.int32)
    occ_product[:no] = occ_product_raw
    occ_pos = np.zeros(O, dtype=np.int32)
    occ_pos[:no] = np.clip(np.asarray(occ_pos_raw, dtype=np.int32), 0, dims.max_seq_len)
    occ_mask = np.zeros(O, dtype=np.float32)
    occ_mask[:no] = 1.0

    # ---- query->product click edges with multiplicity (ref :179-197)
    adj_qp = np.zeros((Q, P), dtype=np.float32)
    last_query_node = 0
    for action in seq:
        if action[1] == "s":
            last_query_node = min(last_query_node + 1, Q - 1)
            continue
        adj_qp[last_query_node, pos[action[-1]]] += 1.0

    # ---- product->product transitions, merged weights (ref :199-218)
    item_seq = [a[-1] for a in seq if a[1] != "s"]
    if not item_seq:
        item_seq = [0]
    adj_pp = np.zeros((P, P), dtype=np.float32)
    last_click_pos = 0
    for i in range(len(item_seq) - 1):
        a, b = pos[item_seq[i]], pos[item_seq[i + 1]]
        adj_pp[a, b] += 1.0
        last_click_pos = b
    last_click_mask = np.zeros(P, dtype=np.float32)
    last_click_mask[last_click_pos] = 1.0

    # ---- product targets: distinct future items + titles (ref :162-176)
    tgt_items = list(dict.fromkeys(a[-1] for a in tar if a[1] != "s"))[:TgP]
    ntp = len(tgt_items)
    product_target_y = np.zeros(TgP, dtype=np.int32)
    product_target_y[:ntp] = tgt_items
    product_target_mask = np.zeros(TgP, dtype=np.float32)
    product_target_mask[:ntp] = 1.0
    click_type = np.zeros(TgP, dtype=np.int32)
    for i, item in enumerate(tgt_items):
        for a in tar:
            if a[1] != "s" and a[-1] == item:
                click_type[i] = schema.CLICK_TYPE_IDS.get(a[1], 0)
                break
    tgt_titles = schema.get_item_title(tar, tgt_items) if tgt_items else ["UNK"]
    if not tgt_titles:
        tgt_titles = ["UNK"]
    ttok = tokenizer(tgt_titles, max_length=T)
    pt_ids, pt_typ, pt_att = _pad_tokens(ttok, TgP, T)

    # ---- query targets: all future queries or masked '' (ref :112-126)
    future_query = schema.get_all_query(tar)
    if not future_query:
        future_query = [""]
        qt_valid = np.zeros(1, dtype=np.float32)
    else:
        qt_valid = np.ones(len(future_query), dtype=np.float32)
    future_query = future_query[:TgQ]
    qt_valid = qt_valid[:TgQ]
    nqt = len(future_query)
    qttok = tokenizer(future_query, max_length=T)
    qt_ids, qt_typ, qt_att = _pad_tokens(qttok, TgQ, T)
    query_target_mask = np.zeros(TgQ, dtype=np.float32)
    query_target_mask[:nqt] = qt_valid
    query_target_node_mask = np.zeros(TgQ, dtype=np.float32)
    query_target_node_mask[:nqt] = 1.0

    # ---- whole-session text: root '' + one sentence per action (ref :222-226)
    text = ([""] + schema.session_to_text(seq))[:TXT]
    ntx = len(text)
    xtok = tokenizer(text, max_length=T)
    x_ids, x_typ, x_att = _pad_tokens(xtok, TXT, T)
    text_node_mask = np.zeros(TXT, dtype=np.float32)
    text_node_mask[:ntx] = 1.0

    return SessionGraph(
        query_input_ids=q_ids,
        query_type_ids=q_typ,
        query_attention_mask=q_att,
        query_pos=query_pos,
        query_node_mask=query_node_mask,
        query_loss_mask=query_loss_mask,
        product_asin=product_asin,
        product_input_ids=p_ids,
        product_type_ids=p_typ,
        product_attention_mask=p_att,
        product_cnt=product_cnt,
        product_node_mask=product_node_mask,
        last_click_mask=last_click_mask,
        occ_product=occ_product,
        occ_pos=occ_pos,
        occ_mask=occ_mask,
        adj_qp=adj_qp,
        adj_pp=adj_pp,
        product_target_y=product_target_y,
        product_target_mask=product_target_mask,
        product_target_click_type=click_type,
        product_target_input_ids=pt_ids,
        product_target_type_ids=pt_typ,
        product_target_attention_mask=pt_att,
        query_target_input_ids=qt_ids,
        query_target_type_ids=qt_typ,
        query_target_attention_mask=qt_att,
        query_target_mask=query_target_mask,
        query_target_node_mask=query_target_node_mask,
        text_input_ids=x_ids,
        text_type_ids=x_typ,
        text_attention_mask=x_att,
        text_node_mask=text_node_mask,
        idx=np.asarray(idx, dtype=np.int32),
        n_actions=np.asarray(n, dtype=np.int32),
    )


def build_graph_batch(
    data: Sequence,
    tokenizer,
    dims: GraphDims,
    indices: Sequence[int] | None = None,
    ignore_query: bool = False,
) -> SessionGraph:
    """Build a whole padded batch from raw (prefix, future) pairs.

    With the hashing tokenizer and the native library present, the entire
    transform — tokenization included — runs as ONE C call over pre-zeroed
    batch arrays (native/graph_builder.cpp, OpenMP over sessions); this is
    the host hot path that bounds corpus embedding (the reference's
    dataloader-side cost, util_amazon_filtered.py:98-230 per session).
    Otherwise it is exactly ``batch_graphs([sequence_to_graph(...)])``.
    Bit-equivalence of the two paths is pinned by tests/test_native.py.
    """
    from sessionsimilaritysearch_tpu_torch import native as _native
    from sessionsimilaritysearch_tpu_torch.tokenizer import HashTokenizer

    idxs = list(indices) if indices is not None else list(range(len(data)))
    assert len(idxs) == len(data)
    if isinstance(tokenizer, HashTokenizer) and data:
        B = len(data)
        T, Q, P, O = (
            dims.token_len,
            dims.max_query_nodes,
            dims.max_product_nodes,
            dims.max_occurrences,
        )
        TgP, TgQ, TXT = (
            dims.max_target_products,
            dims.max_target_queries,
            dims.max_text_sentences,
        )
        i32, f32 = np.int32, np.float32
        # SessionGraph field order; graph_builder.cpp writes by position
        shapes = [
            ((B, Q, T), i32), ((B, Q, T), i32), ((B, Q, T), i32),
            ((B, Q), i32), ((B, Q), f32), ((B, Q), f32),
            ((B, P), i32), ((B, P, T), i32), ((B, P, T), i32),
            ((B, P, T), i32), ((B, P), i32), ((B, P), f32), ((B, P), f32),
            ((B, O), i32), ((B, O), i32), ((B, O), f32),
            ((B, Q, P), f32), ((B, P, P), f32),
            ((B, TgP), i32), ((B, TgP), f32), ((B, TgP), i32),
            ((B, TgP, T), i32), ((B, TgP, T), i32), ((B, TgP, T), i32),
            ((B, TgQ, T), i32), ((B, TgQ, T), i32), ((B, TgQ, T), i32),
            ((B, TgQ), f32), ((B, TgQ), f32),
            ((B, TXT, T), i32), ((B, TXT, T), i32), ((B, TXT, T), i32),
            ((B, TXT), f32),
            ((B,), i32), ((B,), i32),
        ]
        outs = [np.zeros(s, dtype=d) for s, d in shapes]
        dims8 = [T, Q, P, O, TgP, TgQ, TXT, dims.max_seq_len]
        ok = _native.build_graph_batch(
            [d[0] for d in data], [d[1] for d in data], idxs, dims8,
            tokenizer.vocab_size, ignore_query, outs,
        )
        if ok:
            return SessionGraph(*outs)
    return batch_graphs([
        sequence_to_graph(i, seq, tar, tokenizer, dims,
                          ignore_query=ignore_query)
        for i, (seq, tar) in zip(idxs, data)
    ])


def batch_graphs(graphs: Sequence[SessionGraph]) -> SessionGraph:
    """Stack fixed-shape session graphs into a batch along a new leading axis.

    Replaces PyG's index-offset collation (reference: DataLoader.py:12-54):
    with static padded shapes a plain stack suffices, and the result maps
    directly onto a data-parallel mesh axis.
    """
    return SessionGraph(*[np.stack(arrs) for arrs in zip(*graphs)])


def truncate_to_subsession(
    datum, rng: np.random.Generator, min_items: int = 1
):
    """Randomly cut a session at a product interaction, returning
    (prefix, future) with the future re-labeled.

    Host-side equivalent of the reference's ``to_subsession`` graph surgery
    (train_subsession_embedding.py:35-203): instead of truncating node/edge
    stores in-place we re-derive the graph from the cut action sequence,
    which is simpler and equivalent for dense rebuilds.
    """
    seq, tar = datum
    item_positions = [i for i, a in enumerate(seq) if a[1] != "s"]
    if len(item_positions) <= min_items:
        return list(seq), list(tar)
    cut_idx = int(rng.integers(min_items, len(item_positions)))
    cut = item_positions[cut_idx]
    prefix = list(seq[:cut])
    future = list(seq[cut:]) + list(tar)
    return prefix, future
