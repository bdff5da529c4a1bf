"""Session action schema and host-side accessors.

A session is a list of actions; each action is the 8-tuple

    (timestamp, action_type, keyword, asin_str, product_type, brand, title,
     asin_id)

The first 7 fields are revealed by the reference's ETL flattening
(reference: decompose_data.py:13-17 writes action[0..6]); the trailing
integer asin id is what the filtered pickles carry and the graph builder
consumes positionally: ``action[-1]`` is the integer asin, ``action[-2]`` the
title, ``action[4]`` the product type, ``action[3]`` the raw asin string
(reference: util_amazon_filtered.py:33-96, 187). Action types: 's' search,
'c' click, 'ca' add-to-cart, 'p' purchase
(reference: train_session_embedding.py:29).

These accessors mirror the semantics of util_amazon_filtered.py:33-96 and
234-238; they run on the host, outside jit.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple


class Action(NamedTuple):
    timestamp: float
    action_type: str          # 's' | 'c' | 'ca' | 'p'
    keyword: Optional[str]    # search keyword (search actions)
    asin: Optional[str]       # raw asin string (non-search actions)
    product_type: Optional[str]
    brand: Optional[str]
    title: Optional[str]
    asin_id: int = 0          # integer product id (0 = unknown/none)


Session = Sequence[Action]
# A datum is (prefix, future): the observed session and its continuation.
Datum = Tuple[Session, Session]

CLICK_TYPE_IDS = {"c": 0, "ca": 1, "p": 2}


def is_search(action) -> bool:
    return action[1] == "s"


def get_item(session) -> set:
    """Distinct asins interacted with (util_amazon_filtered.py:33-34)."""
    return set(action[-1] for action in session if action[1] != "s")


def get_session_item_title(session) -> List[str]:
    """Title per interaction, in order (util_amazon_filtered.py:36-37)."""
    return [
        action[-2] if action[-2] is not None else ""
        for action in session
        if action[1] != "s"
    ]


def get_next_query(seq) -> Optional[str]:
    """First non-null search keyword (util_amazon_filtered.py:39-47)."""
    for action in seq:
        if action[1] == "s" and action[2] is not None:
            return action[2]
    return None


def get_all_query(seq) -> List[str]:
    """All non-null search keywords in order (util_amazon_filtered.py:49-56)."""
    return [a[2] for a in seq if a[1] == "s" and a[2] is not None]


def get_item_type(session) -> List[str]:
    """Non-null product types per interaction (util_amazon_filtered.py:59-60)."""
    return [
        action[4]
        for action in session
        if action[1] != "s" and action[4] is not None
    ]


def get_item_title(seq, item_list) -> List[str]:
    """First-seen title for each distinct item (util_amazon_filtered.py:62-72)."""
    titles = []
    for item in item_list:
        for action in seq:
            if action[1] != "s" and action[-1] == item:
                titles.append(action[-2] if action[-2] is not None else "")
                break
    return titles


def get_item_pos_cnt(seq, item_list):
    """Per-item occurrence count and per-occurrence reverse positions.

    Positions are ``len(seq) - j`` for each occurrence at index j, grouped by
    item in ``item_list`` order (util_amazon_filtered.py:75-83).
    """
    pos_list: List[int] = []
    cnt_list = [0 for _ in item_list]
    for i, item in enumerate(item_list):
        for j, action in enumerate(seq):
            if action[1] != "s" and action[-1] == item:
                cnt_list[i] += 1
                pos_list.append(len(seq) - j)
    return pos_list, cnt_list


def session_to_text(session) -> List[str]:
    """Flatten a session into one sentence per action
    (util_amazon_filtered.py:85-95)."""
    out = []
    for action in session:
        s = action[2] if action[1] == "s" else action[-2]
        out.append(s if s is not None else "")
    return out


def get_query(sess, pad: bool = True) -> List[str]:
    """Search keywords, optionally prefixed with the root ''
    (util_amazon_filtered.py:234-238)."""
    qs = [a[2] for a in sess if a[1] == "s" and a[2] is not None]
    return ([""] + qs) if pad else qs
