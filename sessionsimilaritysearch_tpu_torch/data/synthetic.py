"""Synthetic session generator.

The reference consumes pickled Amazon session lists that are not shipped
(reference: pretrain_filtered_amazon.py:212 loads
``us-filtered-split-train-data.pkl``). This generator produces sessions with
the same action schema (decompose_data.py:5-43) and enough latent structure
(product-type clusters, shared query vocabulary) that all four similarity
labelers (similarity.py) produce a meaningful signal, so the full train /
index / retrieve / evaluate pipeline is exercisable end-to-end.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from sessionsimilaritysearch_tpu_torch.data.schema import Action

_ADJ = [
    "red", "blue", "large", "small", "wireless", "portable", "classic",
    "modern", "compact", "premium", "budget", "ergonomic", "vintage", "smart",
]
_NOUN = [
    "lamp", "keyboard", "shoe", "bottle", "camera", "backpack", "speaker",
    "monitor", "chair", "kettle", "router", "jacket", "watch", "blender",
]


class SyntheticSessionGenerator:
    """Generates clustered e-commerce sessions.

    - ``n_types`` product types; each product belongs to one type.
    - Each session draws a small set of "interest" types; searches use
      keywords from those types' vocab; clicks/adds/purchases hit products of
      those types. Sessions sharing interests are similar under every
      labeler.
    """

    def __init__(
        self,
        asin_num: int = 1000,
        n_types: int = 20,
        n_brands: int = 50,
        seed: int = 0,
    ):
        self.asin_num = asin_num
        self.n_types = n_types
        self.rng = np.random.default_rng(seed)
        # catalog: asin -> (type, brand, title)
        self.product_type = self.rng.integers(0, n_types, size=asin_num)
        self.brand = self.rng.integers(0, n_brands, size=asin_num)
        self.type_name = [
            f"{_ADJ[t % len(_ADJ)]} {_NOUN[(t * 7) % len(_NOUN)]}"
            for t in range(n_types)
        ]
        self.titles = [
            f"{self.type_name[self.product_type[a]]} brand{self.brand[a]} model{a % 97}"
            for a in range(asin_num)
        ]
        # products grouped by type for fast sampling
        self.by_type = [
            np.where(self.product_type == t)[0] for t in range(n_types)
        ]

    def _make_action(self, t: float, kind: str, asin: int) -> Action:
        return Action(
            timestamp=t,
            action_type=kind,
            keyword=None,
            asin=f"ASIN{int(asin):07d}",
            product_type=self.type_name[self.product_type[asin]],
            brand=f"brand{self.brand[asin]}",
            title=self.titles[asin],
            asin_id=int(asin),
        )

    def _make_search(self, t: float, typ: int) -> Action:
        words = self.type_name[typ].split()
        k = self.rng.integers(1, len(words) + 1)
        kw = " ".join(
            words[i] for i in sorted(self.rng.choice(len(words), k, replace=False))
        )
        return Action(t, "s", kw, None, None, None, None)

    def session(self, max_len: int = 20, min_len: int = 4) -> List[Action]:
        n = int(self.rng.integers(min_len, max_len + 1))
        n_interests = int(self.rng.integers(1, 4))
        interests = self.rng.choice(self.n_types, n_interests, replace=False)
        actions: List[Action] = []
        t = 0.0
        cur_type = int(self.rng.choice(interests))
        for _ in range(n):
            t += float(self.rng.exponential(10.0))
            r = self.rng.random()
            if r < 0.25:
                cur_type = int(self.rng.choice(interests))
                actions.append(self._make_search(t, cur_type))
            else:
                pool = self.by_type[cur_type]
                if len(pool) == 0:
                    pool = np.arange(self.asin_num)
                asin = int(self.rng.choice(pool))
                kind = "c" if r < 0.85 else ("ca" if r < 0.95 else "p")
                actions.append(self._make_action(t, kind, asin))
        # guarantee at least one product interaction
        if all(a.action_type == "s" for a in actions):
            actions.append(
                self._make_action(t + 1.0, "c", int(self.rng.choice(self.by_type[cur_type])))
            )
        return actions

    def datum(self, max_len: int = 20) -> Tuple[List[Action], List[Action]]:
        """One (prefix, future) pair: generate a session and split it."""
        s = self.session(max_len=max_len)
        if len(s) < 2:
            return s, []
        cut = int(self.rng.integers(1, len(s)))
        return s[:cut], s[cut:]

    def dataset(self, n: int, max_len: int = 20):
        return [self.datum(max_len=max_len) for _ in range(n)]


_SYLL = [
    "zor", "vel", "mak", "tun", "rix", "pal", "den", "kol", "fen", "bur",
    "sil", "gat", "nov", "lum", "tar", "wex", "hol", "pin", "dra", "mos",
]


def _word(rng) -> str:
    """An invented 2-3 syllable token (no real-word priors for the text
    encoder to piggyback on)."""
    k = int(rng.integers(2, 4))
    return "".join(_SYLL[int(i)] for i in rng.integers(0, len(_SYLL), k))


class AdversarialSessionGenerator(SyntheticSessionGenerator):
    """Overlap-hostile session generator (VERDICT r2 item 2).

    The clustered generator above makes item overlap a near-sufficient
    similarity signal (type clusters == item clusters), so SKNN is
    near-oracle by construction. This regime breaks that correlation while
    keeping the TYPE structure (the ground-truth labeler's signal) intact,
    approximating the statistics of the reference's filtered-Amazon data
    (test_amazon_filterd.py:452-692) that no public dump reaches here:

    - **Power-law item popularity** (Zipf within each subtype): most
      catalog items are long-tail, so two same-interest sessions usually
      share ZERO specific items -- raw id-overlap is sparse evidence.
    - **Cross-type trending head**: ``trending_frac`` of the catalog is
      globally popular; every session clicks trending items with
      probability ``p_trend`` REGARDLESS of its interests. Shared trending
      items are the dominant source of item overlap and carry no interest
      signal -- exactly the blockbuster-pollution that defeats overlap
      matching on real e-commerce logs.
    - **Hierarchical taxonomy**: ``n_parents`` parent categories x
      ``subs_per_parent`` subtypes; a session's secondary interest is a
      SIBLING subtype with probability ``p_sibling`` (graded similarity
      structure instead of flat clusters).
    - **Title synonymy decoupled from item ids**: each subtype has a pool
      of ``syn_per_type`` invented tokens (sampled from its parent's
      larger pool, so siblings share vocabulary); titles and queries draw
      random subsets. Two same-subtype sessions share title SEMANTICS
      (learnable by the text encoder) even when their item-id sets are
      disjoint -- the signal lives where only the encoder can see it.

    The ``product_type`` strings remain one-per-subtype, so
    ``all_product_type_score`` (similarity.py; reference default labeler,
    config.py:61) measures true interest similarity for every system.
    """

    def __init__(
        self,
        asin_num: int = 8000,
        n_parents: int = 5,
        subs_per_parent: int = 5,
        n_brands: int = 50,
        seed: int = 0,
        zipf_a: float = 0.5,
        trending_frac: float = 0.008,
        p_trend: float = 0.4,
        p_sibling: float = 0.7,
        syn_per_type: int = 6,
    ):
        self.asin_num = asin_num
        self.n_parents = n_parents
        self.subs_per_parent = subs_per_parent
        self.n_types = n_parents * subs_per_parent
        self.p_trend = p_trend
        self.p_sibling = p_sibling
        self.rng = np.random.default_rng(seed)
        rng = self.rng
        self.product_type = rng.integers(0, self.n_types, size=asin_num)
        self.brand = rng.integers(0, n_brands, size=asin_num)
        self.parent_of = np.arange(self.n_types) // subs_per_parent
        # parent vocab pools -> subtype synonym pools (siblings overlap)
        parent_pool = [
            list({_word(rng) for _ in range(3 * syn_per_type)})
            for _ in range(n_parents)
        ]
        self.syn_pool = []
        for t in range(self.n_types):
            pool = parent_pool[self.parent_of[t]]
            take = rng.choice(len(pool), min(syn_per_type, len(pool)),
                              replace=False)
            self.syn_pool.append([pool[i] for i in take])
        # distinct subtype names keep the ground-truth labeler exact
        self.type_name = [
            f"cat{self.parent_of[t]}_sub{t}" for t in range(self.n_types)
        ]
        # titles: 2 synonym tokens + brand + model -- same-subtype titles
        # overlap partially in TOKENS, never exactly
        self.titles = []
        for a in range(asin_num):
            pool = self.syn_pool[self.product_type[a]]
            w = rng.choice(len(pool), 2, replace=len(pool) < 2)
            self.titles.append(
                f"{pool[w[0]]} {pool[w[1]]} brand{self.brand[a]} model{a % 97}"
            )
        self.by_type = [
            np.where(self.product_type == t)[0] for t in range(self.n_types)
        ]
        # Zipf popularity within each subtype (head items re-used, tail
        # items nearly unique per session)
        self._type_pop = []
        for t in range(self.n_types):
            n = len(self.by_type[t])
            w = 1.0 / np.power(np.arange(1, n + 1, dtype=np.float64), zipf_a)
            self._type_pop.append(w / w.sum() if n else w)
        # global trending head: popular across ALL subtypes
        n_trend = max(1, int(asin_num * trending_frac))
        self.trending = rng.choice(asin_num, n_trend, replace=False)
        tw = 1.0 / np.power(
            np.arange(1, n_trend + 1, dtype=np.float64), zipf_a
        )
        self._trend_pop = tw / tw.sum()

    def _make_search(self, t: float, typ: int) -> Action:
        pool = self.syn_pool[typ]
        k = int(self.rng.integers(1, 3))
        idx = self.rng.choice(len(pool), min(k, len(pool)), replace=False)
        return Action(t, "s", " ".join(pool[i] for i in sorted(idx)),
                      None, None, None, None)

    def session(self, max_len: int = 20, min_len: int = 4) -> List[Action]:
        rng = self.rng
        n = int(rng.integers(min_len, max_len + 1))
        primary = int(rng.integers(0, self.n_types))
        interests = [primary]
        if rng.random() < 0.5:  # a second interest, usually a sibling
            if rng.random() < self.p_sibling:
                parent = self.parent_of[primary]
                sibs = [t for t in range(self.n_types)
                        if self.parent_of[t] == parent and t != primary]
                interests.append(int(rng.choice(sibs)))
            else:
                interests.append(int(rng.integers(0, self.n_types)))
        actions: List[Action] = []
        t = 0.0
        cur_type = int(rng.choice(interests))
        for _ in range(n):
            t += float(rng.exponential(10.0))
            r = rng.random()
            if r < 0.2:
                cur_type = int(rng.choice(interests))
                actions.append(self._make_search(t, cur_type))
                continue
            if rng.random() < self.p_trend:
                # interest-blind trending click: spurious overlap
                asin = int(rng.choice(self.trending, p=self._trend_pop))
            else:
                pool = self.by_type[cur_type]
                if len(pool) == 0:
                    pool = np.arange(self.asin_num)
                    asin = int(rng.choice(pool))
                else:
                    asin = int(rng.choice(pool, p=self._type_pop[cur_type]))
            kind = "c" if r < 0.85 else ("ca" if r < 0.95 else "p")
            actions.append(self._make_action(t, kind, asin))
        if all(a.action_type == "s" for a in actions):
            pool = self.by_type[cur_type]
            actions.append(self._make_action(
                t + 1.0, "c",
                int(rng.choice(pool, p=self._type_pop[cur_type])),
            ))
        return actions
