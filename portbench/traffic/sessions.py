"""Clustered e-commerce sessions over a synthetic catalog: a frozen copy
of the program's synthetic session generator, kept here so that a change
to the program cannot move the benchmark's inputs.

``n_types`` product types, each product of one type, one brand and the
title ``"<type name> brand<b> model<asin % 97>"``. A session draws one to
three interest types; a quarter of its actions search a keyword of a
current interest type, the rest click (60%), add to cart (10%) or buy (5%)
a product of that type; it holds at least one product action. An action
is ``(timestamp, type, keyword, asin string, product type, brand, title,
asin id)``.
"""

from __future__ import annotations

from typing import List

import numpy as np

_ADJ = [
    "red", "blue", "large", "small", "wireless", "portable", "classic",
    "modern", "compact", "premium", "budget", "ergonomic", "vintage", "smart",
]
_NOUN = [
    "lamp", "keyboard", "shoe", "bottle", "camera", "backpack", "speaker",
    "monitor", "chair", "kettle", "router", "jacket", "watch", "blender",
]


class SessionGenerator:
    def __init__(self, asin_num: int, n_types: int = 20, n_brands: int = 50, seed: int = 0):
        self.asin_num = asin_num
        self.n_types = n_types
        self.rng = np.random.default_rng(seed)
        self.product_type = self.rng.integers(0, n_types, size=asin_num)
        self.brand = self.rng.integers(0, n_brands, size=asin_num)
        self.type_name = [f"{_ADJ[t % len(_ADJ)]} {_NOUN[(t * 7) % len(_NOUN)]}"
                          for t in range(n_types)]
        self.titles = [f"{self.type_name[t]} brand{b} model{a % 97}"
                       for a, (t, b) in enumerate(zip(self.product_type.tolist(),
                                                      self.brand.tolist()))]
        self.by_type = [np.where(self.product_type == t)[0] for t in range(n_types)]

    def _product(self, t: float, kind: str, asin: int) -> tuple:
        return (t, kind, None, f"ASIN{asin:07d}", self.type_name[self.product_type[asin]],
                f"brand{self.brand[asin]}", self.titles[asin], asin)

    def _search(self, t: float, typ: int) -> tuple:
        words = self.type_name[typ].split()
        k = self.rng.integers(1, len(words) + 1)
        kw = " ".join(words[i] for i in sorted(self.rng.choice(len(words), k, replace=False)))
        return (t, "s", kw, None, None, None, None, 0)

    def session(self, min_len: int, max_len: int) -> List[tuple]:
        rng = self.rng
        n = int(rng.integers(min_len, max_len + 1))
        interests = rng.choice(self.n_types, int(rng.integers(1, 4)), replace=False)
        actions: List[tuple] = []
        t = 0.0
        cur = int(rng.choice(interests))
        for _ in range(n):
            t += float(rng.exponential(10.0))
            r = rng.random()
            if r < 0.25:
                cur = int(rng.choice(interests))
                actions.append(self._search(t, cur))
            else:
                pool = self.by_type[cur]
                if len(pool) == 0:
                    pool = np.arange(self.asin_num)
                kind = "c" if r < 0.85 else ("ca" if r < 0.95 else "p")
                actions.append(self._product(t, kind, int(rng.choice(pool))))
        if all(a[1] == "s" for a in actions):
            actions.append(self._product(t + 1.0, "c", int(rng.choice(self.by_type[cur]))))
        return actions
