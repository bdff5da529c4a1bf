"""Session augmentations for contrastive pretraining.

Host-side equivalents of the reference's augmentation recipes
(pretrain_filtered_amazon.py:103-138): the active one swaps two random
actions and rebuilds the graph (the contrastive "second view", :460-463);
the commented-out drop/perturb/mask variants are provided as well since
they're part of the reference's capability surface.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from sessionsimilaritysearch_tpu_torch.data.schema import Action


def random_exchange_order(datum, rng: np.random.Generator):
    """Swap two random actions (pretrain_filtered_amazon.py:103-118)."""
    seq, tar = datum
    seq = list(seq)
    if len(seq) >= 2:
        i = int(rng.integers(len(seq)))
        j = int(rng.integers(len(seq)))
        tries = 1
        while j == i and tries < 10:
            j = int(rng.integers(len(seq)))
            tries += 1
        seq[i], seq[j] = seq[j], seq[i]
    return seq, list(tar)


def random_drop_action(datum, rng: np.random.Generator):
    """Drop one random action (the random_drop_node recipe, :94-101)."""
    seq, tar = datum
    seq = list(seq)
    if len(seq) > 1:
        del seq[int(rng.integers(len(seq)))]
    return seq, list(tar)


def random_mask_product(datum, rng: np.random.Generator):
    """Replace one product interaction with the unknown product id 0
    (the random_mask_node recipe, :130-137)."""
    seq, tar = datum
    seq = list(seq)
    idxs = [i for i, a in enumerate(seq) if a[1] != "s"]
    if idxs:
        i = int(rng.choice(idxs))
        a = seq[i]
        seq[i] = Action(a[0], a[1], a[2], None, a[4], a[5], a[6], 0)
    return seq, list(tar)


def random_perturb_product(datum, rng: np.random.Generator, asin_num: int):
    """Replace one product with a random one (:121-128)."""
    seq, tar = datum
    seq = list(seq)
    idxs = [i for i, a in enumerate(seq) if a[1] != "s"]
    if idxs:
        i = int(rng.choice(idxs))
        a = seq[i]
        new_id = int(rng.integers(asin_num))
        seq[i] = Action(a[0], a[1], a[2], f"R{new_id}", a[4], a[5], a[6], new_id)
    return seq, list(tar)
