"""Similarity fine-tuning: an asymmetric query / db pair of hash heads over
frozen session embeddings (counterpart of
``sessionsimilaritysearch_tpu/training/finetune.py``).

The encoder runs once over the fine-tune corpus; the fine-tune trains only
the two towers (``q_bin`` + ``q_dec``, ``db_bin`` + ``db_dec``), alternating:
even steps train the db side with the query side hard-coding (eval mode),
odd steps the reverse. The same heads serve any frozen embedding: the
flagship's, the pretrainer's or the text-only encoder's.

JAX runs two optax states over the whole tree and zeroes the other side's
gradients (``_side_mask``). The port keeps one ``AdamWithClip`` per tower,
over that tower's parameters only, which is exact:

- a leaf whose gradient was always zero has zero moments and gets no update
  (the fine-tune has no weight decay);
- the clip's global norm over the masked tree is the norm over one side;
- each optimizer counts its own steps for the bias correction, as each optax
  state does.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from sessionsimilaritysearch_tpu_torch.config import Config
from sessionsimilaritysearch_tpu_torch.device import resolve_device
from sessionsimilaritysearch_tpu_torch.models.encoder import init_parameters
from sessionsimilaritysearch_tpu_torch.models.heads import BinarizeHead
from sessionsimilaritysearch_tpu_torch.training import losses
from sessionsimilaritysearch_tpu_torch.training.train_state import adam_with_clip

SIDES = {"db": ("db_bin", "db_dec"), "q": ("q_bin", "q_dec")}


class TripletBatch(NamedTuple):
    """One fine-tune batch in embedding space: query-side sessions, their
    positive, half-positive and negative, the three similarity labels, and a
    random aux pair (subsession, full session)."""

    ori: torch.Tensor        # [B, d]
    pos: torch.Tensor        # [B, d]
    half: torch.Tensor       # [B, d]
    neg: torch.Tensor        # [B, d]
    pos_score: torch.Tensor  # [B]
    half_score: torch.Tensor
    neg_score: torch.Tensor
    aux_sub: torch.Tensor    # [B_aux, d]
    aux: torch.Tensor        # [B_aux, d]


def _base_similarity(batch: TripletBatch):
    """The frozen base's similarity target: the cosine matrix of the raw
    aux embeddings."""
    return losses._unit_rows(batch.aux_sub) @ losses._unit_rows(batch.aux).T


class FinetuneHeads(nn.Module):
    """Two ``BinarizeHead``s (``q_bin``, ``db_bin``: emb_dim -> code_len) and
    two linear decode heads (``q_dec``, ``db_dec``: code_len -> emb_dim)."""

    def __init__(self, code_len: int, emb_dim: int, device=None):
        super().__init__()
        self.q_bin = BinarizeHead(emb_dim, code_len, device=device)
        self.db_bin = BinarizeHead(emb_dim, code_len, device=device)
        self.q_dec = nn.Linear(code_len, emb_dim, device=device)
        self.db_dec = nn.Linear(code_len, emb_dim, device=device)

    def encode_query(self, emb, train: bool = False):
        return self.q_bin(emb, train=train)

    def encode_db(self, emb, train: bool = False):
        return self.db_bin(emb, train=train)

    def forward(self, batch: TripletBatch, parity: int, loss_type: str, aux_w: float,
                bin_w: float, rec_w: float) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """parity 0 = even step (the db side trains, the query side
        hard-codes); 1 = odd (the reverse). -> (loss, metrics)."""
        train_db = parity == 0
        train_q = not train_db
        base = _base_similarity(batch).detach()
        ori = self.q_bin(batch.ori, train=train_q)
        pos = self.db_bin(batch.pos, train=train_db)
        half = self.db_bin(batch.half, train=train_db)
        neg = self.db_bin(batch.neg, train=train_db)
        aux_sub = self.q_bin(batch.aux_sub, train=train_q)
        aux = self.db_bin(batch.aux, train=train_db)

        reg_loss = sum(losses.binary_regularize(c) for c in (ori, pos, half, neg, aux_sub, aux))
        aux_loss = losses.aux_consistency_loss(aux_sub, aux, base)
        pair = (losses.pair_loss(ori, pos, batch.pos_score, loss_type)
                + losses.pair_loss(ori, neg, batch.neg_score, loss_type)
                + losses.pair_loss(ori, half, batch.half_score, loss_type))
        if train_db:  # even: reconstruct the db side's aux embedding
            rec_loss = losses.reconstruction_loss(batch.aux, self.db_dec(aux))
        else:         # odd: the query side's
            rec_loss = losses.reconstruction_loss(batch.aux_sub, self.q_dec(aux_sub))
        loss = pair + aux_w * aux_loss + bin_w * reg_loss + rec_w * rec_loss
        return loss, {"loss": loss, "pair_loss": pair, "aux_loss": aux_loss,
                      "reg_loss": reg_loss, "rec_loss": rec_loss}

    def valid_losses(self, batch: TripletBatch, loss_type: str, aux_w: float, bin_w: float,
                     rec_w: float) -> Dict[str, torch.Tensor]:
        """The validation breakdown, every code in eval (hard-code) mode."""
        ori = self.q_bin(batch.ori, train=False)
        pos = self.db_bin(batch.pos, train=False)
        half = self.db_bin(batch.half, train=False)
        neg = self.db_bin(batch.neg, train=False)
        aux_sub = self.q_bin(batch.aux_sub, train=False)
        aux = self.db_bin(batch.aux, train=False)
        reg = sum(losses.binary_regularize(c) for c in (ori, pos, half, neg, aux_sub, aux))
        rec = (losses.reconstruction_loss(batch.aux_sub, self.q_dec(aux_sub))
               + losses.reconstruction_loss(batch.aux, self.db_dec(aux)))
        return {
            "pos_loss": losses.pair_loss(ori, pos, batch.pos_score, loss_type),
            "neg_loss": losses.pair_loss(ori, neg, batch.neg_score, loss_type),
            "half_loss": losses.pair_loss(ori, half, batch.half_score, loss_type),
            "aux_loss": aux_w * losses.aux_consistency_loss(aux_sub, aux,
                                                            _base_similarity(batch)),
            "reg_loss": bin_w * reg,
            "rec_loss": rec_w * rec,
        }

    def side_parameters(self, side: str):
        """The parameters of one tower, ``'db'`` or ``'q'``, in
        ``named_parameters`` order."""
        return [(n, p) for n, p in self.named_parameters() if n.split(".")[0] in SIDES[side]]


@dataclasses.dataclass
class FinetuneState:
    """The heads (their parameters), one optimizer per tower and the number
    of steps taken (its parity picks the side the next step trains)."""

    model: FinetuneHeads
    opt_db: torch.optim.Optimizer
    opt_q: torch.optim.Optimizer
    step: int = 0


def create_finetune_state(cfg: Config, device="cuda", emb_dim: Optional[int] = None,
                          shared_init: bool = False,
                          generator: Optional[torch.Generator] = None
                          ) -> Tuple[FinetuneHeads, FinetuneState]:
    """The heads on ``device`` (the card unless the caller asks for the CPU;
    weights drawn from ``generator``, default one seeded with ``cfg.seed``)
    and their state, with two Adam-with-clip optimizers at ``cfg.ft_lr``
    (``cfg.lr`` when 0). ``shared_init=True`` starts the db tower as a copy
    of the query tower, so both sides start as the same random projection
    (SimHash-grade codes on day zero). JAX returns the optax transform as a
    third value; here the optimizers live in the state."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(cfg.seed)
    model = FinetuneHeads(cfg.code_len, emb_dim or cfg.session_emb_dim, device=dev)
    init_parameters(model, generator)
    if shared_init:
        model.db_bin.load_state_dict(model.q_bin.state_dict())
    lr = cfg.ft_lr or cfg.lr

    def opt(side):
        return adam_with_clip([p for _, p in model.side_parameters(side)], lr,
                              cfg.grad_clip_norm)

    return model, FinetuneState(model, opt("db"), opt("q"))


def make_finetune_step(model: FinetuneHeads, cfg: Config):
    """``step(state, batch) -> (state, metrics)``: an even ``state.step``
    trains the db tower, an odd one the query tower (the other tower's
    optimizer does not step); ``state`` is updated in place. JAX's
    ``make_finetune_step`` also takes the optax transform, which the port's
    state holds."""

    def step(state: FinetuneState, batch: TripletBatch):
        parity = state.step % 2
        model.zero_grad(set_to_none=True)
        loss, metrics = model(batch, parity, cfg.loss_type, cfg.aux_w, cfg.bin_w, cfg.rec_w)
        loss.backward()
        (state.opt_db if parity == 0 else state.opt_q).step()
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    return step


def make_valid_fn(model: FinetuneHeads, cfg: Config):
    """``run(state, batch) -> {pos, neg, half, aux, reg, rec}_loss``, every
    code hard."""

    def run(state: FinetuneState, batch: TripletBatch):
        with torch.no_grad():
            return model.valid_losses(batch, cfg.loss_type, cfg.aux_w, cfg.bin_w, cfg.rec_w)

    return run


def make_code_fns(model: FinetuneHeads):
    """The hard-code encoders for serving: ``db_codes(state, emb)`` for the
    corpus, ``q_codes(state, emb)`` for queries; +-1 float rows [n,
    code_len] (0 where a pre-activation is exactly 0)."""

    def db_codes(state: FinetuneState, emb):
        with torch.no_grad():
            return model.encode_db(emb, train=False)

    def q_codes(state: FinetuneState, emb):
        with torch.no_grad():
            return model.encode_query(emb, train=False)

    return db_codes, q_codes


def build_triplet_batches(triplets, embed_fn, aux_pairs, batch_size: int,
                          rng: np.random.Generator, *, device="cuda"):
    """Mined raw triplets and aux pairs -> a factory of ``TripletBatch``
    streams on ``device``. ``embed_fn(list_of_data) -> np.ndarray`` embeds
    with the frozen encoder. The batches draw from ``rng`` in the JAX
    package's order (a permutation, then the aux rows of each batch), so the
    same seed gives the same batches in both packages."""
    dev = resolve_device(device)
    ori = embed_fn([t[0] for t in triplets])
    pos = embed_fn([t[1] for t in triplets])
    half = embed_fn([t[2] for t in triplets])
    neg = embed_fn([t[3] for t in triplets])
    scores = np.asarray([[t[4], t[5], t[6]] for t in triplets], np.float32)
    aux_sub = embed_fn([a[0] for a in aux_pairs])
    aux = embed_fn([a[1] for a in aux_pairs])
    n, na = len(triplets), len(aux_pairs)

    def up(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32, device=dev)

    def batches(shuffle: bool = True):
        idx = rng.permutation(n) if shuffle else np.arange(n)
        for s in range(0, n - batch_size + 1, batch_size):
            sel = idx[s: s + batch_size]
            a_sel = rng.integers(0, na, size=batch_size)
            yield TripletBatch(
                ori=up(ori[sel]), pos=up(pos[sel]), half=up(half[sel]), neg=up(neg[sel]),
                pos_score=up(scores[sel, 0]), half_score=up(scores[sel, 1]),
                neg_score=up(scores[sel, 2]), aux_sub=up(aux_sub[a_sel]), aux=up(aux[a_sel]),
            )

    return batches
