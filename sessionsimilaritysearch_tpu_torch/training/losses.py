"""The trainers' losses (counterparts of
``sessionsimilaritysearch_tpu/training/losses.py``), with the same clips,
weightings and masks:

- the pretrainer's: ``_clipped_norm_rows`` :32, ``cosine_similarity`` :36,
  ``contrastive_loss`` :43, ``make_token_mask`` :65, ``mlm_loss`` :72,
  ``electra_loss`` :80, ``next_text_embedding_loss`` :104,
  ``all_text_embedding_loss`` :114, ``product_target_onehot`` :144,
  ``product_asin_loss`` :154, ``product_asin_precision_recall`` :180,
  ``node_reconstruction_loss`` :273 and ``qaea_distill_loss`` :287
  (``mlm_loss`` and ``next_text_embedding_loss`` serve no trainer, in
  either package);
- the session trainers' query generation: ``make_mlm_target`` :297,
  ``next_query_mlm_loss`` :308, ``autoregressive_query_loss`` :320 and
  ``next_query_electra_loss`` :350;
- the fine-tuner's: ``binary_regularize`` :56, ``_criterion`` :201,
  ``pair_loss`` :209, ``pair_matrix_loss`` :216, ``sim_matrix_loss`` :228,
  ``triplet_loss`` :238, ``aux_consistency_loss`` :246 and
  ``reconstruction_loss`` :259.

The random parts take their draws as arguments or from a
``torch.Generator`` (``make_token_mask``, ``make_mlm_target``, the
negative token ids of ``autoregressive_query_loss``; ``product_asin_loss``
takes its negative-sample mask), so a caller can feed the JAX package's
draws and compare step for step.

**Data parallel.** The pretrainer's batch-coupled losses take ``group``
(a ``parallel.sharding.BatchGroup``; by default ``ALONE``, this process by
itself, whose collectives are the identity): each rank passes its rows of
the global batch and gets its share of the global batch's loss, so that the
shares sum to the one-process loss on the whole batch. A masked mean
divides this rank's sum by the count summed over the ranks (the mean of
per-rank means is another loss when the counts differ); the in-batch
matrices of ``contrastive_loss`` and ``all_text_embedding_loss`` score this
rank's rows against every rank's columns, gathered with their gradient;
``product_asin_loss`` against a row-sharded table scores every rank's rows
against this rank's asins.
"""

from __future__ import annotations

import torch

from sessionsimilaritysearch_tpu_torch.parallel.sharding import ALONE, BatchGroup

MASK_TOKEN_ID = 4  # the tokenizer's [MASK]
MIN_MASKABLE_ID = 5  # ids below are special tokens


def _clipped_norm_rows(x, eps: float = 1e-6):
    return x / torch.sqrt(torch.clamp((x * x).sum(dim=1, keepdim=True), min=eps))


def cosine_similarity(a, b, dim: int = -1, eps: float = 1e-8):
    """Per-row cosine with the product of the norms clipped at ``eps``."""
    an = torch.linalg.vector_norm(a, dim=dim)
    bn = torch.linalg.vector_norm(b, dim=dim)
    return (a * b).sum(dim=dim) / torch.clamp(an * bn, min=eps)


def _diagonal(rows: int, cols: int, group: BatchGroup, device):
    """[rows, cols] membership of this rank's rows among the global
    batch's columns: row i is global row ``offset + i``."""
    offset = group.rows(rows)[0]
    return (torch.arange(cols, device=device)[None, :]
            == offset + torch.arange(rows, device=device)[:, None])


def contrastive_loss(view1, view2, group: BatchGroup = ALONE):
    """JS-style contrastive estimator: normalized cosine score matrix clipped
    to [1e-4, 0.9999]; off-diagonal log(1 - s), diagonal 10 log(s);
    normalized by B^2 + 9B (B the global batch)."""
    other = group.gather(_clipped_norm_rows(view2))
    score = torch.clamp(_clipped_norm_rows(view1) @ other.T, 1e-4, 0.9999)
    b = other.shape[0]
    eye = _diagonal(view1.shape[0], b, group, score.device).to(score.dtype)
    js = torch.log(1.0 - score) * (1.0 - eye) + 10.0 * torch.log(score) * eye
    return -js.sum() / (b * b + 9 * b)


def binary_regularize(out):
    """Push codes to +-1: mean |1 - |out||."""
    return (1.0 - out.abs()).abs().mean()


def make_token_mask(generator: torch.Generator, input_ids, mask_ratio: float,
                    min_maskable_id: int = MIN_MASKABLE_ID):
    """Random maskable-token selection: uniform < ratio AND id >= 5."""
    r = torch.rand(input_ids.shape, generator=generator, device=input_ids.device)
    return (r < mask_ratio) & (input_ids >= min_maskable_id)


def mlm_loss(logits, gt_ids, token_mask):
    """Cross entropy at the masked positions: logits [..., T, V]; gt_ids and
    token_mask [..., T]; mean over the mask, denominator clipped at 1."""
    ce = _token_ce(logits, gt_ids)
    m = token_mask.to(ce.dtype)
    return (ce * m).sum() / torch.clamp(m.sum(), min=1.0)


def electra_loss(pred, input_ids, gt_ids, valid_mask=None, group: BatchGroup = ALONE):
    """Replaced-token-detection BCE, pred in (0, 1) clipped to [1e-7, 1 -
    1e-7]; averaged over ``valid_mask`` when given (the JAX package's
    deliberate exclusion of padding), else over every position."""
    label = (input_ids != gt_ids).to(pred.dtype)
    p = torch.clamp(pred, 1e-7, 1.0 - 1e-7)
    bce = -(label * torch.log(p) + (1.0 - label) * torch.log(1.0 - p))
    if valid_mask is None:  # every rank holds as many positions
        return bce.mean() / group.world
    m = valid_mask.to(bce.dtype)
    return (bce * m).sum() / torch.clamp(group.sum(m.sum()), min=1.0)


def next_text_embedding_loss(rep, target, valid_mask):
    """One target row per graph: sigmoid(rep @ target.T) [B, B] clipped to
    [1e-7, 1 - 1e-7] against diag(valid_mask), mean BCE over the matrix."""
    val = torch.clamp(torch.sigmoid(rep @ target.T), 1e-7, 1.0 - 1e-7)
    y = torch.diag(valid_mask.to(val.dtype))
    return (-(y * torch.log(val) + (1.0 - y) * torch.log(1.0 - val))).mean()


def all_text_embedding_loss(rep, targets, node_mask, valid_mask=None,
                            group: BatchGroup = ALONE):
    """Batch-membership BCE over a padded target store: rep [B, d]; targets
    [B, T, d]; node_mask [B, T] real rows; valid_mask [B, T] rows allowed as
    positives (default node_mask). Memberships with valid_mask 0 and padded
    rows are left out of the mean. This rank's rows of ``rep`` score every
    rank's targets."""
    if valid_mask is None:
        valid_mask = node_mask
    targets = group.gather(targets)
    node_mask, valid_mask = group.gather(node_mask), group.gather(valid_mask)
    B, T, d = targets.shape
    rows = rep.shape[0]
    val = torch.clamp(torch.sigmoid(rep @ targets.reshape(B * T, d).T), 1e-7, 1.0 - 1e-7)
    member = _diagonal(rows, B, group, rep.device).repeat_interleave(T, dim=1).to(val.dtype)
    exists = node_mask.reshape(1, B * T).to(val.dtype).expand(rows, -1)
    valid = valid_mask.reshape(1, B * T).to(val.dtype).expand(rows, -1)
    include = exists * (1.0 - member * (1.0 - valid))
    loss_mat = -(member * torch.log(val) + (1.0 - member) * torch.log(1.0 - val))
    return (loss_mat * include).sum() / torch.clamp(group.sum(include.sum()), min=1.0)


def product_target_onehot(target_y, target_mask, asin_num: int):
    """y [B, asin_num]: the largest target mask at each target asin. A
    scatter-max, as the JAX ``.at[].max``: padded targets point at asin 0
    with mask 0 and must not erase a real target at asin 0."""
    B = target_y.shape[0]
    y = torch.zeros(B, asin_num, dtype=torch.float32, device=target_y.device)
    return y.scatter_reduce(1, target_y.long(), target_mask.to(torch.float32), "amax")


def product_asin_loss(rep, asin_table, target_y, target_mask, neg_mask,
                      group: BatchGroup = ALONE, shard=None):
    """Sigmoid logits over the whole asin vocabulary, clipped to [1e-4,
    0.9999], BCE averaged over the positives plus the sampled negatives.
    ``neg_mask`` [B, asin_num] is the negative sample: uniform draws below
    ``neg_sample_count / asin_num`` (:func:`negative_mask`).

    This rank's share of the global batch's loss over ``group``. A
    replicated table scores this rank's rows against every asin; a
    row-sharded one (``shard``, its ``RowShard``: ``asin_table`` holds asins
    [start, stop)) scores every rank's rows, gathered with their gradient,
    against this rank's asins, and ``neg_mask`` is then [global B, stop -
    start], the global negative sample cut to those columns."""
    if shard is not None:
        rep = group.gather(rep)
        local = group.gather(target_y) - shard.start
        mine = (local >= 0) & (local < asin_table.shape[0])
        target_y = torch.where(mine, local, 0)
        target_mask = group.gather(target_mask) * mine.to(target_mask.dtype)
    y = product_target_onehot(target_y, target_mask, asin_table.shape[0])
    val = torch.clamp(torch.sigmoid(rep @ asin_table.T), 1e-4, 0.9999)
    loss_mat = -(y * torch.log(val) + (1.0 - y) * torch.log(1.0 - val))
    loss_mask = (neg_mask | (y > 0)).to(loss_mat.dtype)
    return (loss_mat * loss_mask).sum() / torch.clamp(group.sum(loss_mask.sum()), min=1.0)


def negative_mask(generator: torch.Generator, batch: int, asin_num: int,
                  neg_sample_count: int, device):
    """About ``neg_sample_count`` random negatives per row: [batch, asin_num]
    bool, uniform draws below ``neg_sample_count / asin_num``."""
    u = torch.rand(batch, asin_num, generator=generator, device=device)
    return u < (neg_sample_count / asin_num)


def product_asin_precision_recall(rep, asin_table, target_y, target_mask, k: int):
    """Top-k precision and recall over the asin vocabulary, batch means over
    the graphs that have targets."""
    val = rep @ asin_table.T
    pred = torch.topk(val, k, dim=1).indices
    y = product_target_onehot(target_y, target_mask, asin_table.shape[0])
    hit = torch.gather(y, 1, pred).sum(dim=1)
    gt_count = y.sum(dim=1)
    has_gt = (gt_count > 0).to(val.dtype)
    denom = torch.clamp(has_gt.sum(), min=1.0)
    precision = (has_gt * hit / k).sum() / denom
    recall = (has_gt * hit / torch.clamp(gt_count, min=1.0)).sum() / denom
    return precision, recall


def node_reconstruction_loss(node_pred, node_feat, keep_mask, node_exists=None,
                             group: BatchGroup = ALONE):
    """Squared (1 - cos) on the nodes the keep mask dropped (and that exist)."""
    node_pred = node_pred.reshape(-1, node_pred.shape[-1])
    node_feat = node_feat.reshape(-1, node_feat.shape[-1])
    dropped = 1.0 - keep_mask.reshape(-1)
    if node_exists is not None:
        dropped = dropped * node_exists.reshape(-1)
    err = (1.0 - cosine_similarity(node_pred, node_feat)) ** 2
    return (dropped * err).sum() / (group.sum(dropped.sum()) + 1e-3)


def qaea_distill_loss(pred, label, group: BatchGroup = ALONE):
    """mean(1 - cos) toward the frozen text embedding (no gradient into it)."""
    return (1.0 - cosine_similarity(pred, label.detach())).mean() / group.world


# ---------------------------------------------------------------------------
# Similarity fine-tune losses
# ---------------------------------------------------------------------------

def _unit_rows(x):
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=1, keepdim=True), min=1e-12)


def _criterion(pred, tgt, loss_type: str):
    if loss_type == "MSE":
        return ((pred - tgt) ** 2).mean()
    if loss_type == "L1":
        return (pred - tgt).abs().mean()
    raise ValueError(f"unrecognized loss type {loss_type}")


def pair_loss(out1, out2, lab, loss_type: str = "MSE"):
    """Per-row cosine against scalar labels."""
    pred = cosine_similarity(out1, out2)
    return _criterion(pred, lab.to(pred.dtype), loss_type)


def pair_matrix_loss(out1, out2, lab, loss_type: str = "MSE"):
    """The full cosine matrix against diag(labels), weighted sqrt(0.001 +
    0.999 I) (the reference's diagonal-heavy weights)."""
    pred = _unit_rows(out1) @ _unit_rows(out2).T
    tgt = torch.diag(lab.to(pred.dtype))
    b = out1.shape[0]
    eye = torch.eye(b, dtype=pred.dtype, device=pred.device)
    weight = torch.sqrt(0.001 * torch.ones_like(eye) + 0.999 * eye)
    return _criterion(pred * weight, tgt * weight, loss_type)


def sim_matrix_loss(out, label_matrix, loss_type: str = "MSE"):
    """Cosine matrix against a label matrix, positives weighted sqrt(10);
    returns (loss, pred, label)."""
    n = _unit_rows(out)
    pred = n @ n.T
    label = label_matrix.to(pred.dtype)
    weight = torch.sqrt(torch.where(label > 0, 10.0, 1.0))
    return _criterion(pred * weight, label * weight, loss_type), pred, label


def triplet_loss(out, pos_out, neg_out, pos_score, neg_score):
    """Margin triplet on cosines, margin = pos_score - neg_score."""
    pos_pred = cosine_similarity(out, pos_out)
    neg_pred = cosine_similarity(out, neg_out)
    return torch.clamp(neg_pred - pos_pred + (pos_score - neg_score), min=0.0).mean()


def aux_consistency_loss(aux_sub_out, aux_out, base_pred):
    """Mean squared distance of the codes' cosine matrix from the frozen
    base's (no gradient into ``base_pred``)."""
    pred = _unit_rows(aux_sub_out) @ _unit_rows(aux_out).T
    return ((pred - base_pred.detach()) ** 2).mean()


def reconstruction_loss(target_emb, rec_emb):
    """Normalized squared L2 minus cosine of the reconstruction of the base
    embedding (no gradient into ``target_emb``)."""
    target_emb = target_emb.detach()
    norm = torch.clamp((target_emb ** 2).sum(dim=1), min=1e-12)
    l2 = (((target_emb - rec_emb) ** 2).sum(dim=1) / norm).mean()
    return l2 - cosine_similarity(target_emb, rec_emb).mean()


# ---------------------------------------------------------------------------
# Decoder-based query-generation losses
# ---------------------------------------------------------------------------

def make_mlm_target(generator, y, y_mask, mask_prob: float, mask_token_id: int,
                    min_maskable_id: int = MIN_MASKABLE_ID, pred_target=None):
    """Positions of the target query to predict -- uniform < ``mask_prob``
    and id >= 5, drawn from ``generator`` unless ``pred_target`` is given --
    replaced by ``mask_token_id``; returns (masked_y, pred_target).
    ``y_mask`` is unused, as in JAX."""
    if pred_target is None:
        pred_target = make_token_mask(generator, y, mask_prob, min_maskable_id)
    return torch.where(pred_target, mask_token_id, y), pred_target


def _token_ce(logits, labels):
    """Softmax cross entropy per position with integer labels, [..., C]
    logits -> [...]."""
    return torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), labels.reshape(-1).long(), reduction="none"
    ).reshape(labels.shape)


def next_query_mlm_loss(logits, y, pred_target):
    """CE at the predicted positions (mean over them, denominator clipped at
    1), and the argmax-infilled sequence for the ELECTRA stage (detached;
    ``argmax`` keeps the first maximum in both packages)."""
    ce = _token_ce(logits, y)
    w = pred_target.to(ce.dtype)
    loss = (ce * w).sum() / torch.clamp(w.sum(), min=1.0)
    output = torch.where(pred_target, logits.argmax(dim=-1), y)
    return loss, output.detach()


def negative_token_ids(generator, batch: int, steps: int, neg_k: int, vocab: int, device):
    """The autoregressive loss's negatives: [batch, steps, neg_k] uniform
    token ids in [0, vocab)."""
    return torch.randint(0, vocab, (batch, steps, neg_k), generator=generator, device=device)


def autoregressive_query_loss(generator, dec_out, y, y_mask, token_table, neg_k: int,
                              neg_ids=None):
    """Next-token loss with sampled negatives over one causal decode:
    position t of ``dec_out`` [B, T, d] predicts token t + 1; pos =
    sigmoid(rep . emb(y_next)), neg = sigmoid(-rep . emb(random)) summed
    over ``neg_k`` negatives (``neg_ids`` [B, T - 1, neg_k], drawn from
    ``generator`` when not given), masked means, weighted 1 / (1 + neg_k)."""
    B, T, _ = dec_out.shape
    rep = dec_out[:, :-1, :]
    mask = y_mask[:, 1:].to(rep.dtype)
    pos_val = torch.sigmoid((rep * token_table[y[:, 1:].long()]).sum(dim=-1))
    if neg_ids is None:
        neg_ids = negative_token_ids(generator, B, T - 1, neg_k, token_table.shape[0],
                                     dec_out.device)
    neg_emb = token_table[neg_ids.long()]                       # [B, T-1, K, d]
    neg_val = torch.sigmoid(-torch.einsum("btd,btkd->btk", rep, neg_emb)).sum(dim=-1)
    denom = torch.clamp(mask.sum(), min=1.0)
    total = (pos_val * mask).sum() / denom + (neg_val * mask).sum() / denom
    return -total / (1 + neg_k)


def next_query_electra_loss(logits2, output, y, y_mask):
    """Replaced-token detection over the infilled sequence: 2-way CE per
    position (label 1 where the infill kept the original), masked mean."""
    ce = _token_ce(logits2, (output == y).long())
    m = y_mask.to(ce.dtype)
    return (ce * m).sum() / torch.clamp(m.sum(), min=1.0)
