"""The pretrainer's losses (counterparts of
``sessionsimilaritysearch_tpu/training/losses.py``: ``_clipped_norm_rows``
:32, ``cosine_similarity`` :36, ``contrastive_loss`` :43, ``make_token_mask``
:65, ``electra_loss`` :80, ``all_text_embedding_loss`` :114,
``product_target_onehot`` :144, ``product_asin_loss`` :154,
``product_asin_precision_recall`` :180, ``node_reconstruction_loss`` :273 and
``qaea_distill_loss`` :287), with the same clips, weightings and masks.

The random parts take their draws as arguments (``make_token_mask`` a
``torch.Generator``, ``product_asin_loss`` its negative-sample mask), so a
caller can feed the JAX package's draws and compare step for step. The
fine-tune and session-trainer losses are not ported yet.
"""

from __future__ import annotations

import torch

MASK_TOKEN_ID = 4  # the tokenizer's [MASK]
MIN_MASKABLE_ID = 5  # ids below are special tokens


def _clipped_norm_rows(x, eps: float = 1e-6):
    return x / torch.sqrt(torch.clamp((x * x).sum(dim=1, keepdim=True), min=eps))


def cosine_similarity(a, b, dim: int = -1, eps: float = 1e-8):
    """Per-row cosine with the product of the norms clipped at ``eps``."""
    an = torch.linalg.vector_norm(a, dim=dim)
    bn = torch.linalg.vector_norm(b, dim=dim)
    return (a * b).sum(dim=dim) / torch.clamp(an * bn, min=eps)


def contrastive_loss(view1, view2):
    """JS-style contrastive estimator: normalized cosine score matrix clipped
    to [1e-4, 0.9999]; off-diagonal log(1 - s), diagonal 10 log(s);
    normalized by B^2 + 9B."""
    score = torch.clamp(_clipped_norm_rows(view1) @ _clipped_norm_rows(view2).T, 1e-4, 0.9999)
    b = view1.shape[0]
    eye = torch.eye(b, dtype=score.dtype, device=score.device)
    js = torch.log(1.0 - score) * (1.0 - eye) + 10.0 * torch.log(score) * eye
    return -js.sum() / (b * b + 9 * b)


def make_token_mask(generator: torch.Generator, input_ids, mask_ratio: float,
                    min_maskable_id: int = MIN_MASKABLE_ID):
    """Random maskable-token selection: uniform < ratio AND id >= 5."""
    r = torch.rand(input_ids.shape, generator=generator, device=input_ids.device)
    return (r < mask_ratio) & (input_ids >= min_maskable_id)


def electra_loss(pred, input_ids, gt_ids, valid_mask=None):
    """Replaced-token-detection BCE, pred in (0, 1) clipped to [1e-7, 1 -
    1e-7]; averaged over ``valid_mask`` when given (the JAX package's
    deliberate exclusion of padding), else over every position."""
    label = (input_ids != gt_ids).to(pred.dtype)
    p = torch.clamp(pred, 1e-7, 1.0 - 1e-7)
    bce = -(label * torch.log(p) + (1.0 - label) * torch.log(1.0 - p))
    if valid_mask is None:
        return bce.mean()
    m = valid_mask.to(bce.dtype)
    return (bce * m).sum() / torch.clamp(m.sum(), min=1.0)


def all_text_embedding_loss(rep, targets, node_mask, valid_mask=None):
    """Batch-membership BCE over a padded target store: rep [B, d]; targets
    [B, T, d]; node_mask [B, T] real rows; valid_mask [B, T] rows allowed as
    positives (default node_mask). Memberships with valid_mask 0 and padded
    rows are left out of the mean."""
    if valid_mask is None:
        valid_mask = node_mask
    B, T, d = targets.shape
    val = torch.clamp(torch.sigmoid(rep @ targets.reshape(B * T, d).T), 1e-7, 1.0 - 1e-7)
    col_graph = torch.arange(B, device=rep.device).repeat_interleave(T)[None, :]
    member = (col_graph == torch.arange(B, device=rep.device)[:, None]).to(val.dtype)
    exists = node_mask.reshape(1, B * T).to(val.dtype).expand(B, -1)
    valid = valid_mask.reshape(1, B * T).to(val.dtype).expand(B, -1)
    include = exists * (1.0 - member * (1.0 - valid))
    loss_mat = -(member * torch.log(val) + (1.0 - member) * torch.log(1.0 - val))
    return (loss_mat * include).sum() / torch.clamp(include.sum(), min=1.0)


def product_target_onehot(target_y, target_mask, asin_num: int):
    """y [B, asin_num]: the largest target mask at each target asin. A
    scatter-max, as the JAX ``.at[].max``: padded targets point at asin 0
    with mask 0 and must not erase a real target at asin 0."""
    B = target_y.shape[0]
    y = torch.zeros(B, asin_num, dtype=torch.float32, device=target_y.device)
    return y.scatter_reduce(1, target_y.long(), target_mask.to(torch.float32), "amax")


def product_asin_loss(rep, asin_table, target_y, target_mask, neg_mask):
    """Sigmoid logits over the whole asin vocabulary, clipped to [1e-4,
    0.9999], BCE averaged over the positives plus the sampled negatives.
    ``neg_mask`` [B, asin_num] is the negative sample: uniform draws below
    ``neg_sample_count / asin_num`` (:func:`negative_mask`)."""
    y = product_target_onehot(target_y, target_mask, asin_table.shape[0])
    val = torch.clamp(torch.sigmoid(rep @ asin_table.T), 1e-4, 0.9999)
    loss_mat = -(y * torch.log(val) + (1.0 - y) * torch.log(1.0 - val))
    loss_mask = (neg_mask | (y > 0)).to(loss_mat.dtype)
    return (loss_mat * loss_mask).sum() / torch.clamp(loss_mask.sum(), min=1.0)


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


def node_reconstruction_loss(node_pred, node_feat, keep_mask, node_exists=None):
    """Squared (1 - cos) on the nodes the keep mask dropped (and that exist)."""
    node_pred = node_pred.reshape(-1, node_pred.shape[-1])
    node_feat = node_feat.reshape(-1, node_feat.shape[-1])
    dropped = 1.0 - keep_mask.reshape(-1)
    if node_exists is not None:
        dropped = dropped * node_exists.reshape(-1)
    err = (1.0 - cosine_similarity(node_pred, node_feat)) ** 2
    return (dropped * err).sum() / (dropped.sum() + 1e-3)


def qaea_distill_loss(pred, label):
    """mean(1 - cos) toward the frozen text embedding (no gradient into it)."""
    return (1.0 - cosine_similarity(pred, label.detach())).mean()
