"""Graph-level readouts over padded node sets (counterparts of
``sessionsimilaritysearch_tpu/models/pooling.py:19-197``)."""

from __future__ import annotations

import math

import torch
from torch import nn


def masked_mean(x, mask, dim: int = 1):
    """Mean over valid nodes; empty sets produce zeros."""
    m = mask[..., None]
    return (x * m).sum(dim=dim) / torch.clamp(m.sum(dim=dim), min=1.0)


def masked_sum(x, mask, dim: int = 1):
    return (x * mask[..., None]).sum(dim=dim)


def masked_max(x, mask, dim: int = 1):
    valid = mask[..., None] > 0
    out = torch.where(valid, x, torch.finfo(x.dtype).min).amax(dim=dim)
    return torch.where(valid.any(dim=dim), out, torch.zeros_like(out))


class AttentionPooling(nn.Module):
    """Attention against the graph's mean vector: att_i = x_i . mean(x),
    reweight, mean-pool, Linear."""

    def __init__(self, in_features: int, num_out: int, device=None):
        super().__init__()
        self.lin = nn.Linear(in_features, num_out, device=device)

    def forward(self, x, mask, graph=None):
        coarse = masked_mean(x, mask)                         # [B, d]
        att = torch.einsum("bnd,bd->bn", x, coarse)           # [B, N]
        return self.lin(masked_mean(x * att[..., None], mask))


class SRGNNPooling(nn.Module):
    """SR-GNN readout: local = the last-clicked node; attention
    lin3(sigmoid(lin1(local) + lin2(x))); global = sum att * x;
    out = lin4(concat(local, global))."""

    def __init__(self, in_features: int, num_out: int, device=None):
        super().__init__()
        d = in_features
        self.lin1 = nn.Linear(d, d, device=device)
        self.lin2 = nn.Linear(d, d, device=device)
        self.lin3 = nn.Linear(d, 1, bias=False, device=device)
        self.lin4 = nn.Linear(2 * d, num_out, device=device)

    def forward(self, x, mask, graph):
        local = masked_sum(x, graph.last_click_mask * mask)   # [B, d]
        att = self.lin3(torch.sigmoid(self.lin1(local)[:, None, :] + self.lin2(x)))
        global_rep = masked_sum(x * att, mask)
        return self.lin4(torch.cat([local, global_rep], dim=-1))


class RecencySRGNNPooling(nn.Module):
    """SR-GNN readout with a learned STAN-style recency stream (counterpart
    of ``pooling.py:102``): per-occurrence weights ``exp(-(rev_pos - 1) /
    lambda)`` over the occurrence stream (``occ_*``; rev_pos 1 = most
    recent), ``lambda = softplus(raw_lambda)`` learned and initialized to
    STAN's 1.04; the recency-weighted mean of the occurrence node states
    joins the attention gate (``lin_rec``) and the final projection
    (``lin4`` over 3 * d)."""

    def __init__(self, in_features: int, num_out: int, init_lambda: float = 1.04,
                 device=None):
        super().__init__()
        d = in_features
        self.init_lambda = init_lambda
        self.raw_lambda = nn.Parameter(torch.empty((), device=device))
        self.lin1 = nn.Linear(d, d, device=device)
        self.lin_rec = nn.Linear(d, d, device=device)
        self.lin2 = nn.Linear(d, d, device=device)
        self.lin3 = nn.Linear(d, 1, bias=False, device=device)
        self.lin4 = nn.Linear(3 * d, num_out, device=device)
        self.reset_lambda()

    @torch.no_grad()
    def reset_lambda(self) -> None:
        """``raw_lambda`` = softplus^-1(init_lambda), as the JAX init."""
        self.raw_lambda.fill_(math.log(math.expm1(self.init_lambda)))

    def forward(self, x, mask, graph):
        local = masked_sum(x, graph.last_click_mask * mask)   # [B, d]
        lam = nn.functional.softplus(self.raw_lambda)
        rev = torch.clamp(graph.occ_pos.to(torch.float32) - 1.0, min=0.0)
        w = torch.exp(-rev / lam) * graph.occ_mask             # [B, O]
        occ = graph.occ_product.long()[..., None].expand(-1, -1, x.shape[-1])
        occ_x = torch.gather(x, 1, occ)                        # [B, O, d]
        denom = torch.clamp(w.sum(dim=1, keepdim=True), min=1e-6)
        rec = (occ_x * w[..., None].to(x.dtype)).sum(dim=1) / denom.to(x.dtype)
        att = self.lin3(torch.sigmoid(
            self.lin1(local)[:, None, :] + self.lin_rec(rec)[:, None, :] + self.lin2(x)))
        global_rep = masked_sum(x * att, mask)
        return self.lin4(torch.cat([local, rec, global_rep], dim=-1))


class PositionalAttentionPooling(nn.Module):
    """Unified query + product pooling (counterpart of ``pooling.py:153``):
    both node types projected to ``num_out - max_seq_len`` (``query_lin``,
    ``product_lin``) and concatenated with a learned positional embedding of
    their reverse position (``positional_emb``, ``max_seq_len + 1`` rows);
    products expanded to one row per occurrence through the ``occ_*``
    stream; then soft attention against the masked mean over the union of
    occurrence and query rows (``node_emb_lin``, and ``coarse_rep_lin`` and
    ``att_lin`` without bias), masked-mean pooled -> [B, num_out]."""

    def __init__(self, query_features: int, product_features: int, num_out: int,
                 max_seq_len: int, device=None):
        super().__init__()
        feat = num_out - max_seq_len
        self.query_lin = nn.Linear(query_features, feat, device=device)
        self.product_lin = nn.Linear(product_features, feat, device=device)
        self.positional_emb = nn.Embedding(max_seq_len + 1, max_seq_len, device=device)
        self.node_emb_lin = nn.Linear(num_out, num_out, device=device)
        self.coarse_rep_lin = nn.Linear(num_out, num_out, bias=False, device=device)
        self.att_lin = nn.Linear(num_out, 1, bias=False, device=device)

    def forward(self, q_emb, p_emb, graph):
        """q_emb [B, Q, dq]; p_emb [B, P, dp]; graph: a batched SessionGraph."""
        q = self.query_lin(q_emb)
        p = self.product_lin(p_emb)
        q_nodes = torch.tanh(torch.cat([q, self.positional_emb(graph.query_pos)], dim=-1))
        occ_idx = graph.occ_product.long()[..., None].expand(-1, -1, p.shape[-1])
        occ = torch.gather(p, 1, occ_idx)                       # [B, O, feat]
        p_nodes = torch.tanh(torch.cat([occ, self.positional_emb(graph.occ_pos)], dim=-1))
        nodes = torch.cat([p_nodes, q_nodes], dim=1)             # [B, O + Q, num_out]
        mask = torch.cat([graph.occ_mask, graph.query_node_mask], dim=1)
        coarse = masked_mean(nodes, mask)[:, None, :]
        att = self.att_lin(torch.sigmoid(self.node_emb_lin(nodes) + self.coarse_rep_lin(coarse)))
        return masked_mean(nodes * att, mask)
