"""Graph-level readouts over padded node sets (counterparts of
``sessionsimilaritysearch_tpu/models/pooling.py:19-99``)."""

from __future__ import annotations

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
