"""Heterogeneous GNN backbones on dense padded session graphs (counterparts
of ``sessionsimilaritysearch_tpu/models/gnn.py:26-196``, ``DenseSAGEConv``
:112, ``DenseGCNConv`` :128, ``HGT`` :199 and ``HeteroSAGE`` :262).

Flax infers a layer's input widths; torch takes them: a bipartite conv gets
its source and destination widths, which differ in the first layer of the
scratch encoder (query nodes ``emb_len`` wide, product nodes ``2 *
emb_len``: the asin id embedding joined to the title text).

``adj[b, i, j]`` counts edges i -> j. GAT weights each parallel edge
separately (count-weighted softmax); GatedGraphConv binarizes the adjacency
unless ``use_edge_weight`` is set.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from sessionsimilaritysearch_tpu_torch.device import resolve_device


class GRUCell(nn.Module):
    """The JAX package's GRU cell, written out: two linears ``ih`` and
    ``hh``, gates split (r, z, n), ``hh``'s bias inside ``r * h_n``."""

    def __init__(self, in_features: int, features: int, device=None):
        super().__init__()
        self.ih = nn.Linear(in_features, 3 * features, device=device)
        self.hh = nn.Linear(features, 3 * features, device=device)

    def forward(self, m, h):
        i_r, i_z, i_n = self.ih(m).chunk(3, dim=-1)
        h_r, h_z, h_n = self.hh(h).chunk(3, dim=-1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        return (1.0 - z) * n + z * h


class DenseGatedGraphConv(nn.Module):
    """GatedGraphConv(out_channels, num_layers=1) on a dense adjacency:
    inputs wider than ``out_channels`` go through ``in_proj``, narrower ones
    are zero-padded; m_dst = sum_src A[src, dst] * (W x_src); GRU update."""

    def __init__(self, in_channels: int, out_channels: int,
                 use_edge_weight: bool = False, device=None):
        super().__init__()
        self.out_channels = out_channels
        self.use_edge_weight = use_edge_weight
        self.in_proj = (
            nn.Linear(in_channels, out_channels, device=device)
            if in_channels > out_channels else None
        )
        self.weight = nn.Linear(out_channels, out_channels, bias=False, device=device)
        self.gru = GRUCell(out_channels, out_channels, device=device)

    def forward(self, x, adj):
        """x [B, N, d_in]; adj [B, N, N] counts."""
        d_in = x.shape[-1]
        if self.in_proj is not None:
            x = self.in_proj(x)
        elif d_in < self.out_channels:
            x = nn.functional.pad(x, (0, self.out_channels - d_in))
        a = adj if self.use_edge_weight else (adj > 0).to(x.dtype)
        m = torch.matmul(a.transpose(1, 2), self.weight(x))  # sum over sources
        return self.gru(m, x)


class DenseGATConv(nn.Module):
    """Single-head bipartite GATConv on a dense adjacency: count-weighted
    softmax over incoming edges (max over all sources, denominator clipped
    at 1e-16); a destination with no incoming edge outputs its bias only."""

    NEGATIVE_SLOPE = 0.2

    def __init__(self, src_channels: int, dst_channels: int, out_channels: int,
                 device=None):
        super().__init__()
        self.lin_src = nn.Linear(src_channels, out_channels, bias=False, device=device)
        self.lin_dst = nn.Linear(dst_channels, out_channels, bias=False, device=device)
        self.att_src = nn.Parameter(torch.empty(out_channels, 1, device=device))
        self.att_dst = nn.Parameter(torch.empty(out_channels, 1, device=device))
        self.bias = nn.Parameter(torch.zeros(out_channels, device=device))

    def forward(self, x_src, x_dst, adj):
        """x_src [B, S, ds]; x_dst [B, D, dd]; adj [B, S, D] -> [B, D, out]."""
        h_src = self.lin_src(x_src)
        h_dst = self.lin_dst(x_dst)
        e_src = (h_src @ self.att_src)[..., 0]             # [B, S]
        e_dst = (h_dst @ self.att_dst)[..., 0]             # [B, D]
        e = nn.functional.leaky_relu(
            e_src[:, :, None] + e_dst[:, None, :], self.NEGATIVE_SLOPE
        )
        w = adj * torch.exp(e - e.amax(dim=1, keepdim=True))
        alpha = w / torch.clamp(w.sum(dim=1, keepdim=True), min=1e-16)
        return torch.matmul(alpha.transpose(1, 2), h_src) + self.bias


class DenseSAGEConv(nn.Module):
    """Bipartite SAGEConv with mean aggregation: ``lin_l`` (with bias) of the
    mean over the binarized incoming edges (degree clipped at 1) plus
    ``lin_r`` (no bias) of the destination's own features."""

    def __init__(self, src_channels: int, dst_channels: int, out_channels: int,
                 device=None):
        super().__init__()
        self.lin_l = nn.Linear(src_channels, out_channels, device=device)
        self.lin_r = nn.Linear(dst_channels, out_channels, bias=False, device=device)

    def forward(self, x_src, x_dst, adj):
        a = (adj > 0).to(x_src.dtype)
        deg = torch.clamp(a.sum(dim=1), min=1.0)                  # [B, D]
        neigh = torch.matmul(a.transpose(1, 2), x_src) / deg[..., None]
        return self.lin_l(neigh) + self.lin_r(x_dst)


class DenseGCNConv(nn.Module):
    """Bipartite GCN conv with symmetric degree normalization:
    out_dst = sum_src A[s, d] / sqrt(deg_s * deg_d) * (W x_src) + b, degrees
    of the binarized adjacency clipped at 1. The destination's features are
    not read (``dst_channels`` is kept for the common conv signature)."""

    def __init__(self, src_channels: int, dst_channels: int, out_channels: int,
                 device=None):
        super().__init__()
        self.lin = nn.Linear(src_channels, out_channels, bias=False, device=device)
        self.bias = nn.Parameter(torch.zeros(out_channels, device=device))

    def forward(self, x_src, x_dst, adj):
        a = (adj > 0).to(x_src.dtype)
        deg_s = torch.clamp(a.sum(dim=2), min=1.0)                # out-degree [B, S]
        deg_d = torch.clamp(a.sum(dim=1), min=1.0)                # in-degree  [B, D]
        norm = a / torch.sqrt(deg_s[:, :, None] * deg_d[:, None, :])
        return torch.matmul(norm.transpose(1, 2), self.lin(x_src)) + self.bias


def _adj_dict(graph) -> Dict[str, torch.Tensor]:
    """Dense adjacency per edge type from a batched SessionGraph."""
    return {
        "qp": graph.adj_qp,                   # query -> product ('clicks')
        "pq": graph.adj_qp.transpose(1, 2),   # product -> query
        "pp": graph.adj_pp,                   # product -> product
    }


class HeteroGGNN(nn.Module):
    """Per layer: GAT on the cross-type edges, GatedGraphConv on
    product -> product, sum aggregation, ReLU; the output is the
    jumping-knowledge concat of the input features and every layer's
    output."""

    def __init__(self, query_channels: int, product_channels: int,
                 hidden_channels: int, num_layers: int,
                 use_edge_weight: bool = False, device=None):
        super().__init__()
        self.num_layers = num_layers
        convs = {}
        dq, dp = query_channels, product_channels
        for i in range(num_layers):
            convs[f"l{i}_qp"] = DenseGATConv(dq, dp, hidden_channels, device=device)
            convs[f"l{i}_pp"] = DenseGatedGraphConv(
                dp, hidden_channels, use_edge_weight, device=device
            )
            convs[f"l{i}_pq"] = DenseGATConv(dp, dq, hidden_channels, device=device)
            dq = dp = hidden_channels
        self.convs = nn.ModuleDict(convs)

    def forward(self, x_dict, graph):
        adj = _adj_dict(graph)
        outs = [x_dict]
        cur = x_dict
        for i in range(self.num_layers):
            q_in, p_in = cur["query"], cur["product"]
            p_from_q = self.convs[f"l{i}_qp"](q_in, p_in, adj["qp"])
            p_from_p = self.convs[f"l{i}_pp"](p_in, adj["pp"])
            q_from_p = self.convs[f"l{i}_pq"](p_in, q_in, adj["pq"])
            cur = {
                "query": torch.relu(q_from_p),
                "product": torch.relu(p_from_q + p_from_p),
            }
            outs.append(cur)
        return {t: torch.cat([o[t] for o in outs], dim=-1) for t in x_dict}


_EDGE_TYPES = (("query", "product", "qp"), ("product", "query", "pq"),
               ("product", "product", "pp"))


class HGT(nn.Module):
    """Heterogeneous graph transformer (JAX ``gnn.py:199-263``): per node
    type an input Linear + ReLU (``lin_{t}``), then per layer type-specific
    Q/K/V projections (``l{i}_{q,k,v}_{t}``) and, for each edge type, a
    multi-head attention of the destinations over their sources through the
    dense adjacency mask (``adj > 0``: edge counts do not weight it), whose
    messages go through ``l{i}_out_{qp,pq,pp}`` and are summed into the
    destination type; then ``gelu(agg) + cur`` (tanh GELU, as Flax's). The
    output is the concat of the projected input (``add_input_feat``) and
    every layer's output. The submodules keep their Flax names, so
    ``weights.flax_to_state_dict`` carries them across as they are."""

    def __init__(self, query_channels: int, product_channels: int, hidden_channels: int,
                 num_heads: int, num_layers: int, device="cuda"):
        super().__init__()
        if hidden_channels % num_heads:
            raise ValueError(f"hidden_channels {hidden_channels} is not a multiple of "
                             f"num_heads {num_heads}")
        dev = resolve_device(device)
        self.num_heads, self.num_layers = num_heads, num_layers
        C = hidden_channels
        for t, d in (("query", query_channels), ("product", product_channels)):
            self.add_module(f"lin_{t}", nn.Linear(d, C, device=dev))
        for i in range(num_layers):
            for t in ("query", "product"):
                for p in "qkv":
                    self.add_module(f"l{i}_{p}_{t}", nn.Linear(C, C, device=dev))
            for _, _, key in _EDGE_TYPES:
                self.add_module(f"l{i}_out_{key}", nn.Linear(C, C, device=dev))

    def forward(self, x_dict, graph, add_input_feat: bool = True):
        layer = self._modules
        cur = {t: torch.relu(layer[f"lin_{t}"](x)) for t, x in x_dict.items()}
        adj = _adj_dict(graph)
        outs = [cur]
        H = self.num_heads
        for i in range(self.num_layers):
            proj = {(p, t): layer[f"l{i}_{p}_{t}"](cur[t]) for t in cur for p in "qkv"}
            agg = {t: torch.zeros_like(cur[t]) for t in cur}
            for src, dst, key in _EDGE_TYPES:
                a = adj[key]                                       # [B, S, D]
                B, S, D = a.shape
                q = proj["q", dst].reshape(B, D, H, -1)
                k = proj["k", src].reshape(B, S, H, -1)
                v = proj["v", src].reshape(B, S, H, -1)
                scale = torch.tensor(q.shape[-1], dtype=q.dtype).sqrt()
                scores = torch.einsum("bdhc,bshc->bhsd", q, k) / scale
                mask = (a > 0)[:, None]                            # [B, 1, S, D]
                scores = scores.masked_fill(~mask, torch.finfo(scores.dtype).min)
                # softmax over the sources; a destination with none gets zero
                att = torch.softmax(scores, dim=2).masked_fill(~mask, 0.0)
                msg = torch.einsum("bhsd,bshc->bdhc", att, v).reshape(B, D, -1)
                agg[dst] = agg[dst] + layer[f"l{i}_out_{key}"](msg)
            cur = {t: nn.functional.gelu(agg[t], approximate="tanh") + cur[t] for t in cur}
            outs.append(cur)
        start = 0 if add_input_feat else 1
        return {t: torch.cat([o[t] for o in outs[start:]], dim=-1) for t in x_dict}


_SAGE_CONVS = {"SAGE": DenseSAGEConv, "GCN": DenseGCNConv, "GAT": DenseGATConv}


class HeteroSAGE(nn.Module):
    """Three bipartite conv layers (widths hidden, hidden, out) lifted to the
    query/product graph with sum aggregation and ReLU: products receive
    ``l{i}_qp`` (query -> product) plus ``l{i}_pp`` (product -> product),
    queries ``l{i}_pq``; ``conv_key`` picks SAGE, GCN or GAT. The output is
    the last layer's node states (no input concat)."""

    def __init__(self, query_channels: int, product_channels: int, hidden_dim: int,
                 out_dim: int, conv_key: str = "SAGE", device=None):
        super().__init__()
        if conv_key not in _SAGE_CONVS:
            raise ValueError("ConvKey can only be GAT, GCN or SAGE.")
        conv = _SAGE_CONVS[conv_key]
        convs = {}
        dq, dp = query_channels, product_channels
        for i, d in enumerate((hidden_dim, hidden_dim, out_dim)):
            convs[f"l{i}_qp"] = conv(dq, dp, d, device=device)
            convs[f"l{i}_pp"] = conv(dp, dp, d, device=device)
            convs[f"l{i}_pq"] = conv(dp, dq, d, device=device)
            dq = dp = d
        self.convs = nn.ModuleDict(convs)

    def forward(self, x_dict, graph):
        adj = _adj_dict(graph)
        cur = x_dict
        for i in range(3):
            q, p = cur["query"], cur["product"]
            p_new = (self.convs[f"l{i}_qp"](q, p, adj["qp"])
                     + self.convs[f"l{i}_pp"](p, p, adj["pp"]))
            q_new = self.convs[f"l{i}_pq"](p, q, adj["pq"])
            cur = {"query": torch.relu(q_new), "product": torch.relu(p_new)}
        return cur
