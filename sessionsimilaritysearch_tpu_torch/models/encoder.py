"""The flagship two-pool session encoder (counterpart of
``sessionsimilaritysearch_tpu/models/encoder.py:35`` ``_embed_nodes``,
``:77`` ``GraphLevelEncoder``, ``:361`` ``build_text_backbone`` and ``:373``
``build_graph_encoder``).

The port covers the uncached forward (``encoder.py:149-200``): one text pass
over the query and product token grids together, asin-id embeddings
concatenated to the product titles, padded nodes zeroed, HeteroGGNN, SR-GNN
pooling of products and attention pooling of queries, concat.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from sessionsimilaritysearch_tpu_torch.config import Config
from sessionsimilaritysearch_tpu_torch.device import resolve_device
from sessionsimilaritysearch_tpu_torch.models.embedding import (
    NodeAsinEmbedding,
    TextEncoder,
)
from sessionsimilaritysearch_tpu_torch.models.gnn import DenseGATConv, HeteroGGNN
from sessionsimilaritysearch_tpu_torch.models.pooling import (
    AttentionPooling,
    SRGNNPooling,
)


def _embed_nodes(embedder: TextEncoder, ids, typ, att):
    """Run a text embedder over a [B, N, T] token grid -> [B, N, d]."""
    B, N, T = ids.shape
    out = embedder(ids.reshape(B * N, T), typ.reshape(B * N, T),
                   att.reshape(B * N, T))
    return out.reshape(B, N, -1)


class GraphLevelEncoder(nn.Module):
    """query nodes <- text embedder; product nodes <- concat(asin-id
    embedding, title text embedding); hetero GNN; separate query/product
    poolings; output = concat(query_emb, product_emb)."""

    def __init__(self, query_node_embedder: TextEncoder,
                 product_node_embedder: NodeAsinEmbedding, gnn: HeteroGGNN,
                 product_pooling: nn.Module, query_pooling: nn.Module):
        super().__init__()
        self.query_node_embedder = query_node_embedder
        self.product_node_embedder = product_node_embedder
        self.gnn = gnn
        self.product_pooling = product_pooling
        self.query_pooling = query_pooling

    def forward(self, graph):
        """``graph``: a batched ``SessionGraph`` of tensors -> [B, 2 * gnn_nout]."""
        Q = graph.query_input_ids.shape[1]
        both = _embed_nodes(
            self.query_node_embedder,
            torch.cat([graph.query_input_ids, graph.product_input_ids], dim=1),
            torch.cat([graph.query_type_ids, graph.product_type_ids], dim=1),
            torch.cat([graph.query_attention_mask,
                       graph.product_attention_mask], dim=1),
        )
        product = torch.cat(
            [self.product_node_embedder(graph.product_asin), both[:, Q:]], dim=-1
        )
        # zero padded rows (nonexistent nodes in the reference's ragged form)
        emb = {
            "query": both[:, :Q] * graph.query_node_mask[..., None],
            "product": product * graph.product_node_mask[..., None],
        }

        node_emb = self.gnn(emb, graph)
        query_embedding = self.query_pooling(
            node_emb["query"], graph.query_node_mask, graph
        )
        product_embedding = self.product_pooling(
            node_emb["product"], graph.product_node_mask, graph
        )
        return torch.cat([query_embedding, product_embedding], dim=-1)


def build_text_backbone(cfg: Config, device=None) -> TextEncoder:
    return TextEncoder(
        vocab_size=cfg.vocab_size,
        d_model=cfg.text_encoder_dim,
        nhead=cfg.query_embedder_nhead,
        nhid=cfg.query_embedder_nhid,
        nlayers=2,
        max_len=cfg.token_len,
        device=device,
    )


@torch.no_grad()
def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded random init, drawn from ``generator`` only (never the global
    RNG), after Flax's defaults: Linear weights lecun-normal, biases zero,
    embeddings normal(0, 1), LayerNorm ones/zeros, GAT attention vectors
    glorot-uniform. ``generator`` must live on the parameters' device."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            m.weight.normal_(0.0, 1.0 / math.sqrt(m.in_features), generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, 1.0, generator=generator)
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, DenseGATConv):
            for p in (m.att_src, m.att_dst):
                limit = math.sqrt(6.0 / (p.shape[0] + p.shape[1]))
                p.uniform_(-limit, limit, generator=generator)
            m.bias.zero_()


def build_graph_encoder(cfg: Config, device,
                        generator: Optional[torch.Generator] = None
                        ) -> GraphLevelEncoder:
    """Two-pool flagship: text backbone + asin ids -> HeteroGGNN -> SR-GNN
    product pooling + attention query pooling -> 2 * gnn_nout embedding.
    Weights are drawn from ``generator`` (default: one seeded with
    ``cfg.seed`` on ``device``); the module is returned in eval mode."""
    if cfg.product_pooling != "srgnn":
        raise NotImplementedError(
            f"product_pooling={cfg.product_pooling!r}: only 'srgnn' is ported "
            "(RecencySRGNNPooling is ROADMAP.md Queue 1 item 4)"
        )
    dev = resolve_device(device)
    d_query = cfg.text_encoder_dim
    d_product = cfg.emb_len + cfg.text_encoder_dim
    hid, layers = cfg.gnn_nhid, cfg.gnn_nlayers
    enc = GraphLevelEncoder(
        query_node_embedder=build_text_backbone(cfg, device=dev),
        product_node_embedder=NodeAsinEmbedding(cfg.asin_num, cfg.emb_len, device=dev),
        gnn=HeteroGGNN(d_query, d_product, hid, layers, device=dev),
        product_pooling=SRGNNPooling(d_product + layers * hid, cfg.gnn_nout, device=dev),
        query_pooling=AttentionPooling(d_query + layers * hid, cfg.gnn_nout, device=dev),
    )
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(cfg.seed)
    init_parameters(enc, generator)
    return enc.eval()
