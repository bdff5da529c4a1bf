"""The flagship two-pool session encoder (counterpart of
``sessionsimilaritysearch_tpu/models/encoder.py:35`` ``_embed_nodes``,
``:77-200`` ``GraphLevelEncoder``, ``:361`` ``build_text_backbone`` and
``:373`` ``build_graph_encoder``).

Three forwards, as in the JAX module (``encoder.py:130-174``):

- uncached: one text pass over the query and product token grids together;
- ``title_table``: product title embeddings gathered by asin id from a
  catalog table (``evalharness.harness.build_title_table``), the query nodes
  still through the text backbone;
- ``title_table`` + ``query_table`` + ``query_kw``: the query nodes gathered
  from a keyword table too, so the forward runs no text backbone at all.

Then asin-id embeddings concatenated to the product titles
(``use_id_embedding``), the optional pretraining node masks, padded nodes
zeroed, HeteroGGNN, SR-GNN (or recency SR-GNN) pooling of products and
attention pooling of queries, concat.
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
    RecencySRGNNPooling,
    SRGNNPooling,
)


def _embed_nodes(embedder: TextEncoder, ids, typ, att):
    """Run a text embedder over a [B, N, T] token grid -> [B, N, d]."""
    B, N, T = ids.shape
    out = embedder(ids.reshape(B * N, T), typ.reshape(B * N, T),
                   att.reshape(B * N, T))
    return out.reshape(B, N, -1)


def _gather_rows(table, ids):
    """``table[ids]`` for an integer grid [B, N] -> [B, N, d]."""
    return torch.index_select(table, 0, ids.reshape(-1)).reshape(*ids.shape, -1)


class GraphLevelEncoder(nn.Module):
    """query nodes <- text embedder (or a keyword table); product nodes <-
    concat(asin-id embedding, title text embedding or a catalog table row)
    (``use_id_embedding`` toggle; with it off ``product_node_embedder`` is
    None and the product width is the text width); hetero GNN; separate
    query/product poolings; output = concat(query_emb, product_emb)."""

    def __init__(self, query_node_embedder: TextEncoder,
                 product_node_embedder: Optional[NodeAsinEmbedding], gnn: HeteroGGNN,
                 product_pooling: nn.Module, query_pooling: nn.Module,
                 use_id_embedding: bool = True):
        super().__init__()
        if use_id_embedding and product_node_embedder is None:
            raise ValueError("use_id_embedding needs a product_node_embedder")
        self.query_node_embedder = query_node_embedder
        self.product_node_embedder = product_node_embedder if use_id_embedding else None
        self.gnn = gnn
        self.product_pooling = product_pooling
        self.query_pooling = query_pooling
        self.use_id_embedding = use_id_embedding

    def embed_texts(self, ids, typ, att):
        """Text backbone over bare [N, T] token rows -> [N, d_text]: the
        hook that build_title_table and build_keyword_table call."""
        return self.query_node_embedder(ids, typ, att)

    def node_embeddings(self, graph, query_node_mask=None, product_node_mask=None,
                        title_table=None, query_table=None, query_kw=None):
        """The GNN's input: {'query': [B, Q, d_q], 'product': [B, P, d_p]},
        padded nodes zeroed (see :meth:`forward` for the arguments)."""
        Q = graph.query_input_ids.shape[1]
        if query_table is not None:
            if title_table is None or query_kw is None:
                raise ValueError("query_table requires title_table and query_kw "
                                 "(the fully cached serving forward)")
            query = _gather_rows(query_table, query_kw)
            b = _gather_rows(title_table, graph.product_asin)
        elif title_table is not None:
            query = _embed_nodes(self.query_node_embedder, graph.query_input_ids,
                                 graph.query_type_ids, graph.query_attention_mask)
            b = _gather_rows(title_table, graph.product_asin)
        else:
            # one text pass over both node stores (the same embedder)
            both = _embed_nodes(
                self.query_node_embedder,
                torch.cat([graph.query_input_ids, graph.product_input_ids], dim=1),
                torch.cat([graph.query_type_ids, graph.product_type_ids], dim=1),
                torch.cat([graph.query_attention_mask,
                           graph.product_attention_mask], dim=1),
            )
            query, b = both[:, :Q], both[:, Q:]
        if self.use_id_embedding:
            product = torch.cat([self.product_node_embedder(graph.product_asin), b], dim=-1)
        else:
            product = b
        # random node-masking for pretraining
        if query_node_mask is not None:
            query = query * query_node_mask[..., None]
        if product_node_mask is not None:
            product = product * product_node_mask[..., None]
        # zero padded rows (nonexistent nodes in the reference's ragged form);
        # the f32 masks also promote bf16 node embeddings to f32, as in JAX
        return {"query": query * graph.query_node_mask[..., None],
                "product": product * graph.product_node_mask[..., None]}

    def readout(self, node_emb, graph):
        """Query and product poolings, concatenated -> [B, 2 * gnn_nout]."""
        query_embedding = self.query_pooling(node_emb["query"], graph.query_node_mask, graph)
        product_embedding = self.product_pooling(
            node_emb["product"], graph.product_node_mask, graph)
        return torch.cat([query_embedding, product_embedding], dim=-1)

    def forward(self, graph, query_node_mask=None, product_node_mask=None,
                get_node: bool = False, title_table=None, query_table=None,
                query_kw=None):
        """``graph``: a batched ``SessionGraph`` of tensors -> [B, 2 * gnn_nout]
        (with ``get_node``: ``(embedding, node_emb, None)``, as JAX returns).

        ``query_node_mask`` / ``product_node_mask``: optional [B, Q] / [B, P]
        multipliers of the node embeddings (node-masking pretraining).
        ``title_table``: [asin_num, d_text] catalog title embeddings, gathered
        by ``graph.product_asin`` instead of a text pass over the titles.
        ``query_table`` + ``query_kw``: [n_keywords, d_text] keyword
        embeddings and the [B, Q] table row of each query node (the query
        embedding depends only on its token row, so the gather is exact);
        they need ``title_table`` too."""
        node_emb = self.gnn(self.node_embeddings(
            graph, query_node_mask, product_node_mask, title_table, query_table,
            query_kw), graph)
        out = self.readout(node_emb, graph)
        if get_node:
            return out, node_emb, None
        return out


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
    glorot-uniform, the recency pooling's decay length its constant.
    ``generator`` must live on the parameters' device."""
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
        elif isinstance(m, RecencySRGNNPooling):
            m.reset_lambda()


_PRODUCT_POOLINGS = {"srgnn": SRGNNPooling, "recency": RecencySRGNNPooling}


def build_graph_encoder(cfg: Config, device,
                        generator: Optional[torch.Generator] = None) -> GraphLevelEncoder:
    """Two-pool flagship: text backbone + asin ids -> HeteroGGNN -> SR-GNN
    (``cfg.product_pooling='srgnn'``) or recency SR-GNN (``'recency'``)
    product pooling + attention query pooling -> 2 * gnn_nout embedding.
    Weights are drawn from ``generator`` (default: one seeded with
    ``cfg.seed`` on ``device``); the module is returned in eval mode."""
    product_pooling = _PRODUCT_POOLINGS[cfg.product_pooling]
    dev = resolve_device(device)
    d_query = cfg.text_encoder_dim
    d_product = cfg.emb_len + cfg.text_encoder_dim
    hid, layers = cfg.gnn_nhid, cfg.gnn_nlayers
    enc = GraphLevelEncoder(
        query_node_embedder=build_text_backbone(cfg, device=dev),
        product_node_embedder=NodeAsinEmbedding(cfg.asin_num, cfg.emb_len, device=dev),
        gnn=HeteroGGNN(d_query, d_product, hid, layers, device=dev),
        product_pooling=product_pooling(d_product + layers * hid, cfg.gnn_nout, device=dev),
        query_pooling=AttentionPooling(d_query + layers * hid, cfg.gnn_nout, device=dev),
    )
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(cfg.seed)
    init_parameters(enc, generator)
    return enc.eval()
