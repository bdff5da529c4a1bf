"""The session encoders (counterparts of
``sessionsimilaritysearch_tpu/models/encoder.py:35`` ``_embed_nodes``,
``:56-74`` ``NodeLevelEncoder``, ``:77-200`` ``GraphLevelEncoder``, ``:203-330``
``UnifyPoolingGraphLevelEncoder``, ``:333`` ``TextSessionEncoder``, ``:361``
``build_text_backbone``, ``:373`` ``build_graph_encoder``, ``:390``
``build_pretrain_encoder`` and ``:412`` ``build_text_session_encoder``).

The node text embedder is the frozen ``TextEncoder`` (the flagship, the
pretrainer, the text-only encoder) or the session trainers' trainable
``NodeTextTransformer``, which reads no token types.

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
from torch.profiler import record_function

from sessionsimilaritysearch_tpu_torch.config import Config
from sessionsimilaritysearch_tpu_torch.device import resolve_device
from sessionsimilaritysearch_tpu_torch.models.embedding import (
    NodeAsinEmbedding,
    NodeTextTransformer,
    TextEncoder,
)
from sessionsimilaritysearch_tpu_torch.models.gnn import DenseGATConv, DenseGCNConv, HeteroGGNN
from sessionsimilaritysearch_tpu_torch.models.heads import BatchNorm, CrossAttentionTransformer
from sessionsimilaritysearch_tpu_torch.models.pooling import (
    AttentionPooling,
    GraphPooling,
    PositionalAttentionPooling,
    RecencySRGNNPooling,
    SRGNNPooling,
    masked_mean,
)


def _embed_nodes(embedder, ids, typ, att, get_token: bool = False,
                 deterministic: bool = True, generator=None):
    """Run a text embedder over a [B, N, T] token grid -> [B, N, d] (and,
    with ``get_token``, a ``TextEncoder``'s token embeddings [B, N, T, d]).
    A ``NodeTextTransformer`` reads no token types and has no token output."""
    B, N, T = ids.shape
    if isinstance(embedder, NodeTextTransformer):
        if get_token:
            raise ValueError("a NodeTextTransformer has no token embeddings")
        return embedder(ids.reshape(B * N, T), att.reshape(B * N, T), deterministic,
                        generator).reshape(B, N, -1)
    out = embedder(ids.reshape(B * N, T), typ.reshape(B * N, T),
                   att.reshape(B * N, T), get_token=get_token)
    if get_token:
        return out[0].reshape(B, N, -1), out[1].reshape(B, N, T, -1)
    return out.reshape(B, N, -1)


def _gather_rows(table, ids):
    """``table[ids]`` for an integer grid [B, N] -> [B, N, d]."""
    return torch.index_select(table, 0, ids.reshape(-1)).reshape(*ids.shape, -1)


class NodeLevelEncoder(nn.Module):
    """Embedders -> GNN -> per-node embeddings (JAX ``encoder.py:56-74``):
    the query nodes through the text embedder, the product nodes through
    the asin-id embedder alone (no titles, no node masks), then the GNN
    (``HGT`` or ``HeteroGGNN``) -> {'query': [B, Q, d], 'product': [B, P,
    d]}. The modules are moved to ``device``, the card unless the caller
    asks for the CPU."""

    def __init__(self, query_node_embedder: nn.Module,
                 product_node_embedder: NodeAsinEmbedding, gnn: nn.Module, device="cuda"):
        super().__init__()
        self.query_node_embedder = query_node_embedder
        self.product_node_embedder = product_node_embedder
        self.gnn = gnn
        self.to(resolve_device(device))

    def forward(self, graph, deterministic: bool = True, generator=None):
        emb = {
            "query": _embed_nodes(self.query_node_embedder, graph.query_input_ids,
                                  graph.query_type_ids, graph.query_attention_mask,
                                  deterministic=deterministic, generator=generator),
            "product": self.product_node_embedder(graph.product_asin),
        }
        return self.gnn(emb, graph)


class _NodeInputs(nn.Module):
    """What both encoders share: the text backbone (``embed_texts``), the
    optional asin-id embedder, the GNN, and the GNN's input
    (:meth:`node_embeddings`)."""

    def __init__(self, query_node_embedder: nn.Module,
                 product_node_embedder: Optional[NodeAsinEmbedding], gnn: nn.Module,
                 use_id_embedding: bool):
        super().__init__()
        if use_id_embedding and product_node_embedder is None:
            raise ValueError("use_id_embedding needs a product_node_embedder")
        self.query_node_embedder = query_node_embedder
        self.product_node_embedder = product_node_embedder if use_id_embedding else None
        self.gnn = gnn
        self.use_id_embedding = use_id_embedding

    def embed_texts(self, ids, typ, att):
        """Text backbone over bare [N, T] token rows -> [N, d_text]: the
        hook that build_title_table and build_keyword_table call."""
        if isinstance(self.query_node_embedder, NodeTextTransformer):
            return self.query_node_embedder(ids, att)
        return self.query_node_embedder(ids, typ, att)

    def node_embeddings(self, graph, query_node_mask=None, product_node_mask=None,
                        title_table=None, query_table=None, query_kw=None,
                        get_token: bool = False, deterministic: bool = True,
                        generator=None):
        """The GNN's input: {'query': [B, Q, d_q], 'product': [B, P, d_p]},
        padded nodes zeroed (see ``GraphLevelEncoder.forward`` for the
        arguments); with ``get_token`` also the text pass's token embeddings
        {'query': [B, Q, T, d], 'product': [B, P, T, d]}, which only the
        uncached forward has."""
        Q = graph.query_input_ids.shape[1]
        tok = None
        if get_token and title_table is not None:
            raise ValueError("cached text tables cannot serve the token branch "
                             "(token_w > 0 needs real token embeddings)")
        if query_table is not None:
            if title_table is None or query_kw is None:
                raise ValueError("query_table requires title_table and query_kw "
                                 "(the fully cached serving forward)")
            query = _gather_rows(query_table, query_kw)
            b = _gather_rows(title_table, graph.product_asin)
        elif title_table is not None:
            query = _embed_nodes(self.query_node_embedder, graph.query_input_ids,
                                 graph.query_type_ids, graph.query_attention_mask,
                                 deterministic=deterministic, generator=generator)
            b = _gather_rows(title_table, graph.product_asin)
        else:
            # one text pass over both node stores (the same embedder)
            out = _embed_nodes(
                self.query_node_embedder,
                torch.cat([graph.query_input_ids, graph.product_input_ids], dim=1),
                torch.cat([graph.query_type_ids, graph.product_type_ids], dim=1),
                torch.cat([graph.query_attention_mask,
                           graph.product_attention_mask], dim=1),
                get_token=get_token, deterministic=deterministic, generator=generator,
            )
            both = out[0] if get_token else out
            query, b = both[:, :Q], both[:, Q:]
            if get_token:
                tok = {"query": out[1][:, :Q], "product": out[1][:, Q:]}
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
        emb = {"query": query * graph.query_node_mask[..., None],
               "product": product * graph.product_node_mask[..., None]}
        return (emb, tok) if get_token else emb


class GraphLevelEncoder(_NodeInputs):
    """query nodes <- text embedder (or a keyword table); product nodes <-
    concat(asin-id embedding, title text embedding or a catalog table row)
    (``use_id_embedding`` toggle; with it off ``product_node_embedder`` is
    None and the product width is the text width); hetero GNN; separate
    query/product poolings; output = concat(query_emb, product_emb)."""

    def __init__(self, query_node_embedder: nn.Module,
                 product_node_embedder: Optional[NodeAsinEmbedding], gnn: nn.Module,
                 product_pooling: nn.Module, query_pooling: nn.Module,
                 use_id_embedding: bool = True):
        super().__init__(query_node_embedder, product_node_embedder, gnn, use_id_embedding)
        self.product_pooling = product_pooling
        self.query_pooling = query_pooling

    def readout(self, node_emb, graph, deterministic: bool = True, generator=None):
        """Query and product poolings, concatenated -> [B, 2 * pooling width]
        (a ``GraphPooling`` also takes the dropout's flag and generator)."""
        def pool(pooling, x, mask):
            if isinstance(pooling, GraphPooling):
                return pooling(x, mask, graph, deterministic, generator)
            return pooling(x, mask, graph)

        return torch.cat([pool(self.query_pooling, node_emb["query"], graph.query_node_mask),
                          pool(self.product_pooling, node_emb["product"],
                               graph.product_node_mask)], dim=-1)

    def forward(self, graph, query_node_mask=None, product_node_mask=None,
                get_node: bool = False, title_table=None, query_table=None,
                query_kw=None, deterministic: bool = True, generator=None):
        """``graph``: a batched ``SessionGraph`` of tensors -> [B, 2 * gnn_nout]
        (with ``get_node``: ``(embedding, node_emb, None)``, as JAX returns).

        ``query_node_mask`` / ``product_node_mask``: optional [B, Q] / [B, P]
        multipliers of the node embeddings (node-masking pretraining).
        ``title_table``: [asin_num, d_text] catalog title embeddings, gathered
        by ``graph.product_asin`` instead of a text pass over the titles.
        ``query_table`` + ``query_kw``: [n_keywords, d_text] keyword
        embeddings and the [B, Q] table row of each query node (the query
        embedding depends only on its token row, so the gather is exact);
        they need ``title_table`` too. ``deterministic`` and ``generator``
        reach the dropouts of a ``NodeTextTransformer`` and ``GraphPooling``
        (the flagship has none)."""
        node_emb = self.gnn(self.node_embeddings(
            graph, query_node_mask, product_node_mask, title_table, query_table,
            query_kw, deterministic=deterministic, generator=generator), graph)
        out = self.readout(node_emb, graph, deterministic, generator)
        if get_node:
            return out, node_emb, None
        return out


class UnifyPoolingGraphLevelEncoder(_NodeInputs):
    """The pretrainer's encoder: the GNN's input as ``GraphLevelEncoder``
    builds it (text backbone or catalog tables, optional asin-id
    embeddings, node keep-masks, padded nodes zeroed), HeteroGGNN, then one
    ``PositionalAttentionPooling`` over the union of node types -> [B,
    session_emb_dim]; with ``cross_attention_transformer`` an optional token
    branch for the token-level losses (``get_token``). Flax creates the
    token branch's parameters only when its init traces it, so the
    pretrainer builds it only when ``token_w > 0``; without it ``get_token``
    returns no token embeddings, as in JAX. The stages run in
    ``torch.profiler`` spans (``text backbone``: the node embeddings, table
    gathers on the cached path; ``gnn``; ``pooling``)."""

    def __init__(self, query_node_embedder: TextEncoder,
                 product_node_embedder: Optional[NodeAsinEmbedding], gnn: HeteroGGNN,
                 pooling: PositionalAttentionPooling,
                 cross_attention_transformer: Optional[CrossAttentionTransformer] = None,
                 use_id_embedding: bool = True):
        super().__init__(query_node_embedder, product_node_embedder, gnn, use_id_embedding)
        self.pooling = pooling
        self.cross_attention_transformer = cross_attention_transformer

    def forward(self, graph, query_node_mask=None, product_node_mask=None,
                get_node: bool = False, get_token: bool = False,
                deterministic: bool = True, generator=None, title_table=None,
                query_table=None, query_kw=None):
        """As JAX ``encoder.py:227``: returns the embedding, then
        ``node_emb`` with ``get_node`` and ``token_emb`` with ``get_token``.
        ``title_table`` [asin_num, d_text] (and ``query_table`` + ``query_kw``)
        replace the text passes by gathers; they cannot serve ``get_token``,
        which needs the per-token embeddings."""
        with record_function("text backbone"):
            out = self.node_embeddings(graph, query_node_mask, product_node_mask, title_table,
                                       query_table, query_kw, get_token=get_token)
        emb, tok = out if get_token else (out, None)
        with record_function("gnn"):
            node_emb = self.gnn(emb, graph)

        token_emb = {}
        if get_token and self.cross_attention_transformer is not None:
            cat = self.cross_attention_transformer
            for t, mask in (("product", graph.product_attention_mask),
                            ("query", graph.query_attention_mask)):
                B, N, T, D = tok[t].shape
                token_emb[t] = cat(node_emb[t].reshape(B * N, -1),
                                   tok[t].reshape(B * N, T, D),
                                   (mask == 0).reshape(B * N, T),
                                   deterministic, generator).reshape(B, N, T, D)

        with record_function("pooling"):
            embedding = self.pooling(node_emb["query"], node_emb["product"], graph)
        if get_node and get_token:
            return embedding, node_emb, token_emb
        if get_node:
            return embedding, node_emb
        if get_token:
            return embedding, token_emb
        return embedding

class TextSessionEncoder(nn.Module):
    """Text-only session encoder (the QAEA_Linear baseline; the fine-tuner's
    QAEA wiring): the frozen text encoder over each sentence of the session
    text (masked token mean inside the encoder), the masked mean over the
    session's sentences, then the optional trainable ``lin``."""

    def __init__(self, text_encoder: TextEncoder, n_in: int, n_out: Optional[int] = None,
                 device=None):
        super().__init__()
        self.text_encoder = text_encoder
        self.lin = nn.Linear(n_in, n_out, device=device) if n_out is not None else None

    def forward(self, graph):
        sent = _embed_nodes(self.text_encoder, graph.text_input_ids, graph.text_type_ids,
                            graph.text_attention_mask)            # [B, TXT, d]
        emb = masked_mean(sent, graph.text_node_mask)
        return self.lin(emb) if self.lin is not None else emb


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
    embeddings normal(0, 1), LayerNorm and BatchNorm ones/zeros (the
    BatchNorm running statistics keep their zeros/ones), GAT attention vectors
    glorot-uniform, the recency pooling's decay length its constant.
    ``generator`` must live on the parameters' device."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            m.weight.normal_(0.0, 1.0 / math.sqrt(m.in_features), generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, 1.0, generator=generator)
        elif isinstance(m, (nn.LayerNorm, BatchNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, DenseGATConv):
            for p in (m.att_src, m.att_dst):
                limit = math.sqrt(6.0 / (p.shape[0] + p.shape[1]))
                p.uniform_(-limit, limit, generator=generator)
            m.bias.zero_()
        elif isinstance(m, DenseGCNConv):
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


def build_pretrain_encoder(cfg: Config, device, generator: Optional[torch.Generator] = None
                           ) -> UnifyPoolingGraphLevelEncoder:
    """The pretrainer's encoder: frozen text backbone, no asin-id embedding
    (JAX ``use_id_embedding=False``: no ``product_node_embedder`` at all),
    HeteroGGNN(gnn_nout, gnn_nlayers), PositionalAttentionPooling(out =
    session_emb_dim) and, when ``cfg.token_w > 0`` (the only case in which
    Flax's init traces it), the CrossAttentionTransformer (3 layers, K=2,
    dropout 0). Weights are drawn from ``generator`` (default: one seeded
    with ``cfg.seed`` on ``device``); the module is returned in eval mode."""
    dev = resolve_device(device)
    d_text = cfg.text_encoder_dim
    hid, layers = cfg.gnn_nout, cfg.gnn_nlayers
    d_node = d_text + layers * hid
    cat = None
    if cfg.token_w > 0:
        cat = CrossAttentionTransformer(d_node, nlayers=3, node_emb_K=2, token_dim=d_text,
                                        nhead=cfg.query_embedder_nhead,
                                        nhid=cfg.query_embedder_nhid, dropout=0.0,
                                        device=dev)
    enc = UnifyPoolingGraphLevelEncoder(
        query_node_embedder=build_text_backbone(cfg, device=dev),
        product_node_embedder=None,
        gnn=HeteroGGNN(d_text, d_text, hid, layers, device=dev),
        pooling=PositionalAttentionPooling(d_node, d_node, cfg.session_emb_dim,
                                           cfg.max_seq_len, device=dev),
        cross_attention_transformer=cat,
        use_id_embedding=False,
    )
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(cfg.seed)
    init_parameters(enc, generator)
    return enc.eval()


def build_text_session_encoder(cfg: Config, device="cuda",
                               generator: Optional[torch.Generator] = None
                               ) -> TextSessionEncoder:
    """The text-only session encoder: the frozen text backbone and an
    ``n_out``-wide ``lin`` -> [B, cfg.n_out]. Runs on the card unless
    ``device`` says otherwise; weights drawn from ``generator`` (default: one
    seeded with ``cfg.seed`` on the device); returned in eval mode."""
    dev = resolve_device(device)
    enc = TextSessionEncoder(build_text_backbone(cfg, device=dev), cfg.text_encoder_dim,
                             cfg.n_out, device=dev)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(cfg.seed)
    init_parameters(enc, generator)
    return enc.eval()
