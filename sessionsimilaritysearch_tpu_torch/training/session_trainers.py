"""Session / subsession / joint embedding trainers (counterpart of
``sessionsimilaritysearch_tpu/training/session_trainers.py``).

- ``mode='subsession'``: a prefix predicts its FUTURE items and its NEXT query;
- ``mode='session'``: the full session predicts ALL its items and its LAST
  query;
- ``JointModel``: a session and a subsession model, both query objectives in
  MLM + ELECTRA form, aligned by a contrastive loss between the session and
  the subsession embedding of the same row.

Encoders: ``encoder_kind='scratch'`` is ``NodeTextTransformer`` + asin ids ->
``HeteroSAGE`` -> mean ``GraphPooling`` (``2 * gnn_pooling_out`` wide);
``'flagship'`` is ``build_graph_encoder`` (the frozen text backbone +
HeteroGGNN + SR-GNN pooling, ``2 * gnn_nout`` wide), the production serving
encoder. The asin loss scores against the encoder's OWN product table
(JAX ``:161``), not a separate target table as in the pretrainer.

The random parts of a step -- the asin loss's negative sample, and the MLM
positions or the autoregressive loss's negative token ids -- are drawn by
:meth:`SessionEmbeddingModel.draw` from the train state's
``torch.Generator``, or passed in as ``draws`` (the parity tests pass the
JAX package's). The dropouts (all at rate 0 in ``Config()``) draw from the
same generator.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from sessionsimilaritysearch_tpu_torch.config import Config
from sessionsimilaritysearch_tpu_torch.device import resolve_device
from sessionsimilaritysearch_tpu_torch.models.embedding import (
    NodeAsinEmbedding,
    NodeTextTransformer,
)
from sessionsimilaritysearch_tpu_torch.models.encoder import (
    GraphLevelEncoder,
    build_graph_encoder,
    init_parameters,
)
from sessionsimilaritysearch_tpu_torch.models.gnn import HeteroSAGE
from sessionsimilaritysearch_tpu_torch.models.heads import MLP, TransformerDecoderHead
from sessionsimilaritysearch_tpu_torch.models.pooling import GraphPooling
from sessionsimilaritysearch_tpu_torch.models.transformer import causal_mask
from sessionsimilaritysearch_tpu_torch.training import losses
from sessionsimilaritysearch_tpu_torch.training.train_state import TrainState, adam_with_clip

MLM_RATIO_FLOOR = 0.05  # the MLM stage masks at least 5% of the target query


def _build_scratch_encoder(cfg: Config, device) -> GraphLevelEncoder:
    """NodeTextTransformer + asin ids -> HeteroSAGE -> mean poolings. Query
    nodes are ``emb_len`` wide, product nodes ``2 * emb_len`` (the asin id
    embedding joined to the title text)."""
    d = cfg.emb_len
    return GraphLevelEncoder(
        query_node_embedder=NodeTextTransformer(
            cfg.vocab_size, d, cfg.query_embedder_nhead, cfg.query_embedder_nhid,
            cfg.query_embedder_nlayers, cfg.query_embedder_dropout, device=device),
        product_node_embedder=NodeAsinEmbedding(cfg.asin_num, d, device=device),
        gnn=HeteroSAGE(d, 2 * d, cfg.gnn_nhid, cfg.gnn_nout, device=device),
        product_pooling=GraphPooling("mean", cfg.gnn_nout, cfg.gnn_pooling_out,
                                     cfg.gnn_dropout, device=device),
        query_pooling=GraphPooling("mean", cfg.gnn_nout, cfg.gnn_pooling_out,
                                   cfg.gnn_dropout, device=device),
        use_id_embedding=True,
    )


@torch.no_grad()
def _init_like_flax(module: nn.Module, generator: torch.Generator) -> None:
    """``init_parameters``, then every embedding table drawn as Flax's
    ``nn.Embed`` default draws it, normal(0, 1 / features): the trainers'
    asin and token tables feed sigmoid and dot-product losses, where
    unit-variance rows would saturate them."""
    init_parameters(module, generator)
    for m in module.modules():
        if isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, 1.0 / math.sqrt(m.embedding_dim), generator=generator)


class SessionEmbeddingModel(nn.Module):
    """One encoder + product head + query decoder, trained on the subsession
    (next-*) or session (all-/last-*) objectives (JAX ``:70``)."""

    def __init__(self, cfg: Config, mode: str = "subsession",
                 query_loss_style: str = "autoregressive", encoder_kind: str = "scratch",
                 device=None):
        super().__init__()
        if mode not in ("subsession", "session"):
            raise ValueError(f"mode must be 'subsession' or 'session', got {mode!r}")
        if query_loss_style not in ("autoregressive", "mlm_electra"):
            raise ValueError(f"unknown query_loss_style {query_loss_style!r}")
        if encoder_kind not in ("scratch", "flagship"):
            raise ValueError(f"encoder_kind must be 'scratch' or 'flagship', got "
                             f"{encoder_kind!r}")
        self.cfg = cfg
        self.mode = mode
        self.query_loss_style = query_loss_style
        self.encoder_kind = encoder_kind
        flagship = encoder_kind == "flagship"
        self.encoder = (build_graph_encoder(cfg, device) if flagship
                        else _build_scratch_encoder(cfg, device))
        emb_dim = cfg.session_emb_dim if flagship else 2 * cfg.gnn_pooling_out
        self.next_product_head = MLP(emb_dim, cfg.emb_len, cfg.ph_nhid, cfg.ph_nlayers,
                                     cfg.ph_dropout, device=device)

        def decoder(nout):
            return TransformerDecoderHead(cfg.emb_len, nout, cfg.qh_nhead, cfg.qh_nhid,
                                          cfg.qh_nlayers, cfg.qh_dropout, device=device)

        self.query_decoder = decoder(cfg.emb_len)
        # the replaced-token-detection decoder: 2-way logits per position
        self.electra_decoder = decoder(2) if query_loss_style == "mlm_electra" else None
        self.memory_proj = nn.Linear(emb_dim, cfg.emb_len, device=device)
        # the flagship's token table is [vocab, text_encoder_dim]; the tied
        # logits of the query decoder work at emb_len
        self.token_table_proj = (nn.Linear(cfg.text_encoder_dim, cfg.emb_len, device=device)
                                 if flagship else None)

    def encode(self, graph, deterministic: bool = True, generator=None):
        """The session embedding [B, emb_dim] (corpus building, serving)."""
        return self.encoder(graph, deterministic=deterministic, generator=generator)

    def product_rep(self, graph):
        """The next-product head's output on a deterministic forward."""
        return self.next_product_head(self.encode(graph), deterministic=True)

    def _asin_table(self):
        return self.encoder.product_node_embedder.encoder.weight

    def _token_table(self):
        q = self.encoder.query_node_embedder
        if self.token_table_proj is not None:
            return self.token_table_proj(q.tok_emb.weight)
        return q.embedding.weight

    def _product_targets(self, graph):
        if self.mode == "subsession":
            return graph.product_target_y, graph.product_target_mask
        return graph.product_asin, graph.product_node_mask

    def _query_target(self, graph):
        """Target query tokens and their f32 mask: the NEXT query (the first
        future query) in subsession mode, the LAST real query node in session
        mode (only sessions with a non-root query contribute)."""
        if self.mode == "subsession":
            y = graph.query_target_input_ids[:, 0, :]
            y_mask = graph.query_target_attention_mask[:, 0, :].to(torch.float32)
            return y, y_mask * graph.query_target_mask[:, :1]
        last = graph.query_node_mask.sum(dim=1).to(torch.int64) - 1     # node 0 is root
        pick = last[:, None, None].expand(-1, 1, graph.query_input_ids.shape[-1])
        y = torch.gather(graph.query_input_ids, 1, pick)[:, 0, :]
        att = torch.gather(graph.query_attention_mask, 1, pick)[:, 0, :].to(torch.float32)
        return y, att * (last > 0).to(torch.float32)[:, None]

    def draw(self, graph, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """The random parts of one step, from ``generator``: ``neg`` [B,
        asin_num] (the asin loss's negative sample), then ``mlm_target`` [B,
        T] (mlm_electra: uniform < max(mask_token_ratio, 0.05) and id >= 5)
        or ``neg_ids`` [B, T - 1, neg_k] (autoregressive)."""
        cfg = self.cfg
        dev = graph.product_asin.device
        B = graph.product_asin.shape[0]
        d = {"neg": losses.negative_mask(generator, B, cfg.asin_num, cfg.neg_sample_count,
                                         dev)}
        y, _ = self._query_target(graph)
        if self.query_loss_style == "mlm_electra":
            d["mlm_target"] = losses.make_token_mask(
                generator, y, max(cfg.mask_token_ratio, MLM_RATIO_FLOOR))
        else:
            d["neg_ids"] = losses.negative_token_ids(generator, B, y.shape[1] - 1, cfg.neg_k,
                                                     cfg.vocab_size, dev)
        return d

    def forward(self, graph, generator: Optional[torch.Generator] = None,
                deterministic: bool = False, draws: Optional[Dict[str, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """-> (loss, metrics {'loss', 'product_loss', 'query_loss'}).
        ``draws`` (:meth:`draw`) are drawn from ``generator`` when not given."""
        cfg = self.cfg
        det, g = deterministic, generator
        if draws is None:
            draws = self.draw(graph, generator)
        embedding = self.encode(graph, det, g)
        rep = self.next_product_head(embedding, det, g)
        tgt_y, tgt_mask = self._product_targets(graph)
        product_loss = losses.product_asin_loss(rep, self._asin_table(), tgt_y, tgt_mask,
                                                draws["neg"])

        # query generation over the graph-embedding memory
        y, y_mask = self._query_target(graph)
        token_table = self._token_table()
        memory = self.memory_proj(embedding)[:, None, :]
        if self.query_loss_style == "mlm_electra":
            # MLM stage: decode the masked target, logits tied to the token table
            masked_y, pred_target = losses.make_mlm_target(
                None, y, y_mask, max(cfg.mask_token_ratio, MLM_RATIO_FLOOR),
                losses.MASK_TOKEN_ID, pred_target=draws["mlm_target"])
            dec_out = self.query_decoder(token_table[masked_y.long()], memory,
                                         tgt_key_padding_mask=pred_target | (y_mask == 0),
                                         deterministic=det, generator=g)
            mlm, output = losses.next_query_mlm_loss(dec_out @ token_table.T, y, pred_target)
            # ELECTRA stage over the argmax-infilled sequence
            logits2 = self.electra_decoder(token_table[output.long()], memory,
                                           tgt_key_padding_mask=y_mask == 0,
                                           deterministic=det, generator=g)
            query_loss = mlm + losses.next_query_electra_loss(logits2, output, y, y_mask)
        else:
            dec_out = self.query_decoder(token_table[y.long()], memory,
                                         tgt_mask=causal_mask(y.shape[1], y.device),
                                         tgt_key_padding_mask=y_mask == 0,
                                         deterministic=det, generator=g)
            query_loss = losses.autoregressive_query_loss(
                None, dec_out, y, y_mask, token_table, cfg.neg_k, neg_ids=draws["neg_ids"])

        if cfg.ph_w == 0 and cfg.qh_w == 0:
            # Config() sets both weights to 0 (the reference edits config.py);
            # an all-zero objective trains nothing, so weigh both equally
            loss = product_loss + query_loss
        else:
            loss = cfg.ph_w * product_loss + cfg.qh_w * query_loss
        return loss, {"loss": loss, "product_loss": product_loss, "query_loss": query_loss}

    def retrieval_metrics(self, graph, k: int = 20):
        """Top-k (precision, recall) of the product head over the asin table."""
        with torch.no_grad():
            rep = self.product_rep(graph)
            tgt_y, tgt_mask = self._product_targets(graph)
            return losses.product_asin_precision_recall(rep, self._asin_table(), tgt_y,
                                                        tgt_mask, k)


class JointModel(nn.Module):
    """A session model (the full session) and a subsession model (its
    prefix), both in MLM + ELECTRA form, aligned by a contrastive loss whose
    positives are the same row in each view (JAX ``:247``)."""

    def __init__(self, cfg: Config, encoder_kind: str = "scratch", device=None):
        super().__init__()
        self.cfg = cfg
        self.session_model = SessionEmbeddingModel(cfg, "session", "mlm_electra", encoder_kind,
                                                   device=device)
        self.subsession_model = SessionEmbeddingModel(cfg, "subsession", "mlm_electra",
                                                      encoder_kind, device=device)

    def draw(self, session_graph, subsession_graph, generator):
        return {"session": self.session_model.draw(session_graph, generator),
                "subsession": self.subsession_model.draw(subsession_graph, generator)}

    def forward(self, session_graph, subsession_graph, generator=None,
                deterministic: bool = False, draws=None):
        """-> (loss, metrics {'loss', 'session_loss', 'subsession_loss',
        'ctv_loss'}). Each view is encoded again for the contrastive term,
        as in JAX."""
        if draws is None:
            draws = self.draw(session_graph, subsession_graph, generator)
        det, g = deterministic, generator
        s_loss, _ = self.session_model(session_graph, g, det, draws["session"])
        ss_loss, _ = self.subsession_model(subsession_graph, g, det, draws["subsession"])
        ctv = losses.contrastive_loss(self.subsession_model.encode(subsession_graph, det, g),
                                      self.session_model.encode(session_graph, det, g))
        ctv_w = self.cfg.ctv_w if self.cfg.ctv_w > 0 else 1.0
        loss = s_loss + ss_loss + ctv_w * ctv
        return loss, {"loss": loss, "session_loss": s_loss, "subsession_loss": ss_loss,
                      "ctv_loss": ctv}


def _apply(state: TrainState, loss) -> None:
    """Backward, the optimizer's clip + Adam, one more step."""
    loss.backward()
    state.optimizer.step()
    state.step += 1


def make_session_train_step(model: SessionEmbeddingModel):
    """``step(state, graph, draws=None) -> (state, metrics)``: gradients of
    the loss, global-norm clip, Adam (AdamW when ``weight_decay > 0``), the
    head's BatchNorm statistics updated; ``state`` is updated in place. Like
    JAX's jitted step it always applies the update and never waits for the
    card (``training.loop.run_training`` decides on a non-finite loss)."""

    def step(state: TrainState, graph, draws=None):
        state.optimizer.zero_grad(set_to_none=False)
        loss, metrics = model(graph, state.generator, deterministic=False, draws=draws)
        _apply(state, loss)
        return state, {k: v.detach() for k, v in metrics.items()}

    return step


def make_joint_train_step(model: JointModel):
    """``step(state, session_graph, subsession_graph, draws=None) -> (state,
    metrics)``, as :func:`make_session_train_step`."""

    def step(state: TrainState, session_graph, subsession_graph, draws=None):
        state.optimizer.zero_grad(set_to_none=False)
        loss, metrics = model(session_graph, subsession_graph, state.generator,
                              deterministic=False, draws=draws)
        _apply(state, loss)
        return state, {k: v.detach() for k, v in metrics.items()}

    return step


def _state(cfg: Config, model: nn.Module, generator: torch.Generator) -> TrainState:
    _init_like_flax(model, generator)
    opt = adam_with_clip(model.parameters(), cfg.lr, cfg.grad_clip_norm, cfg.weight_decay)
    return TrainState(model, opt, generator)


def create_session_state(cfg: Config, device="cuda", mode: str = "subsession",
                         encoder_kind: str = "scratch",
                         generator: Optional[torch.Generator] = None,
                         query_loss_style: str = "autoregressive"
                         ) -> Tuple[SessionEmbeddingModel, TrainState]:
    """The model and its train state on ``device`` (the card unless the
    caller asks for the CPU). Weights are drawn from ``generator`` (default:
    one seeded with ``cfg.seed`` on the device), which then feeds the steps'
    random draws. JAX's ``create_session_state`` always builds the
    autoregressive style; ``query_loss_style`` is the model's own option."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(cfg.seed)
    model = SessionEmbeddingModel(cfg, mode, query_loss_style, encoder_kind, device=dev)
    return model, _state(cfg, model, generator)


def create_joint_state(cfg: Config, device="cuda", encoder_kind: str = "scratch",
                       generator: Optional[torch.Generator] = None
                       ) -> Tuple[JointModel, TrainState]:
    """As :func:`create_session_state`, for the ``JointModel``."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(cfg.seed)
    model = JointModel(cfg, encoder_kind, device=dev)
    return model, _state(cfg, model, generator)
