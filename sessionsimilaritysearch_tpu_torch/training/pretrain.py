"""Pretraining (counterpart of ``sessionsimilaritysearch_tpu/training/pretrain.py``).

``PretrainModel`` bundles the Unify-pooling encoder, the target asin
embedding and the heads, and computes the JAX module's loss menu
(``pretrain.py:116-291``) term for term: the next-product asin BCE, and each
auxiliary (all-product, next / current query, next / current title, qaea
distillation, node reconstruction, token ELECTRA, contrastive views) behind
its config weight. The frozen text backbone doubles as the target text
embedder, as in JAX.

Flax creates only the heads that its init traces; the port builds the same
set from the ``Config``'s weights (``next_product_head`` always,
``all_product_head`` with ``ph_w``, the query heads with ``qh_w``, the title
heads with ``pt_w``, ``qaea_head`` with ``qaea_w``, the node heads with
``node_w``, ``token_electra_head`` and the encoder's cross-attention branch
with ``token_w``), so both parameter trees have the same leaves.

The random parts of a step -- the node keep-masks, the negative samples of
the asin losses and the token corruption -- are drawn by :meth:`PretrainModel.draw`
from the train state's ``torch.Generator``, or passed in as ``draws`` (the
parity tests pass the JAX package's).

**Data parallel** (``make_train_step(model, mesh=...)``, JAX's GSPMD step
over a mesh, ``tests/test_pretrain.py:198``): one process per device, each
with its rows of the global batch (``parallel.shard_batch`` /
``host_local_batch_to_global``) and, after ``parallel.shard_params``, its
rows of the row-sharded tables (``target_asin_embedding``, the text
backbone's ``tok_emb``). The step equals the one-process step on the whole
batch: the draws are the global batch's, from a generator in the same
state on every rank, cut to this rank's rows (and asin columns, for a
sharded table); the BatchNorms normalize by the global batch's statistics;
each loss term is this rank's share of the global term (``losses``), so
the shares sum to the global loss; the replicated parameters' gradients
are summed over the ranks in one all-reduce, a sharded table's stay with
its rows, and the clip takes the global norm. The metrics are the global
values on every rank. Dropout inside the modules would draw per rank, so
the step refuses a configuration that turns it on.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.profiler import record_function

from sessionsimilaritysearch_tpu_torch.config import Config
from sessionsimilaritysearch_tpu_torch.device import resolve_device
from sessionsimilaritysearch_tpu_torch.models.encoder import (
    _embed_nodes,
    build_pretrain_encoder,
    init_parameters,
)
from sessionsimilaritysearch_tpu_torch.models.heads import MLP
from sessionsimilaritysearch_tpu_torch.models.pooling import masked_mean
from sessionsimilaritysearch_tpu_torch.parallel.sharding import ALONE, BatchGroup, row_shards
from sessionsimilaritysearch_tpu_torch.training import losses
from sessionsimilaritysearch_tpu_torch.training.train_state import TrainState, adam_with_clip


class PretrainModel(nn.Module):
    """Encoder + target asin embedding + heads (JAX ``pretrain.py:49``)."""

    def __init__(self, cfg: Config, device, generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(cfg.seed)
        self.cfg = cfg
        d_text, d_sess = cfg.text_encoder_dim, cfg.session_emb_dim
        d_node = d_text + cfg.gnn_nlayers * cfg.gnn_nout
        self.encoder = build_pretrain_encoder(cfg, dev, generator)
        self.target_asin_embedding = nn.Embedding(cfg.asin_num, cfg.emb_len, device=dev)

        def mlp(d_in, n_out, n_hid, n_layers, rate):
            return MLP(d_in, n_out, n_hid, n_layers, rate, device=dev)

        def maybe(weight, build):
            return build() if weight > 0 else None

        self.next_product_head = mlp(d_sess, cfg.emb_len, cfg.ph_nhid, cfg.ph_nlayers,
                                     cfg.ph_dropout)
        self.all_product_head = maybe(cfg.ph_w, lambda: mlp(
            d_sess, cfg.emb_len, cfg.ph_nhid, cfg.ph_nlayers, cfg.ph_dropout))
        self.next_query_head = maybe(cfg.qh_w, lambda: mlp(
            d_sess, d_text, cfg.qh_nhid, cfg.qh_nlayers, cfg.qh_dropout))
        self.all_query_head = maybe(cfg.qh_w, lambda: mlp(
            d_sess, d_text, cfg.qh_nhid, cfg.qh_nlayers, cfg.qh_dropout))
        self.next_title_head = maybe(cfg.pt_w, lambda: mlp(
            d_sess, d_text, d_text, 2, cfg.qh_dropout))
        self.all_title_head = maybe(cfg.pt_w, lambda: mlp(
            d_sess, d_text, d_text, 2, cfg.qh_dropout))
        self.qaea_head = maybe(cfg.qaea_w, lambda: mlp(d_sess, d_text, 2000, 2, 0.0))
        self.query_node_head = maybe(cfg.node_w, lambda: mlp(d_node, d_text, d_text, 2, 0.0))
        self.product_node_head = maybe(cfg.node_w, lambda: mlp(d_node, d_text, d_text, 2, 0.0))
        self.token_electra_head = maybe(cfg.token_w, lambda: nn.Linear(d_text, 1, device=dev))
        with torch.no_grad():
            for name, m in self.named_children():
                if name not in ("encoder", "target_asin_embedding"):
                    init_parameters(m, generator)
            # Flax's Embed default, normal(0, 1 / features): unit-variance
            # asin rows would saturate the loss's [1e-4, 0.9999] clip
            w = self.target_asin_embedding.weight
            w.normal_(0.0, 1.0 / math.sqrt(cfg.emb_len), generator=generator)

    def encode(self, graph):
        """Plain session embedding (corpus building, serving)."""
        return self.encoder(graph)

    def _embed_targets(self, ids, typ, att):
        return _embed_nodes(self.encoder.query_node_embedder, ids, typ, att)

    def _table_shard(self):
        return getattr(self.target_asin_embedding, "row_shard", None)

    def draw(self, graph, generator: torch.Generator,
             group: BatchGroup = ALONE) -> Dict[str, torch.Tensor]:
        """The random parts of one step, from ``generator``: node keep-masks
        (uniform > node_mask_prob, f32), negative-sample masks of the asin
        losses and, with ``token_w > 0``, the token corruption masks
        (uniform < mask_token_ratio, maskable ids only). They are drawn for
        the global batch of ``group`` and cut to this rank's part
        (:meth:`cut_draws`)."""
        cfg = self.cfg
        dev = graph.query_node_mask.device
        B = graph.query_node_mask.shape[0] * group.world

        def uniform(shape):
            return torch.rand((B,) + tuple(shape[1:]), generator=generator, device=dev)

        def neg():
            return losses.negative_mask(generator, B, cfg.asin_num, cfg.neg_sample_count, dev)

        d = {"query_node_mask": (uniform(graph.query_node_mask.shape)
                                 > cfg.node_mask_prob).to(torch.float32),
             "product_node_mask": (uniform(graph.product_node_mask.shape)
                                   > cfg.node_mask_prob).to(torch.float32),
             "neg_next": neg()}
        if cfg.ph_w > 0:
            d["neg_all"] = neg()
        if cfg.token_w > 0:
            d["query_corrupt"] = uniform(graph.query_input_ids.shape) < cfg.mask_token_ratio
            d["product_corrupt"] = (uniform(graph.product_input_ids.shape)
                                    < cfg.mask_token_ratio)
        d = self.cut_draws(d, group)
        if cfg.token_w > 0:
            d["query_corrupt"] &= graph.query_input_ids >= losses.MIN_MASKABLE_ID
            d["product_corrupt"] &= graph.product_input_ids >= losses.MIN_MASKABLE_ID
        return d

    def cut_draws(self, draws: Dict[str, torch.Tensor],
                  group: BatchGroup = ALONE) -> Dict[str, torch.Tensor]:
        """The global batch's draws cut to this rank of ``group``: its rows,
        except the negative samples against a row-sharded table, which keep
        every row and take this rank's asin columns."""
        shard = self._table_shard()
        out = {}
        for key, val in draws.items():
            if key.startswith("neg_") and shard is not None:
                out[key] = val[:, shard.start: shard.stop]
            else:
                lo, hi = group.rows(val.shape[0] // group.world)
                out[key] = val[lo:hi]
        return out

    def forward(self, graph, generator: Optional[torch.Generator] = None, view_graph=None,
                deterministic: bool = False, tables: Optional[dict] = None,
                draws: Optional[Dict[str, torch.Tensor]] = None, group: BatchGroup = ALONE
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """-> (loss, metrics). ``tables``: the cached text catalogs
        ``{"title_table", "query_table" (optional), "query_kw" (with
        query_table)}``; they serve only the active next-product objective,
        so every token-consuming auxiliary weight (qh/pt/qaea/node/token)
        must be 0. ``draws``: the step's random parts (:meth:`draw`), drawn
        from ``generator`` when not given. ``generator`` also feeds the
        dropouts (all at rate 0 in ``Config()``). ``group``: the ranks of the
        step (``parallel.sharding.BatchGroup``, this process alone by
        default); ``graph`` and ``draws`` are this rank's part, and the loss
        and metrics this rank's shares of the global ones."""
        cfg = self.cfg
        if tables is not None and (cfg.qh_w or cfg.pt_w or cfg.qaea_w or cfg.node_w
                                   or cfg.token_w):
            raise ValueError("cached text tables serve only the active next-product "
                             "objective; token-consuming auxiliaries need the real "
                             "text forward")
        shard = self._table_shard()
        if shard is not None and group is ALONE:
            raise ValueError("target_asin_embedding is row-sharded: run the model in a "
                             "data-parallel step (make_train_step(..., mesh=))")
        if draws is None:
            draws = self.draw(graph, generator, group)
        qmask, pmask = draws["query_node_mask"], draws["product_node_mask"]
        g = generator
        det = deterministic

        want_token = cfg.token_w > 0
        enc_graph = graph
        if want_token:
            # replaced-token-detection corruption of both node stores
            enc_graph = graph._replace(
                query_input_ids=torch.where(draws["query_corrupt"], losses.MASK_TOKEN_ID,
                                            graph.query_input_ids),
                product_input_ids=torch.where(draws["product_corrupt"],
                                              losses.MASK_TOKEN_ID,
                                              graph.product_input_ids),
            )
        out = self.encoder(enc_graph, qmask, pmask, get_node=True, get_token=want_token,
                           deterministic=det, generator=g, **(tables or {}))
        embedding, node_emb = out[0], out[1]
        token_emb = out[2] if want_token else None

        with record_function("head + loss"):
            metrics: Dict[str, torch.Tensor] = {}
            table = self.target_asin_embedding.weight

            next_rep = self.next_product_head(embedding, det, g, group)
            next_product_loss = losses.product_asin_loss(
                next_rep, table, graph.product_target_y, graph.product_target_mask,
                draws["neg_next"], group, shard)
            metrics["next_product_loss"] = next_product_loss
            loss = next_product_loss

            if cfg.ph_w > 0:
                all_product_loss = losses.product_asin_loss(
                    self.all_product_head(embedding, det, g, group), table, graph.product_asin,
                    graph.product_node_mask, draws["neg_all"], group, shard)
                metrics["all_product_loss"] = all_product_loss
                loss = loss + cfg.ph_w * next_product_loss + 2 * cfg.ph_w * all_product_loss

            if cfg.qh_w > 0:
                qt_emb = self._embed_targets(graph.query_target_input_ids,
                                             graph.query_target_type_ids,
                                             graph.query_target_attention_mask)
                nq = losses.all_text_embedding_loss(
                    self.next_query_head(embedding, det, g, group), qt_emb,
                    graph.query_target_node_mask, graph.query_target_mask, group)
                q_emb = self._embed_targets(graph.query_input_ids, graph.query_type_ids,
                                            graph.query_attention_mask)
                cq = losses.all_text_embedding_loss(
                    self.all_query_head(embedding, det, g, group), q_emb,
                    graph.query_node_mask, graph.query_loss_mask, group)
                metrics["next_query_loss"], metrics["cur_query_loss"] = nq, cq
                loss = loss + cfg.qh_w * (nq + cq)

            if cfg.pt_w > 0:
                nt_emb = self._embed_targets(graph.product_target_input_ids,
                                             graph.product_target_type_ids,
                                             graph.product_target_attention_mask)
                nt = losses.all_text_embedding_loss(
                    self.next_title_head(embedding, det, g, group), nt_emb,
                    graph.product_target_mask, group=group)
                t_emb = self._embed_targets(graph.product_input_ids, graph.product_type_ids,
                                            graph.product_attention_mask)
                ct = losses.all_text_embedding_loss(
                    self.all_title_head(embedding, det, g, group), t_emb,
                    graph.product_node_mask, group=group)
                metrics["next_title_loss"], metrics["cur_title_loss"] = nt, ct
                loss = loss + cfg.pt_w * (nt + ct)

            if cfg.qaea_w > 0:
                # distill toward the frozen text embedding of the whole-session text
                label = masked_mean(self._embed_targets(graph.text_input_ids,
                                                        graph.text_type_ids,
                                                        graph.text_attention_mask),
                                    graph.text_node_mask)
                qaea_loss = losses.qaea_distill_loss(self.qaea_head(embedding, det, g, group),
                                                     label, group)
                metrics["qaea_loss"] = qaea_loss
                loss = loss + cfg.qaea_w * qaea_loss

            if cfg.node_w > 0:
                q_feat = self._embed_targets(graph.query_input_ids, graph.query_type_ids,
                                             graph.query_attention_mask)
                p_feat = self._embed_targets(graph.product_input_ids, graph.product_type_ids,
                                             graph.product_attention_mask)

                def node_pred(head, x, like):
                    return head(x.reshape(-1, x.shape[-1]), det, g, group).reshape(like.shape)

                qn = losses.node_reconstruction_loss(
                    node_pred(self.query_node_head, node_emb["query"], q_feat), q_feat, qmask,
                    graph.query_node_mask, group)
                pn = losses.node_reconstruction_loss(
                    node_pred(self.product_node_head, node_emb["product"], p_feat), p_feat,
                    pmask, graph.product_node_mask, group)
                metrics["query_node_loss"], metrics["product_node_loss"] = qn, pn
                loss = loss + cfg.node_w * (qn + pn)

            if want_token:
                def pred(t):
                    return torch.sigmoid(self.token_electra_head(token_emb[t]))[..., 0]

                token_loss = losses.electra_loss(
                    pred("query"), enc_graph.query_input_ids, graph.query_input_ids,
                    graph.query_attention_mask, group,
                ) + losses.electra_loss(
                    pred("product"), enc_graph.product_input_ids, graph.product_input_ids,
                    graph.product_attention_mask, group,
                )
                metrics["token_loss"] = token_loss
                loss = loss + cfg.token_w * token_loss

            if cfg.ctv_w > 0 and view_graph is not None:
                view_emb = self.encoder(view_graph, deterministic=det, generator=g)
                ctv = losses.contrastive_loss(embedding, view_emb, group)
                metrics["ctv_loss"] = ctv
                loss = loss + cfg.ctv_w * ctv

            metrics["loss"] = loss
        return loss, metrics

    def retrieval_metrics(self, graph, k: int = 20):
        """Next-product top-k (precision, recall) over the asin vocabulary
        (the whole table: not on a row-sharded one)."""
        if self._table_shard() is not None:
            raise ValueError("retrieval_metrics ranks the whole asin table; this rank "
                             "holds a row shard of it")
        rep = self.next_product_head(self.encoder(graph), deterministic=True)
        return losses.product_asin_precision_recall(
            rep, self.target_asin_embedding.weight, graph.product_target_y,
            graph.product_target_mask, k)


def make_train_step(model: PretrainModel, has_view: bool = False, mesh=None):
    """One pretrain step (JAX ``pretrain.py:304``): gradients of the
    composite loss, global-norm clip, Adam (``adam_with_clip``), BatchNorm
    running statistics updated. ``step(state, graph, view_graph=None,
    tables=None, draws=None) -> (state, metrics)``; ``state`` is updated in
    place. Like JAX's jitted step it always applies the update and never
    waits for the card: whether a non-finite loss is dropped or rolled back
    is the training loop's decision (``training.loop.run_training``). The
    backward runs in a ``torch.profiler`` span (``backward``).

    ``mesh``: the data-parallel step (see the module docstring) over a mesh
    whose process holds one shard (``parallel.multihost.global_mesh(
    local_devices=[device])``); any other mesh raises. ``graph`` (and
    ``view_graph``) are then this rank's rows, ``draws`` the global batch's;
    the replicated gradients are summed over the ranks in a span
    ``gradient all-reduce``."""
    group = ALONE if mesh is None else BatchGroup.from_mesh(mesh)
    if mesh is None and row_shards(model):
        raise ValueError("the model holds row-sharded tables: pass the mesh that "
                         "shard_params used (make_train_step(..., mesh=))")
    cfg = model.cfg
    if mesh is not None and (cfg.ph_dropout or cfg.qh_dropout):
        raise ValueError("the data-parallel step draws for the global batch; dropout in "
                         "the heads would draw per rank (ph_dropout and qh_dropout must be 0)")

    def step(state: TrainState, graph, view_graph=None, tables=None, draws=None):
        state.optimizer.zero_grad(set_to_none=False)
        if draws is not None:
            draws = model.cut_draws(draws, group)
        loss, metrics = model(graph, state.generator, view_graph if has_view else None,
                              deterministic=False, tables=tables, draws=draws, group=group)
        with record_function("backward"):
            loss.backward()
        if group.distributed:
            with record_function("gradient all-reduce"):
                partial = row_shards(model)
                group.sum_([p.grad for name, p in model.named_parameters()
                            if name not in partial and p.grad is not None])
        state.optimizer.step()
        state.step += 1
        metrics = {k: v.detach() for k, v in metrics.items()}
        if group.distributed:
            values = group.sum(torch.stack(list(metrics.values())))
            metrics = dict(zip(metrics, values))
        return state, metrics

    return step


def make_eval_step(model: PretrainModel):
    """Metrics of a deterministic forward (running BatchNorm statistics);
    its node keep-masks and negative samples stay random, as in JAX."""

    def step(state: TrainState, graph, draws=None):
        with torch.no_grad():
            _, metrics = model(graph, state.generator, deterministic=True, draws=draws)
        return metrics

    return step


def make_encode_fn(model: PretrainModel):
    """``encode(state, graph) -> [B, session_emb_dim]``."""

    def encode(state: TrainState, graph):
        with torch.no_grad():
            return model.encode(graph)

    return encode


def create_pretrain_state(cfg: Config, device,
                          generator: Optional[torch.Generator] = None
                          ) -> Tuple[PretrainModel, TrainState]:
    """The model (weights drawn from ``generator``, default one seeded with
    ``cfg.seed`` on ``device``) and its train state; the same generator then
    feeds the steps' random draws."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(cfg.seed)
    model = PretrainModel(cfg, dev, generator)
    opt = adam_with_clip(model.parameters(), cfg.lr, cfg.grad_clip_norm, cfg.weight_decay)
    return model, TrainState(model, opt, generator)
