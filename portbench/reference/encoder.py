"""The flagship two-pool ``GraphLevelEncoder`` forward in plain PyTorch,
over a dict of named weights (the names are the program's ``state_dict``
keys, so one set of weights made by the benchmark serves both).

Text encoder (token + position + token-type embeddings, LayerNorm, a
post-norm transformer with a ReLU feed-forward, masked mean over real
tokens) for the query nodes and the product titles; product nodes are
``concat(asin embedding, title embedding)``; padded nodes are zeroed; a
heterogeneous GNN of ``gnn_nlayers`` layers (single-head GAT on the
query <-> product edges, a gated graph convolution with a GRU update on
product -> product, ReLU, jumping-knowledge concat); SR-GNN pooling of the
products, attention pooling of the queries, concatenated.

``Arith`` says in which arithmetic it runs: ``'f32'`` (float32, TF32 off,
the reference) or ``'fp8'`` (every weight and every operand of a matrix
product rounded to float8 e4m3 with a per-tensor scale, accumulated in
float32: the control that must come out not correct).
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.graph import graph_batch

LN_EPS = 1e-6
FP8_MAX = 448.0  # the largest finite float8 e4m3 value


@contextmanager
def no_tf32():
    """Float32 matrix products in float32: TF32 off for the block."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale that maps its largest
    magnitude to 448, returned in float32."""
    amax = x.abs().amax().clamp(min=1e-30)
    s = amax / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def round_fp8_rows(x: torch.Tensor) -> torch.Tensor:
    """Each row of ``x`` rounded to float8 e4m3 under its own scale."""
    amax = x.abs().amax(dim=-1, keepdim=True).clamp(min=1e-30)
    s = amax / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


class Arith:
    def __init__(self, kind: str = "f32"):
        if kind not in ("f32", "fp8"):
            raise ValueError(f"unknown arithmetic {kind!r}")
        self.kind = kind

    def q(self, x: torch.Tensor) -> torch.Tensor:
        return round_fp8(x) if self.kind == "fp8" else x

    def weights(self, W: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The weights as this arithmetic holds them, in float32."""
        return {k: self.q(v.float()) for k, v in W.items()}


def param_spec(m: dict) -> List[Tuple[str, tuple, str, int]]:
    """(name, shape, init, fan_in) of every weight of the encoder at the
    widths ``m`` (the configuration's ``model`` keys). ``init`` is
    ``'normal'`` (std 1/sqrt(fan_in); embeddings fan_in 1), ``'bias'``,
    ``'ones'``, ``'zeros'`` or ``'glorot'`` (uniform, fan_in + fan_out in
    the last field)."""
    spec = []

    def lin(name, d_in, d_out, bias=True):
        spec.append((f"{name}.weight", (d_out, d_in), "normal", d_in))
        if bias:
            spec.append((f"{name}.bias", (d_out,), "bias", d_in))

    def ln(name, d):
        spec.append((f"{name}.weight", (d,), "ones", 1))
        spec.append((f"{name}.bias", (d,), "zeros", 1))

    dt, dh = m["text_encoder_dim"], m["query_embedder_nhid"]
    t = "query_node_embedder"
    spec.append((f"{t}.tok_emb.weight", (m["vocab_size"], dt), "normal", 1))
    spec.append((f"{t}.pos_emb.weight", (m["token_len"], dt), "normal", 1))
    spec.append((f"{t}.type_emb.weight", (2, dt), "normal", 1))
    ln(f"{t}.emb_ln", dt)
    for i in range(2):
        p = f"{t}.encoder.layers.{i}"
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            lin(f"{p}.self_attn.{proj}", dt, dt)
        ln(f"{p}.norm1", dt)
        lin(f"{p}.ffn_in", dt, dh)
        lin(f"{p}.ffn_out", dh, dt)
        ln(f"{p}.norm2", dt)
    spec.append(("product_node_embedder.encoder.weight", (m["asin_num"], m["emb_len"]),
                 "normal", 1))
    hid, layers = m["gnn_nhid"], m["gnn_nlayers"]
    dq, dp = dt, m["emb_len"] + dt
    for i in range(layers):
        for key, ds, dd in (("qp", dq, dp), ("pq", dp, dq)):
            c = f"gnn.convs.l{i}_{key}"
            spec.append((f"{c}.att_src", (hid, 1), "glorot", hid + 1))
            spec.append((f"{c}.att_dst", (hid, 1), "glorot", hid + 1))
            spec.append((f"{c}.bias", (hid,), "bias", hid))
            lin(f"{c}.lin_src", ds, hid, bias=False)
            lin(f"{c}.lin_dst", dd, hid, bias=False)
        c = f"gnn.convs.l{i}_pp"
        if dp > hid:
            lin(f"{c}.in_proj", dp, hid)
        lin(f"{c}.weight", hid, hid, bias=False)
        lin(f"{c}.gru.ih", hid, 3 * hid)
        lin(f"{c}.gru.hh", hid, 3 * hid)
        dq = dp = hid
    d_prod = m["emb_len"] + dt + layers * hid
    d_query = dt + layers * hid
    lin("product_pooling.lin1", d_prod, d_prod)
    lin("product_pooling.lin2", d_prod, d_prod)
    lin("product_pooling.lin3", d_prod, 1, bias=False)
    lin("product_pooling.lin4", 2 * d_prod, m["gnn_nout"])
    lin("query_pooling.lin", d_query, m["gnn_nout"])
    # the key order of the program's state_dict: the backbone, the asin
    # embedding, the GNN, the product pooling, the query pooling
    return spec


class Encoder:
    """The forward over weights ``W`` (float32, as ``arith`` holds them)."""

    def __init__(self, W: Dict[str, torch.Tensor], m: dict, arith: Arith):
        self.W, self.m, self.a = W, m, arith

    def _lin(self, name: str, x: torch.Tensor, bias: bool = True) -> torch.Tensor:
        b = self.W[f"{name}.bias"] if bias else None
        return F.linear(self.a.q(x), self.W[f"{name}.weight"], b)

    def _mm(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.a.q(x), self.a.q(y))

    def _ln(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, x.shape[-1:], self.W[f"{name}.weight"],
                            self.W[f"{name}.bias"], LN_EPS)

    # -- text encoder
    def texts(self, ids: torch.Tensor) -> torch.Tensor:
        """[N, T] token ids -> [N, text_encoder_dim] (token types are 0)."""
        t = "query_node_embedder"
        T = ids.shape[1]
        x = (self.W[f"{t}.tok_emb.weight"][ids]
             + self.W[f"{t}.pos_emb.weight"][:T][None]
             + self.W[f"{t}.type_emb.weight"][0])
        x = self._ln(f"{t}.emb_ln", x)
        pad = ids == 0
        nhead = self.m["query_embedder_nhead"]
        for i in range(2):
            p = f"{t}.encoder.layers.{i}"
            B, L, D = x.shape
            hd = D // nhead

            def heads(v):
                return v.reshape(B, L, nhead, hd).transpose(1, 2)

            q = heads(self._lin(f"{p}.self_attn.q_proj", x))
            k = heads(self._lin(f"{p}.self_attn.k_proj", x))
            v = heads(self._lin(f"{p}.self_attn.v_proj", x))
            s = self._mm(q, k.transpose(-1, -2)) / math.sqrt(hd)
            s = s.masked_fill(pad[:, None, None, :], torch.finfo(s.dtype).min)
            att = torch.softmax(s, dim=-1)
            att = att.masked_fill(pad.all(dim=-1)[:, None, None, None], 0.0)
            o = self._mm(att, v).transpose(1, 2).reshape(B, L, D)
            x = self._ln(f"{p}.norm1", x + self._lin(f"{p}.self_attn.out_proj", o))
            f = self._lin(f"{p}.ffn_out", torch.relu(self._lin(f"{p}.ffn_in", x)))
            x = self._ln(f"{p}.norm2", x + f)
        mask = (~pad).to(x.dtype)
        return (x * mask[..., None]).sum(dim=1) / mask.sum(dim=1, keepdim=True).clamp(min=1.0)

    # -- graph part
    def _gat(self, c: str, x_src, x_dst, adj):
        h_src = self._lin(f"{c}.lin_src", x_src, bias=False)
        h_dst = self._lin(f"{c}.lin_dst", x_dst, bias=False)
        e_src = self._mm(h_src, self.W[f"{c}.att_src"])[..., 0]
        e_dst = self._mm(h_dst, self.W[f"{c}.att_dst"])[..., 0]
        e = F.leaky_relu(e_src[:, :, None] + e_dst[:, None, :], 0.2)
        w = adj * torch.exp(e - e.amax(dim=1, keepdim=True))
        alpha = w / w.sum(dim=1, keepdim=True).clamp(min=1e-16)
        return self._mm(alpha.transpose(1, 2), h_src) + self.W[f"{c}.bias"]

    def _ggc(self, c: str, x, adj):
        hid = self.m["gnn_nhid"]
        if f"{c}.in_proj.weight" in self.W:
            x = self._lin(f"{c}.in_proj", x)
        elif x.shape[-1] < hid:
            x = F.pad(x, (0, hid - x.shape[-1]))
        a = (adj > 0).to(x.dtype)
        msg = self._mm(a.transpose(1, 2), self._lin(f"{c}.weight", x, bias=False))
        i_r, i_z, i_n = self._lin(f"{c}.gru.ih", msg).chunk(3, dim=-1)
        h_r, h_z, h_n = self._lin(f"{c}.gru.hh", x).chunk(3, dim=-1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        return (1.0 - z) * n + z * x

    def graph_forward(self, query, product, g) -> torch.Tensor:
        """Node inputs ([B, Q, d_text], [B, P, emb_len + d_text], padded
        rows zeroed) -> the session embedding [B, 2 * gnn_nout]."""
        adj_qp, adj_pp = g["adj_qp"], g["adj_pp"]
        outs_q, outs_p = [query], [product]
        q, p = query, product
        for i in range(self.m["gnn_nlayers"]):
            p_from_q = self._gat(f"gnn.convs.l{i}_qp", q, p, adj_qp)
            p_from_p = self._ggc(f"gnn.convs.l{i}_pp", p, adj_pp)
            q_from_p = self._gat(f"gnn.convs.l{i}_pq", p, q, adj_qp.transpose(1, 2))
            q, p = torch.relu(q_from_p), torch.relu(p_from_q + p_from_p)
            outs_q.append(q)
            outs_p.append(p)
        xq, xp = torch.cat(outs_q, dim=-1), torch.cat(outs_p, dim=-1)
        mq, mp = g["query_mask"], g["product_mask"]

        def masked_sum(x, mask):
            return (x * mask[..., None]).sum(dim=1)

        def masked_mean(x, mask):
            return masked_sum(x, mask) / mask[..., None].sum(dim=1).clamp(min=1.0)

        coarse = masked_mean(xq, mq)
        att = torch.einsum("bnd,bd->bn", self.a.q(xq), self.a.q(coarse))
        q_out = self._lin("query_pooling.lin", masked_mean(xq * att[..., None], mq))
        local = masked_sum(xp, g["last_click"] * mp)
        gate = self._lin("product_pooling.lin3", torch.sigmoid(
            self._lin("product_pooling.lin1", local)[:, None, :]
            + self._lin("product_pooling.lin2", xp)), bias=False)
        glob = masked_sum(xp * gate, mp)
        p_out = self._lin("product_pooling.lin4", torch.cat([local, glob], dim=-1))
        return torch.cat([q_out, p_out], dim=-1)

    def node_inputs(self, g) -> Tuple[torch.Tensor, torch.Tensor]:
        """The GNN's inputs of a graph batch (tensors of ``graph.graph_batch``):
        every distinct token row through the text encoder once."""
        B, Q, T = g["query_ids"].shape
        P = g["product_ids"].shape[1]
        rows = torch.cat([g["query_ids"].reshape(-1, T), g["product_ids"].reshape(-1, T)])
        uniq, inv = torch.unique(rows, dim=0, return_inverse=True)
        emb = torch.cat([self.texts(uniq[s: s + 4096]) for s in range(0, len(uniq), 4096)])
        text = emb[inv]
        query = text[: B * Q].reshape(B, Q, -1)
        titles = text[B * Q:].reshape(B, P, -1)
        asin = self.W["product_node_embedder.encoder.weight"][g["product_asin"]]
        product = torch.cat([asin, titles], dim=-1)
        return query * g["query_mask"][..., None], product * g["product_mask"][..., None]

    def __call__(self, g) -> torch.Tensor:
        return self.graph_forward(*self.node_inputs(g), g)


def to_tensors(g: dict, device) -> dict:
    return {k: torch.from_numpy(v).to(device) for k, v in g.items()}


def embed_sessions(sessions, W, m: dict, arith: Arith, device, batch: int = 256
                   ) -> torch.Tensor:
    """Sessions -> [len, 2 * gnn_nout] float32 embeddings on ``device``,
    ``batch`` sessions at a time, in ``arith``."""
    with no_tf32(), torch.no_grad():
        enc = Encoder(arith.weights({k: v.to(device) for k, v in W.items()}), m, arith)
        out = []
        for s in range(0, len(sessions), batch):
            g = graph_batch(sessions[s: s + batch], m["max_seq_len"], m["token_len"],
                            m["vocab_size"], m["ignore_query"])
            out.append(enc(to_tensors(g, device)))
        return torch.cat(out)
