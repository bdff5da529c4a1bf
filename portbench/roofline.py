"""The yardstick of device work: published peaks of one NVIDIA H100 SXM
(dense, without sparsity, at its 700 W limit) and the operations and bytes
that each part of a search needs, counted from shapes whatever implements
it. A kernel's roofline share is the least time of its work, the larger of
operations over the peak and bytes over the bandwidth, over its device
time. Bytes count each input read once; the score buffers an
implementation writes are not part of the work."""

from __future__ import annotations

from typing import Optional, Tuple

PEAK = {"bf16": 989e12, "fp16": 989e12, "fp8": 1979e12, "int8": 1979e12,
        "tf32": 495e12, "f32": 67e12}
HBM_BYTES_PER_S = 3.35e12
POWER_LIMIT_W = 700.0


def least_seconds(ops: float, nbytes: float, peak: str) -> float:
    return max(ops / PEAK[peak], nbytes / HBM_BYTES_PER_S)


def dense_scan(q: int, n: int, d: int, elt: int = 2) -> Tuple[float, float, str]:
    """The exact scan of n rows of width d for q queries: 2·q·n·d products
    at the bf16 rate; the rows and the queries read once."""
    return 2.0 * q * n * d, float(n * d * elt + q * d * elt), "bf16"


def binary_scan(q: int, n: int, bits: int) -> Tuple[float, float, str]:
    """The Hamming scan of n codes of ``bits`` bits for q queries: 2·q·n·bits
    ±1 products at the int8 rate (the tighter bound of any popcount
    design); the packed codes read once."""
    return 2.0 * q * n * bits, float(n * bits // 8 + q * bits // 8), "int8"


def rerank(q: int, pool: int, d: int, elt: int = 2) -> Tuple[float, float, str]:
    """The exact re-rank of ``pool`` rows per query: 2·q·pool·d products;
    the pooled rows gathered once."""
    return 2.0 * q * pool * d, float(q * pool * d * elt + q * d * 4), "bf16"


def encoder_flops(model: dict, batch: int, nodes: Optional[Tuple[int, int]] = None) -> float:
    """FLOPs of ``batch`` sessions through the cached serving forward (GNN
    and poolings; the catalog tables replace the text encoder), counted by
    ``FlopCounterMode`` on the reference encoder at ``nodes`` = (query
    nodes, product nodes) a session: what the sessions need (see
    ``reference.graph.node_counts``); by default the padded shapes, as the
    program runs them."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from portbench.reference.encoder import Arith, Encoder, param_spec

    meta = torch.device("meta")
    W = {name: torch.empty(shape, device=meta) for name, shape, _, _ in param_spec(model)}
    L = model["max_seq_len"]
    Q, P = nodes if nodes is not None else (L + 1, L)
    dt = model["text_encoder_dim"]
    g = {"adj_qp": torch.empty(batch, Q, P, device=meta),
         "adj_pp": torch.empty(batch, P, P, device=meta),
         "query_mask": torch.empty(batch, Q, device=meta),
         "product_mask": torch.empty(batch, P, device=meta),
         "last_click": torch.empty(batch, P, device=meta)}
    query = torch.empty(batch, Q, dt, device=meta)
    product = torch.empty(batch, P, model["emb_len"] + dt, device=meta)
    counter = FlopCounterMode(display=False)
    with counter:
        Encoder(W, model, Arith("f32")).graph_forward(query, product, g)
    return float(counter.get_total_flops())
