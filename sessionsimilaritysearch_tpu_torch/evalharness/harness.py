"""The embedding loop of the serving path (counterpart of
``sessionsimilaritysearch_tpu/evalharness/harness.py:45``
``EmbeddingPipeline``)."""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from sessionsimilaritysearch_tpu_torch.config import Config
from sessionsimilaritysearch_tpu_torch.data.graph import SessionGraph
from sessionsimilaritysearch_tpu_torch.data.loader import SessionGraphLoader
from sessionsimilaritysearch_tpu_torch.device import resolve_device
from sessionsimilaritysearch_tpu_torch.native_build import ensure_native_library


def to_device(batch: SessionGraph, device: torch.device) -> SessionGraph:
    """Host numpy batch -> tensors on ``device``. On a CUDA device each
    field goes through pinned host memory and a ``non_blocking`` copy, so
    the copies queue on the stream behind the previous batch's compute."""
    pin = device.type == "cuda"
    fields = []
    for a in batch:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if pin:
            t = t.pin_memory()
        fields.append(t.to(device, non_blocking=True))
    return SessionGraph(*fields)


class EmbeddingPipeline:
    """Sessions -> padded graphs (``SessionGraphLoader``, built on a prefetch
    thread) -> batched encoder forward -> [N, d] embeddings in input order.
    The loader wrap-pads the last batch to ``batch_size``; the padding rows
    are dropped from the result."""

    def __init__(self, cfg: Config, tokenizer, encode_fn: Callable, *,
                 device, batch_size: int = 256):
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.encode_fn = encode_fn
        self.device = resolve_device(device)
        self.batch_size = batch_size
        ensure_native_library()  # before the loader first loads it

    def __call__(self, data: Sequence, out: str = "np"):
        """``data``: (prefix, future) pairs or bare sessions. ``out``: 'np'
        returns a host float32 array; 'device' keeps the result a tensor on
        the device, so an index build takes the embeddings with no host
        round trip."""
        if out not in ("np", "device"):
            raise ValueError(f"out must be 'np' or 'device', got {out!r}")
        if len(data) == 0:
            z = torch.zeros((0, 0), device=self.device)
            return z if out == "device" else z.cpu().numpy()
        norm = [
            d if isinstance(d, tuple) and len(d) == 2 else (d, [])
            for d in data
        ]
        loader = SessionGraphLoader(
            norm, self.tokenizer, self.cfg.dims, self.batch_size,
            shuffle=False, ignore_query=self.cfg.ignore_query, cache=False,
        )
        try:
            with torch.inference_mode():
                parts = [self.encode_fn(to_device(b, self.device)) for b in loader]
        finally:
            loader.close()
        emb = torch.cat(parts, dim=0)[: len(norm)]
        return emb if out == "device" else emb.float().cpu().numpy()
