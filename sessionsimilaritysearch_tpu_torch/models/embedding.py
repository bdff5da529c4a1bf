"""Node embedders: text -> vector, asin id -> vector (counterparts of
``sessionsimilaritysearch_tpu/models/embedding.py:64`` ``TextEncoder`` and
``:122`` ``NodeAsinEmbedding``)."""

from __future__ import annotations

import torch
from torch import nn

from sessionsimilaritysearch_tpu_torch.models.transformer import (
    LN_EPS,
    TransformerEncoder,
)


class TextEncoder(nn.Module):
    """BERT-style frozen text encoder: token + learned position + token-type
    embeddings -> LayerNorm -> post-norm transformer -> masked mean over
    real tokens, detached (the reference's frozen ``.detach()``). The JAX
    module's optional output Linear (``nout``) is not used by the flagship
    encoder and is not ported."""

    def __init__(self, vocab_size: int, d_model: int = 768, nhead: int = 4,
                 nhid: int = 1024, nlayers: int = 2, max_len: int = 64,
                 device=None):
        super().__init__()
        self.tok_emb = nn.Embedding(vocab_size, d_model, device=device)
        self.pos_emb = nn.Embedding(max_len, d_model, device=device)
        self.type_emb = nn.Embedding(2, d_model, device=device)
        self.emb_ln = nn.LayerNorm(d_model, eps=LN_EPS, device=device)
        self.encoder = TransformerEncoder(d_model, nhead, nhid, nlayers, device=device)

    def forward(self, input_ids, token_type_ids, attention_mask, get_token: bool = False):
        """[B', T] int grids -> [B', d_model] (and, with ``get_token``, the
        per-token embeddings [B', T, d_model]).

        Only the pooled vector is detached, as the JAX module's
        ``stop_gradient`` (``embedding.py:111-112``) stops only it: the
        per-token embeddings carry gradients into the backbone. So the
        backbone runs without autograd unless ``get_token`` asks for them."""
        with torch.set_grad_enabled(get_token and torch.is_grad_enabled()):
            pos = torch.arange(input_ids.shape[-1], device=input_ids.device)
            x = self.emb_ln(
                self.tok_emb(input_ids)
                + self.pos_emb(pos)[None]
                + self.type_emb(torch.clamp(token_type_ids, 0, 1))
            )
            token_emb = self.encoder(x, key_padding_mask=attention_mask == 0)
            mask = attention_mask.to(token_emb.dtype)
            denom = torch.clamp(mask.sum(dim=1, keepdim=True), min=1.0)
            out = ((token_emb * mask[..., None]).sum(dim=1) / denom).detach()
        if get_token:
            return out, token_emb
        return out


class NodeAsinEmbedding(nn.Module):
    """One learned vector per product id."""

    def __init__(self, nproducts: int, ninp: int, device=None):
        super().__init__()
        self.encoder = nn.Embedding(nproducts, ninp, device=device)

    def forward(self, ids):
        return self.encoder(ids)
