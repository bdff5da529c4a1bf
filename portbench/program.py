"""The system under test, built as a deployment of
``sessionsimilaritysearch_tpu_torch`` runs it: the flagship encoder under
the bf16 serving policy, the catalog title table and the keyword table,
the cached serving forward, and a ``SessionSearchEngine`` whose index is
filled with the corpus rows through its own ``add``. Only this module and
the run import the program."""

from __future__ import annotations

import dataclasses

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def program_config(model: dict):
    from sessionsimilaritysearch_tpu_torch.config import Config

    names = {f.name for f in dataclasses.fields(Config)}
    return Config().replace(**{k: v for k, v in model.items() if k in names})


def build_engine(cfg_file: dict, weights: dict, catalog, keywords, corpus, device):
    """The engine, its index holding every corpus row. ``weights`` are the
    benchmark's (the reference's names are the program's ``state_dict``
    keys)."""
    from sessionsimilaritysearch_tpu_torch.engine import SessionSearchEngine
    from sessionsimilaritysearch_tpu_torch.evalharness.harness import (
        build_keyword_table,
        build_title_table,
        make_cached_encode_fn,
    )
    from sessionsimilaritysearch_tpu_torch.models.encoder import build_graph_encoder
    from sessionsimilaritysearch_tpu_torch.tokenizer import get_tokenizer
    from sessionsimilaritysearch_tpu_torch.utils.precision import serving_params

    cfg = program_config(cfg_file["model"])
    eng_kw = dict(cfg_file["engine"])
    batch = int(eng_kw.pop("batch_size"))
    n_bits = eng_kw.pop("n_bits", None)
    proj_seed = eng_kw.pop("projection_seed", None)
    eng_kw["dtype"] = _DTYPES[eng_kw["dtype"]]
    enc = build_graph_encoder(cfg, device)
    enc.load_state_dict({k: v.float() for k, v in weights.items()})
    enc = serving_params(enc)
    tok = get_tokenizer(cfg.vocab_size)
    with torch.inference_mode():
        table = build_title_table(cfg, tok, catalog.titles, enc, batch_size=batch)
        qtable, lookup = build_keyword_table(cfg, tok, keywords, enc, batch_size=batch)
    encode = make_cached_encode_fn(enc, table, query_table=qtable, kw_lookup=lookup)
    eng = SessionSearchEngine(cfg, tok, encode, dim=cfg.session_emb_dim,
                              capacity=corpus.rows, device=device, batch_size=batch,
                              **eng_kw)
    if n_bits is not None and eng.index.n_bits != n_bits:
        raise RuntimeError(f"the engine built {eng.index.n_bits}-bit codes, not {n_bits}")
    if proj_seed is not None and eng.index.seed != proj_seed:
        raise RuntimeError(f"the engine drew its projection from seed {eng.index.seed}")
    with torch.inference_mode():
        for _, rows in corpus.blocks():
            eng.index.add(rows)
    return eng


def launch_counts() -> dict:
    """The program's kernel launch counters by kernel and variant."""
    from sessionsimilaritysearch_tpu_torch.ops import mips, packed

    return {"k1": mips.launch_count, "k1_wgmma": mips.wgmma_launch_count,
            "k1_cp_async": mips.cp_async_launch_count, "k4": packed.launch_count}
