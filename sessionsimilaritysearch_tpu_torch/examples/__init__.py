"""The operational scripts (counterparts of the repository's ``examples/``):
one module per script, with the same file names, each run as
``python -m sessionsimilaritysearch_tpu_torch.examples.<name>`` and on the
card unless ``--device cpu`` is given.

- ``serving_soak``: one sustained ``SessionSearchEngine`` workload that
  interleaves ingest, search, ``remove_sessions``, ``expire``, a
  non-blocking ``save_async`` and ``restore``, on one device or over a mesh
  of shards;
- ``flagship_campaign``: a multi-epoch pretrain at the reference's widths
  with step-granular checkpoints and a crash / resume drill;
- ``training_soak``: every pretrain head and the contrastive view through
  ``run_training``, with a forced NaN rollback and a checkpoint resume;
- ``flagship_serving``: train the flagship encoder, embed a corpus through
  the fully cached bf16 forward and serve it through all 14 search modes
  (QPS, value-recall@10, ``ave_type_score10``), resumable from a
  ``--cache`` that either package writes;
- ``flagship_train``: pretrain or subsession training at the reference's
  widths with a checkpoint resume proof;
- ``index_build_100k``: train, embed, build and serve a 100k-session f32
  index (its serve half is ``serve``);
- ``maintenance_bench``: ``range_search`` across radii, filtered search,
  ``merge_from`` and ``remove_ids`` at 2^20 x 1600, unsharded and on a
  one-shard mesh;
- ``embed_pipeline_probe``: ``EmbeddingPipeline``'s host and device
  outputs, their parity, and an index build from each;
- ``quality_protocol``: encoder vs SKNN, STAN and their score and
  reciprocal-rank fusions over independent seeds (mean +- std), with the
  pretrain or the flagship encoder;
- ``binary_quality``: dense cosine against 250-bit Hamming serving of
  untrained, SimHash, ITQ and fine-tuned codes on the same embeddings;
- ``knn_pairings``: next-item recall@K of the three query / corpus
  pairings of a subsession and a session tower, joint or independent;
- ``generalization_benchmark``: the out-of-catalog regime (corpus and
  queries from disjoint catalog halves), encoder vs SKNN and STAN;
- ``incatalog_benchmark``: the in-catalog regime, encoder vs SKNN, STAN
  and their hybrid fusion.
"""
