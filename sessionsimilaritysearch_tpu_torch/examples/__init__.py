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
  ``run_training``, with a forced NaN rollback and a checkpoint resume.
"""
