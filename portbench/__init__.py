"""The benchmark of ``sessionsimilaritysearch_tpu_torch`` on NVIDIA GPUs.

``python -m portbench.run --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``. Everything a cell
uses is found by name: its configuration in ``configs/``, its traffic mix
in ``traffic/`` and its metrics in ``metrics/``. The plain reference that
decides ``correct`` lives in ``reference/`` and imports nothing of the
program.
"""
