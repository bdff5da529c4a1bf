"""One reader per metric, ``<name>.py`` with ``read(run)``: the value, or
None where the run has nothing to read (the metric is then left out).
``run`` holds ``window`` (the driver's ``Window``), ``setup_s``, ``trace``
(``trace.Trace`` of a traced run, else None), ``host`` (the traced run's
host seconds per span name, every request of its window), ``work`` (per
profiled request, the window's first ones: {part: (ops, bytes, peak)}) and
``scoring`` (the configuration's scoring-kernel name patterns)."""
