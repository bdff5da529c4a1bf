"""Traffic: ``<mix>.json`` files of parameters. A mix's ``driver`` names
the module ``<driver>.py`` here that makes its requests from the seed and
sends them (``closed.py``: one closed-loop client through
``engine.search``); mixes of one driver differ in data alone."""
