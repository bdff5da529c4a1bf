"""Utilities of the port (counterparts of ``sessionsimilaritysearch_tpu.utils``,
which exports the same names)."""

from sessionsimilaritysearch_tpu_torch.utils.logging import MetricLogger, RunDir  # noqa: F401
from sessionsimilaritysearch_tpu_torch.utils.profiling import PhaseTimer, trace  # noqa: F401
from sessionsimilaritysearch_tpu_torch.utils.sanitize import (  # noqa: F401
    assert_donates,
    assert_pure,
    debug_nans,
)
