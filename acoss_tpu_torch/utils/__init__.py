"""Logging, timing and fault-tolerance utilities (port of
`acoss_tpu.utils`)."""

from acoss_tpu_torch.utils.logging import (  # noqa: F401
    ErrorFile, get_logger, timeit)
