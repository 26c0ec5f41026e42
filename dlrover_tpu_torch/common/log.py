"""Process-wide logger: the port's own copy of ``dlrover_tpu/common/log.py``
(same logger name and format, same ``DLROVER_TPU_LOG_LEVEL`` knob)."""

import logging
import sys

from dlrover_tpu_torch.common.constants import ConfigKey, env_str

_FORMAT = (
    "[%(asctime)s] [%(levelname)s] "
    "[%(filename)s:%(lineno)d:%(funcName)s] %(message)s"
)


def _build_logger() -> logging.Logger:
    logger = logging.getLogger("dlrover_tpu")
    if logger.handlers:
        return logger
    level_name = env_str(ConfigKey.LOG_LEVEL, "INFO").upper()
    logger.setLevel(getattr(logging, level_name, logging.INFO))
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter(_FORMAT))
    logger.addHandler(handler)
    logger.propagate = False
    return logger


logger = _build_logger()
