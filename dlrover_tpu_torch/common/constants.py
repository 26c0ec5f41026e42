"""The environment knobs the port reads.

A private copy of the part of ``dlrover_tpu/common/constants.py`` this
package needs (the port imports nothing of the JAX package). The knob
names stay the same, so one environment drives both packages alike.
"""

import os


def env_str(name: str, default: str = "") -> str:
    return os.environ.get(name, default)


class ConfigKey:
    LOG_LEVEL = "DLROVER_TPU_LOG_LEVEL"
    # trainer/data.py: the auto-tuner's dataloader config file, inherited
    # by agent-forked workers
    PARAL_CONFIG_FILE = "DLROVER_TPU_PARAL_CONFIG_FILE"
    # models/decode.py fused-kernel routing: 1/0 force the decode kernel
    # on/off; default "auto" follows the policy in flash_decode_wanted
    FLASH_DECODE = "DLROVER_TPU_FLASH_DECODE"
