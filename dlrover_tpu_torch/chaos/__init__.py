"""Deterministic fault-injection plane (see ``injector.py``).

Usage at an injection site::

    from dlrover_tpu_torch.chaos import get_injector
    from dlrover_tpu_torch.common.constants import ChaosSite

    inj = get_injector()
    if inj is not None:
        inj.fire(ChaosSite.RPC_SEND, method=method)  # may sleep or raise

``get_injector()`` returns None unless ``DLROVER_FAULT_SCHEDULE`` is set
(or :func:`configure` was called).
"""

from dlrover_tpu_torch.chaos.injector import (  # noqa: F401
    SCHEDULE_ENV,
    SEED_ENV,
    FaultInjector,
    FaultRule,
    InjectedError,
    InjectedFault,
    active_repro,
    configure,
    get_injector,
    parse_rule,
    parse_schedule,
    reset_injector,
)
