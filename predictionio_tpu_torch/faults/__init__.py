"""Deterministic, seeded fault injection (see inject.py).

``fault_point(name)`` is a no-op unless a :class:`FaultPlan` is active
(via the ``PIO_FAULTS`` env var or the test API) — the hot paths pay one
module-global None check.
"""

from predictionio_tpu_torch.faults.inject import (  # noqa: F401
    KNOWN_POINTS,
    FaultError,
    FaultPlan,
    FaultRule,
    active_plan,
    clear,
    fault_point,
    injected,
    install,
    parse_plan,
    parse_rule,
    plan_from_env,
)
