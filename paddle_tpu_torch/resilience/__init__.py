"""Fault tolerance at the serving seam (counterpart of
``paddle_tpu/resilience``). Ported: the batcher's typed rejections and
health state machine (``recovery``) and seeded fault injection
(``chaos``)."""
from .chaos import (ChaosError, TransientChaosError, arm_scenario,
                    disarm, fault_point)
from .recovery import (DeadlineExceeded, HealthState, HealthStateMachine,
                       Overloaded)

__all__ = ["ChaosError", "TransientChaosError", "arm_scenario", "disarm",
           "fault_point", "DeadlineExceeded", "HealthState",
           "HealthStateMachine", "Overloaded"]
