"""Host runtime utilities: phase timers, resource logging, deadlines."""

from pintron_tpu_torch.runtime.timing import (PhaseTimer, Timeout,
                                        TimerRegistry,
                                        log_info_extended,
                                        resource_usage_log)

__all__ = ["PhaseTimer", "Timeout", "TimerRegistry", "log_info_extended",
           "resource_usage_log"]
