from .straggler import (StepTimeMonitor, simulate_fault_impact,
                        simulate_straggler_impact)
from .elastic import (ElasticPlan, elastic_restart_plan,
                      restart_plan_for_faults)

__all__ = ["StepTimeMonitor", "simulate_straggler_impact",
           "simulate_fault_impact", "ElasticPlan",
           "elastic_restart_plan", "restart_plan_for_faults"]
