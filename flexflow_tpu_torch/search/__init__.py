"""The strategy search on one device (the port of ``flexflow_tpu/search``):
the cost model calibrated on the card, Unity and MCMC, the substitution
engine, strategy and program serialization."""
from .costmodel import CostMetrics, OpCostModel  # noqa: F401
from .mcmc import (StrategySimulator, assignment_to_strategy,  # noqa: F401
                   data_parallel_assignment, mcmc_search)
from .optimizer import optimize_strategy  # noqa: F401
from .serialization import (load_strategy, program_from_json,  # noqa: F401
                            program_to_json, save_strategy)
