"""Auto-parallelization search (port of ``flexflow_tpu.search``): the GPU
machine model, the cost simulator, the Unity DP search, the MCMC fallback
and the substitution engine (SURVEY §2.1 L4a/L4b).
"""
from .machine_model import GPUMachineModel  # noqa: F401
from .simulator import CostMetrics, OpSharding, Simulator  # noqa: F401
from .unity import unity_search, mcmc_optimize, factorizations  # noqa: F401
from .multipod import (ICISubSolver, hierarchical_enabled,  # noqa: F401
                       simulated_multipod_machine)
