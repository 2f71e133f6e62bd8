"""Mimose core: collector, estimator, scheduler, planner.

The reference's public names (``src/repro/core/__init__.py``), from
the port's modules.  None of the modules below imports this package's
names, so importing one submodule first (which runs this file) is safe.
"""
from repro_torch.actions import Action, as_actions  # noqa: F401
from repro_torch.core.cache import LRUCache  # noqa: F401
from repro_torch.core.collector import (CollectionResult,  # noqa: F401
                                        ShuttlingCollector, input_size_of,
                                        unit_residual_bytes)
from repro_torch.core.estimator import (DecisionTreeEstimator,  # noqa: F401
                                        ESTIMATORS, PolyEstimator)
from repro_torch.core.planner import (MimosePlanner, NonePlanner,  # noqa: F401
                                      PlannerBase, fixed_train_bytes)
from repro_torch.core.baselines import (DTRSimPlanner,  # noqa: F401
                                        SublinearPlanner)
from repro_torch.core.scheduler import (ActionTables, Plan,  # noqa: F401
                                        action_tables, build_buckets,
                                        escalate_plan, greedy_plan,
                                        greedy_plan_adaptive,
                                        greedy_plan_reference,
                                        greedy_plan_sharded)
from repro_torch.core.simulator import (BatchSimResult,  # noqa: F401
                                        ShardedSimResult, SimResult,
                                        dtr_simulate,
                                        peak_if_checkpointing_unit, simulate,
                                        simulate_many, simulate_sharded)
from repro_torch.core.solver import (BackgroundSolver,  # noqa: F401
                                     SolveRequest, SolveResult, solve)
from repro_torch.launch.roofline import (offload_transfer_s,  # noqa: F401
                                         plan_unit_flops, unit_fwd_flops)
from repro_torch.sharding.budget import (MeshBudget,  # noqa: F401
                                         fixed_train_bytes_per_device)
