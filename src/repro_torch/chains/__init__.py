"""Function-chain subsystem (paper §3.1.3 collaborative execution +
§5.1.4 data localization): model an application as a DAG of functions
with typed data edges, plan placement for the whole chain with a
data-gravity cost model, and execute it collaboratively across target
platforms.

    from repro_torch.chains import catalog, DataGravityPlanner, ChainExecutor

    tmpl = catalog.get("etl-pipeline")
    planner = DataGravityPlanner(cp.policy, cp.placement, fns)
    plan = planner.plan(tmpl.chain, list(cp.platforms.values()))
    ex = ChainExecutor(cp, fns)
    inst = ex.launch(tmpl.chain, plan)
"""
from repro_torch.chains.spec import EXTERNAL, Chain, DataEdge, Stage
from repro_torch.chains.planner import (PLAN_MODES, ChainPlan,
                                        DataGravityPlanner)
from repro_torch.chains.executor import ChainExecutor, ChainInstance
from repro_torch.chains import catalog
from repro_torch.chains.catalog import ChainInput, ChainTemplate

__all__ = [
    "EXTERNAL", "Chain", "DataEdge", "Stage",
    "PLAN_MODES", "ChainPlan", "DataGravityPlanner",
    "ChainExecutor", "ChainInstance",
    "catalog", "ChainInput", "ChainTemplate",
]
