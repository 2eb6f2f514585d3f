"""Test infrastructure for the port: the mock runtimes and the fuzz
harness, the load and scenario harnesses (the client swarm, the catch-up
storm and their oracle twins), the pinned synthetic catch-up corpora (the
library entries' and the catch-up service's), the hard-semantics
fixtures, and the fault injector the op log reads."""

from .faults import FaultError, FaultInjector, FaultPlan, FaultPoint
from .mocks import MockContainerRuntimeFactory, MockClientRuntime
from .scenarios import (ClientSwarm, Phase, ScenarioSpec, SwarmResult,
                        build_scenario, oracle_spec, run_swarm,
                        run_swarm_with_oracle, scenario_docs)

__all__ = [
    "FaultError", "FaultInjector", "FaultPlan", "FaultPoint",
    "MockContainerRuntimeFactory", "MockClientRuntime",
    "ClientSwarm", "Phase", "ScenarioSpec", "SwarmResult",
    "build_scenario", "oracle_spec", "run_swarm", "run_swarm_with_oracle",
    "scenario_docs",
]
