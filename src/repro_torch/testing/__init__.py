"""Reusable test kits for the AgentCgroup control plane.

``repro_torch.testing.conformance`` is the backend-certification kit: any
``Backend`` implementation proves itself bit-identical to the reference
host-tree semantics by replaying the standard scenario set through one
parametrized fixture.

Port of ``repro/testing``.
"""
from repro_torch.testing.conformance import (BACKEND_KINDS,
                                             STANDARD_SCENARIOS,
                                             ConformanceReport,
                                             ConformanceSuite, OpRecorder,
                                             Scenario, ScenarioResult,
                                             backend_features,
                                             faulty_backend_factory,
                                             get_scenario, replay,
                                             standard_backend_factory)

__all__ = [
    "BACKEND_KINDS", "ConformanceReport", "ConformanceSuite", "OpRecorder",
    "Scenario", "ScenarioResult", "STANDARD_SCENARIOS",
    "backend_features", "faulty_backend_factory", "get_scenario", "replay",
    "standard_backend_factory",
]
