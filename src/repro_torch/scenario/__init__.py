"""repro_torch.scenario — client-population scenarios for the Engine
(port of ``repro.scenario``).

* :mod:`repro_torch.scenario.profiles` — ``ClientProfile`` /
  ``ScenarioConfig`` + the deterministic ``ProfileStream`` churn
  generators (uniform, pareto-straggler, diurnal-churn).
* :mod:`repro_torch.scenario.population` — the population simulator: N
  (100k+) lazily materialized synthetic clients driving one server
  (import it directly; it pulls in ``repro_torch.api``).
"""
from repro_torch.scenario.profiles import (STREAMS, ClientProfile,
                                           DiurnalChurnStream,
                                           ParetoStragglerStream,
                                           ProfileStream, RoundEvents,
                                           ScenarioConfig, UniformStream,
                                           build_profile_stream,
                                           scenario_kinds)

__all__ = [
    "ClientProfile", "ScenarioConfig", "ProfileStream", "RoundEvents",
    "UniformStream", "ParetoStragglerStream", "DiurnalChurnStream",
    "STREAMS", "build_profile_stream", "scenario_kinds",
]
