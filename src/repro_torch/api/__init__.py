"""repro_torch.api — the experiment/engine API (port of ``repro.api``).

* :mod:`repro_torch.api.phases` — ``RoundProgram``: algorithms as
  compositions of typed phases over one ``TrainState``.
* :mod:`repro_torch.api.registry` / :mod:`repro_torch.api.tasks` — name
  -> program and name -> task tables.
* :mod:`repro_torch.api.config` / :mod:`repro_torch.api.engine` — frozen
  ``ExperimentConfig`` + the ``Engine.run()`` driver loop.
"""
from repro_torch.api.config import ExperimentConfig
from repro_torch.api.engine import Engine, evaluate
from repro_torch.api.phases import (ClientUpdate, Commit, ExtractFeatures,
                                    FeatureGradients, Phase, PhaseContext,
                                    RoundProgram, RoundVars, ServerUpdate,
                                    SLAlgorithm, TrainState, build_algorithm,
                                    init_train_state)
from repro_torch.api.registry import (PROGRAMS, algorithm_names, get_program,
                                      register_program)
from repro_torch.api.tasks import TASKS, build_task, register_task, task_names

__all__ = [
    "ExperimentConfig", "Engine", "evaluate",
    "Phase", "PhaseContext", "RoundProgram", "RoundVars", "TrainState",
    "SLAlgorithm", "ExtractFeatures", "ServerUpdate", "FeatureGradients",
    "ClientUpdate", "Commit", "build_algorithm", "init_train_state",
    "PROGRAMS", "algorithm_names", "get_program", "register_program",
    "TASKS", "build_task", "register_task", "task_names",
]
