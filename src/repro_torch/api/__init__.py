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

__all__ = ["ExperimentConfig", "Engine", "evaluate"]
