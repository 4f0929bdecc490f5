"""The SL algorithm zoo: a thin, deprecated shim over ``repro_torch.api``.

Port of ``repro/core/algorithms.py``.  Every algorithm shares one
interface:

    algo = make_algorithm("cyclesfl", task, opt_server=..., opt_client=...)
    state = algo.init(seed, n_clients)
    state, metrics = algo.round(state, cohort_idx, xs, ys, key)

The rounds live in :mod:`repro_torch.api.phases` as
:class:`~repro_torch.api.phases.RoundProgram` compositions; see
:mod:`repro_torch.api.registry` for the name -> program table (paper
§2.1 / §4):

  ssl       sequential SL (O(N)-latency canon)
  psl       parallel SL, server replicas averaged, clients never aggregated
  sflv1     PSL + FedAvg of client models (SplitFed V1)
  sflv2     single server, clients processed sequentially server-side
  sglr      server-side local gradient averaging (no model aggregation)
  fedavg    full-model local training + averaging (non-SL yardstick)
  cyclepsl  CycleSL plugged into PSL    (== paper Algorithm 1)
  cyclesfl  CycleSL plugged into SFL
  cyclesglr CycleSL plugged into SGLR
  cyclessl  CycleSL on sequential SL    (appendix-only in the paper)

Deprecated: new code resolves programs through
``repro_torch.api.get_program`` + ``build_algorithm``, or drives whole
experiments with ``repro_torch.api.Engine``.
"""
from __future__ import annotations

import warnings

from repro_torch.api.engine import resolve_device
from repro_torch.api.phases import (RoundProgram, SLAlgorithm,  # noqa: F401
                                    TrainState, build_algorithm)
from repro_torch.api.registry import PROGRAMS, get_program
from repro_torch.core.cyclesl import CycleConfig
from repro_torch.core.split import SplitTask
from repro_torch.optim import Optimizer

# Backwards-compatible aliases: AlgoState is the state the phases
# transform, and ALGORITHMS resolves through the one program registry.
AlgoState = TrainState
ALGORITHMS: dict[str, RoundProgram] = PROGRAMS


def make_algorithm(name: str, task: SplitTask, opt_server: Optimizer,
                   opt_client: Optimizer,
                   cycle: CycleConfig = CycleConfig(),
                   device=None) -> SLAlgorithm:
    """Deprecated shim: bind a registered RoundProgram.  ``device=None``
    puts the state ``init`` builds on the card (it raises without one).

    Use ``repro_torch.api.build_algorithm(repro_torch.api.get_program(
    name), ...)`` (or ``repro_torch.api.Engine`` for full runs) in new
    code.
    """
    warnings.warn(
        "make_algorithm is deprecated; use repro_torch.api.get_program + "
        "build_algorithm, or repro_torch.api.Engine",
        DeprecationWarning, stacklevel=2)
    return build_algorithm(get_program(name), task, opt_server, opt_client,
                           cycle, device=resolve_device(device))
