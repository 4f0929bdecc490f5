"""The SL algorithm registry: name -> RoundProgram (paper §2.1 / §4).

Port of ``repro/api/registry.py``.  Each Cycle variant is its baseline
with ``ServerUpdate`` swapped to the CycleSL inner loop and
``FeatureGradients`` pointed at the updated server.  New algorithms
register here (``register_program``) and work in every entry point:
``Engine``, ``launch/train.py`` and the deprecated ``make_algorithm``
shim.
"""
from __future__ import annotations

from repro_torch.api.phases import (ClientUpdate, Commit, ExtractFeatures,
                                    FeatureGradients, LocalFedAvgRound,
                                    RoundProgram, SequentialChainRound,
                                    ServerSequentialRound, ServerUpdate)


def _classic(name: str, server_mode: str, commit: str,
             average: bool | None = False) -> RoundProgram:
    """Classic SL order: features -> server step(s) -> gradients at the
    PRE-update server θ_S^t -> client VJP steps -> commit."""
    return RoundProgram(name, (
        ExtractFeatures(),
        ServerUpdate(mode=server_mode),
        FeatureGradients(use_updated=False, average=average),
        ClientUpdate(),
        Commit(mode=commit),
    ), uses_global_client=(commit == "average"))


def _cycle(name: str, commit: str,
           average: bool | None = None) -> RoundProgram:
    """CycleSL order (Algorithm 1): the server trains FIRST on the pooled
    feature dataset, clients then receive gradients from the UPDATED,
    frozen server (Eq. 5)."""
    return RoundProgram(name, (
        ExtractFeatures(),
        ServerUpdate(mode="cycle"),
        FeatureGradients(use_updated=True, average=average),
        ClientUpdate(record_gnorm=True),
        Commit(mode=commit),
    ), uses_global_client=(commit == "average"))


PROGRAMS: dict[str, RoundProgram] = {
    # sequential / fused baselines
    "ssl": RoundProgram("ssl", (SequentialChainRound(),),
                        uses_global_client=True),
    "sflv2": RoundProgram("sflv2", (ServerSequentialRound(),),
                          uses_global_client=True),
    "fedavg": RoundProgram("fedavg", (LocalFedAvgRound(),),
                           uses_global_client=True),
    # parallel SL family (classic back-prop order)
    "psl": _classic("psl", "replica_avg", commit="per_client"),
    "sflv1": _classic("sflv1", "replica_avg", commit="average"),
    "sglr": _classic("sglr", "mean_grad", commit="per_client", average=True),
    # Cycle variants: same programs, server phase swapped
    "cyclepsl": _cycle("cyclepsl", commit="per_client"),
    "cyclesfl": _cycle("cyclesfl", commit="average"),
    "cyclesglr": _cycle("cyclesglr", commit="per_client", average=True),
    # CycleSL on the sequential chain: one shared client model updated
    # along the cohort chain
    "cyclessl": RoundProgram("cyclessl", (
        ExtractFeatures(),
        ServerUpdate(mode="cycle"),
        FeatureGradients(use_updated=True),
        ClientUpdate(record_gnorm=True, chained=True),
        Commit(mode="global"),
    ), uses_global_client=True),
}


def get_program(name: str) -> RoundProgram:
    key = name.lower()
    if key not in PROGRAMS:
        raise KeyError(f"unknown algorithm {name!r}: {sorted(PROGRAMS)}")
    return PROGRAMS[key]


def register_program(program: RoundProgram, overwrite: bool = False) -> None:
    key = program.name.lower()          # lookups lowercase; store likewise
    if key in PROGRAMS and not overwrite:
        raise ValueError(f"algorithm {key!r} already registered "
                         "(pass overwrite=True to replace)")
    PROGRAMS[key] = program


def algorithm_names() -> tuple[str, ...]:
    return tuple(sorted(PROGRAMS))
