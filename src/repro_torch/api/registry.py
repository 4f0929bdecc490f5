"""The SL algorithm registry: name -> RoundProgram.

Port of ``repro/api/registry.py``.  Only ``cyclesfl`` (Algorithm 1 with
a FedAvg commit, the default program) is ported; the JAX package's other
names raise ``NotImplementedError``.
"""
from __future__ import annotations

from repro_torch.api.phases import (ClientUpdate, Commit, ExtractFeatures,
                                    FeatureGradients, RoundProgram,
                                    ServerUpdate)

# the JAX package's programs that the port does not have yet
NOT_PORTED = ("cyclepsl", "cyclesglr", "cyclessl", "fedavg", "psl", "sflv1",
              "sflv2", "sglr", "ssl")


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
    "cyclesfl": _cycle("cyclesfl", commit="average"),
}


def get_program(name: str) -> RoundProgram:
    key = name.lower()
    if key in NOT_PORTED:
        raise NotImplementedError(f"algorithm {name!r} is not ported yet; "
                                  f"ported: {sorted(PROGRAMS)}")
    if key not in PROGRAMS:
        raise KeyError(f"unknown algorithm {name!r}: {sorted(PROGRAMS)}")
    return PROGRAMS[key]


def algorithm_names() -> tuple[str, ...]:
    return tuple(sorted(PROGRAMS))
