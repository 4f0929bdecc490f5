"""The parallel SL family and its Cycle variants (psl, sflv1, sglr,
cyclepsl, cyclesfl, cyclesglr) through the port's Engine against
``repro.api.Engine``, padded (variable attendance, a padded slot drawn)
and unpadded, and the port's registry against the reference's.

Tolerances and the harness: ``torch_parity.py``.
"""
import dataclasses

import pytest

from repro.api.registry import PROGRAMS as J_PROGRAMS
from repro.api.registry import get_program as j_get_program
from repro_torch.api import (PROGRAMS, algorithm_names, get_program,
                             register_program)
from torch_parity import MODES, check_program
from torch_threads import one_thread  # noqa: F401

PARALLEL = ("psl", "sflv1", "sglr", "cyclepsl", "cyclesfl", "cyclesglr")


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("algo", PARALLEL)
def test_parallel_program_matches_reference(algo, mode):
    check_program(algo, mode, seed=1)


def test_registry_has_the_reference_names():
    assert set(PROGRAMS) == set(J_PROGRAMS)
    assert algorithm_names() == tuple(sorted(J_PROGRAMS))
    assert get_program("CyclePSL") is PROGRAMS["cyclepsl"]
    for get in (get_program, j_get_program):
        with pytest.raises(KeyError):
            get("splitfed-v3")


@pytest.mark.parametrize("name", sorted(J_PROGRAMS))
def test_program_structure_matches_reference(name):
    """describe(), each phase's type and dataclass fields (mode,
    use_updated, average, record_gnorm, chained), uses_global_client."""
    want, got = j_get_program(name), get_program(name)
    assert got.name == want.name
    assert got.describe() == want.describe()
    assert got.uses_global_client == want.uses_global_client
    assert len(got.phases) == len(want.phases)
    for p, q in zip(got.phases, want.phases):
        assert type(p).__name__ == type(q).__name__
        assert dataclasses.asdict(p) == dataclasses.asdict(q)


def test_register_program_refuses_a_taken_name():
    prog = dataclasses.replace(get_program("psl"), name="PSL-copy")
    register_program(prog)
    try:
        assert get_program("psl-copy") is prog
        with pytest.raises(ValueError):
            register_program(prog)
        register_program(prog, overwrite=True)
    finally:
        del PROGRAMS["psl-copy"]
