"""The sequential and fused programs (ssl, sflv2, fedavg, cyclessl)
through the port's Engine against ``repro.api.Engine``, padded
(variable attendance, a padded slot drawn) and unpadded; and the
deprecated ``make_algorithm`` shim and the kwargs ``launch.train.run``.

Tolerances and the harness: ``torch_parity.py``.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.api import PROGRAMS, TrainState
from repro_torch.api.tasks import build_task
from repro_torch.optim import adam
from torch_parity import MODES, check_program
from torch_threads import one_thread  # noqa: F401

SEQUENTIAL = ("ssl", "sflv2", "fedavg", "cyclessl")


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("algo", SEQUENTIAL)
def test_sequential_program_matches_reference(algo, mode):
    check_program(algo, mode, seed=1)


def test_make_algorithm_warns_and_runs():
    from repro_torch.core import algorithms
    assert algorithms.ALGORITHMS is PROGRAMS
    assert algorithms.AlgoState is TrainState
    task, fed, _ = build_task("image", 6, 0.5, 0, 4, 2)
    with pytest.warns(DeprecationWarning):
        algo = algorithms.make_algorithm("psl", task, adam(1e-3), adam(1e-3),
                                         device="cpu")
    state = algo.init(0, fed.n_clients)
    rng = np.random.default_rng(0)
    cohort = np.array([0, 3])
    pairs = [fed.clients[c].sample_batch(rng, 8) for c in cohort]
    xs = torch.from_numpy(np.stack([p[0] for p in pairs]))
    ys = torch.from_numpy(np.stack([p[1] for p in pairs]))
    state, metrics = algo.round(state, torch.from_numpy(cohort), xs, ys, 0)
    assert sorted(metrics) == ["feat_grad_norm_mean", "feat_grad_norm_std",
                               "server_loss"]
    assert all(math.isfinite(float(v)) for v in metrics.values())
    assert state.clients.step.tolist() == [1, 0, 0, 1, 0, 0]
    assert int(state.server.step) == 1


def test_make_algorithm_refuses_the_cpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    from repro_torch.core import algorithms
    task, _, _ = build_task("image", 4, 0.5, 0, 4, 2)
    with pytest.warns(DeprecationWarning), pytest.raises(RuntimeError,
                                                          match="CUDA"):
        algorithms.make_algorithm("psl", task, adam(1e-3), adam(1e-3))


def test_train_run_wrapper_runs_psl_on_the_cpu():
    from repro_torch.launch import train
    res = train.run("psl", rounds=2, n_clients=10, attendance=0.3, batch=8,
                    width=4, eval_every=2, device="cpu", log=lambda *a: None)
    assert res["algo"] == "psl" and len(res["history"]) == 1
    h = res["history"][-1]
    assert h["round"] == 2 and math.isfinite(h["test_loss"])
    assert 0.0 <= h["accuracy"] <= 1.0


def test_cli_takes_every_algo_and_variable_attendance():
    from repro_torch.launch import train
    res = train.main(["--device", "cpu", "--algo", "sflv2", "--rounds", "2",
                      "--clients", "10", "--attendance", "0.3", "--batch",
                      "8", "--width", "4", "--eval-every", "2",
                      "--variable-attendance"])
    assert res["algo"] == "sflv2" and res["history"][-1]["round"] == 2
