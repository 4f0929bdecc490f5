"""The port's task registry against ``repro.api.tasks``: the cifar
(resnet9), charlm (Shakespeare LSTM) and gaze (mlp, mse loss) tasks
build the reference's arrays and splits, and two Engine rounds of each
match the reference's.

Engine rounds use ``torch_parity.py``'s harness and tolerances
(per-round metrics rtol 1e-4, the carried initial state, the
reference's injected plans; gaze's ``angular_deg`` rtol 1e-4).  Under
cifar the conv biases in front of a BatchNorm are held to Adam's 2 * lr
* steps bound alone: their exact gradient is 0 (see
``repro_torch.models.cnn.bias_before_batchnorm``).  Under gaze the
std of the grad norm over rounds is also held within 1e-6 of the mean
norm: its two round means lie 1e-3 apart, so that std is a cancellation
whose float32 rounding (measured 7e-10, 1e-7 of the mean) is a large
share of it.
"""
import argparse

import numpy as np
import pytest
import torch

from repro.api.tasks import TASKS as J_TASKS
from repro.api.tasks import build_task as j_build
from repro_torch.api import (TASKS, Engine, ExperimentConfig, build_task,
                             register_task, task_names)
from repro_torch.models.cnn import bias_before_batchnorm
from torch_parity import check_program

# name -> (task name, metric key, fixed cut or None)
EXPECT = {"image": ("femnist_cnn@cut2", "accuracy"),
          "cifar": ("resnet9@cut2", "accuracy"),
          "charlm": ("shakespeare_lstm@cut2", "accuracy"),
          "gaze": ("mlp@cut1", "angular_deg")}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread in this process: the LSTM's step loop and the
    small convolutions gain nothing from more, and beside the suite's
    other workers more threads only contend (each worker would start
    one a core)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_registry_has_the_reference_tasks():
    assert set(TASKS) == set(J_TASKS)
    assert task_names() == tuple(sorted(J_TASKS))


@pytest.mark.parametrize("name", ["cifar", "charlm", "gaze"])
def test_task_arrays_and_split_are_the_reference(name):
    """Same arrays client by client, same task name (charlm always cuts
    at 2 and gaze at 1, whatever ``cut`` says) and the same metric key;
    gaze's labels are float32 [n, 2], charlm's inputs int64 ids."""
    jt, jf, jk = j_build(name, 6, 0.5, 2, 4, 3 if name == "cifar" else 2)
    tt, tf, tk = build_task(name, 6, 0.5, 2, 4, 3 if name == "cifar" else 2)
    assert tk == jk and tt.name == jt.name
    assert (tt.server_head is None) == (jt.server_head is None)
    if name != "cifar":
        assert tt.name == EXPECT[name][0]
    assert tf.n_clients == jf.n_clients
    for a, b in zip(jf.clients, tf.clients):
        for f in ("x_train", "y_train", "x_test", "y_test"):
            want, got = getattr(a, f), getattr(b, f)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    y = tf.clients[0].y_train
    if name == "gaze":
        assert y.dtype == np.float32 and y.shape[1:] == (2,)
    if name == "charlm":
        assert tf.clients[0].x_train.dtype == np.int64


ENGINE_CASES = [("cifar", "cyclesfl", "padded"),
                ("charlm", "cyclesfl", "padded"),
                ("charlm", "sflv1", "unpadded"),
                ("gaze", "cyclepsl", "padded"),
                ("gaze", "psl", "unpadded")]


@pytest.mark.parametrize("task,algo,mode", ENGINE_CASES,
                         ids=[f"{t}-{a}-{m}" for t, a, m in ENGINE_CASES])
def test_two_engine_rounds_match_reference(task, algo, mode):
    exempt = bias_before_batchnorm if task == "cifar" else None
    check_program(algo, mode, seed=1, exempt=exempt, task=task,
                  rounds_std_atol=1e-6 if task == "gaze" else 0.0)


@pytest.mark.parametrize("task", list(EXPECT))
def test_config_validates_every_task_and_the_timing_knobs(task):
    cfg = ExperimentConfig(task=task, collect_timing=True, sync_every=3)
    assert cfg.validate() is cfg
    eng = Engine(cfg, device="cpu", log=lambda *a: None)
    assert eng.task.name.startswith(EXPECT[task][0].split("@")[0])
    assert eng.metric_key == EXPECT[task][1]


def test_flags_reach_the_config():
    ap = ExperimentConfig.add_arguments(argparse.ArgumentParser())
    cfg = ExperimentConfig.from_flags(ap.parse_args(
        ["--task", "gaze", "--sync-every", "4", "--cut", "2"]))
    assert (cfg.task, cfg.sync_every, cfg.cut) == ("gaze", 4, 2)
    with pytest.raises(SystemExit):
        ap.parse_args(["--task", "celeba"])


def test_register_task_makes_a_task_reachable():
    @register_task("gaze-copy")
    def _copy(n_clients, alpha, seed, width, cut):
        return TASKS["gaze"](n_clients, alpha, seed, width, cut)
    try:
        cfg = ExperimentConfig(task="gaze-copy", n_clients=4, attendance=0.5,
                               rounds=1, eval_every=1, batch=4)
        res = Engine(cfg, device="cpu", log=lambda *a: None).run()
        assert res["task"] == "gaze-copy"
        assert np.isfinite(res["history"][-1]["angular_deg"])
    finally:
        del TASKS["gaze-copy"]
    with pytest.raises(KeyError):
        ExperimentConfig(task="gaze-copy").validate()
