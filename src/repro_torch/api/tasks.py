"""Task registry: name -> (SplitTask, FederatedDataset, metric key).

Port of ``repro/api/tasks.py``: the synthetic stand-ins for the paper's
four workloads (§4.1), built exactly as the reference builds them, so
one config drives both packages on identical arrays.  New workloads
register with ``register_task`` and are immediately reachable from
``ExperimentConfig``.
"""
from __future__ import annotations

from typing import Callable

import numpy as np

from repro_torch.core.split import SplitTask, make_stage_task
from repro_torch.data.federated import FederatedDataset
from repro_torch.data.synthetic import (SyntheticCharLMTask,
                                        SyntheticImageTask,
                                        SyntheticRegressionTask)
from repro_torch.models.cnn import femnist_cnn, mlp, resnet9
from repro_torch.models.lstm import shakespeare_lstm

TaskBuilder = Callable[..., tuple[SplitTask, FederatedDataset, str]]
TASKS: dict[str, TaskBuilder] = {}


def register_task(name: str):
    """Register ``fn(n_clients, alpha, seed, width, cut, mesh=None)``.

    On a mesh the Engine calls it with ``mesh=``, and the builder must
    place its task there (``core.split.make_stage_task(..., mesh=)``);
    off the mesh it is called with the five positional arguments alone.
    """
    def deco(fn: TaskBuilder) -> TaskBuilder:
        TASKS[name] = fn
        return fn
    return deco


@register_task("image")
def _image(n_clients, alpha, seed, width, cut, mesh=None):
    gen = SyntheticImageTask(n_clients=n_clients, alpha=alpha, seed=seed)
    x, y, _, idx = gen.build()
    model = femnist_cnn(n_classes=gen.n_classes, width=width)
    task = make_stage_task(model, cut=cut, kind="xent", mesh=mesh)
    x = x.reshape(len(x), gen.img, gen.img, gen.channels)
    # femnist cnn expects 28x28x1; adapt by averaging channels + padding
    x = x.mean(axis=-1, keepdims=True)
    x = np.pad(x, ((0, 0), (6, 6), (6, 6), (0, 0)))
    return task, FederatedDataset.from_arrays(x, y, idx, seed=seed), "accuracy"


@register_task("cifar")
def _cifar(n_clients, alpha, seed, width, cut, mesh=None):
    gen = SyntheticImageTask(n_clients=n_clients, alpha=alpha, seed=seed,
                             img=32, n_classes=20, samples_per_client=96)
    x, y, _, idx = gen.build()
    model = resnet9(n_classes=20, width=width)
    task = make_stage_task(model, cut=cut, kind="xent", mesh=mesh)
    return task, FederatedDataset.from_arrays(x, y, idx, seed=seed), "accuracy"


@register_task("charlm")
def _charlm(n_clients, alpha, seed, width, cut, mesh=None):
    # the paper's Shakespeare cut: embedding and LSTM on the client,
    # whatever cfg.cut says
    gen = SyntheticCharLMTask(n_clients=n_clients, seed=seed)
    x, y, _, idx = gen.build()
    model = shakespeare_lstm(vocab=gen.vocab)
    task = make_stage_task(model, cut=2, kind="xent", mesh=mesh)
    return task, FederatedDataset.from_arrays(x, y, idx, seed=seed), "accuracy"


@register_task("gaze")
def _gaze(n_clients, alpha, seed, width, cut, mesh=None):
    # float32 [N, 2] targets under the mse loss, always cut after the
    # first layer
    gen = SyntheticRegressionTask(n_clients=n_clients, seed=seed)
    x, y, _, idx = gen.build()
    model = mlp(gen.d_in, [128, 64], gen.d_out)
    task = make_stage_task(model, cut=1, kind="mse", mesh=mesh)
    return task, FederatedDataset.from_arrays(x, y, idx, seed=seed), "angular_deg"


def build_task(name: str, n_clients: int, alpha: float, seed: int,
               width: int, cut: int, mesh=None):
    """``(task, dataset, metric key)``; ``mesh`` places the task's halves
    on it (``core.split.make_stage_task``)."""
    if name not in TASKS:
        raise KeyError(f"unknown task {name!r}: {sorted(TASKS)}")
    fn = TASKS[name]
    if mesh is None:
        return fn(n_clients, alpha, seed, width, cut)
    return fn(n_clients, alpha, seed, width, cut, mesh=mesh)


def task_names() -> tuple[str, ...]:
    return tuple(sorted(TASKS))
