"""Task registry: name -> (SplitTask, FederatedDataset, metric key).

Port of ``repro/api/tasks.py``.  Only ``image`` (the synthetic FEMNIST
stand-in on ``femnist_cnn``) is ported; the JAX package's other tasks
raise ``NotImplementedError``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.split import make_stage_task
from repro_torch.data.federated import FederatedDataset
from repro_torch.data.synthetic import SyntheticImageTask
from repro_torch.models.cnn import femnist_cnn

NOT_PORTED = ("charlm", "cifar", "gaze")


def _image(n_clients, alpha, seed, width, cut):
    gen = SyntheticImageTask(n_clients=n_clients, alpha=alpha, seed=seed)
    x, y, _, idx = gen.build()
    model = femnist_cnn(n_classes=gen.n_classes, width=width)
    task = make_stage_task(model, cut=cut, kind="xent")
    x = x.reshape(len(x), gen.img, gen.img, gen.channels)
    # femnist cnn expects 28x28x1; adapt by averaging channels + padding
    x = x.mean(axis=-1, keepdims=True)
    x = np.pad(x, ((0, 0), (6, 6), (6, 6), (0, 0)))
    return task, FederatedDataset.from_arrays(x, y, idx, seed=seed), "accuracy"


TASKS = {"image": _image}


def build_task(name: str, n_clients: int, alpha: float, seed: int,
               width: int, cut: int):
    if name in NOT_PORTED:
        raise NotImplementedError(f"task {name!r} is not ported yet; "
                                  f"ported: {sorted(TASKS)}")
    if name not in TASKS:
        raise KeyError(f"unknown task {name!r}: {sorted(TASKS)}")
    return TASKS[name](n_clients, alpha, seed, width, cut)


def task_names() -> tuple[str, ...]:
    return tuple(sorted(TASKS))
