"""Rank jobs of ``tests/test_torch_dryrun.py``: one train step on a real
gloo mesh, whose census the dry run's fake group is held to.

``repro_torch.launch.meshcheck.spawn_ranks`` runs each job in spawned
ranks, which import this module: it imports torch and the port only,
never JAX.
"""
import torch

from repro_torch.launch.dryrun import step_args
from repro_torch.launch.steps import build_train_step
from repro_torch.utils.profiling import mesh_comms


def train_census(mesh, cfg, shape, cycle, cohort):
    """This rank's census of one ``build_train_step`` round on ``mesh``
    (every group's, since the step was built)."""
    torch.set_num_threads(1)
    bundle = build_train_step(cfg, shape, cycle, cohort=cohort,
                              device="cpu", mesh=mesh)
    for c in mesh_comms(mesh):
        c.take_census()
    bundle.fn(*step_args(bundle, "train"))
    out = {}
    for c in mesh_comms(mesh):
        out.update(c.take_census())
    return out
