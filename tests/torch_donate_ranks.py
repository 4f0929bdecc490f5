"""Rank jobs of ``tests/test_torch_donate.py``: the Engine on a (2, 2)
mesh, donated and not.

``repro_torch.launch.meshcheck.spawn_ranks`` runs the job in spawned
ranks, which import this module: it imports torch and the port only,
never JAX.
"""
import torch

from repro_torch.api import Engine, ExperimentConfig
from repro_torch.utils.tree import tree_leaves, tree_map


def engine_run(kw: dict, donate: bool) -> dict:
    """``Engine(donate=donate).run()`` of ``ExperimentConfig(**kw)`` on
    the CPU: each round's metrics, the last round's state gathered whole,
    and whether this rank's server leaves kept their storages from the
    first round to the last."""
    rows, ptrs, out = [], [], {}

    class Rec:
        def on_round(self, eng, rnd, state, metrics):
            rows.append({k: v.detach().clone() for k, v in metrics.items()})
            ptrs.append([t.data_ptr() for t in
                         tree_leaves(state.server.params)])
            if rnd == kw["rounds"] - 1:
                out["state"] = tree_map(lambda t: t.detach().clone(),
                                        eng.whole_state(state))

    eng = Engine(ExperimentConfig(**kw), device="cpu", callbacks=[Rec()],
                 donate=donate, log=lambda *a: None)
    try:
        eng.run()
    finally:
        eng.close()
    out.update(rows=rows, server_in_place=ptrs[0] == ptrs[-1],
               donate=eng.donate)
    return out


def world(mesh, cases: dict) -> dict:
    """Each case ``name: config kwargs`` through the Engine, donated and
    not (the Engine builds its own mesh over these ranks)."""
    torch.set_num_threads(1)
    return {name: {d: engine_run(kw, d) for d in (True, False)}
            for name, kw in cases.items()}
