"""The port's checkpoints (``repro_torch.checkpoint``) and the Engine's
resume, against ``repro.checkpoint`` and ``repro.api.Engine``.

One file format for both packages: a step written by either loads in
the other, leaf for leaf and bit for bit (float32, int32, and bfloat16
as the raw 2-byte records numpy writes for the reference's bfloat16).
A resumed port run equals the port's unbroken run bit for bit and the
reference's within the tolerances of ``torch_runtime_parity.py``; a
checkpoint written by the reference's Engine resumes in the port's.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import Engine as JEngine
from repro.api import ExperimentConfig as JConfig
from repro.checkpoint import load_checkpoint as j_load
from repro.checkpoint import save_checkpoint as j_save
from repro_torch.checkpoint import (checkpoint_valid, latest_step,
                                    load_checkpoint, load_metadata,
                                    save_checkpoint, valid_steps)
from repro_torch.resilience import FaultConfig, FaultStream, ResilienceConfig
from repro_torch.utils.tree import tree_leaves
from repro_torch.utils.weights import train_state_from_reference
from torch_parity import Recorder, assert_rows_close, reference_plan_fn
from torch_runtime_parity import (assert_history_close, config, port_setup,
                                  reference_setup, run_port, states_equal,
                                  strip)
from torch_threads import one_thread  # noqa: F401


def _tree(v=0.0):
    return {"w": torch.full((4, 3), v),
            "b": {"x": torch.arange(6, dtype=torch.int32)}}


@pytest.fixture(scope="module")
def states():
    """One TrainState of each package, the port's carried from the
    reference's: femnist_cnn cut 2 (SFL: server + shared client) and the
    mlp with a per-client store (PSL: [N, ...] stacks)."""
    out = {}
    for name, kw, setup in (("sfl", dict(task="image", n_clients=10,
                                         attendance=0.3, width=4, cut=2),
                             False),
                            ("psl", dict(algo="psl"), True)):
        cfg = config(**kw)
        extra = {}
        if setup:
            task, fed = reference_setup()
            extra = dict(task=task, fed=fed)
        jeng = JEngine(JConfig.from_dict(cfg.to_dict()), log=lambda *a: None,
                       **extra)
        j = jax.device_get(jeng.init_state())
        out[name] = (j, train_state_from_reference(j))
    return out


@pytest.mark.parametrize("writer", ["port", "reference"])
@pytest.mark.parametrize("kind", ["sfl", "psl"])
def test_a_step_loads_in_the_other_package(writer, kind, states, tmp_path):
    """Same paths, same bytes: the port reads the reference's step into
    its template and the reference reads the port's into its own."""
    j, t = states[kind]
    d = str(tmp_path)
    if writer == "port":
        save_checkpoint(d, 5, t, metadata={"algo": kind})
        got, step = j_load(d, j)
        for a, b in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(j)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    else:
        j_save(d, 5, j, metadata={"algo": kind})
        got, step = load_checkpoint(d, t)
        assert states_equal(got, t)
        assert all(a.dtype == b.dtype for a, b in zip(tree_leaves(got),
                                                      tree_leaves(t)))
    assert step == 5 and load_metadata(d, 5) == {"algo": kind}
    names = json.load(open(os.path.join(d, "step_5", "manifest.json")))
    assert len(names["paths"]) == len(tree_leaves(t))


def test_checksum_detects_truncation_and_falls_back(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 1, _tree(1.0))
    save_checkpoint(d, 2, _tree(2.0))
    assert latest_step(d) == 2
    FaultStream.corrupt_checkpoint(d, 2)
    assert not checkpoint_valid(os.path.join(d, "step_2"))
    with pytest.warns(RuntimeWarning, match="corrupt"):
        assert latest_step(d) == 1
    with pytest.warns(RuntimeWarning):
        tree, step = load_checkpoint(d, _tree())
    assert step == 1 and torch.equal(tree["w"], _tree(1.0)["w"])


def test_gc_never_deletes_the_newest_valid_step(tmp_path):
    d = str(tmp_path)
    for s in (1, 2, 3):
        save_checkpoint(d, s, _tree(float(s)), keep=1)
    assert valid_steps(d) == [3]
    FaultStream.corrupt_checkpoint(d, 3)
    save_checkpoint(d, 4, _tree(4.0), keep=1)
    assert valid_steps(d) == [4]
    FaultStream.corrupt_checkpoint(d, 4)
    with pytest.warns(RuntimeWarning):
        assert latest_step(d) is None
    with pytest.warns(RuntimeWarning):
        with pytest.raises(FileNotFoundError):
            load_checkpoint(d, _tree())


def test_atomic_write_leaves_no_tmp_dir(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 7, _tree(7.0))
    assert os.listdir(d) == ["step_7"]
    manifest = json.load(open(os.path.join(d, "step_7", "manifest.json")))
    assert manifest["format"] == 2 and "arrays.npz" in manifest["checksum"]
    assert manifest["paths"] == ["b/x", "w"]


def test_legacy_manifest_without_checksum_loads(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 3, _tree(3.0))
    mpath = os.path.join(d, "step_3", "manifest.json")
    m = json.load(open(mpath))
    del m["checksum"], m["format"]
    json.dump(m, open(mpath, "w"))
    assert checkpoint_valid(os.path.join(d, "step_3"))
    tree, step = load_checkpoint(d, _tree())
    assert step == 3 and torch.equal(tree["w"], _tree(3.0)["w"])


def test_bfloat16_round_trip(tmp_path):
    """bf16 leaves go to disk as raw 2-byte records, as numpy writes the
    reference's bfloat16, and come back by the template's dtype: the
    port's own round trip, and a leaf the reference wrote."""
    vals = torch.tensor([[1.5, -2.0, 3.25e-3], [65280.0, -0.0, 7.0]])
    t = {"p": vals.to(torch.bfloat16), "f": torch.ones(2)}
    save_checkpoint(str(tmp_path / "port"), 1, t)
    with np.load(tmp_path / "port" / "step_1" / "arrays.npz") as data:
        assert data["p"].dtype == np.dtype("V2")
    got, _ = load_checkpoint(str(tmp_path / "port"), t)
    assert got["p"].dtype == torch.bfloat16 and torch.equal(got["p"], t["p"])
    j_save(str(tmp_path / "ref"), 1,
           {"p": jnp.asarray(vals.numpy(), jnp.bfloat16),
            "f": jnp.ones(2)})
    got, _ = load_checkpoint(str(tmp_path / "ref"), t)
    assert torch.equal(got["p"], t["p"]) and torch.equal(got["f"], t["f"])


# ------------------------------------------------------------- resume
RESUME = dict(task="image", n_clients=10, attendance=0.3, batch=8, width=4,
              cut=2, seed=3, eval_every=2)


@pytest.mark.parametrize("algo", ["cyclesfl", "cyclepsl"])
def test_resume_is_the_unbroken_run(algo, tmp_path):
    """Four rounds, stop, resume to six: bit for bit the port's unbroken
    six rounds (state, history, every round's metrics), and within the
    harness's tolerances of the reference's unbroken run."""
    cfg = config(algo=algo, rounds=6, **RESUME)
    jcfg = JConfig.from_dict(cfg.to_dict())
    jrec = Recorder()
    jeng = JEngine(jcfg, callbacks=[jrec], log=lambda *a: None)
    state0 = jax.device_get(jeng.init_state())
    jres = jeng.run(state=state0)
    plan = dict(plan_fn=reference_plan_fn(jeng.padded_capacity * cfg.batch))
    t0 = train_state_from_reference(state0)
    _, full, rec_f = run_port(cfg, state=t0, **plan)
    ck = str(tmp_path)
    _, part, rec_p = run_port(config(algo=algo, rounds=4, ckpt_dir=ck,
                                     **RESUME), state=t0, **plan)
    assert valid_steps(ck) == [2, 4]
    assert load_metadata(ck, 4) == {"algo": algo}
    _, res, rec = run_port(config(algo=algo, rounds=6, ckpt_dir=ck,
                                  resume=True, **RESUME), **plan)
    assert res["resumed_from_round"] == 4
    assert strip(res["history"]) == strip(full["history"])[-1:]
    assert rec_p.rows + rec.rows == rec_f.rows
    assert states_equal(rec.state, rec_f.state)
    assert_rows_close(jrec.rows[4:], rec.rows)
    assert_history_close(jres["history"][-1:], res["history"],
                         len(jeng.fed.test_arrays()[1]))
    assert res["telemetry"]["per_round"] == jres["telemetry"]["per_round"][4:]


def test_resume_from_a_reference_checkpoint(tmp_path):
    """The reference's Engine checkpoints at round 4; the port's Engine
    resumes from that step to round 6 and lands within tolerance of the
    reference's unbroken run."""
    cfg = config(rounds=6, **RESUME)
    jrec = Recorder()
    full = JEngine(JConfig.from_dict(cfg.to_dict()), callbacks=[jrec],
                   log=lambda *a: None)
    jres = full.run()
    ck = str(tmp_path)
    JEngine(JConfig.from_dict(config(rounds=4, ckpt_dir=ck, **RESUME
                                     ).to_dict()), log=lambda *a: None).run()
    _, res, rec = run_port(
        config(rounds=6, ckpt_dir=ck, resume=True, **RESUME),
        plan_fn=reference_plan_fn(full.padded_capacity * cfg.batch))
    assert res["resumed_from_round"] == 4
    assert_rows_close(jrec.rows[4:], rec.rows)
    assert_history_close(jres["history"][-1:], res["history"],
                         len(full.fed.test_arrays()[1]))


def test_a_torn_checkpoint_falls_back(tmp_path):
    """The fault stream tears some saves; resume restarts from the
    newest step it left whole, and the run still ends as the unbroken
    one does."""
    setup = port_setup()
    faults = ResilienceConfig(faults=FaultConfig(ckpt_rate=0.5))
    stream = FaultStream(faults.faults, 0)
    torn = [s for s in (1, 2, 3, 4) if stream.ckpt_corrupt(s)]
    whole = [s for s in (1, 2, 3, 4) if s not in torn]
    assert torn and whole and max(whole) < 4, (torn, whole)
    base = dict(eval_every=1, resilience=faults)
    _, full, rec_f = run_port(config(rounds=6, **base), setup)
    ck = str(tmp_path)
    _, part, _ = run_port(config(rounds=4, ckpt_dir=ck, **base), setup)
    assert part["resilience"]["ckpt_corruptions"] == len(torn)
    with pytest.warns(RuntimeWarning, match="corrupt"):
        _, res, rec = run_port(config(rounds=6, ckpt_dir=ck, resume=True,
                                      **base), setup)
    assert res["resumed_from_round"] == max(whole)
    assert states_equal(rec.state, rec_f.state)
    assert strip(res["history"]) == strip(full["history"])[max(whole):]


def test_launch_run_checkpoints(tmp_path):
    """``launch.train.run(ckpt_dir=...)`` saves at every evaluation."""
    from repro_torch.launch.train import run
    res = run("cyclesfl", rounds=4, n_clients=10, attendance=0.3, batch=8,
              width=4, eval_every=2, ckpt_dir=str(tmp_path), device="cpu",
              log=lambda *a: None)
    assert valid_steps(str(tmp_path)) == [2, 4]
    assert load_metadata(str(tmp_path), 4) == {"algo": "cyclesfl"}
    assert [h["round"] for h in res["history"]] == [2, 4]
