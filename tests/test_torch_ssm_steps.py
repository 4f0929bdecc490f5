"""The port's step builders on the SSM family, held against
``repro.launch`` and ``repro.core.cyclesl`` on the CPU.

Two CycleSL rounds of the transformer split task on the mamba2-2.7b
(attention-free, 2 blocks cut after 1) and zamba2-1.2b (4 mamba2 blocks
cut after 1, the shared attention after block 1 on the server) smoke
configs, and the prefill step of each.  Both packages start from one JAX
init (server and client weights carried across), take the same numpy
token batches, and the port runs the reference's resample plan,
injected through ``plan_fn``.  The sequence is 64 positions, two SSD
chunks of the smoke configs' 32, so the state carries between chunks in
every block forward and in the scan's chunked backward.  The reference
round is jitted once per config and shared through a module-scoped
fixture.

Tolerances, as tests/test_torch_steps.py: per-round metrics rtol 1e-4
(float32 sums in another order, compounded over two rounds); params
after the rounds all but 0.1% within 1e-6 and every one within the
2 * lr * steps that Adam's near-sign first steps can move a weight.
The 0.1% is a share of the whole tree, where tests/test_torch_steps.py
takes it per leaf: these trees hold 256-element leaves (norm scales),
in which one weight past 1e-6 is already 0.4% of the leaf.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.core import cyclesl as jc
from repro.core import protocol as jp
from repro.core.feature_store import resample_plan as j_plan
from repro.core.split import make_transformer_task as j_make_task
from repro.models.transformer import Transformer as JT
from repro.optim import adam as j_adam
from repro_torch.configs import InputShape, smoke_config
from repro_torch.core.cyclesl import CycleConfig
from repro_torch.launch import inputs as t_inputs
from repro_torch.launch.steps import build_prefill_step, build_train_step
from repro_torch.utils.tree import tree_leaves
from repro_torch.utils.weights import entity_from_reference, to_torch
from torch_threads import one_thread  # noqa: F401

ARCHS = ["mamba2-2.7b", "zamba2-1.2b"]
LR = 3e-4
C, ROUNDS = 2, 2
SHAPE = InputShape("train_smoke", 64, 4, "train")       # b = 2 per client
PREFILL = InputShape("prefill_smoke", 64, 2, "prefill")


def _assert_adam_close(j_tree, t_tree, steps):
    jl, tl = jax.tree.leaves(j_tree), tree_leaves(t_tree)
    assert len(jl) == len(tl)
    over = total = 0
    for a, b in zip(jl, tl):
        d = np.abs(np.asarray(a, np.float32) - b.float().numpy())
        if not d.size:
            continue
        assert d.max() <= 2 * LR * steps + 1e-6, d.max()
        over, total = over + int((d > 1e-6).sum()), total + d.size
    assert over <= 1e-3 * total, (over, total)


@pytest.fixture(scope="module")
def rounds():
    """arch -> (JAX per-round metrics, JAX final state, port per-round
    metrics, port final state), two rounds from one carried init."""
    out = {}
    for arch in ARCHS:
        jcfg, tcfg = j_smoke(arch), smoke_config(arch)
        jtask, jopt = j_make_task(jcfg), j_adam(LR)
        jserver = jp.init_entity(jtask.init_server(jax.random.PRNGKey(0)),
                                 jopt)
        jclients = jp.broadcast_entity(
            jp.init_entity(jtask.init_client(jax.random.PRNGKey(1)), jopt), C)
        jkeys = [jax.random.PRNGKey(10 + r) for r in range(ROUNDS)]
        step = jax.jit(lambda s, c, xs, ys, key: jc.cyclesl_round(
            jtask, s, c, jopt, jopt, xs, ys, key, jc.CycleConfig()))

        def plan_fn(key, valid, epochs, sb):
            assert valid is None
            return torch.from_numpy(np.array(
                j_plan(jkeys[key], SHAPE.global_batch, epochs, sb))), None

        bundle = build_train_step(tcfg, SHAPE, CycleConfig(),
                                  cohort=C, device="cpu", plan_fn=plan_fn)
        ts = entity_from_reference(jax.device_get(jserver))
        tcl = entity_from_reference(jax.device_get(jclients))
        jm_all, tm_all = [], []
        for r in range(ROUNDS):
            xs, ys = t_inputs.make_train_batch(tcfg, SHAPE, C, r)
            jserver, jclients, jm = step(
                jserver, jclients, {"tokens": jnp.asarray(xs["tokens"])},
                jnp.asarray(ys), jkeys[r])
            ts, tcl, tm = bundle.fn(ts, tcl,
                                    t_inputs.to_device(xs, tcfg, "cpu"),
                                    torch.from_numpy(ys), r)
            jm_all.append({k: float(v) for k, v in jm.items()})
            tm_all.append({k: float(v) for k, v in tm.items()})
        out[arch] = (jm_all, jax.device_get((jserver, jclients)), tm_all,
                     (ts, tcl))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_cyclesl_round_metrics_match_reference(rounds, arch):
    jm_all, _, tm_all, _ = rounds[arch]
    for jm, tm in zip(jm_all, tm_all):
        assert set(jm) == set(tm)
        for k in jm:
            assert np.isfinite(tm[k])
            np.testing.assert_allclose(tm[k], jm[k], rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("side", ["server", "clients"])
def test_cyclesl_round_params_match_reference(rounds, arch, side):
    """Server: 2 steps a round (pool of 4 rows, server batch 2), its
    tree holding zamba2's shared attention block; each client slot: 1
    step a round."""
    _, (jserver, jclients), _, (ts, tcl) = rounds[arch]
    j_e, t_e, steps = ((jserver, ts, 2 * ROUNDS) if side == "server"
                       else (jclients, tcl, ROUNDS))
    assert ("shared_attn" in t_e.params) == (
        side == "server" and arch == "zamba2-1.2b")
    np.testing.assert_array_equal(t_e.step.numpy(), np.asarray(j_e.step))
    assert int(np.asarray(j_e.step).reshape(-1)[0]) == steps
    _assert_adam_close(j_e.params, t_e.params, steps)
    _assert_adam_close(j_e.opt_state, t_e.opt_state, steps)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_step_matches_reference(arch):
    """Last-position logits of the full forward, in bfloat16 on both
    sides (one bf16 rounding apart at most: rtol 8e-3)."""
    jcfg = j_smoke(arch)
    jparams = jax.device_get(JT.init(jax.random.PRNGKey(2), jcfg))
    bundle = build_prefill_step(smoke_config(arch), PREFILL, device="cpu")
    (batch,) = bundle.make_batch(5)
    jlog, _ = JT.forward(jparams, jcfg, jnp.asarray(batch["tokens"].numpy()))
    want = np.asarray(jlog[:, -1].astype(jnp.bfloat16), np.float32)
    got = bundle.fn(to_torch(jparams), batch)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (
        PREFILL.global_batch, jcfg.vocab)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=8e-3,
                               atol=1e-3)
