"""The port's other dense, MoE and VLM configs, held against
``repro.models`` and ``repro.core.cyclesl`` on the CPU.

glm4-9b, phi3-mini-3.8b (dense, GQA or MHA), moonshot-v1-16b-a3b (MoE
with a shared expert), grok-1-314b (MoE) and pixtral-12b (vlm, patch
embeddings in place of the first token positions), each at its smoke
size (2 layers, cut after 1): the full forward and loss from one
carried JAX init, and two CycleSL rounds of the transformer split task
from one carried init with the reference's resample plan injected.
olmoe-1b-7b and gemma2-2b are held the same way, and in more detail, by
``test_torch_transformer.py`` and ``test_torch_steps.py``.

Tolerances as there: float32 on both sides, sums in another order.
Logits atol 1e-5, losses rtol 1e-5; per-round metrics rtol 1e-4; params
after the rounds all but 0.1% within 1e-6 and every one within the
2 * lr * steps that Adam's near-sign first steps can move it.
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
from repro_torch.models.transformer import Transformer
from repro_torch.utils.tree import tree_leaves
from repro_torch.utils.weights import entity_from_reference, to_torch

ARCHS = ["glm4-9b", "phi3-mini-3.8b", "moonshot-v1-16b-a3b", "grok-1-314b",
         "pixtral-12b"]
LR = 3e-4
C, ROUNDS = 2, 2
SHAPE = InputShape("train_smoke", 32, 4, "train")       # b = 2 per client
PREFILL = InputShape("prefill_smoke", 24, 2, "prefill")


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_reference(arch):
    """Logits and MoE aux of ``Transformer.forward`` and the loss of
    ``loss_fn``; pixtral's first positions come from patch embeddings."""
    jcfg, tcfg = j_smoke(arch), smoke_config(arch)
    jparams = jax.device_get(JT.init(jax.random.PRNGKey(3), jcfg))
    tparams = to_torch(jparams)
    (batch,) = build_prefill_step(tcfg, PREFILL, device="cpu").make_batch(7)
    assert ("patch_embeds" in batch) == (arch == "pixtral-12b")
    jb = _jax_batch({k: v.numpy() for k, v in batch.items()})
    patch = batch.get("patch_embeds")
    jlog, jmet = JT.forward(jparams, jcfg, jb["tokens"], jb.get("patch_embeds"))
    with torch.no_grad():
        tlog, tmet = Transformer.forward(tparams, tcfg, batch["tokens"], patch)
    assert tuple(tlog.shape) == jlog.shape
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-5)
    assert set(tmet) == set(jmet)
    for k in tmet:
        np.testing.assert_allclose(np.asarray(tmet[k], np.float32),
                                   np.asarray(jmet[k]), rtol=1e-5, atol=1e-7)
    labels = np.roll(batch["tokens"].numpy(), -1, axis=1)
    jl_, _ = JT.loss_fn(jparams, jcfg, jb["tokens"], jnp.asarray(labels),
                        jb.get("patch_embeds"))
    with torch.no_grad():
        tl_, _ = Transformer.loss_fn(tparams, tcfg, batch["tokens"],
                                     torch.from_numpy(labels), patch)
    np.testing.assert_allclose(float(tl_), float(jl_), rtol=1e-5)


@pytest.fixture(scope="module")
def rounds():
    """arch -> (JAX per-round metrics, JAX final state, port per-round
    metrics, port final state), two rounds from one carried init; run
    for an arch the first time a test asks for it."""
    cache = {}

    def run(arch):
        if arch in cache:
            return cache[arch]
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

        bundle = build_train_step(tcfg, SHAPE, CycleConfig(), cohort=C,
                                  device="cpu", plan_fn=plan_fn)
        ts = entity_from_reference(jax.device_get(jserver))
        tcl = entity_from_reference(jax.device_get(jclients))
        jm_all, tm_all = [], []
        for r in range(ROUNDS):
            xs, ys = t_inputs.make_train_batch(tcfg, SHAPE, C, r)
            assert ("patch_embeds" in xs) == (arch == "pixtral-12b")
            jserver, jclients, jm = step(jserver, jclients, _jax_batch(xs),
                                         jnp.asarray(ys), jkeys[r])
            ts, tcl, tm = bundle.fn(ts, tcl,
                                    t_inputs.to_device(xs, tcfg, "cpu"),
                                    torch.from_numpy(ys), r)
            jm_all.append({k: float(v) for k, v in jm.items()})
            tm_all.append({k: float(v) for k, v in tm.items()})
        cache[arch] = (jm_all, jax.device_get((jserver, jclients)), tm_all,
                       (ts, tcl))
        return cache[arch]

    return run


@pytest.mark.parametrize("arch", ARCHS)
def test_cyclesl_round_metrics_match_reference(rounds, arch):
    jm_all, _, tm_all, _ = rounds(arch)
    for jm, tm in zip(jm_all, tm_all):
        assert set(jm) == set(tm)
        for k in jm:
            assert np.isfinite(tm[k])
            np.testing.assert_allclose(tm[k], jm[k], rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_cyclesl_round_params_match_reference(rounds, arch):
    """Server: 2 steps a round (pool of 4 rows, server batch 2); each
    client slot: 1 step a round."""
    _, (jserver, jclients), _, (ts, tcl) = rounds(arch)
    for j_e, t_e, steps in ((jserver, ts, 2 * ROUNDS),
                            (jclients, tcl, ROUNDS)):
        np.testing.assert_array_equal(t_e.step.numpy(), np.asarray(j_e.step))
        assert int(np.asarray(j_e.step).reshape(-1)[0]) == steps
        for j_tree, t_tree in ((j_e.params, t_e.params),
                               (j_e.opt_state, t_e.opt_state)):
            jl, tl = jax.tree.leaves(j_tree), tree_leaves(t_tree)
            assert len(jl) == len(tl)
            for a, b in zip(jl, tl):
                d = np.abs(np.asarray(a, np.float32) - b.float().numpy())
                if not d.size:
                    continue
                assert d.max() <= 2 * LR * steps + 1e-6, d.max()
                assert (d > 1e-6).mean() <= 1e-3, (d > 1e-6).mean()
