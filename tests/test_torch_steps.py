"""The port's step builders, held against ``repro.launch`` and
``repro.core.cyclesl`` on the CPU.

Two CycleSL rounds of the transformer split task on the olmoe-1b-7b and
gemma2-2b smoke configs: both packages start from one JAX init (server
and client weights carried across), take the same numpy token batches,
and the port runs the reference's resample plan, injected through
``plan_fn``.  The reference round is jitted once per config and shared
through a module-scoped fixture.

Tolerances: per-round metrics rtol 1e-4 (float32 sums in another order,
compounded over two rounds).  Params after the rounds: Adam's first
steps move a weight by about lr * sign(g), so a weight whose gradient
is tiny may move by a different fraction of lr; all but 0.1% of the
weights are held to 1e-6 and every weight to the 2 * lr * steps that
such steps can move it at most.  The router's top-k is a discontinuity:
one flipped expert choice would change a metric by far more than 1e-4,
so these tolerances also show that no choice flipped.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import INPUT_SHAPES as J_SHAPES
from repro.configs import smoke_config as j_smoke
from repro.core import cyclesl as jc
from repro.core import protocol as jp
from repro.core.feature_store import resample_plan as j_plan
from repro.core.split import make_transformer_task as j_make_task
from repro.launch import inputs as j_inputs
from repro.models.transformer import Transformer as JT
from repro.optim import adam as j_adam
from repro_torch.configs import INPUT_SHAPES, InputShape, smoke_config
from repro_torch.core.cyclesl import CycleConfig
from repro_torch.launch import inputs as t_inputs
from repro_torch.launch.steps import (build_prefill_step, build_step,
                                      build_train_step)
from repro_torch.utils.tree import tree_leaves
from repro_torch.utils.weights import entity_from_reference, to_torch

ARCHS = ["olmoe-1b-7b", "gemma2-2b"]
LR = 3e-4
C, ROUNDS = 2, 2
SHAPE = InputShape("train_smoke", 32, 4, "train")       # b = 2 per client
PREFILL = InputShape("prefill_smoke", 24, 2, "prefill")
# gemma2's smoke config has 2 layers and cuts after 2, which leaves the
# server no block; the rounds run it 4 deep so that the server holds a
# local and a global block
DEPTH = {"olmoe-1b-7b": 2, "gemma2-2b": 4}


def _assert_adam_close(j_tree, t_tree, steps):
    jl, tl = jax.tree.leaves(j_tree), tree_leaves(t_tree)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        d = np.abs(np.asarray(a, np.float32) - b.float().numpy())
        if not d.size:
            continue
        assert d.max() <= 2 * LR * steps + 1e-6, d.max()
        assert (d > 1e-6).mean() <= 1e-3, (d > 1e-6).mean()


@pytest.fixture(scope="module")
def rounds():
    """arch -> (JAX per-round metrics, JAX final state, port per-round
    metrics, port final state), two rounds from one carried init."""
    out = {}
    for arch in ARCHS:
        jcfg = j_smoke(arch).with_(n_layers=DEPTH[arch])
        tcfg = smoke_config(arch).with_(n_layers=DEPTH[arch])
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
                j_plan(jkeys[key], C * SHAPE.global_batch // C, epochs,
                       sb))), None

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
            ts, tcl, tm = bundle.fn(ts, tcl, t_inputs.to_device(xs, tcfg, "cpu"),
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
    """Server: 2 steps a round (pool of 4 rows, server batch 2); each
    client slot: 1 step a round."""
    _, (jserver, jclients), _, (ts, tcl) = rounds[arch]
    j_e, t_e, steps = ((jserver, ts, 2 * ROUNDS) if side == "server"
                       else (jclients, tcl, ROUNDS))
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


@pytest.mark.parametrize("arch", ARCHS + ["pixtral-12b"])
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
def test_input_specs_match_reference(arch, shape):
    jcfg, tcfg = j_smoke(arch), smoke_config(arch)
    jdt = {jnp.int32: torch.int32, jnp.float32: torch.float32,
           jnp.bfloat16: torch.bfloat16}
    if shape == "train_4k":
        want = j_inputs.train_batch_specs(jcfg, J_SHAPES[shape], 8)
        got = t_inputs.train_batch_specs(tcfg, INPUT_SHAPES[shape], 8)
    else:
        want = j_inputs.prefill_specs(jcfg, J_SHAPES[shape])
        got = t_inputs.prefill_specs(tcfg, INPUT_SHAPES[shape])
    wl = jax.tree.leaves(want)
    gl = [s for s in jax.tree.leaves(got, is_leaf=lambda x: isinstance(
        x, t_inputs.Spec))]
    assert len(wl) == len(gl)
    for w, g in zip(wl, gl):
        assert tuple(w.shape) == tuple(g.shape)
        assert jdt[w.dtype.type] == g.dtype


def test_train_batch_labels_are_next_tokens():
    cfg = smoke_config("olmoe-1b-7b")
    xs, ys = t_inputs.make_train_batch(cfg, SHAPE, C, 3)
    assert xs["tokens"].shape == ys.shape == (C, 2, SHAPE.seq_len)
    np.testing.assert_array_equal(xs["tokens"][..., 1:], ys[..., :-1])
    assert xs["tokens"].dtype == np.int32 and 0 <= xs["tokens"].min()
    assert xs["tokens"].max() < cfg.vocab
    xs2, _ = t_inputs.make_train_batch(cfg, SHAPE, C, 3)
    np.testing.assert_array_equal(xs["tokens"], xs2["tokens"])


def test_build_step_dispatch_and_unported_kinds():
    cfg = smoke_config("gemma2-2b")
    assert build_step(cfg, SHAPE, cohort=C, device="cpu").name == "train"
    assert build_step(cfg, PREFILL, device="cpu").name == "prefill"
    with pytest.raises(ValueError):
        build_step(cfg, SHAPE, device="cpu")
    with pytest.raises(NotImplementedError, match="serving"):
        build_step(cfg, INPUT_SHAPES["decode_32k"], device="cpu")
    with pytest.raises(ValueError):
        build_train_step(cfg, SHAPE, cohort=3, device="cpu")
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        build_prefill_step(cfg.with_(family="audio"), PREFILL, device="cpu")


def test_step_builders_run_on_the_card_unless_asked():
    """``device=None`` means the card; with none here they raise."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = smoke_config("olmoe-1b-7b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_train_step(cfg, SHAPE, cohort=C)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_prefill_step(cfg, PREFILL)
