"""The port's round on a device mesh, on the CPU over gloo.

The reference's mesh path does not run in this JAX (its meshes build
Explicit axes, which ``with_sharding_constraint`` refuses), so the port's
mesh is held to the reference's own criteria against unsharded rounds
(``repro/launch/meshcheck.py``): a one-rank mesh is bit for bit the
port's unsharded round, an N-rank mesh agrees with it within 1e-5, and
the shard-local resample is bit for bit the gather-everything route.
The port's unsharded round is held to the reference's unsharded round
within rtol 1e-4, on the reference's initial state and resample plans
(carried in, as in ``tests/torch_parity.py``).

The protocol is meshcheck's (``mlp(8, [16], 4)`` cut 1, capacity 8,
batch 8, live sizes 5 + r % 3, 3 rounds, server epochs 2).  One world of
4 ranks and one of 2 are spawned (``tests/torch_mesh_ranks.py``), each
over a ``file://`` store under pytest's tmp dir, one thread a rank; the
world of 1 runs in this process.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import build_algorithm as j_build_algorithm
from repro.api import get_program as j_get_program
from repro.core.cyclesl import CycleConfig as JCycle
from repro.core.feature_store import FeatureStore as JStore
from repro.core.feature_store import gather_batch as j_gather_batch
from repro.core.feature_store import masked_resample_plan as j_masked_plan
from repro.kernels import ops as j_ops
from repro.launch import meshcheck as jm
from repro.optim import adam as j_adam
from repro_torch.api import Engine, ExperimentConfig, algorithm_names
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.meshcheck import (C, ROUNDS, drive, masks, max_diff,
                                          spawn_ranks, task_and_data)
from repro_torch.sharding.collectives import census_by_op
from repro_torch.utils.tree import tree_leaves
from repro_torch.utils.weights import train_state_from_reference

import torch_mesh_ranks as ranks

ALGOS = algorithm_names()
FUSED = "cyclesfl"
LR = 5e-3
ENGINE = dict(rounds=3, eval_every=3, n_clients=20, attendance=0.25,
              batch=8, width=4)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread in this process, as in every spawned rank: the
    port's small ops gain nothing from more, and beside the suite's other
    workers more threads only contend."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def carried():
    """The reference's unsharded runs, its initial states (as the port's
    TrainStates) and its per-round resample plans."""
    jtask, jxs, jys = jm._task_and_data()
    opt = j_adam(LR)
    runs, state0s = {}, {}
    for name in ALGOS:
        algo = j_build_algorithm(j_get_program(name), jtask, opt, opt,
                                 JCycle(server_epochs=2))
        state0s[name] = train_state_from_reference(
            jax.device_get(algo.init(jax.random.PRNGKey(0), n_clients=C)))
        state, rows, _ = jm._drive(name, jtask, jxs, jys)
        runs[name] = (jax.device_get(state), rows)
    plans = {}
    for r, m in enumerate(masks(ROUNDS)):
        valid = jnp.repeat(jnp.asarray(m.numpy()), 8)
        p, ok = j_masked_plan(jax.random.PRNGKey(r), valid, 2, 8)
        plans[r] = (torch.from_numpy(np.array(p)),
                    torch.from_numpy(np.array(ok)))
    return runs, state0s, ranks.FixedPlans(plans)


@pytest.fixture(scope="module")
def unsharded(carried):
    _, state0s, plans = carried
    task, xs, ys = task_and_data()
    out = {n: drive(n, task, xs, ys, state0=state0s[n], plan_fn=plans)
           for n in ALGOS}
    out["fused"] = drive(FUSED, task, xs, ys, state0=state0s[FUSED],
                         plan_fn=plans, fused=True)
    return out


@pytest.fixture(scope="module")
def one_rank(carried):
    _, state0s, plans = carried
    mesh = make_local_mesh("cpu")
    try:
        return ranks.protocol(mesh, state0s, plans, FUSED)
    finally:
        mesh.close()


POOL_T, POOL_K = 32, 7


def _pool():
    rng = np.random.default_rng(5)
    feats = rng.normal(size=(POOL_T, 3, 5)).astype(np.float32)
    labels = rng.integers(0, POOL_K, size=POOL_T).astype(np.int64)
    w = (rng.normal(size=(15, POOL_K)) * 0.3).astype(np.float32)
    cases = {"divisible": (rng.integers(0, POOL_T, 8), False),
             "ragged": (rng.integers(0, POOL_T, 6), False),
             "replicated": (rng.integers(0, POOL_T, 8), True),
             "fused": (rng.integers(0, POOL_T, 8), None)}
    return feats, labels, w, cases


@pytest.fixture(scope="module")
def world4(carried, tmp_path_factory):
    _, state0s, plans = carried
    feats, labels, w, cases = _pool()
    t_cases = {k: (torch.from_numpy(i.astype(np.int32)), rep)
               for k, (i, rep) in cases.items()}
    return spawn_ranks(4, ranks.protocol_and_gathers, (
        (state0s, plans, FUSED),
        (torch.from_numpy(feats), torch.from_numpy(labels), t_cases,
         torch.from_numpy(w))), workdir=tmp_path_factory.mktemp("w4"))


@pytest.fixture(scope="module")
def world2(carried, tmp_path_factory):
    _, state0s, plans = carried
    return spawn_ranks(2, ranks.protocol_and_engines, (
        (state0s, plans, FUSED),
        {a: {**ENGINE, "algo": a, "mesh_shape": (2, 1)} for a in ALGOS}),
        workdir=tmp_path_factory.mktemp("w2"))


def _assert_close_to_reference(jrun, run):
    """Metrics rtol 1e-4; weights within 1e-5 but for 0.1% of a leaf,
    each within the 2 * lr * steps Adam's near-sign steps can move it
    (``tests/torch_parity.py``); step counters equal."""
    jstate, jrows = jrun
    state, rows = run[0], run[1]
    for j, t in zip(jrows, rows):
        assert set(j) == set(t)
        for k in j:
            np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]),
                                       rtol=1e-4, atol=1e-6, err_msg=k)
    leaves = [np.asarray(a) for a in jax.tree.leaves(jstate)]
    steps = max(int(a.max()) for a in leaves if a.dtype == np.int32)
    for a, b in zip(leaves, tree_leaves(state)):
        if a.dtype == np.int32:
            np.testing.assert_array_equal(b.numpy(), a)
            continue
        d = np.abs(a.astype(np.float64) - b.double().numpy())
        assert d.max() <= 2 * LR * steps + 1e-6
        assert (d > 1e-5).sum() <= max(1, 1e-3 * d.size)


@pytest.mark.parametrize("algo", ALGOS)
def test_port_unsharded_matches_reference(algo, carried, unsharded):
    _assert_close_to_reference(carried[0][algo], unsharded[algo])


@pytest.mark.parametrize("algo", ALGOS)
def test_one_rank_mesh_is_bit_for_bit_unsharded(algo, unsharded, one_rank):
    for route, run in one_rank[algo].items():
        want = unsharded["fused" if route.startswith("fused") else algo]
        assert max_diff(want[0], want[1], run[0], run[1]) == 0.0, route


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("algo", ALGOS)
def test_n_rank_mesh_agrees_with_unsharded(algo, world, carried, unsharded,
                                           world2, world4):
    """Within 1e-5 of the port's unsharded round on every route (the
    fused loss too), within rtol 1e-4 of the reference's, and the same
    on every rank."""
    per_rank = [r["protocol"][algo] for r in (world2 if world == 2
                                              else world4)]
    for route, run in per_rank[0].items():
        want = unsharded["fused" if route.startswith("fused") else algo]
        assert max_diff(want[0], want[1], run[0], run[1]) <= 1e-5, route
        for other in per_rank[1:]:
            o = other[route]
            assert max_diff(run[0], run[1], o[0], o[1]) == 0.0, route
    _assert_close_to_reference(carried[0][algo], per_rank[0]["gather"])


@pytest.mark.parametrize("world", [1, 2, 4])
def test_shard_local_is_bit_for_bit_gather_everything(world, one_rank,
                                                      world2, world4):
    runs = (one_rank if world == 1 else
            (world2 if world == 2 else world4)[0]["protocol"])
    for name in ranks.CYCLE:
        g, l = runs[name]["gather"], runs[name]["local"]
        assert max_diff(g[0], g[1], l[0], l[1]) == 0.0, name
    # the fused loss reduces its partial sums over ranks: equal within
    # float32 rounding, bit for bit at one rank
    g, l = runs[FUSED]["fused_gather"], runs[FUSED]["fused_local"]
    assert max_diff(g[0], g[1], l[0], l[1]) <= (0.0 if world == 1 else 1e-6)


def test_census_shard_local_moves_no_pool(world4):
    """The gather-everything route all_gathers the pool once a round (one
    call for the float32 features, one for the int64 labels); the
    shard-local route never does and moves minibatches instead."""
    runs = world4[0]["protocol"]
    for name in ranks.CYCLE:
        if name == "cyclessl":          # whole on every rank: no census
            assert all(c == {} for c in runs[name]["local"][2])
            continue
        for census in runs[name]["gather"][2]:
            assert census["all_gather/pool"]["calls"] == 2
            assert not any(k.endswith("/minibatch") for k in census)
        for census in runs[name]["local"][2]:
            assert not any(k.endswith("/pool") for k in census)
            assert census["reduce_scatter/minibatch"]["calls"] > 0
    fused = runs[FUSED]["fused_local"][2][0]
    assert "all_reduce/loss" in fused and "all_reduce/head_grad" in fused
    assert not any(k.endswith("/pool") for k in fused)


def test_collectives_on_four_ranks(world4):
    """broadcast, the trees' one call per dtype in rank order, and the
    census's calls and bytes."""
    for r, out in enumerate(world4):
        bc, gathered, reduced, scattered, census = out["gathers"][
            "collectives"]
        assert torch.equal(bc, torch.arange(4.0) + 1)
        ints = torch.arange(6, dtype=torch.int64).reshape(2, 3)
        assert torch.equal(gathered[0], torch.cat([ints + 10 * q
                                                   for q in range(4)]))
        assert torch.equal(gathered[1], torch.cat(
            [torch.full((2, 2, 2), float(q)) for q in range(4)]))
        assert torch.equal(reduced[0], 4 * ints + 60)
        assert torch.equal(reduced[1], torch.full((2, 2, 2), 6.0))
        assert torch.equal(scattered[0], torch.full((2, 3), 10.0))
        assert census == {
            "broadcast/test": {"calls": 1, "bytes": 16},
            "all_gather/test": {"calls": 2, "bytes": 48 + 32},
            "all_reduce/test": {"calls": 2, "bytes": 48 + 32},
            "reduce_scatter/test": {"calls": 1, "bytes": 96}}


@pytest.mark.parametrize("case", ["divisible", "ragged", "replicated"])
def test_shard_local_gather_matches_reference_gather(case, world4):
    """Reduce-scattered rows (M divides the ranks) concatenate to the
    reference's gather; otherwise every rank holds all of it."""
    feats, labels, _, cases = _pool()
    idx, rep = cases[case]
    jf, jy = j_gather_batch(JStore(jnp.asarray(feats), jnp.asarray(labels)),
                            jnp.asarray(idx, jnp.int32))
    outs = [r["gathers"][case] for r in world4]
    scatter = case == "divisible"
    if scatter:
        f = torch.cat([o[0] for o in outs])
        y = torch.cat([o[1] for o in outs])
    else:
        f, y = outs[0]
        for o in outs[1:]:
            assert torch.equal(o[0], f) and torch.equal(o[1], y)
    np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    census = census_by_op(world4[0]["gathers"][case + "/census"])
    assert set(census) == {"reduce_scatter" if scatter else "all_reduce"}


def test_shard_local_fused_loss_matches_reference(world4):
    feats, labels, w, cases = _pool()
    idx = jnp.asarray(cases["fused"][0], jnp.int32)
    jloss, jdw = jax.value_and_grad(
        lambda ww: j_ops.fused_gather_loss_mean(
            jnp.asarray(feats), jnp.asarray(labels), idx, ww))(
        jnp.asarray(w))
    for r in world4:
        loss, dw = r["gathers"]["fused"]
        np.testing.assert_allclose(loss.numpy(), np.asarray(jloss),
                                   rtol=1e-5)
        np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), rtol=1e-4,
                                   atol=1e-6)
        assert torch.equal(dw, world4[0]["gathers"]["fused"][1])


@pytest.mark.parametrize("algo", ALGOS)
def test_engine_on_a_two_rank_mesh_matches_unsharded(algo, world2):
    """Each program's Engine at mesh (2, 1): its capacity 5 aligned to 6
    (the extra slot dead), within 1e-5 of the unsharded Engine, the same
    on both ranks."""
    rows, final = [], []

    class Rec:
        def on_round(self, eng, rnd, state, metrics):
            rows.append({k: v.detach() for k, v in metrics.items()})
            final[:] = [state]

    eng = Engine(ExperimentConfig(**{**ENGINE, "algo": algo}), device="cpu",
                 callbacks=[Rec()], log=lambda *a: None)
    hist = eng.run()["history"]
    assert eng.padded_capacity == 5
    got = [r["engine"][algo] for r in world2]
    assert [g[3] for g in got] == [6, 6]
    assert max_diff(final[0], rows, got[0][0], got[0][1]) <= 1e-5
    assert max_diff(got[0][0], got[0][1], got[1][0], got[1][1]) == 0.0
    strip = lambda h: [{k: v for k, v in e.items() if k != "elapsed_s"}
                       for e in h]
    assert strip(got[0][2]) == strip(got[1][2])
    for a, b in zip(strip(hist), strip(got[0][2])):
        assert a.keys() == b.keys() and a["round"] == b["round"]
        np.testing.assert_allclose(b["test_loss"], a["test_loss"],
                                   rtol=1e-5)
