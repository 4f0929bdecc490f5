"""The dry run (``repro_torch.launch.dryrun``): a step traced on ``meta``
as rank 0 of a mesh over torch's fake process group.

Its state bytes are the CPU-initialized state's on (1, 1) and rank 0's
``shard_plan`` blocks on (2, 2); ``count`` on meta is ``count`` on the
CPU; the fake group's census on (1, 2) is a real gloo (1, 2) round's;
the CLI runs over one whole arch and the roofline reads its records;
the train step runs as its bundle donates, which lowers the peak by at
least the server entity's params and moments and leaves the state, the
FLOPs and the collective bytes as they were.
"""
import json
import math

import pytest
import torch

import torch_dryrun_ranks as ranks
from repro_torch.configs import InputShape, smoke_config
from repro_torch.core.cyclesl import CycleConfig
from repro_torch.core.split import make_transformer_task
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.dryrun import dry_run, state_bytes, step_args
from repro_torch.launch.meshcheck import spawn_ranks
from repro_torch.launch.steps import build_train_step
from repro_torch.models.module import SHAPES
from repro_torch.sharding.specs import shard_plan
from repro_torch.utils.cost import count
from repro_torch.utils.tree import tree_leaves
from torch_threads import one_thread  # noqa: F401

SHAPE = InputShape("train_smoke", 32, 4, "train")        # b = 2 a client
CYCLE = CycleConfig(server_epochs=1, server_batch=2)
C = 2


@pytest.fixture(autouse=True)
def no_group_left():
    """End the fake group a dry run on a mesh starts, so no later test in
    this worker finds it."""
    yield
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "zamba2-1.2b"])
def test_state_bytes_on_one_card_are_the_cpu_state(arch):
    cfg = smoke_config(arch)
    rec = dry_run(cfg, SHAPE, (1, 1), cohort=C, cycle=CYCLE)
    bundle = build_train_step(cfg, SHAPE, CYCLE, cohort=C, device="cpu")
    want = sum(t.numel() * t.element_size()
               for t in tree_leaves(bundle.init_state(0)))
    assert rec["state_bytes"] == want
    assert rec["census"] == {} and rec["fits"]
    assert rec["peak_bytes"] > want


def _block_bytes(params, plan, data: bool) -> int:
    """Bytes of a rank's blocks of ``params`` (whole shapes) under
    ``plan``: a leaf's ``model`` cut, and its ``data`` cut with
    ``data``."""
    total = 0
    for x, s in zip(tree_leaves(params), tree_leaves(plan)):
        shape = list(x.shape)
        if s.dim is not None:
            shape[s.dim] = s.hi - s.lo
        if data and s.ddim is not None:
            shape[s.ddim] = s.dhi - s.dlo
        total += math.prod(shape) * x.element_size()
    return total


def _entity_bytes(params_bytes: int, params_f32_bytes: int, n: int) -> int:
    """n entities of one param tree: its params, Adam's float32 m and v,
    an int32 step each."""
    return n * (params_bytes + 2 * params_f32_bytes + 4)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "zamba2-1.2b"])
def test_state_bytes_on_2x2_are_rank_0s_shard_plan_blocks(arch):
    cfg = smoke_config(arch).with_(dtype="bfloat16")
    rec = dry_run(cfg, SHAPE, (2, 2), cohort=C, cycle=CYCLE)
    sizes, coords = {"data": 2, "model": 2}, {"data": 0, "model": 0}
    task = make_transformer_task(cfg)
    server, client = task.init_server(SHAPES), task.init_client(SHAPES)
    s_plan = shard_plan(server, sizes, coords, "server", cfg)
    c_plan = shard_plan(client, sizes, coords, "full", cfg)
    f32 = lambda tree: [t.to(torch.float32) for t in tree_leaves(tree)]
    want = (_entity_bytes(_block_bytes(server, s_plan, True),
                          _block_bytes(f32(server), s_plan, True), 1)
            + _entity_bytes(_block_bytes(client, c_plan, False),
                            _block_bytes(f32(client), c_plan, False),
                            C // 2))
    assert rec["state_bytes"] == want
    # FSDP over data and the model axis both moved bytes
    assert any(k.startswith("model/") for k in rec["census"])
    assert "all_gather/weights" in rec["census"]


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "zamba2-1.2b"])
def test_count_on_meta_is_count_on_the_cpu(arch):
    cfg = smoke_config(arch)
    got = {}
    for dev in ("cpu", "meta"):
        bundle = build_train_step(cfg, SHAPE, CYCLE, cohort=C, device=dev)
        args = step_args(bundle, "train")
        got[dev] = (count(bundle.fn, *args), state_bytes(args, "train"))
    (cpu, cpu_state), (meta, meta_state) = got["cpu"], got["meta"]
    assert cpu_state == meta_state
    assert cpu.flops == meta.flops and cpu.flops > 0
    assert cpu.traffic_bytes == meta.traffic_bytes
    assert cpu.by_op == meta.by_op
    assert cpu.kernel_calls() == meta.kernel_calls()
    assert cpu.peak_bytes == meta.peak_bytes


def test_fake_group_census_is_a_gloo_rounds_census():
    cfg = smoke_config("olmoe-1b-7b")
    want = spawn_ranks(2, ranks.train_census, (cfg, SHAPE, CYCLE, C), "cpu",
                       shape=(1, 2))
    rec = dry_run(cfg, SHAPE, (1, 2), cohort=C, cycle=CYCLE)
    assert rec["census"] == want[0]
    assert rec["cost"]["collective_bytes"] == sum(
        r["bytes"] for r in want[0].values()) > 0


def test_the_cli_runs_one_whole_arch_and_the_roofline_reads_it(tmp_path,
                                                              capsys):
    out = tmp_path / "dryrun.json"
    assert dryrun.main(["--arch", "whisper-base", "--mesh-shape", "1,1",
                        "--out", str(out)]) == 0
    recs = json.loads(out.read_text())
    assert [r["status"] for r in recs] == ["ok", "ok", "ok", "skipped"]
    assert all(r["state_bytes"] > 0 and r["cost"]["flops"] > 0
               for r in recs if r["status"] == "ok")
    assert roofline.main(["--in", str(out), "--out",
                          str(tmp_path / "roofline.json"), "--md"]) == 0
    rows = json.loads((tmp_path / "roofline.json").read_text())
    assert {r["dominant"] for r in rows if r["status"] == "ok"} <= {
        "compute", "memory", "collective"}
    assert "| whisper-base | train_4k | 1x1 |" in capsys.readouterr().out


@pytest.mark.parametrize("arch,mesh", [("olmoe-1b-7b", None),
                                       ("zamba2-1.2b", None),
                                       ("glm4-9b", (2, 2))])
def test_a_donated_step_peaks_lower_by_the_server_entity(arch, mesh):
    cfg = smoke_config(arch)
    donated = dry_run(cfg, SHAPE, mesh, cohort=C, cycle=CYCLE)
    kept = dry_run(cfg, SHAPE, mesh, cohort=C, cycle=CYCLE, donate=False)
    bundle = build_train_step(cfg, SHAPE, CYCLE, cohort=C, device="meta")
    assert bundle.donate == (0, 1)
    server, _ = bundle.init_state(0)
    entity = sum(t.numel() * t.element_size()
                 for t in tree_leaves((server.params, server.opt_state)))
    if mesh is not None:      # a quarter: no more than rank 0's blocks
        entity = sum(t.numel() * t.element_size() for t in tree_leaves(
            (server.params, server.opt_state))) // 4
    assert donated["state_bytes"] == kept["state_bytes"]
    assert kept["peak_bytes"] - donated["peak_bytes"] >= entity > 0
    for k in ("flops", "collective_bytes", "by_kernel"):
        assert donated["cost"][k] == kept["cost"][k], k
    assert donated["census"] == kept["census"]
