"""Import hygiene of the port and the failure modes of chip_smoke.py.

The port imports torch and never JAX or anything of the JAX package;
its modules build no kernel at import time.  chip_smoke.py exits
non-zero and prints no result where there is no card, and where it
stands alone outside a checkout of the repository.
"""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
from torch_threads import one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]

_WALK = """
import importlib, json, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_port_imports_neither_jax_nor_the_reference():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", _WALK], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["bad"] == []
    for mod in ("repro_torch.api.engine", "repro_torch.core.cyclesl",
                "repro_torch.core.algorithms", "repro_torch.api.registry",
                "repro_torch.kernels.gather_loss", "repro_torch.launch.train",
                "repro_torch.utils.weights", "repro_torch.configs.registry",
                "repro_torch.configs.olmoe_1b_7b",
                "repro_torch.configs.gemma2_2b",
                "repro_torch.kernels.flash_attention",
                "repro_torch.kernels.topk_gating",
                "repro_torch.kernels.ssd_scan",
                "repro_torch.configs.mamba2_2p7b",
                "repro_torch.configs.zamba2_1p2b",
                "repro_torch.models.mamba2",
                "repro_torch.models.attention", "repro_torch.models.moe",
                "repro_torch.models.transformer", "repro_torch.core.split",
                "repro_torch.launch.inputs", "repro_torch.launch.steps",
                "repro_torch.optim.schedule", "repro_torch.models.lstm",
                "repro_torch.models.cnn", "repro_torch.data.synthetic",
                "repro_torch.api.tasks", "repro_torch.serve",
                "repro_torch.serve.config", "repro_torch.serve.runtime",
                "repro_torch.serve.loadgen", "repro_torch.launch.serve",
                "repro_torch.utils.device", "repro_torch.checkpoint.io",
                "repro_torch.scenario.profiles",
                "repro_torch.scenario.population",
                "repro_torch.resilience.config",
                "repro_torch.resilience.faults",
                "repro_torch.resilience.guards",
                "repro_torch.resilience.policy",
                "repro_torch.resilience.harness",
                "repro_torch.models.encdec",
                "repro_torch.configs.whisper_base",
                "repro_torch.sharding", "repro_torch.sharding.specs",
                "repro_torch.sharding.collectives",
                "repro_torch.sharding.parallel",
                "repro_torch.launch.mesh", "repro_torch.launch.meshcheck",
                "repro_torch.utils.profiling", "repro_torch.utils.cost",
                "repro_torch.launch.roofline", "repro_torch.launch.dryrun",
                "repro_torch.kernels._count"):
        assert mod in out["modules"]


def test_chip_smoke_imports_no_jax():
    src = (ROOT / "chip_smoke.py").read_text()
    for line in src.splitlines():
        s = line.strip()
        if s.startswith(("import ", "from ")):
            assert "jax" not in s and not s.split()[1].startswith("repro."), s


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_a_card_or_a_checkout(where, tmp_path):
    script = ROOT / "chip_smoke.py"
    if where == "alone":
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, str(script)], capture_output=True,
                          text=True, cwd=script.parent, env=env, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
