"""``python -m repro_torch.launch.meshcheck`` on the CPU: the checker's
own ranks over gloo, its exit code and its JSON report.

World 4 holds every program's one-rank mesh bit for bit to the unsharded
round and its 4-rank mesh within 1e-5.  (``--shard-local`` checks what
``tests/test_torch_mesh.py`` holds already: the two resample routes bit
for bit.)
"""
import json
import os
import subprocess
import sys
from pathlib import Path
from torch_threads import one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


def _meshcheck(*flags):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.meshcheck", "--device",
         "cpu", *flags], capture_output=True, text=True, env=env,
        timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    return json.loads(proc.stdout)


def test_meshcheck_cli_passes_on_the_cpu():
    report = _meshcheck("--ranks", "4")
    assert report["ok"] and report["device"] == "cpu"
    algos = report["algos"]
    assert len(algos) == 10
    for name, rec in algos.items():
        assert rec["ok"] and rec["same_on_every_rank"], name
        assert rec["exact_1dev_diff"] == 0.0
        assert rec["ndev_diff"] <= 1e-5


def test_meshcheck_defaults_to_the_card(monkeypatch, capsys):
    """Without ``--device`` the checker asks for one card a rank and,
    with too few, exits 2 before any rank starts: the CPU runs only when
    asked."""
    import torch
    from repro_torch.launch import meshcheck
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert meshcheck.main(["--ranks", "2"]) == 2
    assert json.loads(capsys.readouterr().out) == {
        "error": "needs 2 cards, have 0"}
