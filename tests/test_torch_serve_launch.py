"""The port's serving entry points on the CPU.

``python -m repro_torch.launch.serve`` batched and ``--continuous``,
``launch.steps.build_step`` for a decode shape (held against the JAX
package's ``decode_step`` with the weights carried across, float32,
rtol 1e-4 / atol 1e-5), the ``serve`` field of ``ExperimentConfig``
against the JAX package's dict, whisper's ``serve_whisper`` and the
audio branch of ``main`` against the JAX package's, and the doors that
stay shut: the continuous runtime for audio, a mesh, and the card where
there is none.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api.config import ExperimentConfig as JConfig
from repro.configs import smoke_config as j_smoke
from repro.models.transformer import Transformer as JT
from repro.serve import ServeConfig as JServeConfig
from repro_torch.api import ExperimentConfig
from repro_torch.configs import InputShape, smoke_config
from repro_torch.launch import serve as serve_mod
from repro_torch.launch.steps import build_step
from repro_torch.serve import ServeConfig, ServeRuntime
from repro_torch.utils.weights import to_torch
from torch_threads import one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("arch", ["gemma2-2b", "olmoe-1b-7b",
                                  "zamba2-1.2b"])
def test_batched_serve_on_the_cpu(arch):
    res = serve_mod.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                          "--prompt-len", "4", "--steps", "3"])
    assert res["batch"] == 2 and res["decode_s_per_token"] > 0.0
    res = serve_mod.serve_decoder_only(smoke_config(arch), batch=2,
                                       prompt_len=4, steps=3, device="cpu")
    toks = res["tokens"]
    assert toks.shape == (2, 3) and toks.dtype == torch.int32
    assert bool(((toks >= 0) & (toks < smoke_config(arch).vocab)).all())


def test_serve_edges_steps_and_prompt_zero():
    cfg = smoke_config("gemma2-2b")
    res = serve_mod.serve_decoder_only(cfg, batch=2, prompt_len=0, steps=0,
                                       device="cpu")
    assert res["tokens"].shape == (2, 0)
    assert res["decode_s_per_token"] == 0.0
    res = serve_mod.serve_decoder_only(cfg, batch=2, prompt_len=3, steps=0,
                                       device="cpu")
    assert res["tokens"].shape == (2, 0)
    with pytest.raises(ValueError):
        serve_mod.serve_decoder_only(cfg, batch=2, prompt_len=-1, steps=1,
                                     device="cpu")
    with pytest.raises(ValueError):
        serve_mod.serve_decoder_only(cfg, batch=0, prompt_len=1, steps=1,
                                     device="cpu")


def test_continuous_serve_cli_on_the_cpu():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--continuous",
         "--device", "cpu", "--arch", "olmoe-1b-7b", "--concurrency", "3",
         "--requests", "5", "--serve-slots", "4", "--serve-max-prompt-len",
         "4", "--serve-max-new-tokens", "3", "--serve-prefill-batch", "2"],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = proc.stdout
    assert "arch=olmoe-1b-7b continuous serve:" in out
    assert "'done': 5" in out
    assert "traces: {'prefill': 1, 'admit': 1, 'decode': 1}" in out


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "zamba2-1.2b"])
def test_build_decode_step_matches_reference(arch):
    """``build_step`` for a decode shape: its state, its token batch and
    one step against the reference's ``decode_step`` on the carried
    weights."""
    cfg, jcfg = smoke_config(arch), j_smoke(arch)
    shape = InputShape("decode_32", 32, 2, "decode")
    bundle = build_step(cfg, shape, device="cpu")
    assert bundle.name == "decode"
    params, state = bundle.init_state(0)
    (tok,) = bundle.make_batch(0)
    assert tok.shape == (2, 1) and tok.dtype == torch.int32
    jp = jax.device_get(JT.init(jax.random.PRNGKey(0), jcfg))
    jstate = JT.init_decode_state(jcfg, 2, 32)
    jstep = jax.jit(lambda p, t, s: JT.decode_step(p, jcfg, t, s))
    for t in range(3):
        want, jstate = jstep(jp, jnp.asarray(tok.numpy()), jstate)
        got, state = bundle.fn(to_torch(jp), tok, state)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-5)
        tok = torch.argmax(got[:, -1:], dim=-1).to(torch.int32)
    assert int(state["pos"]) == 3


@pytest.mark.parametrize("serve", [
    {}, {"slots": 16, "deadline_s": 2.5, "max_retries": 1},
    {"max_prompt_len": 64, "max_new_tokens": 64, "prefill_batch": 8,
     "backoff_base_s": 0.25}], ids=["default", "deadlines", "budgets"])
def test_experiment_config_serve_round_trips_reference_dict(serve):
    jd = JConfig(serve=JServeConfig(**serve)).to_dict()
    cfg = ExperimentConfig.from_dict(jd).validate()
    assert isinstance(cfg.serve, ServeConfig)
    assert cfg.to_dict() == jd
    assert ExperimentConfig(serve=ServeConfig(**serve)).to_dict() == jd


def test_serve_flags_reach_the_config():
    import argparse
    ap = ExperimentConfig.add_arguments(argparse.ArgumentParser())
    args = ap.parse_args(["--serve-slots", "6", "--serve-prefill-batch",
                          "3", "--serve-deadline-s", "9"])
    cfg = ExperimentConfig.from_flags(args)
    assert cfg.serve == ServeConfig(slots=6, prefill_batch=3, deadline_s=9.0)
    with pytest.raises(ValueError):
        ExperimentConfig.from_flags(ap.parse_args(
            ["--serve-slots", "2", "--serve-prefill-batch", "3"]))


def test_whisper_and_audio_decode_raise():
    """The audio doors now open: ``serve_whisper`` with the JAX package's
    weights and frames gives its tokens, ``main --arch whisper-base``
    serves the smoke config, and the audio decode step builds.  The
    continuous runtime still refuses audio, as in the JAX package."""
    from repro.configs import smoke_config as jsmoke
    from repro.launch.serve import serve_whisper as j_serve_whisper
    from repro.models.encdec import EncDec as JE
    jcfg = jsmoke("whisper-base")
    want = j_serve_whisper(jcfg, batch=2, steps=3)
    frames = jax.random.normal(jax.random.PRNGKey(1),
                               (2, 60, jcfg.enc_d_model), jnp.float32) * 0.1
    got = serve_mod.serve_whisper(
        smoke_config("whisper-base"), batch=2, steps=3, device="cpu",
        params=to_torch(jax.device_get(JE.init(jax.random.PRNGKey(0), jcfg))),
        frames=torch.from_numpy(np.asarray(frames)))
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))
    res = serve_mod.main(["--arch", "whisper-base", "--device", "cpu",
                          "--batch", "2", "--steps", "3"])
    assert res["batch"] == 2 and res["decode_s_per_token"] > 0.0
    with pytest.raises(SystemExit):
        serve_mod.main(["--arch", "whisper-base", "--device", "cpu",
                        "--continuous"])
    audio = smoke_config("whisper-base")
    assert build_step(audio, InputShape("decode_32", 32, 2, "decode"),
                      device="cpu").name == "decode"
    with pytest.raises(ValueError, match="decoder-only"):
        ServeRuntime(audio, ServeConfig(), device="cpu")


def test_entry_points_refuse_the_cpu_unless_asked():
    """With no card, every serving entry point's default device raises;
    none drops to the CPU on its own."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    cfg = smoke_config("gemma2-2b")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeRuntime(cfg, ServeConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_mod.serve_decoder_only(cfg, batch=1, prompt_len=1, steps=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_step(cfg, InputShape("decode_32", 32, 2, "decode"))
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_mod.main(["--continuous"])
