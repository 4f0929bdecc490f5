"""Split-serving driver: batched decode with the composed model.

Port of ``repro/launch/serve.py``.  It runs on the card (``--device
cuda``, the default) and raises where there is none; ``--device cpu``
runs it on the CPU, with a smoke-sized arch by default (``--full`` for
the published widths).  It prefills a prompt batch, then steps the
KV/SSM cache token by token; for whisper (``serve_whisper``) it encodes
60 frames once and decodes from token 0.  The prompt is drawn from numpy
(``default_rng(1)``) and the weights from a ``torch.Generator`` seeded
with ``seed``, where the JAX package draws both from its PRNG: the two
packages serve other prompts and weights from the same seeds.

``--continuous`` switches decoder-only archs to the production path:
the fixed-slot continuous-batching runtime in :mod:`repro_torch.serve`
(static slot table, deadlines, retry/backoff) driven by the closed-loop
load generator.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b --steps 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-base --steps 16
  PYTHONPATH=src python -m repro_torch.launch.serve --continuous --concurrency 8
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.registry import get_config, list_archs, smoke_config
from repro_torch.models.encdec import EncDec
from repro_torch.models.transformer import Transformer
from repro_torch.serve import (ServeConfig, ServeRuntime, make_prompts,
                               run_closed_loop)
from repro_torch.utils.device import resolve_device


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve_decoder_only(cfg, batch: int, prompt_len: int, steps: int,
                       seed: int = 0, *, device=None):
    """Prefill a [batch, prompt_len] prompt token by token, then decode
    ``steps`` greedy tokens from weights drawn from ``seed``.  The batch
    is one sequence a row and, for MoE archs, one dispatch group, as in
    the JAX package."""
    if batch < 1:
        raise ValueError(f"batch={batch} must be >= 1")
    if prompt_len < 0 or steps < 0:
        raise ValueError(f"prompt_len={prompt_len} and steps={steps} must "
                         "be >= 0")
    dev = resolve_device(device)
    params = Transformer.init(torch.Generator(device=dev).manual_seed(seed),
                              cfg)
    prompt = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, size=(batch, prompt_len), dtype=np.int32)).to(dev)
    # capacity >= 1 keeps the zero-work edge (prompt_len=0, steps=0) a
    # well-defined no-op instead of a degenerate 0-length ring buffer
    state = Transformer.init_decode_state(cfg, batch,
                                          max(prompt_len + steps, 1),
                                          device=dev)

    def decode(tok, st):
        return Transformer.decode_step(params, cfg, tok, st)

    logits = None
    tok = torch.zeros((batch, 1), dtype=torch.int32, device=dev)
    with torch.no_grad():
        # prefill by stepping the prompt through the SAME step the decode
        # loop uses (cache-exact)
        t0 = time.time()
        for i in range(prompt_len):
            logits, state = decode(prompt[:, i:i + 1], state)
        if prompt_len:
            # greedy continuation: generation starts from the token the
            # prefilled prompt predicts, not a replay of the prompt's start
            tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        _sync(dev)
        t_prefill = time.time() - t0
        out_tokens = []
        t0 = time.time()
        for _ in range(steps):
            logits, state = decode(tok, state)
            tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
            out_tokens.append(tok)
        _sync(dev)
        dt = time.time() - t0
    toks = (torch.cat(out_tokens, dim=1) if out_tokens
            else torch.zeros((batch, 0), dtype=torch.int32, device=dev))
    if logits is not None:
        assert bool(torch.isfinite(logits).all()), \
            "non-finite logits in serve loop"
    return {"tokens": toks, "prefill_s": t_prefill,
            "decode_s_per_token": dt / steps if steps else 0.0,
            "batch": batch}


def serve_whisper(cfg, batch: int, steps: int, seed: int = 0, *,
                  device=None, params=None, frames=None):
    """Encode 60 frames once, then decode ``steps`` greedy tokens from
    token 0.  The weights are drawn from ``seed`` and the frames (normal
    times 0.1) from ``default_rng(1)``, unless ``params`` and ``frames``
    [batch, T, d] are given (a parity test passes the JAX package's)."""
    if batch < 1:
        raise ValueError(f"batch={batch} must be >= 1")
    if steps < 0:
        raise ValueError(f"steps={steps} must be >= 0")
    dev = resolve_device(device)
    if params is None:
        params = EncDec.init(torch.Generator(device=dev).manual_seed(seed),
                             cfg)
    if frames is None:
        frames = torch.from_numpy((np.random.default_rng(1).standard_normal(
            (batch, 60, cfg.enc_d_model)) * 0.1).astype(np.float32))
    frames = frames.to(device=dev, dtype=cfg.torch_dtype)
    logits = None
    tok = torch.zeros((batch, 1), dtype=torch.int32, device=dev)
    outs = []
    with torch.no_grad():
        state = EncDec.init_decode_state(params, cfg, frames,
                                         seq_len=steps + 1)
        _sync(dev)
        t0 = time.time()
        for _ in range(steps):
            logits, state = EncDec.decode_step(params, cfg, tok, state)
            tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
            outs.append(tok)
        _sync(dev)
        dt = time.time() - t0
    if logits is not None:
        assert bool(torch.isfinite(logits).all()), \
            "non-finite logits in serve loop"
    return {"tokens": (torch.cat(outs, dim=1) if outs else
                       torch.zeros((batch, 0), dtype=torch.int32, device=dev)),
            "decode_s_per_token": dt / steps if steps else 0.0,
            "batch": batch}


def serve_continuous(cfg, serve_cfg, concurrency: int, n_requests: int,
                     seed: int = 0, device=None):
    """Drive the continuous-batching runtime with a closed loop."""
    rt = ServeRuntime(cfg, serve_cfg, seed=seed, device=device)
    prompts = make_prompts(n_requests, serve_cfg.max_prompt_len, cfg.vocab,
                           seed=seed + 1)
    row = run_closed_loop(rt, prompts, concurrency=concurrency)
    row["traces"] = dict(rt.traces)
    row["max_slot_reuse"] = rt.stats()["max_slot_reuse"]
    return row


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b", choices=list_archs())
    ap.add_argument("--full", action="store_true",
                    help="use the full config (published widths)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (cuda or cpu)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--continuous", action="store_true",
                    help="serve via the fixed-slot continuous-batching "
                         "runtime (decoder-only archs)")
    ap.add_argument("--concurrency", type=int, default=4,
                    help="closed-loop client count (--continuous)")
    ap.add_argument("--requests", type=int, default=16,
                    help="total requests to serve (--continuous)")
    ServeConfig.add_arguments(ap)
    args = ap.parse_args(argv)
    cfg = get_config(args.arch) if args.full else smoke_config(args.arch)
    if args.continuous:
        if cfg.family == "audio":
            ap.error("--continuous serves decoder-only archs")
        row = serve_continuous(cfg, ServeConfig.from_flags(args),
                               args.concurrency, args.requests,
                               device=args.device)
        print(f"arch={cfg.name} continuous serve:")
        for k, v in row.items():
            print(f"  {k}: {v}")
        return row
    if cfg.family == "audio":
        res = serve_whisper(cfg, args.batch, args.steps, device=args.device)
    else:
        res = serve_decoder_only(cfg, args.batch, args.prompt_len,
                                 args.steps, device=args.device)
    toks = res.pop("tokens")
    print(f"arch={cfg.name} generated {toks.shape[1]} tokens x{toks.shape[0]} seqs")
    print({k: (round(v, 5) if isinstance(v, float) else v)
           for k, v in res.items()})
    print("sample:", toks[0][:12].tolist())
    return res


if __name__ == "__main__":
    main()
