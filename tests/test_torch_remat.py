"""Rematerialisation in the port's model stacks (``models.module.remat``,
the port's ``jax.checkpoint``), held against the same code with
``module.remat`` swapped for a plain call.

The JAX package checkpoints each stack group of ``period`` blocks, each
whisper encoder and decoder block and each chunk of the chunked loss;
the port calls ``module.remat`` at the same places.  A recomputed
forward computes the same values, so on the CPU every output, metric
and gradient is bit for bit the plain call's.  The bytes saved for the
backward outside the checkpoints (``saved_tensors_hooks``, each storage
once, the parameters' left out) grow by one group input [B, S, d] a
group with remat, and by a multiple of it without; no saved tensor is a
[B, chunk, vocab_padded] tile.  On ``meta`` the dry run's peak falls and
its FLOPs rise.  Smoke configs on one thread; inputs from a numpy seed.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import InputShape, smoke_config
from repro_torch.core.cyclesl import CycleConfig
from repro_torch.launch.dryrun import dry_run
from repro_torch.models import module
from repro_torch.models.encdec import EncDec
from repro_torch.models.transformer import (Transformer, pattern_period,
                                            positions_for)
from repro_torch.utils.tree import tree_leaves, tree_unflatten_like
from torch_threads import one_thread  # noqa: F401

DECODERS = ["olmoe-1b-7b", "gemma2-2b", "mamba2-2.7b", "zamba2-1.2b"]
B, S, CHUNK = 2, 64, 24       # three loss chunks, the last one padded
FRAMES, TEXT = 32, 16          # whisper's encoder frames and text tokens


def plain(fn, *args):
    """``module.remat`` as it was before: the call itself."""
    return fn(*args)


@pytest.fixture
def no_remat(monkeypatch):
    """Swap ``module.remat`` for a plain call while the fixture lives."""
    def swap():
        monkeypatch.setattr(module, "remat", plain)
    return swap


@pytest.fixture
def remat_calls(monkeypatch):
    """The functions ``module.remat`` is called with, in order."""
    calls, real = [], module.remat

    def counting(fn, *args):
        calls.append(fn)
        return real(fn, *args)
    monkeypatch.setattr(module, "remat", counting)
    return calls


def _ints(seed, shape, high):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, high, size=shape).astype(np.int64))


def _decoder(arch, n_layers=None):
    cfg = smoke_config(arch)
    if n_layers is not None:
        cfg = cfg.with_(n_layers=n_layers)
    params = Transformer.init(torch.Generator().manual_seed(0), cfg)
    tokens = _ints(1, (B, S), cfg.vocab)
    labels = _ints(2, (B, S), cfg.vocab)
    labels[:, -5:] = -1                 # sequence padding, left out
    return cfg, params, (tokens, labels)


def _decoder_loss(cfg):
    """The split server's loss over the whole model: embed, every block,
    the chunked loss and the MoE's aux and z terms."""
    def run(params, tokens, labels):
        x = Transformer.embed_inputs(params, cfg, tokens)
        x, metrics = Transformer.stack_forward(
            params, cfg, x, positions_for(B, S, x.device), first_block=0,
            n_blocks=cfg.n_layers)
        nll, acc = Transformer.chunked_lm_loss(params, cfg, x, labels,
                                               chunk=CHUNK)
        loss = nll
        if cfg.moe is not None:
            loss = (loss + cfg.moe.aux_weight * metrics["aux_loss"]
                    + cfg.moe.router_z_weight * metrics["z_loss"])
        return loss, [x, nll, acc, metrics["aux_loss"], metrics["z_loss"]]
    return run


def _whisper(n_layers=None, enc_layers=None):
    cfg = smoke_config("whisper-base")
    cfg = cfg.with_(n_layers=n_layers or cfg.n_layers,
                    enc_layers=enc_layers or cfg.enc_layers)
    params = EncDec.init(torch.Generator().manual_seed(0), cfg)
    frames = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (B, FRAMES, cfg.d_model)).astype(np.float32))
    return cfg, params, (frames, _ints(4, (B, TEXT), cfg.vocab),
                         _ints(5, (B, TEXT), cfg.vocab))


def _whisper_loss(cfg):
    def run(params, frames, tokens, labels):
        enc_out = EncDec.encode(params["encoder"], cfg, frames)
        logits = EncDec.decode_train(params["decoder"], cfg, tokens,
                                     enc_out)
        ll = torch.log_softmax(logits, dim=-1)
        loss = -torch.gather(ll, -1, labels[..., None])[..., 0].mean()
        return loss, [enc_out, logits]
    return run


def _case(arch, **depth):
    if arch == "whisper-base":
        cfg, params, inputs = _whisper(**depth)
        return cfg, params, inputs, _whisper_loss(cfg)
    cfg, params, inputs = _decoder(arch, **depth)
    return cfg, params, inputs, _decoder_loss(cfg)


def _values_and_grads(params, inputs, run):
    """(loss and outputs, every parameter's gradient), detached."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss, outs = run(tree_unflatten_like(params, leaves), *inputs)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return ([t.detach() for t in [loss, *outs]],
            [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)])


def _bit_equal(a, b):
    return len(a) == len(b) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
        for x, y in zip(a, b))


# ------------------------------------------------------------ the helper
def test_remat_recomputes_under_grad_and_calls_once_without():
    """Under grad ``fn`` runs in the forward and again in the backward,
    and the gradient is the plain call's; under ``no_grad`` and
    ``inference_mode`` it runs once and records nothing."""
    runs = []

    def fn(x, w):
        runs.append(1)
        return torch.tanh(x @ w).sum()
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, 8)).astype(np.float32))
    w = x.T.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(module.remat(fn, x, w), w)
    assert len(runs) == 2
    (want,) = torch.autograd.grad(fn(x, w), w)
    assert torch.equal(g, want)
    for ctx in (torch.no_grad, torch.inference_mode):
        runs.clear()
        with ctx():
            out = module.remat(fn, x, w)
        assert len(runs) == 1 and out.grad_fn is None


# ---------------------------------------------------------- bit equality
@pytest.mark.parametrize("arch", DECODERS + ["whisper-base"])
def test_outputs_metrics_and_gradients_are_bit_equal(arch, no_remat):
    """Every output, metric and parameter gradient of the whole model's
    loss is the same bits with remat as with the plain call."""
    cfg, params, inputs, run = _case(arch)
    got = _values_and_grads(params, inputs, run)
    no_remat()
    want = _values_and_grads(params, inputs, run)
    assert _bit_equal(got[0], want[0])
    assert _bit_equal(got[1], want[1])


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "gemma2-2b"])
def test_chunked_loss_off_the_chunk_grid_is_bit_equal(arch, no_remat,
                                                      remat_calls):
    """``chunked_lm_loss`` at S = 40 in chunks of 16 (the last one
    padded to 16, its labels -1): the nll, the accuracy and the
    gradients of the hidden states and the head are the same bits, one
    ``remat`` a chunk."""
    cfg = smoke_config(arch)
    params = Transformer.init(torch.Generator().manual_seed(0), cfg)
    hidden = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (B, 40, cfg.d_model)).astype(np.float32)).to(cfg.torch_dtype)
    labels = _ints(7, (B, 40), cfg.vocab)
    labels[0, :3] = -1

    def run(p, h):
        nll, acc = Transformer.chunked_lm_loss(p, cfg, h, labels, chunk=16)
        return nll, [acc]
    got = _values_and_grads({"p": params, "h": hidden}, (),
                            lambda t: run(t["p"], t["h"]))
    assert len(remat_calls) == 3
    no_remat()
    want = _values_and_grads({"p": params, "h": hidden}, (),
                             lambda t: run(t["p"], t["h"]))
    assert _bit_equal(got[0], want[0])
    assert _bit_equal(got[1], want[1])


# -------------------------------------------------------------- structure
@pytest.mark.parametrize("arch", DECODERS + ["whisper-base"])
def test_remat_sites_are_the_reference_checkpoints(arch, remat_calls):
    """One ``remat`` a group of ``period`` blocks (gemma2's pair is one),
    one a mamba block and none for zamba2's shared block, one a whisper
    block on each side, and one a loss chunk."""
    cfg, params, inputs, run = _case(arch)
    _values_and_grads(params, inputs, run)
    got = {}
    for fn in remat_calls:
        got[fn.__qualname__] = got.get(fn.__qualname__, 0) + 1
    if arch == "whisper-base":
        assert got == {"EncDec.encode.<locals>.block": cfg.enc_layers,
                       "EncDec.decode_train.<locals>.block": cfg.n_layers}
        return
    chunks = -(-S // CHUNK)
    assert got == {"_group": cfg.n_layers // pattern_period(cfg),
                   "Transformer.chunked_lm_loss.<locals>.one": chunks}
    if arch == "gemma2-2b":
        assert pattern_period(cfg) == 2
    if arch == "zamba2-1.2b":       # the shared block ran, in no group
        assert any(p < cfg.n_layers for p in cfg.ssm.shared_attn_positions)


# ----------------------------------------------------------------- memory
def _saved(params, inputs, run):
    """{storage: bytes} of the non-parameter tensors saved for the
    backward outside any checkpoint, and their shapes."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    mine = {p.untyped_storage().data_ptr() for p in leaves}
    seen, shapes = {}, []

    def pack(t):
        st = t.untyped_storage()
        if st.data_ptr() not in mine and st.nbytes():
            seen[st.data_ptr()] = st.nbytes()
            shapes.append(tuple(t.shape))
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss, _ = run(tree_unflatten_like(params, leaves), *inputs)
    torch.autograd.grad(loss, leaves, allow_unused=True)
    return sum(seen.values()), shapes


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "gemma2-2b", "mamba2-2.7b",
                                  "whisper-base"])
def test_saved_bytes_grow_by_one_group_input_a_group(arch, no_remat):
    """One group more (``period`` decoder blocks; for whisper one decoder
    block) adds exactly its input [B, S, d] in the model's dtype to the
    bytes saved for the backward with remat, and at least four times
    that without.  With remat no saved tensor has ``vocab_padded``
    columns (the loss tiles are recomputed; without it each chunk's
    log-softmax is one)."""
    if arch == "whisper-base":
        cfg = smoke_config(arch)
        depths = [dict(n_layers=n) for n in (cfg.n_layers,
                                             cfg.n_layers + 1)]
        rows = TEXT
    else:
        p = pattern_period(smoke_config(arch))
        depths = [dict(n_layers=2 * p), dict(n_layers=3 * p)]
        rows = S
    runs = {}
    for mode in ("remat", "plain"):
        if mode == "plain":
            no_remat()
        runs[mode] = [_saved(*_case(arch, **d)[1:]) for d in depths]
    cfg = _case(arch, **depths[0])[0]
    one_input = B * rows * cfg.d_model * cfg.torch_dtype.itemsize
    (small, shapes), (large, _) = runs["remat"]
    assert large - small == one_input
    (small, plain_shapes), (large, _) = runs["plain"]
    assert large - small >= 4 * one_input
    if arch != "whisper-base":      # whisper's loss reads whole logits
        tiles = [s for s in plain_shapes if s[-1:] == (cfg.vocab_padded,)]
        assert tiles and not any(s[-1:] == (cfg.vocab_padded,)
                                 for s in shapes)


# ---------------------------------------------------------------- dry run
@pytest.mark.parametrize("arch,depth", [("olmoe-1b-7b", 4),
                                        ("zamba2-1.2b", None)])
def test_dry_run_peak_falls_and_flops_rise(arch, depth, no_remat):
    """A smoke train step on ``meta``: the rematerialised step's peak is
    below the plain one's, and its FLOPs above (the recomputed
    forwards).  olmoe's smoke config runs at depth 4: at its own 2 the
    server is one group, whose input and recompute cost what its
    activations would."""
    cfg = smoke_config(arch)
    if depth is not None:
        cfg = cfg.with_(n_layers=depth)
    shape = InputShape("train_smoke", 64, 4, "train")
    cycle = CycleConfig(server_epochs=1, server_batch=2)
    got = dry_run(cfg, shape, cohort=2, cycle=cycle)
    no_remat()
    want = dry_run(cfg, shape, cohort=2, cycle=cycle)
    assert got["peak_bytes"] < want["peak_bytes"]
    assert got["cost"]["flops"] > want["cost"]["flops"]
    assert got["state_bytes"] == want["state_bytes"]
