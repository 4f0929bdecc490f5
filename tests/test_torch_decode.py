"""The port's decode path, held against ``repro.models`` on the CPU.

The registry's smoke configs of gemma2-2b (local/global windows,
softcaps, sandwich norms), olmoe-1b-7b (MoE, qk-norm), phi3-mini,
mamba2-2.7b and zamba2-1.2b (the hybrid's shared attention block), and
step by step the other four decoder-only configs, go through both
packages' ``init_decode_state``/``decode_step`` with the
weights of one JAX init carried across and one numpy token stream.  The
cache holds 20 positions and 24 tokens are stepped, so the ring wraps,
and gemma2's local layers (window 16) drop keys the ring still holds.

Tolerances: float32 on both sides with sums in another order; logits
and state within rtol 1e-4, atol 1e-5.  A wrong ring slot, mask or
carried state moves the logits by far more.  Decode against the port's
own forward (teacher forcing) takes atol 1e-4: the forward attends
through the blocked ``flash_attention`` plain version, decode through
``sdpa`` over the ring.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.launch.serve import serve_decoder_only as j_serve_decoder_only
from repro.models.transformer import Transformer as JT
from repro_torch.configs import smoke_config
from repro_torch.launch.serve import serve_decoder_only
from repro_torch.models.transformer import Transformer
from repro_torch.utils.tree import tree_leaves_with_path, tree_map
from repro_torch.utils.weights import to_numpy, to_torch
from torch_threads import one_thread  # noqa: F401

ARCHS = ["gemma2-2b", "olmoe-1b-7b", "phi3-mini-3.8b", "mamba2-2.7b",
         "zamba2-1.2b"]
# the registry's other decoder-only configs: glm4, moonshot (MoE with a
# shared expert), grok-1 (8 experts) and pixtral (a VLM, text tokens)
OTHER_ARCHS = ["glm4-9b", "moonshot-v1-16b-a3b", "grok-1-314b",
               "pixtral-12b"]
B, CAP, STEPS = 2, 20, 24


def _carried(arch, cfg_fn=lambda c: c):
    jcfg, cfg = cfg_fn(j_smoke(arch)), cfg_fn(smoke_config(arch))
    jp = jax.device_get(JT.init(jax.random.PRNGKey(0), jcfg))
    return jcfg, cfg, jp, to_torch(jp)


def _stream(cfg, n, seed=7):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=(B, n),
                                                dtype=np.int32)


def _assert_state_close(jstate, tstate):
    jl = {("/".join(map(str, p))): np.asarray(v)
          for p, v in tree_leaves_with_path(jax.device_get(jstate))}
    tl = {("/".join(map(str, p))): v
          for p, v in tree_leaves_with_path(to_numpy(tstate))}
    assert jl.keys() == tl.keys()
    for k in jl:
        assert tl[k].shape == jl[k].shape, k
        np.testing.assert_allclose(tl[k], jl[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("arch", ARCHS + OTHER_ARCHS)
def test_decode_steps_match_reference(arch):
    """Step by step past the ring's capacity: the logits after every step,
    and the whole state (caches, SSM state and conv window, positions)
    when the ring is full and at the end."""
    jcfg, cfg, jp, tp = _carried(arch)
    toks = _stream(cfg, STEPS)
    jstep = jax.jit(lambda p, t, s: JT.decode_step(p, jcfg, t, s))
    jstate = JT.init_decode_state(jcfg, B, CAP)
    tstate = Transformer.init_decode_state(cfg, B, CAP, device="cpu")
    for t in range(STEPS):
        jl, jstate = jstep(jp, jnp.asarray(toks[:, t:t + 1]), jstate)
        tl, tstate = Transformer.decode_step(
            tp, cfg, torch.from_numpy(toks[:, t:t + 1]), tstate)
        assert tl.shape == (B, 1, cfg.vocab)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-5, err_msg=f"step {t}")
        if t in (CAP - 1, STEPS - 1):
            _assert_state_close(jstate, tstate)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_own_forward(arch):
    """Teacher forcing: the logits of decode step t equal the port's
    full forward at position t (MoE: capacity factor 8, as the JAX
    package's own test, so neither side drops a token)."""
    def no_drops(c):
        return c if c.moe is None else c.with_(
            moe=dataclasses.replace(c.moe, capacity_factor=8.0))

    _, cfg, _, tp = _carried(arch, no_drops)
    S = 12
    toks = torch.from_numpy(_stream(cfg, S, seed=3))
    with torch.no_grad():
        full, _ = Transformer.forward(tp, cfg, toks)
    state = Transformer.init_decode_state(cfg, B, S, device="cpu")
    outs = []
    for t in range(S):
        lg, state = Transformer.decode_step(tp, cfg, toks[:, t:t + 1], state)
        outs.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               atol=1e-4)


@pytest.mark.parametrize("arch", ["gemma2-2b", "olmoe-1b-7b",
                                  "zamba2-1.2b"])
def test_per_row_positions(arch):
    """A [B] position whose rows are equal gives the scalar form's bits;
    rows at different positions each give what they give alone (MoE
    routed a token a group, as the serving runtime routes it)."""
    _, cfg, _, tp = _carried(arch)
    toks = torch.from_numpy(_stream(cfg, 9, seed=5))
    step = lambda t, s: Transformer.decode_step(tp, cfg, t, s,
                                                moe_group_size=1)
    scalar = Transformer.init_decode_state(cfg, B, CAP, device="cpu")
    for t in range(6):
        _, scalar = step(toks[:, t:t + 1], scalar)

    def per_row(state):
        out = dict(state, pos=state["pos"].expand(B).clone())
        if "kv" in state:
            kv = state["kv"]
            out["kv"] = kv._replace(idx=kv.idx.expand(B).clone())
        return out

    rows = per_row(scalar)
    ls, scalar = step(toks[:, 6:7], scalar)
    lr, rows = step(toks[:, 6:7], rows)
    assert torch.equal(ls, lr)
    for (p, a), (_, b) in zip(tree_leaves_with_path(scalar),
                              tree_leaves_with_path(rows)):
        assert torch.equal(a.expand_as(b), b), p
    # row 0 steps on alone from position 7, row 1 from 0 at once
    alone = [Transformer.init_decode_state(cfg, 1, CAP, device="cpu")
             for _ in range(B)]
    for t in range(7):
        _, alone[0] = step(toks[:1, t:t + 1], alone[0])
    mixed = _splice(per_row(Transformer.init_decode_state(
        cfg, B, CAP, device="cpu")), alone[0], row=0)
    for t in range(2):
        tok = torch.stack([toks[0, 7 + t], toks[1, t]])[:, None]
        lm, mixed = step(tok, mixed)
        l0, alone[0] = step(toks[:1, 7 + t:8 + t], alone[0])
        l1, alone[1] = step(toks[1:, t:t + 1], alone[1])
        # batch 2 against batch 1: the products sum in another order
        np.testing.assert_allclose(lm.numpy(), torch.cat([l0, l1]).numpy(),
                                   rtol=1e-4, atol=1e-5)


def _splice(state, one, row):
    """``state`` with row ``row`` replaced by the batch-1 state ``one``:
    per-row leaves [B] take its scalar, stacked [L, B, ...] its row."""
    def put(t, o):
        t = t.clone()
        if t.dim() == 1:
            t[row] = o
        else:
            t[:, row] = o[:, 0]
        return t
    return tree_map(put, state, one)


def test_serve_decoder_only_one_group_moe_matches_reference(monkeypatch):
    """``serve_decoder_only`` routes its batch as one MoE group, as the
    reference does: at B = 2 with capacity 1 (olmoe's smoke config, E 4,
    k 2) the two rows of a BOS-0 start pick the same experts, and the
    second row's assignments drop.  The greedy tokens equal the
    reference's (its init's weights carried in place of the port's
    draw), and the rows differ, which only the drops explain."""
    cfg = smoke_config("olmoe-1b-7b")
    jp = jax.device_get(JT.init(jax.random.PRNGKey(0), j_smoke(cfg.name)))
    want = j_serve_decoder_only(j_smoke(cfg.name), batch=2, prompt_len=0,
                                steps=6, seed=0)
    monkeypatch.setattr(Transformer, "init",
                        staticmethod(lambda gen, c: to_torch(jp)))
    got = serve_decoder_only(cfg, batch=2, prompt_len=0, steps=6,
                             device="cpu")
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))
    assert not torch.equal(got["tokens"][0], got["tokens"][1])
