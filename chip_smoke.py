#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--out report.json]

Phases, each of which ends the script with a non-zero exit on failure:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions;
2. build: every CUDA source under src/repro_torch/kernels/csrc, compiled
   with nvcc from this checkout (one process per source, in parallel);
3. kernel checks: each kernel against its plain PyTorch version on the
   card, at the shapes the main path and the olmoe round give it and at
   edge cases, with its time, its bound and a one-call PyTorch
   yardstick where one exists;
4. main path: ``Engine.run()`` of cyclesfl on femnist_cnn at the paper's
   width 32 (cut 2), with the kernels' launch counters reset before and
   read after;
5. fused variant: the same at cut 3 with ``fused_gather_loss``;
6. card against CPU: two rounds at a small width with TF32 off, one
   carried init and one injected plan, on the CPU (plain versions) and
   on the card (kernels);
7. transformer round: ``launch.steps.build_train_step`` for olmoe-1b-7b
   at full width (depth 16 cut to 4, cut 2 as published), cohort 2,
   batch 2 a client, sequence 2048, bf16, 3 CycleSL rounds from a
   random init on the card, with the launch counters reset before and
   read after;
8. prefill: ``build_prefill_step`` at the same config, batch 2,
   sequence 2048;
9. card against CPU for the transformer round: olmoe-1b-7b and
   gemma2-2b at smoke size, float32, TF32 off, 2 rounds.

It then prints the ``kernels`` JSON line and, last, the device line
``{"ok": true, "device": {...}}``.  Without a card, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""
import argparse
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM peaks (NVIDIA data sheet, dense, at the full 700 W limit):
# HBM, float32 on the CUDA cores (the port keeps TF32 off), and bf16 /
# fp16 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12
MAIN = dict(n_clients=100, attendance=0.05, batch=16, width=32)
# the transformer round: olmoe-1b-7b at full width, 16 layers cut to 4
OLMOE_DEPTH, OLMOE_COHORT, OLMOE_BATCH, OLMOE_SEQ = 4, 2, 2, 2048
OLMOE_ROUNDS = 3
CHECKS = []           # every kernel check of phase 3, for the report


def eager_ms(fn, iters=50, warmup=5):
    """Mean time per call in ms of ``fn`` launched from Python, between
    CUDA events around ``iters`` calls: includes the host's dispatch
    cost whenever that is longer than the device's work."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters=20, replays=10):
    """Mean device time per call in ms: ``iters`` calls captured in one
    CUDA graph, replayed ``replays`` times between CUDA events, so the
    host's dispatch cost drops out."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def bound(nbytes, flops, dtype=None):
    """Least time (ms) for the work: bytes over the memory rate against
    operations over the card's peak for the operands' type (bf16 and
    fp16 on the tensor cores, else float32); the larger bounds it."""
    import torch
    rate = (BF16_FLOPS_PER_S if dtype in (torch.bfloat16, torch.float16)
            else FP32_FLOPS_PER_S)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def within(got, want, tol, ulps=None):
    """Whether ``got`` is within ``tol`` of ``want``; for a bfloat16
    output when ``ulps`` is given, each value within the larger of
    ``ulps`` bfloat16 ulps of ``want`` (a rounding flip) and ``tol`` (a
    float32 difference that cancellation leaves above the ulp of a value
    near zero)."""
    import torch
    d = (got.double() - want.double()).abs()
    if ulps is None or want.dtype != torch.bfloat16:
        return float(d.max()) <= tol
    _, e = torch.frexp(want.float())        # |want| = m * 2^e, m in [0.5, 1)
    ulp = torch.where(want == 0, 0.0, torch.exp2(e.double() - 8))
    return bool((d <= torch.clamp(ulps * ulp, min=tol)).all())


def check(name, shape, kernel, plain, tol, nbytes, flops, library=None,
          dtype=None, ulps=None):
    """Run ``kernel`` and ``plain`` once on the same inputs, compare,
    time both (and ``library``) on the device, and print one line.
    Raises when the kernel disagrees with its plain version beyond
    ``tol`` (beyond ``ulps`` bfloat16 ulps for a bfloat16 output, when
    given)."""
    import torch
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    err = max(float((a.double() - b.double()).abs().max()) if a.numel() else 0.0
              for a, b in zip(got, want))
    ok = all(within(a, b, tol, ulps) for a, b in zip(got, want) if a.numel())
    ms, plain_ms = device_ms(kernel), device_ms(plain)
    lib_ms = device_ms(library) if library is not None else None
    eager = eager_ms(kernel)
    b_ms, b_by = bound(nbytes, flops, dtype)
    row = {"name": name, "shape": shape, "max_abs_err": err, "tol": tol,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": lib_ms, "eager_ms": eager}
    CHECKS.append(row)
    print(f"check {name} {shape}: max_abs_err={err:.3e} (tol {tol:.0e}"
          + (f"; bf16 outputs within {ulps} ulp" if ulps else "") + ") "
          f"kernel={ms:.4f}ms (eager {eager:.4f}ms) plain={plain_ms:.4f}ms "
          f"bound={b_ms:.5f}ms ({b_by}) "
          f"library={'n/a' if lib_ms is None else f'{lib_ms:.4f}ms'}")
    if not ok:
        raise AssertionError(f"{name} {shape}: kernel differs from its plain "
                             f"version by {err} (tol {tol}, ulps {ulps})")
    return row


def kernel_checks(torch, dev):
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {}
    olmoe = get_config("olmoe-1b-7b")
    pool = OLMOE_COHORT * OLMOE_BATCH       # rows of the round's feature pool

    # ---- feature_resample: the pooled features and labels of one step
    def resample(name, src, m):
        idx = torch.randint(0, src.shape[0], (m,), generator=gen,
                            device=dev, dtype=torch.int32)
        flat = src.reshape(src.shape[0], -1)
        row_b = flat.shape[1] * src.element_size()
        nbytes = (len(set(idx.tolist())) + m) * row_b + 4 * m
        return check(name, f"{list(src.shape)} {str(src.dtype)[6:]} idx[{m}]",
                     lambda: (ops.resample_rows(src, idx),),
                     lambda: (ref.feature_resample_ref(flat, idx)
                              .reshape((m,) + tuple(src.shape[1:])),),
                     0.0, nbytes, 0,
                     library=lambda: torch.index_select(src, 0, idx))

    feats = torch.relu(torch.randn(80, 7, 7, 64, device=dev, generator=gen))
    labels = torch.randint(0, 10, (80,), generator=gen, device=dev)
    rows["feature_resample"] = resample("feature_resample", feats, 16)
    resample("feature_resample", labels, 16)
    resample("feature_resample", torch.randn(8192, 3136, device=dev,
                                             generator=gen), 2048)
    resample("feature_resample", torch.randn(80, 2048, device=dev,
                                             generator=gen).bfloat16(), 16)
    # the olmoe round's server step: the pooled bf16 block-cut activations
    # [C * b, S, d] and int32 next-token labels [C * b, S], server batch b
    resample("feature_resample", torch.randn(
        pool, OLMOE_SEQ, olmoe.d_model, device=dev, generator=gen
    ).bfloat16(), OLMOE_BATCH)
    resample("feature_resample", torch.randint(
        0, olmoe.vocab, (pool, OLMOE_SEQ), device=dev, generator=gen,
        dtype=torch.int32), OLMOE_BATCH)
    # rows too short or misaligned for wide vectors: the 2- and 1-byte paths
    resample("feature_resample", torch.randn(38, 13, device=dev,
                                             generator=gen).bfloat16()[1:], 16)
    resample("feature_resample", torch.randint(0, 100, (81, 3), device=dev,
                                               generator=gen).to(torch.uint8),
             16)

    # ---- fused_adam: the server's dense leaves and a client stack.  A
    # bfloat16 p' is held to one bf16 ulp of the plain version's, or 1e-6
    # near zero (the float32 sums differ in their last bit, which flips a
    # rounding now and then), and the float32 moments to 1e-6: an
    # absolute 2e-2 would pass an update (lr 1e-3) wrong altogether
    def adam(shape, steps, dtype=torch.float32, main=False, wd=0.0):
        p = torch.randn(shape, device=dev, generator=gen).to(dtype)
        g = torch.randn(shape, device=dev, generator=gen).to(dtype)
        m = torch.randn(shape, device=dev, generator=gen) * 0.1
        v = torch.rand(shape, device=dev, generator=gen) * 0.1
        step = torch.tensor(steps, dtype=torch.int32, device=dev)
        n = p.numel()
        nbytes = n * (3 * p.element_size() + 4 * 4) + 4 * step.numel()
        lib = None
        if main:
            q = p.clone().requires_grad_(True)
            q.grad = g.clone()
            opt = torch.optim.Adam([q], lr=1e-3, fused=True,
                                   capturable=True)
            lib = opt.step
        kw = dict(lr=1e-3, weight_decay=wd)
        return check("fused_adam",
                     f"{list(shape)} {str(dtype)[6:]} step{list(step.shape)}"
                     + (f" wd {wd}" if wd else ""),
                     lambda: ops.fused_adam(p, g, m, v, step, **kw),
                     lambda: ref.fused_adam_ref(p, g, m, v, step, **kw),
                     1e-6, nbytes, 14 * n, library=lib, dtype=dtype, ulps=1)

    rows["fused_adam"] = adam((3136, 2048), 3, main=True)
    adam((2048, 10), 3)
    adam((5, 5, 5, 32, 64), [0, 1, 2, 3, 4])
    adam((5, 3136, 2048), [4, 4, 4, 9, 0])
    adam((3136, 2048), 3, dtype=torch.bfloat16)
    adam((2048, 10), 7, wd=0.01)
    # the olmoe round's client slots: bf16 leaves stacked [C, ...] with f32
    # moments and a step per slot; the embedding, and the gate projections
    # of the client's experts (2^29 elements, 2^31 bytes a moment)
    mo = olmoe.moe
    adam((OLMOE_COHORT, olmoe.vocab_padded, olmoe.d_model), [0, 3],
         dtype=torch.bfloat16)
    adam((OLMOE_COHORT, olmoe.cut_layers, mo.n_experts, olmoe.d_model,
          mo.d_ff_expert), [2, 0], dtype=torch.bfloat16)

    # ---- gather_loss: the cut-3 head over the pooled dense features
    def gather_loss(t, d, k, m, dtype=torch.float32, labels=torch.int64):
        src = torch.relu(torch.randn(t, d, device=dev, generator=gen)
                         ).to(dtype)
        lab = torch.randint(0, k, (t,), generator=gen, device=dev
                            ).to(labels)
        w = (torch.randn(d, k, device=dev, generator=gen) / d ** 0.5
             ).to(dtype)
        idx = torch.randint(0, t, (m,), generator=gen, device=dev,
                            dtype=torch.int32)
        nbytes = (len(set(idx.tolist())) * d * src.element_size()
                  + d * k * w.element_size() + m * lab.element_size()
                  + m * 4 + m * 4)
        return check("gather_loss", f"[{t}, {d}] w[{d}, {k}] idx[{m}] "
                     f"{str(dtype)[6:]} labels {str(labels)[6:]}",
                     lambda: (ops.gather_loss_microbatch(src, lab, idx, w),),
                     lambda: (ref.gather_loss_microbatch_ref(src, lab, idx, w),),
                     1e-4, nbytes, 2 * m * d * k + 6 * m * k, dtype=dtype)

    rows["gather_loss"] = gather_loss(80, 2048, 10, 16)
    gather_loss(8192, 2048, 62, 2048)
    gather_loss(37, 33, 7, 19, dtype=torch.bfloat16, labels=torch.int32)

    # ---- flash_attention: the olmoe round's heads, gemma2's, edge cases
    # (tolerances of tests/test_kernels.py: 2e-2 bf16, 2e-5 float32); each
    # bf16 case runs in float32 too, where 2e-5 would catch a key dropped,
    # doubled or off by one at a mask's edge
    def attention(B, Sq, Sk, H, Hkv, D, dtype, causal=True, window=None,
                  cap=None, main=False):
        q = torch.randn(B, Sq, H, D, device=dev, generator=gen).to(dtype)
        k = torch.randn(B, Sk, Hkv, D, device=dev, generator=gen).to(dtype)
        v = torch.randn(B, Sk, Hkv, D, device=dev, generator=gen).to(dtype)
        kw = dict(causal=causal, window=window, softcap=cap)
        # the (query, key) pairs this mask keeps: the work the call does
        i = torch.arange(Sq, device=dev)[:, None]
        j = torch.arange(Sk, device=dev)[None, :]
        keep = torch.ones(Sq, Sk, dtype=torch.bool, device=dev)
        if causal:
            keep &= j <= i
        if window is not None:
            keep &= i - j < window
        pairs = int(keep.sum())
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        lib = None
        if main:
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            lib = lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                         is_causal=causal)
        return check("flash_attention",
                     f"q[{B}, {Sq}, {H}, {D}] kv[{B}, {Sk}, {Hkv}, {D}] "
                     f"{str(dtype)[6:]} causal={causal} window={window} "
                     f"softcap={cap}",
                     lambda: (flash_attention(q, k, v, **kw),),
                     lambda: (ref.flash_attention_ref(q, k, v, **kw),),
                     2e-2 if dtype == torch.bfloat16 else 2e-5, nbytes,
                     4 * B * H * D * pairs, library=lib, dtype=dtype)

    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention
    rows["flash_attention"] = attention(2, 2048, 2048, 16, 16, 128,
                                        torch.bfloat16, main=True)
    attention(2, 2048, 2048, 16, 16, 128, torch.float32)
    for dtype in (torch.bfloat16, torch.float32):
        attention(1, 2048, 2048, 8, 4, 256, dtype, window=1024, cap=50.0)
        attention(1, 200, 200, 4, 2, 64, dtype)
        attention(2, 100, 300, 4, 2, 128, dtype)
    attention(1, 256, 256, 4, 4, 128, torch.float32, causal=False)

    # ---- topk_gating: the olmoe router's group, a small router, ties
    def gating(T, E, k, ties=False):
        if ties:
            x = torch.randint(-2, 3, (T, E), device=dev, generator=gen
                              ).float()
        else:
            x = torch.randn(T, E, device=dev, generator=gen)
        nbytes = x.numel() * 4 + T * k * 8
        got, want = topk_gating(x, k), ref.topk_gating_ref(x, k)
        if not torch.equal(got[1], want[1]):
            raise AssertionError(f"topk_gating [{T}, {E}] k={k}: ids differ "
                                 f"from the plain version")
        return check("topk_gating", f"[{T}, {E}] k={k}"
                     + (" tied" if ties else ""),
                     lambda: (topk_gating(x, k)[0],),
                     lambda: (ref.topk_gating_ref(x, k)[0],),
                     1e-6, nbytes, T * E * (4 + 2 * k), dtype=x.dtype)

    from repro_torch.kernels.topk_gating import topk_gating
    rows["topk_gating"] = gating(4096, 64, 8)
    gating(4096, 8, 2)
    gating(4096, 64, 8, ties=True)
    return rows


def counters():
    from repro_torch.kernels import (feature_resample, flash_attention,
                                     fused_adam, gather_loss, topk_gating)
    return {"feature_resample": feature_resample, "fused_adam": fused_adam,
            "gather_loss": gather_loss, "flash_attention": flash_attention,
            "topk_gating": topk_gating}


def reset_counters():
    for mod in counters().values():
        mod.launches = 0


def read_counters():
    return {k: mod.launches for k, mod in counters().items()}


def drive(torch, label, cfg, expect):
    """Run ``Engine.run()`` on the card with the counters reset just
    before and read just after; check finite metrics and the launches."""
    from repro_torch.api import Engine
    eng_stamps = []

    class Clock:
        def on_round(self, engine, rnd, state, metrics):
            torch.cuda.synchronize()
            eng_stamps.append((time.perf_counter(),
                               {k: float(v) for k, v in metrics.items()}))

    eng = Engine(cfg, device="cuda", callbacks=[Clock()],
                 log=lambda msg: print(f"{label}: {msg}"))
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters()
    losses = [m["server_loss"] for _, m in eng_stamps]
    steady = [b[0] - a[0] for a, b in zip(eng_stamps, eng_stamps[1:])]
    rps = len(steady) / sum(steady) if steady else float("nan")
    hist = res["history"][-1]
    print(f"{label}: {cfg.rounds} rounds in {wall:.3f}s; rounds 2..{cfg.rounds} "
          f"at {rps:.2f} rounds/s; server_loss per round {losses}; "
          f"test_loss={hist['test_loss']:.4f} accuracy={hist['accuracy']:.4f}; "
          f"launches {launches} (expected {expect})")
    vals = [v for _, m in eng_stamps for v in m.values()]
    vals += [hist["test_loss"], hist["train_loss"]]
    if not all(math.isfinite(x) for x in vals):
        raise AssertionError(f"{label}: non-finite metrics {vals}")
    for k, n in expect.items():
        if launches[k] != n:
            raise AssertionError(f"{label}: {k} launched {launches[k]} times, "
                                 f"expected {n}")
    return {"rounds": cfg.rounds, "wall_s": wall, "rounds_per_s": rps,
            "server_loss": losses, "history": res["history"],
            "launches": launches}


def device_profile(torch, label, run):
    """``run()`` under torch.profiler: device busy share of the wall
    time and the kernels that take the device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events only (kernels, copies): the host ops that
    # launched them carry the same device time again
    rows = sorted(((e.key, e.count, e.self_device_time_total)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), key=lambda r: -r[2])
    busy = sum(r[2] for r in rows)
    print(f"profile {label}: {wall_us / 1e3:.1f}ms wall, device busy "
          f"{busy / 1e3:.1f}ms ({busy / wall_us:.1%})")
    for name, count, t in rows[:12]:
        print(f"profile {label}:   {t / 1e3:8.3f}ms {count:6d}x {name[:90]}")
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "top": [{"name": n, "count": c, "device_ms": t / 1e3}
                    for n, c, t in rows[:25]]}


def profile_rounds(torch, cfg):
    """``Engine.run()`` (rounds + eval) under the profiler, warm."""
    from repro_torch.api import Engine
    eng = Engine(cfg, device="cuda", log=lambda msg: None)
    eng.run()                                   # warm: cuDNN picks, caches
    return device_profile(torch, f"cut{cfg.cut} ({cfg.rounds} rounds + eval)",
                          eng.run)


def card_against_cpu(torch):
    """Two rounds on the CPU (plain versions) and on the card (kernels),
    with TF32 off, one carried init and one injected plan.  Per-round
    metrics must agree to rtol 1e-4 (float32 sums in another order);
    weights to 1e-5 but for at most 0.1% of them, each within the
    2 * lr * steps that Adam's near-sign steps can move a weight."""
    from repro_torch.api import Engine, ExperimentConfig
    from repro_torch.core.feature_store import masked_resample_plan
    from repro_torch.utils.tree import tree_leaves, tree_map
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("card-vs-cpu: TF32 off for cuDNN convolutions and matmuls")

    def plan_fn(key, valid, epochs, sb):
        return masked_resample_plan(key, valid.cpu(), epochs, sb)

    out = {}
    for cut, fused in ((2, False), (3, True)):
        cfg = ExperimentConfig(rounds=2, eval_every=2, n_clients=10,
                               attendance=0.3, batch=8, width=8, cut=cut
                               ).with_cycle(server_epochs=2,
                                            fused_gather_loss=fused)
        runs = {}
        for dev in ("cpu", "cuda"):
            rows, final = [], []

            class Rec:
                def on_round(self, engine, rnd, state, metrics):
                    rows.append({k: float(v) for k, v in metrics.items()})
                    final[:] = [state]

            eng = Engine(cfg, device=dev, callbacks=[Rec()], plan_fn=plan_fn,
                         log=lambda msg: None)
            init = Engine(cfg, device="cpu", log=lambda msg: None).init_state()
            eng.run(state=tree_map(lambda t: t.to(dev), init))
            runs[dev] = (rows, final[0])
        worst = 0.0
        for rc, rg in zip(runs["cpu"][0], runs["cuda"][0]):
            for k in rc:
                rel = abs(rg[k] - rc[k]) / max(abs(rc[k]), 1e-12)
                worst = max(worst, rel)
        # 2 rounds x 2 epochs x (3 clients x 8 rows / server batch 8)
        steps = 2 * 2 * 3
        w_max, w_frac = 0.0, 0.0
        for a, b in zip(tree_leaves(runs["cpu"][1]), tree_leaves(runs["cuda"][1])):
            d = (a.double() - b.cpu().double()).abs()
            w_max = max(w_max, float(d.max()))
            w_frac = max(w_frac, float((d > 1e-5).double().mean()))
        label = f"cut{cut}{'-fused' if fused else ''}"
        print(f"card-vs-cpu {label}: worst metric rel diff {worst:.3e} "
              f"(tol 1e-4); weights max abs diff {w_max:.3e} "
              f"(bound {2 * 1e-3 * steps:.0e}), share over 1e-5 {w_frac:.2e} "
              f"(tol 1e-3)")
        if not (worst <= 1e-4 and w_max <= 2 * 1e-3 * steps
                and w_frac <= 1e-3):
            raise AssertionError(f"card-vs-cpu {label}: card and CPU disagree")
        out[label] = {"worst_metric_rel_diff": worst, "weights_max_abs": w_max,
                      "weights_share_over_1e-5": w_frac}
    return out


def olmoe_round(torch, rounds=OLMOE_ROUNDS, profile=False):
    """The transformer path: ``build_train_step`` for olmoe-1b-7b at full
    width, depth 4 (cut 2), cohort 2, batch 2 a client, sequence 2048,
    bf16; random init on the card, tokens from a numpy seed.

    Expected launches per round (no checkpointing, so no recompute; the
    attention and router backwards are plain torch and launch nothing):
    every block forward launches flash_attention once and topk_gating
    once (a client's or a server step's 2 x 2048 tokens are one dispatch
    group), and blocks run cut * C times in the extract, (L - cut) *
    steps in the server steps, (L - cut) * C in the feature gradients
    and cut * C in the client VJPs, with steps = C * b / server batch;
    feature_resample gathers features and labels once a server step;
    fused_adam steps every server leaf once a server step and every
    stacked client leaf once."""
    from repro_torch.configs import InputShape, get_config
    from repro_torch.core.cyclesl import CycleConfig
    from repro_torch.launch.steps import build_train_step
    from repro_torch.utils.tree import tree_leaves
    cfg = get_config("olmoe-1b-7b").with_(n_layers=OLMOE_DEPTH)
    L, cut, C, b = cfg.n_layers, cfg.cut_layers, OLMOE_COHORT, OLMOE_BATCH
    shape = InputShape("olmoe_round", OLMOE_SEQ, C * b, "train")
    cycle = CycleConfig(server_epochs=1, server_batch=b)
    bundle = build_train_step(cfg, shape, cycle, cohort=C, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    server, clients = bundle.init_state(0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    state_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves((server, clients)))
    n_server = sum(t.numel() for t in tree_leaves(server.params))
    n_client = sum(t.numel() for t in tree_leaves(clients.params)) // C
    steps = cycle.server_epochs * (C * b // cycle.server_batch)
    blocks = cut * C + (L - cut) * steps + (L - cut) * C + cut * C
    expect = {"flash_attention": blocks * rounds,
              "topk_gating": blocks * rounds,
              "feature_resample": 2 * steps * rounds,
              "fused_adam": (len(tree_leaves(server.params)) * steps
                             + len(tree_leaves(clients.params))) * rounds,
              "gather_loss": 0}
    batches = [bundle.make_batch(r) for r in range(rounds)]
    torch.cuda.synchronize()
    reset_counters()
    stamps, per_round = [time.perf_counter()], []
    for r in range(rounds):
        xs, ys = batches[r]
        server, clients, m = bundle.fn(server, clients, xs, ys, r)
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        per_round.append({k: float(v) for k, v in m.items()})
    launches = read_counters()
    peak = torch.cuda.max_memory_allocated()
    steady = stamps[-1] - stamps[1]
    rps = (rounds - 1) / steady
    tokens = C * b * OLMOE_SEQ
    print(f"olmoe round: {cfg.name} L={L} cut={cut} d={cfg.d_model} "
          f"E={cfg.moe.n_experts} top{cfg.moe.top_k}, params {n_client:,} "
          f"a client, {n_server:,} the server; C={C} b={b} S={OLMOE_SEQ} "
          f"bf16; init {init_s:.2f}s; entity states {state_bytes / 1e9:.2f} "
          f"GB")
    for r, m in enumerate(per_round):
        print(f"olmoe round {r + 1}: {stamps[r + 1] - stamps[r]:.3f}s "
              + " ".join(f"{k}={v:.6g}" for k, v in m.items()))
    print(f"olmoe round: rounds 2..{rounds} at {rps:.3f} rounds/s, "
          f"{rps * tokens:.1f} tokens/s; peak memory {peak / 1e9:.2f} GB; "
          f"launches {launches} (expected {expect}: {blocks} block forwards "
          f"a round = cut*C {cut * C} + (L-cut)*steps {(L - cut) * steps} "
          f"+ (L-cut)*C {(L - cut) * C} + cut*C {cut * C})")
    vals = [v for m in per_round for v in m.values()]
    if not all(math.isfinite(x) for x in vals):
        raise AssertionError(f"olmoe round: non-finite metrics {per_round}")
    for k, n in expect.items():
        if launches[k] != n:
            raise AssertionError(f"olmoe round: {k} launched {launches[k]} "
                                 f"times, expected {n}")
    prof = None
    if profile:                 # one more round, after the counted ones
        prof = device_profile(torch, "olmoe round", lambda: bundle.fn(
            server, clients, *batches[0], 0))
    return {"profile": prof, "config": {"arch": cfg.name, "n_layers": L, "cut": cut,
                       "cohort": C, "batch": b, "seq": OLMOE_SEQ,
                       "server_steps": steps, "dtype": cfg.dtype},
            "params_client": n_client, "params_server": n_server,
            "state_bytes": state_bytes, "init_s": init_s,
            "round_s": [b - a for a, b in zip(stamps, stamps[1:])],
            "rounds_per_s": rps, "tokens_per_s": rps * tokens,
            "peak_bytes": peak, "metrics": per_round, "launches": launches,
            "expected_launches": expect}


def olmoe_prefill(torch):
    """``build_prefill_step`` at the round's config: batch 2, sequence
    2048; one flash_attention and one topk_gating launch a layer."""
    from repro_torch.configs import InputShape, get_config
    from repro_torch.launch.steps import build_prefill_step
    cfg = get_config("olmoe-1b-7b").with_(n_layers=OLMOE_DEPTH)
    shape = InputShape("olmoe_prefill", OLMOE_SEQ, OLMOE_BATCH, "prefill")
    bundle = build_prefill_step(cfg, shape, device="cuda")
    (params,), (batch,) = bundle.init_state(0), bundle.make_batch(0)
    bundle.fn(params, batch)                       # warm
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    logits = bundle.fn(params, batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = read_counters()
    ok = bool(torch.isfinite(logits.float()).all())
    print(f"prefill: {cfg.name} L={cfg.n_layers} B={OLMOE_BATCH} "
          f"S={OLMOE_SEQ}: last-token logits {list(logits.shape)} "
          f"{str(logits.dtype)[6:]} finite={ok} in {ms:.2f} ms "
          f"({OLMOE_BATCH * OLMOE_SEQ / ms * 1e3:.0f} tokens/s); launches "
          f"{launches}")
    want = {"flash_attention": cfg.n_layers, "topk_gating": cfg.n_layers}
    if not ok or tuple(logits.shape) != (OLMOE_BATCH, cfg.vocab):
        raise AssertionError("prefill: logits not finite or of the wrong "
                             "shape")
    for k, n in want.items():
        if launches[k] != n:
            raise AssertionError(f"prefill: {k} launched {launches[k]} "
                                 f"times, expected {n}")
    return {"ms": ms, "launches": launches, "shape": list(logits.shape)}


def transformer_card_against_cpu(torch):
    """Two rounds of the transformer round on the CPU (plain versions)
    and on the card (kernels), float32 with TF32 off, from one init
    drawn on the CPU and with one plan, for olmoe-1b-7b and gemma2-2b at
    smoke size (gemma2 4 deep, so the server holds a local and a global
    block).  Per-round metrics must agree to rtol 1e-4 (the feature-
    gradient norms' std against their mean): float32 sums in another
    order move them by about 1e-6; one flipped router choice
    would move the loss by far more, and at these inputs the router's
    top-k gaps are orders of magnitude wider than that noise, so none
    flips.  Weights as in phase 6: all but 0.1% within 1e-5, every one
    within the 2 * lr * steps that Adam's near-sign steps can move it."""
    from repro_torch.configs import InputShape, smoke_config
    from repro_torch.core.cyclesl import CycleConfig
    from repro_torch.core.feature_store import resample_plan
    from repro_torch.launch.steps import build_train_step
    from repro_torch.utils.tree import tree_leaves, tree_map
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    shape, C, rounds, lr = InputShape("smoke", 64, 4, "train"), 2, 2, 3e-4

    def plan_fn(key, valid, epochs, sb):
        return resample_plan(key, C * 2, epochs, sb), None

    out = {}
    for arch, depth in (("olmoe-1b-7b", 2), ("gemma2-2b", 4)):
        cfg = smoke_config(arch).with_(n_layers=depth)
        init = build_train_step(cfg, shape, cohort=C, device="cpu"
                                ).init_state(0)
        runs = {}
        for dev in ("cpu", "cuda"):
            bundle = build_train_step(cfg, shape, CycleConfig(), cohort=C,
                                      device=dev, plan_fn=plan_fn)
            server, clients = tree_map(lambda t: t.to(dev), init)
            rows = []
            for r in range(rounds):
                xs, ys = bundle.make_batch(r)
                server, clients, m = bundle.fn(server, clients, xs, ys, r)
                rows.append({k: float(v) for k, v in m.items()})
            runs[dev] = (rows, (server, clients))
        cpu_rows, card_rows = runs["cpu"][0], runs["cuda"][0]
        # the std of C = 2 near-equal norms is their half difference: its
        # error is that of the norms, so it is measured against their mean
        scale = lambda rc, k: max(abs(rc[k]), 1e-12, rc[
            "feat_grad_norm_mean"] if k == "feat_grad_norm_std" else 0.0)
        worst = max(abs(rg[k] - rc[k]) / scale(rc, k)
                    for rc, rg in zip(cpu_rows, card_rows) for k in rc)
        steps = rounds * 2          # server steps; clients step less
        w_max = w_frac = 0.0
        for a, b in zip(tree_leaves(runs["cpu"][1]),
                        tree_leaves(runs["cuda"][1])):
            if not a.numel():
                continue
            d = (a.double() - b.cpu().double()).abs()
            w_max = max(w_max, float(d.max()))
            w_frac = max(w_frac, float((d > 1e-5).double().mean()))
        print(f"card-vs-cpu {arch} (smoke, {depth} layers, f32): worst "
              f"metric rel diff {worst:.3e} (tol 1e-4); weights max abs diff "
              f"{w_max:.3e} (bound {2 * lr * steps:.1e}), share over 1e-5 "
              f"{w_frac:.2e} (tol 1e-3); per round cpu {cpu_rows} "
              f"card {card_rows}")
        if not (worst <= 1e-4 and w_max <= 2 * lr * steps
                and w_frac <= 1e-3):
            raise AssertionError(f"card-vs-cpu {arch}: card and CPU disagree")
        out[arch] = {"worst_metric_rel_diff": worst, "weights_max_abs": w_max,
                     "weights_share_over_1e-5": w_frac}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=10,
                    help="rounds of the main path and of the fused variant")
    ap.add_argument("--out", default=None, help="write the full report here")
    ap.add_argument("--profile", action="store_true",
                    help="also profile the main path, its fused variant "
                         "and one olmoe round")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.api import ExperimentConfig
    from repro_torch.kernels import _build

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    dev = torch.device("cuda")

    # 2. build
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"build: {len(libs)} kernels from src/repro_torch/kernels/csrc in "
          f"{time.perf_counter() - t0:.2f}s -> {_build.BUILD_DIR}")

    # 3. kernel checks
    rows = kernel_checks(torch, dev)

    # 4-5. the main path and the fused variant
    r = args.rounds
    main_run = drive(torch, "main cut2", ExperimentConfig(
        rounds=r, eval_every=r, cut=2, **MAIN),
        {"feature_resample": 2 * 5 * r, "fused_adam": (2 * 5 + 4) * r,
         "gather_loss": 0})
    fused_run = drive(torch, "fused cut3", ExperimentConfig(
        rounds=r, eval_every=r, cut=3, **MAIN).with_cycle(
            fused_gather_loss=True),
        {"feature_resample": 0, "fused_adam": (1 * 5 + 5) * r,
         "gather_loss": 5 * r})

    profiles = {}
    if args.profile:
        for cut in (2, 3):
            profiles[f"cut{cut}"] = profile_rounds(torch, ExperimentConfig(
                rounds=r, eval_every=r, cut=cut, **MAIN).with_cycle(
                    fused_gather_loss=cut == 3))

    # 6. card against CPU
    parity = card_against_cpu(torch)

    # 7-9. the transformer round, its prefill, card against CPU
    olmoe = olmoe_round(torch, profile=args.profile)
    prefill = olmoe_prefill(torch)
    parity.update(transformer_card_against_cpu(torch))

    sources = {"feature_resample": "src/repro/kernels/feature_resample.py:24",
               "fused_adam": "src/repro/kernels/fused_adam.py:44",
               "gather_loss": "src/repro/kernels/gather_loss.py:47",
               "flash_attention": "src/repro/kernels/flash_attention.py:70",
               "topk_gating": "src/repro/kernels/topk_gating.py:38"}
    kernels = []
    for name, row in rows.items():
        run = {"gather_loss": fused_run, "flash_attention": olmoe,
               "topk_gating": olmoe}.get(name, main_run)
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": sources[name], "launches": run["launches"][name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"nvidia_smi": smi, "torch": torch.__version__,
                       "cuda": torch.version.cuda, "kernels": kernels,
                       "main": main_run, "fused": fused_run,
                       "checks": CHECKS, "olmoe_round": olmoe,
                       "prefill": prefill,
                       "profile": profiles, "card_vs_cpu": parity}, f,
                      indent=1)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
