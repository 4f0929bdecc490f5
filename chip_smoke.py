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
   card, at the shapes the main path, the olmoe and zamba2 rounds and
   the mamba2 prefill give it and at edge cases, with its time, its
   bound and a one-call PyTorch yardstick where one exists, and the
   time of an empty kernel (the launch floor) by the same timers;
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
9. card against CPU for the transformer round: olmoe-1b-7b, gemma2-2b,
   mamba2-2.7b and zamba2-1.2b at smoke size, float32, TF32 off, 2
   rounds;
10. hybrid round: the same as 7 for zamba2-1.2b whole (38 mamba2
    blocks cut after 4 as published, the shared attention block after
    blocks 12 and 25 on the server), bf16, 3 rounds;
11. SSM prefills: ``build_prefill_step`` for zamba2-1.2b and for
    mamba2-2.7b at its full 64 blocks, batch 2, sequence 2048.

It then prints the ``kernels`` JSON line and, last, the device line
``{"ok": true, "device": {...}}``.  Without a card, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""
import argparse
import json
import math
import os
import re
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
# the transformer rounds: cohort 2, batch 2 a client, sequence 2048, 3
# rounds; olmoe-1b-7b at full width with its 16 layers cut to 4, and
# zamba2-1.2b whole
COHORT, BATCH, SEQ, ROUNDS = 2, 2, 2048, 3
OLMOE_DEPTH = 4
# ssd_scan in float32 is held to this share of max|plain| (the f32 sums
# of the kernel's 64-row tiles and the plain version's chunks differ by
# about 1e-6 of it); a dropped diagonal term or a missing carry moves
# the output by far more, which the checks print and assert
SSD_F32_REL = 1e-4
CHECKS = []           # every kernel check of phase 3, for the report
# the __global__ functions of src/repro_torch/kernels/csrc, for profiles
PORT_KERNELS = ("gather_rows_kernel", "fused_adam_kernel",
                "gather_loss_kernel", "flash_wgmma_kernel", "flash_fwd_kernel",
                "topk_gating_kernel", "ssd_wgmma_kernel", "ssd_scan_kernel")


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
    pool = COHORT * BATCH       # rows of the round's feature pool

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
        pool, SEQ, olmoe.d_model, device=dev, generator=gen
    ).bfloat16(), BATCH)
    resample("feature_resample", torch.randint(
        0, olmoe.vocab, (pool, SEQ), device=dev, generator=gen,
        dtype=torch.int32), BATCH)
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
    adam((COHORT, olmoe.vocab_padded, olmoe.d_model), [0, 3],
         dtype=torch.bfloat16)
    adam((COHORT, olmoe.cut_layers, mo.n_experts, olmoe.d_model,
          mo.d_ff_expert), [2, 0], dtype=torch.bfloat16)

    rows["gather_loss"] = gather_loss_checks(torch, dev, gen)
    rows["flash_attention"] = flash_checks(torch, dev, gen)

    rows["topk_gating"] = gating_checks(torch, dev, gen)
    rows["ssd_scan"] = ssd_checks(torch, dev, gen)
    return rows


def gather_loss_checks(torch, dev, gen):
    """``gather_loss`` against its plain version within 1e-4 (float32
    sums in another order): femnist cut 3's head ([80, 2048] x [2048,
    10], idx 16, one row tile split over a cluster), a large server batch
    ([8192, 2048] x [2048, 62], idx 2048), and the design's edges: K past
    one class tile (129, 300), a bias, D not a multiple of the 128-wide
    chunk (16- and 4-byte copies), M = 1, bf16 operands (odd lengths take
    the 2-byte copies), int32 labels; then an index and a label out of range,
    which give NaN on their rows and leave the others as the plain
    version's.  Each line names the launch shape.  Returns femnist's row."""
    from repro_torch.kernels import gather_loss as gl
    from repro_torch.kernels import ops, ref

    def inputs(t, d, k, m, dtype, w_dtype, labels, bias):
        src = torch.relu(torch.randn(t, d, device=dev, generator=gen)
                         ).to(dtype)
        lab = torch.randint(0, k, (t,), generator=gen, device=dev
                            ).to(labels)
        w = (torch.randn(d, k, device=dev, generator=gen) / d ** 0.5
             ).to(w_dtype)
        idx = torch.randint(0, t, (m,), generator=gen, device=dev,
                            dtype=torch.int32)
        b = (torch.randn(k, device=dev, generator=gen) if bias else None)
        return src, lab, w, idx, b

    def case(t, d, k, m, dtype=torch.float32, w_dtype=None,
             labels=torch.int64, bias=False):
        w_dtype = w_dtype or dtype
        src, lab, w, idx, b = inputs(t, d, k, m, dtype, w_dtype, labels, bias)
        nbytes = (len(set(idx.tolist())) * d * src.element_size()
                  + d * k * w.element_size() + m * lab.element_size()
                  + m * 4 + m * 4 + (4 * k if bias else 0))
        shape = gl.card_shape(src, w, m)
        row = check("gather_loss", f"[{t}, {d}] w[{d}, {k}] idx[{m}] "
                    f"{str(dtype)[6:]}" + (f" w {str(w_dtype)[6:]}"
                                           if w_dtype != dtype else "")
                    + f" labels {str(labels)[6:]}" + (" bias" if bias else "")
                    + f" (row tile {gl.ROW_TILE}, k tile {shape['k_tile']}, "
                    f"cluster {shape['cluster']})",
                    lambda: (ops.gather_loss_microbatch(src, lab, idx, w, b),),
                    lambda: (ref.gather_loss_microbatch_ref(src, lab, idx, w,
                                                            b),),
                    1e-4, nbytes, 2 * m * d * k + 6 * m * k, dtype=dtype)
        row["launch"] = {"row_tile": gl.ROW_TILE, **shape}
        return row

    main = case(80, 2048, 10, 16)
    case(8192, 2048, 62, 2048)
    case(37, 33, 7, 19, dtype=torch.bfloat16, labels=torch.int32)
    case(80, 2048, 10, 16, dtype=torch.bfloat16)
    case(80, 2048, 10, 16, dtype=torch.bfloat16, w_dtype=torch.float32)
    case(512, 256, 300, 200, bias=True)
    case(512, 1000, 62, 130, bias=True)
    case(97, 1001, 129, 70, labels=torch.int32)
    case(40, 96, 62, 1)
    case(8192, 2048, 300, 2048, dtype=torch.bfloat16, bias=True)

    # out of range: idx -1 and T, a label K; the other rows as the plain's
    src, lab, w, idx, b = inputs(64, 300, 62, 40, torch.float32,
                                 torch.float32, torch.int64, True)
    lab[int(idx[5])] = 62
    idx[3], idx[7] = -1, 64
    bad = torch.zeros(40, dtype=torch.bool, device=dev)
    bad[3] = bad[7] = True
    bad |= lab[idx.clamp(0, 63).long()] == 62
    got = ops.gather_loss_microbatch(src, lab, idx, w, b)
    keep = ~bad
    want = ref.gather_loss_microbatch_ref(src, lab.clamp(max=61),
                                          idx.clamp(0, 63), w, b)
    torch.cuda.synchronize()
    if not (torch.isnan(got[bad]).all() and torch.isfinite(got[keep]).all()
            and within(got[keep], want[keep], 1e-4)):
        raise AssertionError("gather_loss: an index or label out of range "
                             "must give NaN on its row alone")
    print(f"check gather_loss out of range: {int(bad.sum())} NaN rows of 40, "
          f"the rest within 1e-4 of the plain version")
    return main


def gating_checks(torch, dev, gen):
    """``topk_gating`` against its plain version: ids exactly equal,
    weights within 1e-6, at olmoe's router group ([4096, 64] k 8, the
    returned row), moonshot's (E 64, k 6) and grok-1's (E 8, k 2), and at
    the design's edges: integer (tied) logits, rows all equal, logits so
    spread that most probabilities underflow to +0 (then ids in index
    order), bf16, E not a multiple of a lane's 8 (60, 7, 4), E = 256 with
    k 8 and k = E (the rounds past 8), and T not a multiple of the rows a
    warp takes.  Each line names the lanes a row takes."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.topk_gating import lanes_per_row, topk_gating

    def case(T, E, k, kind="randn", dtype=torch.float32):
        if kind == "tied":
            x = torch.randint(-2, 3, (T, E), device=dev, generator=gen).float()
        elif kind == "equal":
            x = torch.full((T, E), 0.75, device=dev)
        elif kind == "underflow":
            x = torch.randn(T, E, device=dev, generator=gen) * 200
        else:
            x = torch.randn(T, E, device=dev, generator=gen)
        x = x.to(dtype)
        nbytes = x.numel() * x.element_size() + T * k * 8
        got, want = topk_gating(x, k), ref.topk_gating_ref(x, k)
        if not torch.equal(got[1], want[1]):
            raise AssertionError(f"topk_gating [{T}, {E}] k={k} {kind}: ids "
                                 f"differ from the plain version")
        lanes = lanes_per_row(E)
        row = check("topk_gating", f"[{T}, {E}] k={k}"
                    + ("" if kind == "randn" else f" {kind}")
                    + ("" if dtype == torch.float32 else f" {str(dtype)[6:]}")
                    + f" ({lanes} lane{'s' if lanes > 1 else ''} a row, "
                    f"{32 // lanes} row{'s' if lanes < 32 else ''} a warp)",
                    lambda: (topk_gating(x, k)[0],),
                    lambda: (ref.topk_gating_ref(x, k)[0],),
                    1e-6, nbytes, T * E * (4 + 2 * k), dtype=x.dtype)
        row["launch"] = {"lanes_per_row": lanes}
        return row

    main = case(4096, 64, 8)
    case(4096, 8, 2)
    case(4096, 64, 8, "tied")
    case(4096, 64, 6)
    case(4096, 64, 8, dtype=torch.bfloat16)
    case(4093, 64, 8)
    case(1000, 64, 8, "equal")
    case(1000, 64, 8, "underflow")
    case(1000, 60, 6)
    case(1001, 7, 7, "tied")
    case(999, 4, 1)
    case(1000, 256, 8)
    case(300, 256, 256)
    case(333, 16, 16, "tied", torch.bfloat16)
    return main


def launch_floor(torch):
    """Device and eager time of an empty kernel, by the timers of the
    kernel checks: what a launch of a us-scale kernel costs at least."""
    from ctypes import c_void_p
    from repro_torch.kernels import _build
    fn = _build.entry("launch_floor", [c_void_p])

    def run():
        _build.check(fn(torch.cuda.current_stream().cuda_stream),
                     "launch_floor")

    out = {"ms": device_ms(run), "eager_ms": eager_ms(run)}
    print(f"launch floor (empty kernel): {out['ms']:.4f}ms "
          f"(eager {out['eager_ms']:.4f}ms)")
    return out


def flash_checks(torch, dev, gen):
    """``flash_attention`` against its plain version (tolerances of
    tests/test_kernels.py: 2e-2 bf16, 2e-5 float32): the olmoe round's
    heads [2, 2048, 16, 128] and zamba2's [2, 2048, 32, 64], bf16 causal
    (the tensor-core design), and edge cases of the tensor-core kernel's
    tiles (128 query rows as two warpgroups of 64, 128-row key tiles):
    ragged Sq = Sk = 200, Sq 100 / Sk 300, GQA with H / Hkv = 4, a window
    of 100 that starts inside a key tile, softcap 50, no causal mask, and
    q, k, v as strided slices of one fused [B, S, 3, H, D] tensor;
    gemma2's D = 256 and phi3-mini's [2, 2048, 32, 96] causal (the
    CUDA-core design in bf16 too).  Each case runs in float32 too (the
    CUDA-core design), where 2e-5 would catch a key dropped, doubled or
    off by one at a mask's edge.  Before the checks it prints how far
    the plain bf16 output moves when the last key tile is dropped and
    when the diagonal is masked off by one, against 2e-2.  Returns the
    olmoe bf16 row."""
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import design, flash_attention

    def qkv(B, Sq, Sk, H, Hkv, D, dtype, fused):
        if fused:           # one [B, S, 3, H, D] projection, sliced
            t = torch.randn(B, Sq, 3, H, D, device=dev, generator=gen
                            ).to(dtype)
            return t[:, :, 0], t[:, :, 1], t[:, :, 2]
        return (torch.randn(B, Sq, H, D, device=dev, generator=gen).to(dtype),
                torch.randn(B, Sk, Hkv, D, device=dev, generator=gen
                            ).to(dtype),
                torch.randn(B, Sk, Hkv, D, device=dev, generator=gen
                            ).to(dtype))

    def sensitivity(label, q, k, v):
        """What dropping the keys of the last 128-row tile, or masking
        each row's own key (j < i instead of j <= i), moves the plain
        causal output by."""
        want = ref.flash_attention_ref(q, k, v).float()
        cut = k.shape[1] - 128
        drop = ref.flash_attention_ref(q, k[:, :cut], v[:, :cut]).float()
        shift = ref.flash_attention_ref(q[:, 1:], k[:, :-1], v[:, :-1]
                                        ).float()
        d_tile = float((drop - want).abs().max())
        d_diag = float((shift - want[:, 1:]).abs().max())
        print(f"flash_attention {label}: dropping the last key tile moves "
              f"the plain output by {d_tile:.3e}, masking the diagonal off "
              f"by one by {d_diag:.3e}; the bf16 tolerance is 2e-2")
        if not min(d_tile, d_diag) > 2 * 2e-2:
            raise AssertionError("flash_attention: the bf16 tolerance would "
                                 "not catch a dropped tile or diagonal")

    def attention(B, Sq, Sk, H, Hkv, D, dtype, causal=True, window=None,
                  cap=None, main=False, fused=False):
        q, k, v = qkv(B, Sq, Sk, H, Hkv, D, dtype, fused)
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
        if main and dtype == torch.bfloat16:
            sensitivity(f"[{B}, {Sq}, {H}, {D}]", q, k, v)
        kind = design(dtype, D)
        row = check("flash_attention",
                    f"q[{B}, {Sq}, {H}, {D}] kv[{B}, {Sk}, {Hkv}, {D}] "
                    f"{str(dtype)[6:]} causal={causal} window={window} "
                    f"softcap={cap}" + (" fused-qkv" if fused else "")
                    + f" design={kind}",
                    lambda: (flash_attention(q, k, v, **kw),),
                    lambda: (ref.flash_attention_ref(q, k, v, **kw),),
                    2e-2 if dtype == torch.bfloat16 else 2e-5, nbytes,
                    4 * B * H * D * pairs, library=lib, dtype=dtype)
        row["design"] = kind
        return row

    main = attention(2, 2048, 2048, 16, 16, 128, torch.bfloat16, main=True)
    attention(2, 2048, 2048, 16, 16, 128, torch.float32)
    # zamba2-1.2b's shared attention block: 32 heads of 64, causal
    zamba = get_config("zamba2-1.2b")
    for dtype in (torch.bfloat16, torch.float32):
        attention(BATCH, SEQ, SEQ, zamba.n_heads, zamba.n_kv_heads, zamba.hd,
                  dtype, main=True)
    # phi3-mini-3.8b: 32 heads of 96, kv 32, causal
    phi3 = get_config("phi3-mini-3.8b")
    for dtype in (torch.bfloat16, torch.float32):
        attention(BATCH, SEQ, SEQ, phi3.n_heads, phi3.n_kv_heads, phi3.hd,
                  dtype, main=True)
    for dtype in (torch.bfloat16, torch.float32):
        attention(1, 2048, 2048, 8, 4, 256, dtype, window=1024, cap=50.0)
        for D in (64, 128):
            attention(1, 200, 200, 4, 2, D, dtype)
            attention(2, 100, 300, 4, 2, D, dtype)
            attention(1, 512, 512, 8, 2, D, dtype)
            attention(1, 512, 512, 4, 4, D, dtype, window=100)
            attention(1, 512, 512, 4, 4, D, dtype, cap=50.0)
            attention(1, 256, 256, 4, 4, D, dtype, causal=False)
            attention(2, 512, 512, 4, 4, D, dtype, fused=True)
    return main


def ssd_checks(torch, dev, gen):
    """``ssd_scan`` against its plain chunked version, with inputs drawn
    as the model makes them (x, B, C ~ N(0, 1), dt = softplus(N(0, 1)),
    A = -linspace(1, 16, H)): at zamba2-1.2b's and mamba2-2.7b's shapes
    (batch 2, sequence 2048, their chunk 256, G = 1; x, B and C as the
    column slices of one conv output that the model passes), in bf16 and
    float32; with B and C per head (G = H, the TPU kernel's contract); a
    single chunk; chunk 64; a slow decay (A = -1e-3), where the state
    grows over 2048 steps; and a ragged shape (L, P and N not multiples
    of the kernel's tiles).  bf16 at the paths' (N, P) runs on the
    tensor-core design, which is also held, in bf16, with B and C per
    head, in a single chunk, at chunk 64, at the slow decay, and at L =
    96 with chunk 32 (a half-filled last 64-row tile); the ragged shape
    stays float32.  float32 outputs are held to SSD_F32_REL of
    max|plain|, after printing what a dropped diagonal term and a
    missing inter-chunk carry move the output by at the main shape;
    bf16 y to one bf16 ulp (the float32 sums differ in the last bits and
    flip a rounding now and then) and its float32 state to SSD_F32_REL
    of max|y, h|."""
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import design, ssd_scan

    def inputs(B, L, H, P, N, G, dtype, A, sliced):
        if sliced:          # column slices of one [B, L, conv_ch] tensor
            flat = torch.randn(B, L, H * P + 2 * G * N, device=dev,
                               generator=gen).to(dtype)
            x, bm, cm = torch.split(flat, [H * P, G * N, G * N], dim=-1)
            x = x.reshape(B, L, H, P)
            bm, cm = bm.reshape(B, L, G, N), cm.reshape(B, L, G, N)
        else:
            x = torch.randn(B, L, H, P, device=dev, generator=gen).to(dtype)
            bm = torch.randn(B, L, G, N, device=dev, generator=gen).to(dtype)
            cm = torch.randn(B, L, G, N, device=dev, generator=gen).to(dtype)
        dt = F.softplus(torch.randn(B, L, H, device=dev, generator=gen))
        if A is None:
            A = -torch.linspace(1.0, 16.0, H, device=dev)
        return x, dt, A.to(device=dev, dtype=torch.float32), bm, cm

    def sensitivity(x, dt, A, bm, cm, chunk, want, scale):
        """What dropping the diagonal term (C_i . B_i) dt_i x_i, or the
        state carried into each chunk, moves the output by."""
        rep = x.shape[2] // bm.shape[2]
        cb = torch.einsum("blgn,blgn->blg", cm.float(), bm.float())
        diag = (cb.repeat_interleave(rep, dim=2) * dt)[..., None] * x.float()
        h0 = torch.zeros((x.shape[0], x.shape[2], bm.shape[3], x.shape[3]),
                         device=dev)
        fresh = torch.cat([ref.ssd_chunk(h0, x[:, lo:lo + chunk],
                                         dt[:, lo:lo + chunk], A,
                                         bm[:, lo:lo + chunk],
                                         cm[:, lo:lo + chunk])[0]
                           for lo in range(0, x.shape[1], chunk)], dim=1)
        return (float(diag.abs().max()) / scale,
                float((fresh - want.float()).abs().max()) / scale)

    def scan(label, B, L, H, P, N, G, dtype, chunk, A=None, sliced=False,
             main=False):
        x, dt, A, bm, cm = inputs(B, L, H, P, N, G, dtype, A, sliced)
        want = ref.ssd_chunked(x, dt, A, bm, cm, chunk)
        scale = max(float(w.float().abs().max()) for w in want)
        if main:
            drop_diag, no_carry = sensitivity(x, dt, A, bm, cm, chunk,
                                              want[0], scale)
            print(f"ssd_scan {label}: a dropped diagonal term moves y by "
                  f"{drop_diag:.3e} of max|y|, a missing carry by "
                  f"{no_carry:.3e}; the f32 tolerance is {SSD_F32_REL:.0e}")
            if not SSD_F32_REL <= 0.1 * min(drop_diag, no_carry):
                raise AssertionError("ssd_scan: the f32 tolerance would not "
                                     "catch a dropped term or carry")
        el = x.element_size()
        # the function's least work, independent of the chunk: the
        # recurrence's decay and dt B x^T update of h (3 N P a row and
        # head) and y = C h (2 N P); a chunked form does more
        flops = 5 * B * L * H * N * P
        nbytes = (2 * x.numel() * el + (bm.numel() + cm.numel()) * el
                  + 4 * (dt.numel() + A.numel() + B * H * N * P))
        kind = design(dtype, N, P)
        row = check("ssd_scan", f"{label} x[{B}, {L}, {H}, {P}] "
                    f"B/C[{B}, {L}, {G}, {N}] {str(dtype)[6:]} chunk {chunk}"
                    + (" sliced" if sliced else "") + f" design={kind}",
                    lambda: ssd_scan(x, dt, A, bm, cm, chunk=chunk),
                    lambda: ref.ssd_chunked(x, dt, A, bm, cm, chunk),
                    SSD_F32_REL * scale, nbytes, flops, dtype=dtype,
                    ulps=1 if dtype == torch.bfloat16 else None)
        row["max_rel_err"] = row["max_abs_err"] / scale
        row["design"] = kind
        got = ssd_scan(x, dt, A, bm, cm, chunk=chunk)
        row["y_rel_err"], row["h_rel_err"] = (
            float((g.double() - w.double()).abs().max()) / scale
            for g, w in zip(got, want))
        print(f"ssd_scan {label}: max|y, h| {scale:.4g}, error "
              f"{row['max_rel_err']:.3e} of it (y {row['y_rel_err']:.3e}, "
              f"final state {row['h_rel_err']:.3e})")
        return row

    def dims(arch):
        """(B, L, H, P, N, G) of the model's scan, and its chunk."""
        c = get_config(arch)
        s = c.ssm
        H = s.expand * c.d_model // s.head_dim
        return (BATCH, SEQ, H, s.head_dim, s.d_state, s.n_groups), s.chunk

    (zb, chunk), (mb, _) = dims("zamba2-1.2b"), dims("mamba2-2.7b")
    B, L, H, P, N, _ = zb
    main = scan("zamba2", *zb, torch.bfloat16, chunk, sliced=True)
    scan("zamba2", *zb, torch.float32, chunk, sliced=True, main=True)
    scan("mamba2", *mb, torch.bfloat16, chunk, sliced=True)
    scan("mamba2", *mb, torch.float32, chunk, sliced=True)
    for dtype in (torch.float32, torch.bfloat16):
        scan("per-head B/C (G = H)", B, L, H, P, N, H, dtype, chunk)
        scan("one chunk", B, chunk, H, P, N, 1, dtype, chunk)
        scan("chunk 64", B, L, H, P, N, 1, dtype, 64)
        scan("slow decay A = -1e-3", B, L, H, P, N, 1, dtype, chunk,
             A=torch.full((H,), -1e-3))
    scan("half-filled last tile", 1, 96, 3, 64, 64, 1, torch.bfloat16, 32)
    scan("ragged", 1, 96, 3, 48, 20, 1, torch.float32, 32)
    return main


def counters():
    from repro_torch.kernels import (feature_resample, flash_attention,
                                     fused_adam, gather_loss, ssd_scan,
                                     topk_gating)
    return {"feature_resample": feature_resample, "fused_adam": fused_adam,
            "gather_loss": gather_loss, "flash_attention": flash_attention,
            "topk_gating": topk_gating, "ssd_scan": ssd_scan}


def reset_counters():
    for mod in counters().values():
        mod.launches = 0
        for kind in getattr(mod, "design_launches", {}):
            mod.design_launches[kind] = 0


def read_counters():
    """Launches by kernel, and flash_attention's and ssd_scan's also by
    design (``flash_attention/wgmma``, ``ssd_scan/simt``, ...)."""
    out = {}
    for k, mod in counters().items():
        out[k] = mod.launches
        for kind, n in getattr(mod, "design_launches", {}).items():
            out[f"{k}/{kind}"] = n
    return out


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
    # the port's own kernels, however small, by their function names
    ours = [{"name": fn, "count": c, "device_ms": t / 1e3}
            for n, c, t in rows for fn in PORT_KERNELS
            if re.search(rf"\b{fn}\b", n)]
    for r in ours:
        print(f"profile {label}: port kernel {r['name']} {r['count']}x "
              f"{r['device_ms']:.3f}ms ({r['device_ms'] * 1e3 / busy:.2%} of "
              f"device busy)")
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "top": [{"name": n, "count": c, "device_ms": t / 1e3}
                    for n, c, t in rows[:25]], "port_kernels": ours}


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


def block_launches(cfg, lo, hi):
    """Kernel launches of one forward through blocks [lo, hi): an
    attention block launches flash_attention once (and topk_gating once
    when it is MoE), a mamba2 block ssd_scan once, and the hybrid
    family's shared attention block flash_attention once after each of
    its positions inside the range.  Nothing is checkpointed, so no
    forward runs twice, and the backwards recompute plain versions,
    which launch nothing."""
    import torch
    from repro_torch.models.transformer import block_kind
    kind, n = block_kind(cfg), hi - lo
    if kind in ("mamba", "hybrid"):
        shared = cfg.ssm.shared_attn_positions if kind == "hybrid" else ()
        out = {"ssd_scan": n, "topk_gating": 0,
               "flash_attention": sum(lo <= p < hi for p in shared)}
    else:
        out = {"ssd_scan": 0, "flash_attention": n,
               "topk_gating": n if kind == "moe" else 0}
    # bf16 attention at head_dim 64 or 128 (olmoe, zamba2) and the bf16
    # SSD scan at (N, P) = (64, 64) or (128, 64) (zamba2, mamba2-2.7b) run
    # on the tensor cores, every launch of them
    bf16 = cfg.torch_dtype == torch.bfloat16
    tc = {"flash_attention": bf16 and cfg.hd in (64, 128),
          "ssd_scan": bf16 and cfg.ssm is not None and (
              cfg.ssm.d_state, cfg.ssm.head_dim) in ((64, 64), (128, 64))}
    for k, on in tc.items():
        out[f"{k}/wgmma"] = out[k] if on else 0
        out[f"{k}/simt"] = 0 if on else out[k]
    return out


def split_round(torch, label, cfg, rounds=ROUNDS, profile=False):
    """A transformer path: ``build_train_step`` for ``cfg`` (its
    published cut), cohort 2, batch 2 a client, sequence 2048; random
    init on the card, tokens from a numpy seed; ``rounds`` CycleSL
    rounds with the launch counters reset before and read after.

    Expected launches per round: the client blocks [0, cut) run C times
    in the extract and C times in the client VJPs, the server blocks
    [cut, L) once in each of the steps = C * b / server batch server
    steps and C times in the feature gradients, each forward launching
    ``block_launches``; feature_resample gathers features and labels
    once a server step; fused_adam steps every server leaf once a server
    step and every stacked client leaf once; gather_loss never runs (no
    linear server head).  olmoe-1b-7b at depth 4, cut 2: 16 block
    forwards a round, each one flash_attention and one topk_gating
    launch.  zamba2-1.2b, 38 blocks cut after 4: 8 + 68 + 68 + 8 = 152
    ssd_scan launches a round, and flash_attention 2 * (steps + C) = 8
    (the shared block after blocks 12 and 25, both on the server)."""
    from repro_torch.configs import InputShape
    from repro_torch.core.cyclesl import CycleConfig
    from repro_torch.launch.steps import build_train_step
    from repro_torch.utils.tree import tree_leaves
    L, cut, C, b = cfg.n_layers, cfg.cut_layers, COHORT, BATCH
    shape = InputShape(label, SEQ, C * b, "train")
    cycle = CycleConfig(server_epochs=1, server_batch=b)
    bundle = build_train_step(cfg, shape, cycle, cohort=C, device="cuda")
    torch.cuda.empty_cache()
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
    client, srv = block_launches(cfg, 0, cut), block_launches(cfg, cut, L)
    per_round = {k: 2 * C * client[k] + (steps + C) * srv[k] for k in client}
    expect = {k: n * rounds for k, n in per_round.items()}
    expect.update(feature_resample=2 * steps * rounds, gather_loss=0,
                  fused_adam=(len(tree_leaves(server.params)) * steps
                              + len(tree_leaves(clients.params))) * rounds)
    batches = [bundle.make_batch(r) for r in range(rounds)]
    torch.cuda.synchronize()
    reset_counters()
    stamps, metrics = [time.perf_counter()], []
    for r in range(rounds):
        xs, ys = batches[r]
        server, clients, m = bundle.fn(server, clients, xs, ys, r)
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        metrics.append({k: float(v) for k, v in m.items()})
    launches = read_counters()
    peak = torch.cuda.max_memory_allocated()
    rps = (rounds - 1) / (stamps[-1] - stamps[1])
    tokens = C * b * SEQ
    print(f"{label}: {cfg.name} L={L} cut={cut} d={cfg.d_model}, params "
          f"{n_client:,} a client, {n_server:,} the server; C={C} b={b} "
          f"S={SEQ} {cfg.dtype}; init {init_s:.2f}s; entity states "
          f"{state_bytes / 1e9:.2f} GB")
    for r, m in enumerate(metrics):
        print(f"{label} {r + 1}: {stamps[r + 1] - stamps[r]:.3f}s "
              + " ".join(f"{k}={v:.6g}" for k, v in m.items()))
    print(f"{label}: rounds 2..{rounds} at {rps:.3f} rounds/s, "
          f"{rps * tokens:.1f} tokens/s; peak memory {peak / 1e9:.2f} GB; "
          f"launches {launches} (expected {expect}; a round: client blocks "
          f"{client} x {2 * C}, server blocks {srv} x {steps + C})")
    vals = [v for m in metrics for v in m.values()]
    if not all(math.isfinite(x) for x in vals):
        raise AssertionError(f"{label}: non-finite metrics {metrics}")
    for k, n in expect.items():
        if launches[k] != n:
            raise AssertionError(f"{label}: {k} launched {launches[k]} "
                                 f"times, expected {n}")
    prof = None
    if profile:                 # one more round, after the counted ones
        prof = device_profile(torch, label, lambda: bundle.fn(
            server, clients, *batches[0], 0))
    return {"profile": prof, "config": {
                "arch": cfg.name, "n_layers": L, "cut": cut, "cohort": C,
                "batch": b, "seq": SEQ, "server_steps": steps,
                "dtype": cfg.dtype},
            "params_client": n_client, "params_server": n_server,
            "state_bytes": state_bytes, "init_s": init_s,
            "round_s": [b - a for a, b in zip(stamps, stamps[1:])],
            "rounds_per_s": rps, "tokens_per_s": rps * tokens,
            "peak_bytes": peak, "metrics": metrics, "launches": launches,
            "expected_launches": expect}


def prefill(torch, label, cfg):
    """``build_prefill_step`` for ``cfg``, batch 2, sequence 2048: one
    forward through every block (``block_launches`` of [0, L))."""
    from repro_torch.configs import InputShape
    from repro_torch.launch.steps import build_prefill_step
    shape = InputShape(label, SEQ, BATCH, "prefill")
    bundle = build_prefill_step(cfg, shape, device="cuda")
    torch.cuda.empty_cache()
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
    want = block_launches(cfg, 0, cfg.n_layers)
    print(f"{label}: {cfg.name} L={cfg.n_layers} B={BATCH} S={SEQ}: "
          f"last-token logits {list(logits.shape)} {str(logits.dtype)[6:]} "
          f"finite={ok} in {ms:.2f} ms ({BATCH * SEQ / ms * 1e3:.0f} "
          f"tokens/s); launches {launches} (expected {want})")
    if not ok or tuple(logits.shape) != (BATCH, cfg.vocab):
        raise AssertionError(f"{label}: logits not finite or of the wrong "
                             f"shape")
    for k, n in want.items():
        if launches[k] != n:
            raise AssertionError(f"{label}: {k} launched {launches[k]} "
                                 f"times, expected {n}")
    return {"ms": ms, "launches": launches, "shape": list(logits.shape)}


def transformer_card_against_cpu(torch):
    """Two rounds of the transformer round on the CPU (plain versions)
    and on the card (kernels), float32 with TF32 off, from one init
    drawn on the CPU and with one plan, for olmoe-1b-7b, gemma2-2b,
    mamba2-2.7b and zamba2-1.2b at smoke size (gemma2 4 deep, so the
    server holds a local and a global block; zamba2's shared attention
    after block 1 on the server; the sequence of 64 is two of the SSM
    configs' 32-row chunks, so the state carries).  Per-round metrics
    must agree to rtol 1e-4 (the feature-
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
    for arch, depth in (("olmoe-1b-7b", 2), ("gemma2-2b", 4),
                        ("mamba2-2.7b", 2), ("zamba2-1.2b", 4)):
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
                         "and one olmoe and one zamba2 round")
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

    # 3. kernel checks, and the launch floor they are read against
    rows = kernel_checks(torch, dev)
    floor = launch_floor(torch)

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
    from repro_torch.configs import get_config
    olmoe_cfg = get_config("olmoe-1b-7b").with_(n_layers=OLMOE_DEPTH)
    olmoe = split_round(torch, "olmoe round", olmoe_cfg,
                        profile=args.profile)
    prefills = {"olmoe-1b-7b": prefill(torch, "olmoe prefill", olmoe_cfg)}
    parity.update(transformer_card_against_cpu(torch))

    # 10-11. the hybrid round (zamba2-1.2b whole) and the SSM prefills
    zamba = split_round(torch, "zamba2 round", get_config("zamba2-1.2b"),
                        profile=args.profile)
    for arch in ("zamba2-1.2b", "mamba2-2.7b"):
        prefills[arch] = prefill(torch, f"{arch.split('-')[0]} prefill",
                                 get_config(arch))

    sources = {"feature_resample": "src/repro/kernels/feature_resample.py:24",
               "fused_adam": "src/repro/kernels/fused_adam.py:44",
               "gather_loss": "src/repro/kernels/gather_loss.py:47",
               "flash_attention": "src/repro/kernels/flash_attention.py:70",
               "topk_gating": "src/repro/kernels/topk_gating.py:38",
               "ssd_scan": "src/repro/kernels/ssd_scan.py:61"}
    kernels = []
    for name, row in rows.items():
        run = {"gather_loss": fused_run, "flash_attention": olmoe,
               "topk_gating": olmoe, "ssd_scan": zamba}.get(name, main_run)
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": sources[name], "launches": run["launches"][name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            **({"design": row["design"]} if "design" in row else {})})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"nvidia_smi": smi, "torch": torch.__version__,
                       "cuda": torch.version.cuda, "kernels": kernels,
                       "main": main_run, "fused": fused_run,
                       "checks": CHECKS, "olmoe_round": olmoe,
                       "zamba2_round": zamba, "prefill": prefills,
                       "profile": profiles, "card_vs_cpu": parity,
                       "launch_floor": floor}, f,
                      indent=1)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
