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
   card, at the shapes the main path, the olmoe, zamba2 and whisper
   rounds, the mamba2 prefill, whisper's decode and the resnet9 and
   celeba workloads give it and at edge cases, with its time, its bound and a one-call PyTorch
   yardstick where one exists, and the time of an empty kernel (the
   launch floor) by the same timers;
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
    mamba2-2.7b at its full 64 blocks, batch 2, sequence 2048;
12. the algorithm zoo: ``Engine.run()`` of each of the ten programs at
    the main path's configuration, with the launch counters reset
    before and read after, then psl, cyclepsl, cyclesglr and ssl again
    under variable attendance (padded slots drawn), and the time of the
    per-client store's commit scatter;
13. card against CPU for every program, as in 6, under variable
    attendance with a padded slot drawn;
14. the paper's other workloads: ``Engine.run()`` at the main path's
    protocol (100 clients, cohort 5, batch 16) of cifar (resnet9 width
    64) and charlm (the Shakespeare LSTM) with cyclesfl and sflv1, gaze
    (the mlp under the mse loss) with cyclepsl and psl, resnet9 at each
    of its six cuts, cifar with the host syncing every 5 rounds, and
    celeba_cnn (width 32, 84 px) at cut 1 and at cut 4 with
    ``fused_gather_loss``, each with exact launch counts from its
    task's leaves and the Engine's ``round_time_s``;
15. card against CPU for each of those tasks, as in 13;
16. serving at full width, bf16, random init: ``ServeRuntime`` (8
    slots, prompt and generation budgets 64, prefill chunks of 4) under
    ``run_closed_loop`` at concurrency 8, over 24 requests of
    olmoe-1b-7b whole and 8 of zamba2-1.2b whole, with the schedule and
    the exact ``topk_gating`` launches checked; gemma2-2b whole through
    ``launch.serve.serve_decoder_only`` (batch 4, prompt 64, 32 steps);
17. decode against ``Transformer.forward`` (teacher forcing) on the card
    at full width for olmoe-1b-7b and zamba2-1.2b, and the runtime card
    against CPU at the smoke configs of olmoe, zamba2 and gemma2;
18. checkpoints and resume at the main path's width (cyclesfl,
    femnist_cnn width 32, 10 rounds, a checkpoint every 2): the unbroken
    run twice, 4 rounds then a resumed Engine, a torn checkpoint the
    restore falls back past, the SIGKILL harness
    (``repro_torch.resilience.harness``) in processes of its own, and
    ``save_checkpoint``/``load_checkpoint`` ms per step;
19. the resilience runtime on the main path (24 rounds) under the
    reference bench's six configs: guard off and on in turns with their
    round_time_s, each faulted config's summary against the faults the
    deterministic stream fires, with launch counts and recovery ms per
    faulted round; a quarantined NaN slot through gather_loss at cut 3;
    card against CPU for nan_quarantine and nan_rollback, as in 13;
20. ``run_population`` at 100,000 clients (cohort 32, batch 8, mlp
    width 32, 12 rounds) under no churn, dropout, stragglers (also
    pipelined async at depth 1, max realized lag 1) and diurnal churn:
    rounds/s, the sampler's ms, clients materialized and telemetry equal
    to a CPU run's; then, under the profiler, the guard's launches a
    round and a population round's busy share;
21. whisper-base whole (6 + 6 blocks, d 512, bf16, random init):
    ``build_train_step`` (cohort 2, batch 2 a client, 1500 frames, 448
    text positions, 3 rounds) with exact flash_attention,
    feature_resample and fused_adam launches, the prefill (batch 2), the
    decode step (batch 8 over a context of 448) and
    ``launch.serve.serve_whisper`` (batch 4, 32 steps);
22. whisper card against CPU (the smoke config, as in 9) and teacher
    forcing at full width (16 decode steps against the forward);
23. the pipelined rounds on the main path: sync against sequential and
    async on the side stream against one stream, bit for bit; rounds/s
    of sequential, sync and async in turns; pipelined resume; NaN-faulted
    pipelined runs recovered;
24. the round on a device mesh over NCCL, in a process of its own: a
    (1, 1) mesh on the main path (cut 2, and cut 3 fused) and the ten
    programs at phase 13's protocol, gather-everything and shard-local
    resample, each bit for bit the unsharded port with exact launches
    and its collectives' census a round; rounds/s of the mesh against
    unsharded in turns; with two cards or more, the ten programs on
    min(cards, 4) ranks within 1e-5 of one rank;
25. the ``model`` axis, in a process of its own: a (1, 1) mesh through
    the tensor- and expert-parallel code at olmoe-1b-7b's full width
    (depth 4, bf16, 3 rounds and the prefill), bit for bit the
    unsharded steps with their launches; flash_attention, fused_adam
    and topk_gating at a rank's shapes on a model axis of 2 and 4; with
    two cards or more, on (1, n) (n = 4 where there are four, else 2):
    the smoke config within 1e-5 of unsharded (loss, every gradient,
    prefill logits), full width at depth 4 against the unsharded run,
    and olmoe-1b-7b whole (16 blocks) for 3 rounds with exact launches,
    its census held to the count written beside ``tp_census``, peak
    memory a card, rounds/s, tokens/s and the prefill; with four cards
    also on (2, 2), FSDP over ``data`` beside the model axis;
26. the Engine on the reference's 2-D mesh, in a process of its own: a
    (1, 1) mesh on the main path bit for bit the unsharded Engine; with
    four cards (2, 2), (4, 1) and (1, 4), with two (1, 2): the main
    path held to unsharded with exact launches and census, and the ten
    programs on (2, 2);
27. the Mamba-2, hybrid and whisper steps on the ``model`` axis, in a
    process of its own: a (1, 1) mesh through the head-parallel code
    for zamba2-1.2b whole and whisper-base whole (bf16, 3 rounds and
    the prefill), bit for bit the unsharded steps with their launches;
    ssd_scan and flash_attention at a rank's shapes on a model axis of
    2 and 4; with four cards zamba2-1.2b and whisper-base whole on (1,
    4) and (2, 2), whisper-base on (4, 1) (FSDP alone) and mamba2-2.7b
    at depth 8 on (1, 4) (two cards: (1, 2)), each held to the unsharded
    run, its planted fault (the B/C branch's gradient sum dropped in a
    Mamba model) refused, its census held to ``ssm_tp_census``;
28. decode and the serving slot table on a mesh, in a process of its
    own: a (1, 1) mesh through ``ServeRuntime`` (olmoe-1b-7b whole,
    phase 16's stream of one wave) and ``build_decode_step`` (olmoe,
    zamba2-1.2b, whisper-base whole, mamba2-2.7b at depth 8), bit for
    bit the unsharded runs with their launches and no collective;
    topk_gating at a rank's serving rows; with four cards olmoe-1b-7b
    and zamba2-1.2b whole served on (1, 4) and (2, 2) with phase 16's
    config and stream, whisper-base and mamba2-2.7b decoding on (1, 4):
    teacher-forced bf16 logits held to unsharded by phase 17's yardstick,
    a served stream parting from the unsharded one only where the
    unsharded top-2 gap lies within it, every rank alike, the census a
    tick, ms a tick, tokens/s, TTFT and peak memory a card, and a
    decode without its attention's (Mamba's) reduce refused;
29. the Engine's pipelined rounds, health guard and recovery,
    checkpoints and scenarios on a mesh, in a process of its own: the
    Engine at its defaults (femnist width 16, cut 2) pipelined sync at
    depth 2, guarded under phase 19's fault rates with torn checkpoints,
    at cut 3 with ``fused_gather_loss`` guarded and pipelined async at
    depth 1, and cyclepsl under diurnal churn checkpointed and resumed: on a
    (1, 1) mesh bit for bit the unsharded Engine with its launches as
    counted and no collective of its own; the kernels of the pipelined
    olmoe steps at a rank's shapes on (2, 2); with four cards every run
    on (2, 2) and (4, 1) held to unsharded, every rank's host outcomes
    the unsharded run's, a resume bit for bit the unbroken run on its
    mesh, the census a round, rounds/s beside unsharded, the guard's
    flag left unsummed over ``model`` refused, and olmoe-1b-7b at depth
    4 through ``build_pipelined_train_steps(mesh=)`` on (2, 2) bit for
    bit ``build_train_step(mesh=)``;
30. the tooling (``utils.profiling``, ``utils.cost``, ``launch.dryrun``,
    ``launch.roofline``): the Engine at the main path's width (cut 2,
    and cut 3 fused) with a ``RoundProfiler``, bit for bit the
    unprofiled run, its sections and call counts a CPU run's,
    ``phase_costs`` by phase; the olmoe and zamba2 rounds of phases 7
    and 10 against the dry run of the same step on ``meta``: state bytes
    exactly, the peak estimate within 25%, ``count`` on the card equal
    to ``count`` on meta, the round at 0.95 or more of its roofline
    time, and its MFU.  Phase 3's bounds come from
    ``utils.cost.kernel_cost`` and ``launch.roofline``'s peaks;
31. the attention split over kv head groups (glm4-9b's 2 kv heads on a
    model axis of 4), in a process of its own: a (1, 1) mesh through
    the same code at depth 4, bit for bit the unsharded run; with four
    cards, on (1, 4), depth 4 held to one card by phase 25's criteria
    with each kv group's copies bit-equal and the group's gradient sum
    dropped refused, glm4-9b whole for 3 rounds with its census as
    predicted and a card's peak under 80 GB and within 5% of the dry
    run's, and its teacher-forced and served decode held to one card by
    phase 28's criteria;
32. the donated TrainState, in a process of its own: the in-place Adam
    entry (``fused_adam_``) bit-equal to the out-of-place kernel at the
    femnist, olmoe client and olmoe rank shapes, a slot whose ``keep``
    flag is 0 untouched, against its plain version, both entries' device
    ms; the Engine at its defaults (donated) bit-equal to
    ``donate=False`` at cut 2, cut 3 fused, cyclepsl with padded slots
    and pipelined sync and async, every fused_adam launch in place, and
    a guarded run with donation off; glm4-9b at depth 4 through the
    train step's ``donated()`` bit-equal to its ``fn``; with four cards,
    glm4-9b at depth 4 on (2, 2) donated bit-equal to undonated and held
    to one card by phase 25's criteria, and glm4-9b and olmoe-1b-7b
    whole on (2, 2) and (1, 4), donated, each card's peak against the
    donated dry run's (glm4-9b within 5%);
33. the redesigned fused_adam, in a process of its own: both entries at
    phase 32a's shapes and at edge shapes that force a row's scalar head
    and tail (one element, entities of 5 f32 and of 1001 bf16), against
    the plain version, in place bit-equal to out of place, a kept slot
    untouched, views one element into a larger buffer bit-equal to the
    aligned run (the scalar path against the vector path), each kernel's
    registers and 16-byte accesses, and the device ms of both entries and
    of ``Adam(fused=True, capturable=True)`` in one call;
34. rematerialisation (``models.module.remat``), in a process of its
    own: olmoe-1b-7b at depth 4, zamba2-1.2b and whisper-base whole at
    phase 7's protocol, each run as the port runs it, with
    ``module.remat`` swapped for a plain call, and as the port again,
    in turns: the states after 3 rounds bit for bit the same, a lower
    ``max_memory_allocated`` with remat (the round's, where activations
    set it, and the feature gradients' pass's), the launches by kernel
    as counted with and without the recompute, and rounds/s both ways
    (``remat_dry_runs`` gives the dry run's side on any machine).
    Phase 32's four-card runs print their peaks beside those measured
    before remat.

It then prints the ``kernels`` JSON line and, last, the device line
``{"ok": true, "device": {...}}``.  Without a card, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""
import argparse
import contextlib
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

MAIN = dict(n_clients=100, attendance=0.05, batch=16, width=32)
# the transformer rounds: cohort 2, batch 2 a client, sequence 2048, 3
# rounds; olmoe-1b-7b at full width with its 16 layers cut to 4, and
# zamba2-1.2b whole
COHORT, BATCH, SEQ, ROUNDS = 2, 2, 2048, 3
OLMOE_DEPTH = 4
# whisper-base's inputs: 1500 encoder frames, 448 decoder positions
WHISPER_FRAMES, WHISPER_TEXT = 1500, 448
# ssd_scan in float32 is held to this share of max|plain| (the f32 sums
# of the kernel's 64-row tiles and the plain version's chunks differ by
# about 1e-6 of it); a dropped diagonal term or a missing carry moves
# the output by far more, which the checks print and assert
SSD_F32_REL = 1e-4
CHECKS = []           # every kernel check of phase 3, for the report


def port_kernels() -> tuple:
    """The ``__global__`` functions of the port's kernel sources
    (``_build.SOURCES`` under src/repro_torch/kernels/csrc), read from the
    sources so that a profile names every one of them."""
    from repro_torch.kernels import _build
    names = []
    for src in _build.SOURCES:
        names += re.findall(r"__global__\s+void\s+(?:__launch_bounds__\("
                            r"[^)]*\)\s+)?(\w+)\s*\(",
                            (_build.CSRC / f"{src}.cu").read_text())
    return tuple(names)


def port_kernel_of(name, kernels) -> str | None:
    """The port kernel (one of ``kernels``) that a profiler's kernel name
    (demangled, template arguments and all) launched, or None."""
    return next((fn for fn in kernels if re.search(rf"\b{fn}\b", name)),
                None)


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


def kernel_cost(name, *args, **kw):
    """``utils.cost.kernel_cost``: a kernel call's (flops, bytes, dtype),
    the one source of the checks' bounds."""
    from repro_torch.utils.cost import kernel_cost as cost
    return cost(name, *args, **kw)


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


def check(name, shape, kernel, plain, tol, cost, library=None, ulps=None):
    """Run ``kernel`` and ``plain`` once on the same inputs, compare,
    time both (and ``library``) on the device, and print one line.
    ``cost`` is the call's ``utils.cost.kernel_cost`` (flops, bytes,
    dtype), read against ``launch.roofline``'s peaks for the bound.
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
    from repro_torch.launch.roofline import bound
    flops, nbytes, dtype = cost
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
        return check(name, f"{list(src.shape)} {str(src.dtype)[6:]} idx[{m}]",
                     lambda: (ops.resample_rows(src, idx),),
                     lambda: (ref.feature_resample_ref(flat, idx)
                              .reshape((m,) + tuple(src.shape[1:])),),
                     0.0, kernel_cost("feature_resample", flat, idx),
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
    # the whisper round's server step: the pooled bf16 encoder states
    # [C * b, 1500, 512] (1.5 MB rows) and the int32 decoder tokens and
    # labels [C * b, 448], server batch b
    whisper = get_config("whisper-base")
    resample("feature_resample", torch.randn(
        pool, WHISPER_FRAMES, whisper.d_model, device=dev, generator=gen
    ).bfloat16(), BATCH)
    resample("feature_resample", torch.randint(
        0, whisper.vocab, (pool, WHISPER_TEXT), device=dev, generator=gen,
        dtype=torch.int32), BATCH)
    # rows too short or misaligned for wide vectors: the 2- and 1-byte paths
    resample("feature_resample", torch.randn(38, 13, device=dev,
                                             generator=gen).bfloat16()[1:], 16)
    resample("feature_resample", torch.randint(0, 100, (81, 3), device=dev,
                                               generator=gen).to(torch.uint8),
             16)
    # resnet9 at cut 1, width 64: NHWC [32, 32, 64] f32 rows of 256 KB;
    # gaze's float32 [2] targets, rows of 8 bytes
    resample("feature_resample", torch.relu(torch.randn(
        80, 32, 32, 64, device=dev, generator=gen)), 16)
    resample("feature_resample", torch.randn(80, 2, device=dev,
                                             generator=gen), 16)

    # ---- fused_adam: the server's dense leaves and a client stack.  A
    # bfloat16 p' is held to one bf16 ulp of the plain version's, or 1e-6
    # near zero (the float32 sums differ in their last bit, which flips a
    # rounding now and then), and the float32 moments to 1e-6: an
    # absolute 2e-2 would pass an update (lr 1e-3) wrong altogether
    def adam(shape, steps, dtype=torch.float32, library=False, wd=0.0):
        p = torch.randn(shape, device=dev, generator=gen).to(dtype)
        g = torch.randn(shape, device=dev, generator=gen).to(dtype)
        m = torch.randn(shape, device=dev, generator=gen) * 0.1
        v = torch.rand(shape, device=dev, generator=gen) * 0.1
        step = torch.tensor(steps, dtype=torch.int32, device=dev)
        lib = None
        if library:
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
                     1e-6, kernel_cost("fused_adam", p, g, m, v, step),
                     library=lib, ulps=1)

    rows["fused_adam"] = adam((3136, 2048), 3, library=True)
    adam((2048, 10), 3)
    adam((5, 5, 5, 32, 64), [0, 1, 2, 3, 4])
    adam((5, 3136, 2048), [4, 4, 4, 9, 0])
    adam((3136, 2048), 3, dtype=torch.bfloat16)
    adam((2048, 10), 7, wd=0.01)
    # resnet9 at width 64: res2's [3, 3, 512, 512] convs (server) and the
    # client stack's BatchNorm vectors [C, 128]
    adam((3, 3, 512, 512), 3, library=True)
    adam((5, 128), [0, 1, 2, 3, 4])
    # the olmoe round's client slots: bf16 leaves stacked [C, ...] with f32
    # moments and a step per slot; the embedding, and the gate projections
    # of the client's experts (2^29 elements, 2^31 bytes a moment)
    mo = olmoe.moe
    adam((COHORT, olmoe.vocab_padded, olmoe.d_model), [0, 3],
         dtype=torch.bfloat16, library=True)
    adam((COHORT, olmoe.cut_layers, mo.n_experts, olmoe.d_model,
          mo.d_ff_expert), [2, 0], dtype=torch.bfloat16)
    # the whisper round: the decoder's bf16 embedding (server) and the
    # encoder's stacked ffn input projections of the client slots
    adam((whisper.vocab_padded, whisper.d_model), 3, dtype=torch.bfloat16,
         library=True)
    adam((COHORT, whisper.enc_layers, whisper.d_model, whisper.d_ff), [2, 0],
         dtype=torch.bfloat16)

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
                    1e-4, kernel_cost("gather_loss", src, lab, idx, w, b))
        row["launch"] = {"row_tile": gl.ROW_TILE, **shape}
        return row

    main = case(80, 2048, 10, 16)
    case(8192, 2048, 62, 2048)
    # celeba_cnn at cut 4 (width 32, 84 px): K = 2 in a class tile of 16,
    # D = 800 = 6 chunks of 128 and one of 32
    case(80, 800, 2, 16)
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
    returned row) and its serving rows ([8, 64] a decode tick, [4, 64] a
    prefill position), moonshot's (E 64, k 6) and grok-1's (E 8, k 2), and at
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
                    1e-6, kernel_cost("topk_gating", x, k))
        row["launch"] = {"lanes_per_row": lanes}
        return row

    main = case(4096, 64, 8)
    # the serving path's router rows: a decode tick over 8 slots, and a
    # prefill chunk of 4 (olmoe, each layer, each position)
    case(8, 64, 8)
    case(4, 64, 8)
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


def _qkv(torch, dev, gen, B, Sq, Sk, H, Hkv, D, dtype, fused):
    """Random q, k, v drawn on ``gen``; ``fused``: strided slices of one
    [B, S, 3, H, D] projection."""
    if fused:           # one [B, S, 3, H, D] projection, sliced
        t = torch.randn(B, Sq, 3, H, D, device=dev, generator=gen
                        ).to(dtype)
        return t[:, :, 0], t[:, :, 1], t[:, :, 2]
    return (torch.randn(B, Sq, H, D, device=dev, generator=gen).to(dtype),
            torch.randn(B, Sk, Hkv, D, device=dev, generator=gen
                        ).to(dtype),
            torch.randn(B, Sk, Hkv, D, device=dev, generator=gen
                        ).to(dtype))


def _attention_sensitivity(label, q, k, v):
    """What dropping the keys of the last 128-row tile, or masking
    each row's own key (j < i instead of j <= i), moves the plain
    causal output by."""
    from repro_torch.kernels import ref
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

def attention_check(torch, dev, gen, B, Sq, Sk, H, Hkv, D, dtype,
                    causal=True, window=None, cap=None, main=False,
                    fused=False, library=False, note=""):
    """One ``flash_attention`` check (see :func:`flash_checks`): random
    q, k, v drawn on ``gen``, the kernel against its plain version, its
    work counted as the (query, key) pairs the mask keeps, SDPA's time
    with ``main`` or ``library``; ``note`` is added to the printed
    shape."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import design, flash_attention
    q, k, v = _qkv(torch, dev, gen, B, Sq, Sk, H, Hkv, D, dtype, fused)
    kw = dict(causal=causal, window=window, softcap=cap)
    lib = None
    if main or library:
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        gqa = {"enable_gqa": True} if H != Hkv else {}
        lib = lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                     is_causal=causal, **gqa)
    if main and dtype == torch.bfloat16:
        _attention_sensitivity(f"[{B}, {Sq}, {H}, {D}]", q, k, v)
    kind = design(dtype, D)
    row = check("flash_attention",
                f"q[{B}, {Sq}, {H}, {D}] kv[{B}, {Sk}, {Hkv}, {D}] "
                f"{str(dtype)[6:]} causal={causal} window={window} "
                f"softcap={cap}" + (" fused-qkv" if fused else "")
                + f" design={kind}" + note,
                lambda: (flash_attention(q, k, v, **kw),),
                lambda: (ref.flash_attention_ref(q, k, v, **kw),),
                2e-2 if dtype == torch.bfloat16 else 2e-5,
                kernel_cost("flash_attention", q, k, v, **kw), library=lib)
    row["design"] = kind
    return row


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
    CUDA-core design in bf16 too); whisper-base's encoder [2, 1500, 8,
    64] non-causal (a ragged last key tile of 92), its cross-attention
    (448 queries over 1500 keys), its causal decoder [2, 448] and its
    decode cross-attention (one query a row, batch 8), with SDPA's time,
    and its smoke config's heads of 32, and glm4-9b's [2, 2048, 32 | 2,
    128] whole and a rank's [2, 2048, 8 | 1, 128] on a model axis of 4
    (GQA, with SDPA's time).  Each case runs in float32 too (the
    CUDA-core design), where 2e-5 would catch a key dropped, doubled or
    off by one at a mask's edge.  Before the checks it prints how far
    the plain bf16 output moves when the last key tile is dropped and
    when the diagonal is masked off by one, against 2e-2.  Returns the
    olmoe bf16 row."""
    import functools
    from repro_torch.configs import get_config
    attention = functools.partial(attention_check, torch, dev, gen)

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
    # glm4-9b: its 32 query heads of 128 over 2 kv heads (GQA 16), whole,
    # and a rank's 8 over its group's one kv head on a model axis of 4
    # (GQA 8, phase 31's path)
    glm4 = get_config("glm4-9b")
    for H, Hkv, note in ((glm4.n_heads, glm4.n_kv_heads, " (glm4-9b)"),
                         (glm4.n_heads // 4, 1, " (a rank's heads of glm4-9b "
                          "over its kv group's head, model axis 4)")):
        for dtype in (torch.bfloat16, torch.float32):
            attention(BATCH, SEQ, SEQ, H, Hkv, glm4.hd, dtype, main=True,
                      note=note)
    # whisper-base (8 heads of 64): the encoder's self-attention over 1500
    # frames (11 key tiles of 128 and a ragged 92), the decoder's
    # cross-attention (448 queries, 1500 keys), its causal self-attention
    # and the decode's cross-attention (one query a row, batch 8)
    whisper = get_config("whisper-base")
    H, D = whisper.n_heads, whisper.hd
    for dtype in (torch.bfloat16, torch.float32):
        attention(2, WHISPER_FRAMES, WHISPER_FRAMES, H, H, D, dtype,
                  causal=False, library=True)
        attention(2, WHISPER_TEXT, WHISPER_FRAMES, H, H, D, dtype,
                  causal=False, library=True)
        attention(2, WHISPER_TEXT, WHISPER_TEXT, H, H, D, dtype,
                  library=True)
        attention(8, 1, WHISPER_FRAMES, H, H, D, dtype, causal=False,
                  library=True)
        # whisper-base's smoke config (4 heads of 32, on the CUDA cores)
        attention(2, 60, 60, 4, 4, 32, dtype, causal=False)
        attention(2, 16, 60, 4, 4, 32, dtype, causal=False)
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


def _ssd_inputs(torch, dev, gen, B, L, H, P, N, G, dtype, A, sliced):
    """Inputs of a scan as the model makes them (see
    :func:`ssd_checks`); ``sliced="rank"`` as a rank of a model axis
    makes them, x whole and B, C column slices of one [B, L, 2 G N]
    conv output."""
    import torch.nn.functional as F
    if sliced == "rank":
        x = torch.randn(B, L, H, P, device=dev, generator=gen).to(dtype)
        bc = torch.randn(B, L, 2 * G * N, device=dev, generator=gen
                         ).to(dtype)
        bm, cm = (t.reshape(B, L, G, N) for t in torch.split(
            bc, [G * N, G * N], dim=-1))
    elif sliced:        # column slices of one [B, L, conv_ch] tensor
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


def _ssd_sensitivity(torch, x, dt, A, bm, cm, chunk, want, scale):
    """What dropping the diagonal term (C_i . B_i) dt_i x_i, or the
    state carried into each chunk, moves the output by."""
    from repro_torch.kernels import ref
    dev = x.device
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


def ssd_check(torch, dev, gen, label, B, L, H, P, N, G, dtype, chunk,
              A=None, sliced=False, main=False):
    """One ``ssd_scan`` check (see :func:`ssd_checks`): the kernel against
    its plain chunked version on inputs drawn on ``gen``, its work the
    recurrence's least; ``main`` first prints what a dropped diagonal
    term or carry would move."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import design, ssd_scan
    x, dt, A, bm, cm = _ssd_inputs(torch, dev, gen, B, L, H, P, N, G, dtype,
                                   A, sliced)
    want = ref.ssd_chunked(x, dt, A, bm, cm, chunk)
    scale = max(float(w.float().abs().max()) for w in want)
    if main:
        drop_diag, no_carry = _ssd_sensitivity(torch, x, dt, A, bm, cm,
                                               chunk, want[0], scale)
        print(f"ssd_scan {label}: a dropped diagonal term moves y by "
              f"{drop_diag:.3e} of max|y|, a missing carry by "
              f"{no_carry:.3e}; the f32 tolerance is {SSD_F32_REL:.0e}")
        if not SSD_F32_REL <= 0.1 * min(drop_diag, no_carry):
            raise AssertionError("ssd_scan: the f32 tolerance would not "
                                 "catch a dropped term or carry")
    kind = design(dtype, N, P)
    row = check("ssd_scan", f"{label} x[{B}, {L}, {H}, {P}] "
                f"B/C[{B}, {L}, {G}, {N}] {str(dtype)[6:]} chunk {chunk}"
                + {False: "", True: " sliced", "rank": " a rank's B/C "
                   "slices"}[sliced] + f" design={kind}",
                lambda: ssd_scan(x, dt, A, bm, cm, chunk=chunk),
                lambda: ref.ssd_chunked(x, dt, A, bm, cm, chunk),
                SSD_F32_REL * scale,
                kernel_cost("ssd_scan", x, dt, A, bm, cm, chunk=chunk),
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
    import functools
    from repro_torch.configs import get_config
    scan = functools.partial(ssd_check, torch, dev, gen)

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


def drive(torch, label, cfg, expect, clock=True, **engine_kw):
    """Run ``Engine.run()`` on the card with the counters reset just
    before and read just after; check finite metrics and the launches.
    ``expect`` is a dict of launches or a function of the Engine that
    gives one; ``engine_kw`` (a ``task`` and its ``fed``) go to the
    Engine.  With ``clock`` the host syncs after every round for the
    rounds/s; without it only the Engine's own syncs run (its
    ``collect_timing`` windows), and the metrics are read at the end."""
    from repro_torch.api import Engine
    eng_stamps = []

    class Clock:
        def on_round(self, engine, rnd, state, metrics):
            if clock:
                torch.cuda.synchronize()
            eng_stamps.append((time.perf_counter(), dict(metrics)))

    eng = Engine(cfg, device="cuda", callbacks=[Clock()],
                 log=lambda msg: print(f"{label}: {msg}"), **engine_kw)
    if callable(expect):
        expect = expect(eng)
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters()
    eng_stamps = [(t, {k: float(v) for k, v in m.items()})
                  for t, m in eng_stamps]
    losses = [m["server_loss"] for _, m in eng_stamps]
    steady = [b[0] - a[0] for a, b in zip(eng_stamps, eng_stamps[1:])]
    rps = len(steady) / sum(steady) if clock and steady else float("nan")
    hist = res["history"][-1]
    key = eng.metric_key
    timing = ("" if "round_time_s" not in res else
              f"; round_time_s {res['round_time_s']:.6f} (sync_every "
              f"{cfg.sync_every})")
    print(f"{label}: {cfg.rounds} rounds in {wall:.3f}s; rounds 2..{cfg.rounds} "
          f"at {rps:.2f} rounds/s{timing}; server_loss per round {losses}; "
          f"test_loss={hist['test_loss']:.4f} {key}={hist[key]:.4f}; "
          f"launches {launches} (expected {expect})")
    padded = 0
    if cfg.pad_cohorts:       # replay the sampler: padded slots drawn
        import numpy as np
        rng = np.random.default_rng(cfg.seed + 1)
        padded = sum(int((eng.sample_round(rng)[3] == 0).sum())
                     for _ in range(cfg.rounds))
        print(f"{label}: {padded} padded slots in {cfg.rounds} rounds")
    vals = [v for _, m in eng_stamps for v in m.values()]
    vals += [hist["test_loss"], hist["train_loss"], hist[key]]
    if not all(math.isfinite(x) for x in vals):
        raise AssertionError(f"{label}: non-finite metrics {vals}")
    for k, n in expect.items():
        if launches[k] != n:
            raise AssertionError(f"{label}: {k} launched {launches[k]} times, "
                                 f"expected {n}")
    return {"rounds": cfg.rounds, "wall_s": wall, "rounds_per_s": rps,
            "round_time_s": res.get("round_time_s"), "metric_key": key,
            "server_loss": losses, "history": res["history"],
            "launches": launches, "padded_slots": padded}


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
    # launched them carry the same device time again, and so do the
    # "nccl:*" ranges c10d marks on the device around its kernels
    rows = sorted(((e.key, e.count, e.self_device_time_total)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0
                   and not e.key.startswith("nccl:")), key=lambda r: -r[2])
    busy = sum(r[2] for r in rows)
    nccl = sum(r[2] for r in rows if r[0].startswith("nccl"))
    print(f"profile {label}: {wall_us / 1e3:.1f}ms wall, device busy "
          f"{busy / 1e3:.1f}ms ({busy / wall_us:.1%}), NCCL kernels "
          f"{nccl / 1e3:.1f}ms ({nccl / wall_us:.1%} of the wall)")
    for name, count, t in rows[:12]:
        print(f"profile {label}:   {t / 1e3:8.3f}ms {count:6d}x {name[:90]}")
    # the port's own kernels, however small, by their function names
    kernels = port_kernels()
    ours = [{"name": fn, "count": c, "device_ms": t / 1e3}
            for n, c, t in rows
            if (fn := port_kernel_of(n, kernels)) is not None]
    for r in ours:
        print(f"profile {label}: port kernel {r['name']} {r['count']}x "
              f"{r['device_ms']:.3f}ms ({r['device_ms'] * 1e3 / busy:.2%} of "
              f"device busy)")
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "nccl_ms": nccl / 1e3,
            "top": [{"name": n, "count": c, "device_ms": t / 1e3}
                    for n, c, t in rows[:25]], "port_kernels": ours}


def profile_rounds(torch, cfg):
    """``Engine.run()`` (rounds + eval) under the profiler, warm."""
    from repro_torch.api import Engine
    eng = Engine(cfg, device="cuda", log=lambda msg: None)
    eng.run()                                   # warm: cuDNN picks, caches
    return device_profile(torch, f"{cfg.algo} cut{cfg.cut} ({cfg.rounds} "
                          f"rounds + eval)", eng.run)


def cpu_and_card(torch, cfg, plan_fn, **engine_kw):
    """``Engine.run()`` of ``cfg`` on the CPU (plain versions) and on the
    card (kernels) from one init drawn on the CPU: each side's per-round
    metrics, final state, last evaluation and Engine.  ``engine_kw``
    (a ``task`` and its ``fed``) go to both Engines."""
    from repro_torch.api import Engine
    from repro_torch.utils.tree import tree_map
    init = Engine(cfg, device="cpu", log=lambda msg: None,
                  **engine_kw).init_state()
    runs = {}
    for dev in ("cpu", "cuda"):
        rows, final = [], []

        class Rec:
            def on_round(self, engine, rnd, state, metrics):
                # scalar metrics (not the guard's health vectors)
                rows.append({k: float(v) for k, v in metrics.items()
                             if v.numel() == 1})
                final[:] = [state]

        eng = Engine(cfg, device=dev, callbacks=[Rec()], plan_fn=plan_fn,
                     log=lambda msg: None, **engine_kw)
        res = eng.run(state=tree_map(lambda t: t.to(dev), init))
        runs[dev] = (rows, final[0], res["history"][-1], eng)
    return runs


def card_against_cpu(torch):
    """Two rounds on the CPU (plain versions) and on the card (kernels),
    with TF32 off, one carried init and one injected plan.  Per-round
    metrics must agree to rtol 1e-4 (float32 sums in another order);
    weights to 1e-5 but for at most 0.1% of them, each within the
    2 * lr * steps that Adam's near-sign steps can move a weight."""
    from repro_torch.api import ExperimentConfig
    from repro_torch.core.feature_store import masked_resample_plan
    from repro_torch.utils.tree import tree_leaves
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
        runs = cpu_and_card(torch, cfg, plan_fn)
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


def block_launches(cfg, lo, hi, shared=True):
    """Kernel launches of one forward through blocks [lo, hi): an
    attention block launches flash_attention once (and topk_gating once
    when it is MoE), a mamba2 block ssd_scan once, and the hybrid
    family's shared attention block flash_attention once after each of
    its positions inside the range (``shared=False`` leaves it out: it
    runs outside any checkpoint, so a recompute does not run it).  The
    backwards of the kernels recompute plain versions, which launch
    nothing."""
    from repro_torch.models.transformer import block_kind
    kind, n = block_kind(cfg), hi - lo
    if kind in ("mamba", "hybrid"):
        pos = (cfg.ssm.shared_attn_positions
               if kind == "hybrid" and shared else ())
        out = {"ssd_scan": n, "topk_gating": 0,
               "flash_attention": sum(lo <= p < hi for p in pos)}
    else:
        out = {"ssd_scan": 0, "flash_attention": n,
               "topk_gating": n if kind == "moe" else 0}
    return by_design(cfg, out)


def half_launches(cfg, half, again=False):
    """Kernel launches of one forward through the ``"client"`` or
    ``"server"`` half of the train step's split, or the ``"whole"``
    model: ``block_launches`` of its blocks; whisper's encoder (the
    client) launches flash_attention once a block and its decoder twice
    (``whisper_forward_launches``).  ``again`` counts the recompute a
    backward through the half runs first instead: every group of blocks
    is under ``module.remat`` and runs its forward once more, all of its
    kernels with it (its last op that saves a tensor comes after them),
    but for the hybrid's shared block, which is in no group."""
    if cfg.family == "audio":
        n = whisper_forward_launches(cfg, encode=half != "server",
                                     decode=half != "client")
        return by_design(cfg, {"ssd_scan": 0, "flash_attention": n,
                               "topk_gating": 0})
    lo, hi = {"client": (0, cfg.cut_layers),
              "server": (cfg.cut_layers, cfg.n_layers),
              "whole": (0, cfg.n_layers)}[half]
    return block_launches(cfg, lo, hi, shared=not again)


def round_launches(cfg, c_local, steps, again=True):
    """Kernel launches of one CycleSL round of the train step by kernel
    (and by design): the client half runs forward ``c_local`` times in
    the extract (under ``no_grad``: once) and ``c_local`` times in the
    VJPs, the server half once in each of ``steps`` server steps and
    ``c_local`` times in the feature gradients; every pass under grad
    recomputes its groups in its backward (``half_launches(...,
    again=True)``); ``again=False`` leaves the recompute out."""
    client, srv = half_launches(cfg, "client"), half_launches(cfg, "server")
    c_again = half_launches(cfg, "client", again=True)
    s_again = half_launches(cfg, "server", again=True)
    if not again:
        c_again = s_again = {k: 0 for k in client}
    return {k: c_local * (2 * client[k] + c_again[k])
            + (steps + c_local) * (srv[k] + s_again[k]) for k in client}


def by_design(cfg, out):
    """``out`` (launches by kernel) with flash_attention's and
    ssd_scan's split by design: bf16 attention at head_dim 64 or 128
    (olmoe, zamba2, whisper) and the bf16 SSD scan at (N, P) = (64, 64)
    or (128, 64) (zamba2, mamba2-2.7b) run on the tensor cores, every
    launch of them."""
    import torch
    bf16 = cfg.torch_dtype == torch.bfloat16
    tc = {"flash_attention": bf16 and cfg.hd in (64, 128),
          "ssd_scan": bf16 and cfg.ssm is not None and (
              cfg.ssm.d_state, cfg.ssm.head_dim) in ((64, 64), (128, 64))}
    for k, on in tc.items():
        out[f"{k}/wgmma"] = out[k] if on else 0
        out[f"{k}/simt"] = 0 if on else out[k]
    return out


def take_census(mesh) -> dict:
    """The census of every collective group of ``mesh`` (its ``model``
    axis', its batch axes', its ``data`` axis' where that is a group of
    its own) since the last take, and a fresh one; {} off the mesh."""
    from repro_torch.utils.profiling import mesh_comms
    out = {}
    for comm in mesh_comms(mesh) if mesh is not None else ():
        out.update(comm.take_census())
    return out


def split_round(torch, label, cfg, rounds=ROUNDS, profile=False, mesh=None,
                keep_state=False, cohort=COHORT, donate=False, remat=True):
    """A transformer path: ``build_train_step`` for ``cfg`` (its
    published cut; whisper's encoder and decoder), ``cohort`` clients,
    batch 2 a client, sequence 2048 (whisper: 1500 frames and 448 text
    positions); random init on the card, tokens from a numpy seed;
    ``rounds`` CycleSL rounds with the launch counters reset before and
    read after.

    Expected launches per round: the client blocks [0, cut) run C times
    in the extract and C times in the client VJPs, the server blocks
    [cut, L) once in each of the steps = C * b / server batch server
    steps and C times in the feature gradients, each forward launching
    ``half_launches``, and each of them but the extract's (under
    ``no_grad``) again in its backward's recompute
    (:func:`round_launches`); feature_resample gathers features and
    labels (whisper: features, tokens and labels) once a server step;
    fused_adam steps every server leaf once a server step and every
    stacked client leaf once; gather_loss never runs (no linear server
    head).  olmoe-1b-7b at depth 4, cut 2: 16 block forwards a round and
    12 recomputes, each one flash_attention and one topk_gating launch.
    zamba2-1.2b, 38 blocks cut after 4: 8 + 68 + 68 + 8 = 152 ssd_scan
    launches a round and 8 + 136 = 144 recomputes, 296 in all, and
    flash_attention 2 * (steps + C) = 8 (the shared block after blocks
    12 and 25, both on the server, in no checkpoint).

    ``mesh`` runs the step on a mesh (phase 25): each rank its blocks
    and its ``C / cohort_size(mesh)`` slots, the same launches on every
    rank (a block is a leaf as a whole leaf is; the slot counts above
    are the rank's), and each round's census of both axes kept;
    ``keep_state`` returns the final state; ``peak_bytes`` is the whole
    call's peak, init included, ``step_peak_bytes`` the rounds' (what a
    dry run of the step models); ``donate`` runs the step as
    its bundle donates (``StepBundle.donated()``: the state stepped in
    place); ``remat=False`` expects the launches of a run with
    ``module.remat`` swapped for a plain call (phase 34: no
    recompute)."""
    from repro_torch.configs import InputShape
    from repro_torch.core.cyclesl import CycleConfig
    from repro_torch.launch.mesh import cohort_size
    from repro_torch.launch.steps import build_train_step
    from repro_torch.utils.tree import tree_leaves
    L, cut, C, b = cfg.n_layers, cfg.cut_layers, cohort, BATCH
    audio = cfg.family == "audio"
    seq = WHISPER_TEXT if audio else SEQ
    c_local = C if mesh is None else C // cohort_size(mesh)
    shape = InputShape(label, seq, C * b, "train")
    cycle = CycleConfig(server_epochs=1, server_batch=b)
    bundle = build_train_step(cfg, shape, cycle, cohort=C, device="cuda",
                              mesh=mesh)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    server, clients = bundle.init_state(0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    state_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves((server, clients)))
    n_server = sum(t.numel() for t in tree_leaves(server.params))
    n_client = (sum(t.numel() for t in tree_leaves(clients.params))
                // c_local)
    steps = cycle.server_epochs * (C * b // cycle.server_batch)
    client, srv = half_launches(cfg, "client"), half_launches(cfg, "server")
    per_round = round_launches(cfg, c_local, steps, again=remat)
    expect = {k: n * rounds for k, n in per_round.items()}
    expect.update(feature_resample=(3 if audio else 2) * steps * rounds,
                  gather_loss=0,
                  fused_adam=(len(tree_leaves(server.params)) * steps
                              + len(tree_leaves(clients.params))) * rounds)
    batches = [bundle.make_batch(r) for r in range(rounds)]
    step = bundle.donated() if donate else bundle.fn
    torch.cuda.synchronize()
    # the draw of the whole model before a rank keeps its shards can peak
    # above the rounds (with remat it does on a mesh); the dry run models
    # a step, so the rounds' peak is kept apart
    init_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    take_census(mesh)
    stamps, metrics, census = [time.perf_counter()], [], []
    for r in range(rounds):
        xs, ys = batches[r]
        server, clients, m = step(server, clients, xs, ys, r)
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        metrics.append({k: float(v) for k, v in m.items()})
        if mesh is not None:
            census.append(take_census(mesh))
    launches = read_counters()
    step_peak = torch.cuda.max_memory_allocated()
    peak = max(init_peak, step_peak)
    rps = (rounds - 1) / (stamps[-1] - stamps[1])
    tokens = C * b * seq
    print(f"{label}: {cfg.name} L={L} cut={cut} d={cfg.d_model}, params "
          f"{n_client:,} a client, {n_server:,} the server; C={C} b={b} "
          f"S={seq}" + (f" frames {WHISPER_FRAMES}" if audio else "")
          + f" {cfg.dtype}; init {init_s:.2f}s; entity states "
          f"{state_bytes / 1e9:.2f} GB")
    for r, m in enumerate(metrics):
        print(f"{label} {r + 1}: {stamps[r + 1] - stamps[r]:.3f}s "
              + " ".join(f"{k}={v:.6g}" for k, v in m.items()))
    print(f"{label}: rounds 2..{rounds} at {rps:.3f} rounds/s, "
          f"{rps * tokens:.1f} tokens/s; peak memory {peak / 1e9:.2f} GB; "
          f"launches {launches} (expected {expect}; a round: client blocks "
          f"{client} x {2 * c_local}, server blocks {srv} x "
          f"{steps + c_local}, each backward's recompute beside them)")
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
    extra = {"state": (server, clients)} if keep_state else {}
    if mesh is not None:
        extra["census"] = census
    return {**extra, "profile": prof, "config": {
                "arch": cfg.name, "n_layers": L, "cut": cut, "cohort": C,
                "batch": b, "seq": seq, "server_steps": steps,
                "dtype": cfg.dtype, "donate": donate,
                **({"frames": WHISPER_FRAMES} if audio else {})},
            "params_client": n_client, "params_server": n_server,
            "state_bytes": state_bytes, "init_s": init_s,
            "round_s": [b - a for a, b in zip(stamps, stamps[1:])],
            "rounds_per_s": rps, "tokens_per_s": rps * tokens,
            "peak_bytes": peak, "step_peak_bytes": step_peak,
            "metrics": metrics, "launches": launches,
            "expected_launches": expect}


def prefill(torch, label, cfg, mesh=None, keep=False):
    """``build_prefill_step`` for ``cfg``, batch 2, sequence 2048
    (whisper: 1500 frames, 448 tokens): one forward through every block
    (``half_launches`` of the whole model); on ``mesh`` each rank its
    shards.  ``keep`` returns the logits."""
    from repro_torch.configs import InputShape
    from repro_torch.launch.steps import build_prefill_step
    seq = WHISPER_TEXT if cfg.family == "audio" else SEQ
    shape = InputShape(label, seq, BATCH, "prefill")
    bundle = build_prefill_step(cfg, shape, device="cuda", mesh=mesh)
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
    want = half_launches(cfg, "whole")
    print(f"{label}: {cfg.name} L={cfg.n_layers} B={BATCH} S={seq}: "
          f"last-token logits {list(logits.shape)} {str(logits.dtype)[6:]} "
          f"finite={ok} in {ms:.2f} ms ({BATCH * seq / ms * 1e3:.0f} "
          f"tokens/s); launches {launches} (expected {want})")
    if not ok or tuple(logits.shape) != (BATCH, cfg.vocab):
        raise AssertionError(f"{label}: logits not finite or of the wrong "
                             f"shape")
    for k, n in want.items():
        if launches[k] != n:
            raise AssertionError(f"{label}: {k} launched {launches[k]} "
                                 f"times, expected {n}")
    return {"ms": ms, "launches": launches, "shape": list(logits.shape),
            **({"logits": logits} if keep else {})}


TRANSFORMER_PARITY = (("olmoe-1b-7b", 2), ("gemma2-2b", 4),
                      ("mamba2-2.7b", 2), ("zamba2-1.2b", 4))


def transformer_card_against_cpu(torch, archs=TRANSFORMER_PARITY):
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
    for arch, depth in archs:
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


# phase 12 drives these again under variable attendance: the PSL family
# (per-client store: sentinel scatter, per-client evaluation of padded
# cohorts) and ssl (the masked chain of server and client steps)
VARIABLE_RERUN = ("psl", "cyclepsl", "cyclesglr", "ssl")


def zoo_launches(algo, rounds, Ls=2, Lc=4, fused=False):
    """Launches of ``rounds`` rounds of ``algo`` at the main path's
    protocol: L_s server and L_c client leaves (femnist cut 2: 2 and 4),
    C = 5 slots, S = 5 server inner-loop steps (80 pooled rows / server
    batch 16).  The cycle programs run the inner loop (S server steps,
    each gathering features and labels: 2 S feature_resample, or with
    ``fused`` one gather_loss a step instead) and step the client stack
    once (L_c), but cyclessl steps its one client along the chain (C
    L_c).  psl, sflv1 and sglr step the server once (replicas stacked,
    or on the mean gradient) and the client stack once, as fedavg steps
    its server and client replicas; sflv2 steps its server once a slot
    (C L_s) and the client copies once; ssl steps both once a slot.
    Padded slots step and are then deselected, so the counts do not
    depend on attendance."""
    C, S = 5, 5
    adam = {"cyclesfl": S * Ls + Lc, "cyclepsl": S * Ls + Lc,
            "cyclesglr": S * Ls + Lc, "cyclessl": S * Ls + C * Lc,
            "psl": Ls + Lc, "sflv1": Ls + Lc, "sglr": Ls + Lc,
            "fedavg": Ls + Lc, "sflv2": C * Ls + Lc, "ssl": C * (Ls + Lc)}
    cycle = algo.startswith("cycle")
    resample = 2 * S if cycle and not fused else 0
    return {"fused_adam": adam[algo] * rounds,
            "feature_resample": resample * rounds,
            "gather_loss": (S if cycle and fused else 0) * rounds}


def put_entities_time(torch):
    """The per-client store's commit scatter at the main path's size
    ([100, ...] params, m and v of femnist_cnn's client half, cut 2): one
    cohort of 4 clients and a padded slot, device and eager ms."""
    from repro_torch.api import Engine, ExperimentConfig
    from repro_torch.core.protocol import put_entities, take_entities
    from repro_torch.utils.tree import tree_leaves
    eng = Engine(ExperimentConfig(algo="cyclepsl", cut=2, **MAIN),
                 device="cuda", log=lambda msg: None)
    store = eng.init_state().clients
    cohort = torch.tensor([3, 17, 42, 99, 100], device=store.step.device)
    vals = take_entities(store, cohort)
    nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(store))
    run = lambda: put_entities(store, cohort, vals)
    ms, eager = device_ms(run), eager_ms(run)
    print(f"put_entities: store {nbytes / 1e6:.2f} MB in "
          f"{len(tree_leaves(store))} leaves, cohort 5 (one padded): "
          f"{ms:.4f} ms device, {eager:.4f} ms eager")
    return {"store_bytes": nbytes, "ms": ms, "eager_ms": eager}


def zoo(torch, rounds):
    """Phase 12: every program at the main path's configuration, with
    exact launch counts, then ``VARIABLE_RERUN`` under variable
    attendance, which must draw padded slots."""
    from repro_torch.api import ExperimentConfig, algorithm_names
    out = {}
    for algo in algorithm_names():
        out[algo] = drive(torch, f"zoo {algo}", ExperimentConfig(
            algo=algo, rounds=rounds, eval_every=rounds, cut=2, **MAIN),
            zoo_launches(algo, rounds))
    for algo in VARIABLE_RERUN:
        run = drive(torch, f"zoo {algo} variable", ExperimentConfig(
            algo=algo, rounds=rounds, eval_every=rounds, cut=2,
            variable_attendance=True, **MAIN), zoo_launches(algo, rounds))
        if not run["padded_slots"]:
            raise AssertionError(f"zoo {algo} variable: no padded slot drawn")
        out[f"{algo}/variable"] = run
    print("zoo rounds/s (host-bound; compare within this call only): "
          + ", ".join(f"{k} {v['rounds_per_s']:.2f}" for k, v in out.items()))
    out["put_entities"] = put_entities_time(torch)
    return out


def zoo_card_against_cpu(torch):
    """Phase 13: phase 6 for every program, two rounds at width 8 under
    variable attendance, server epochs 2, seed 4: its second round draws
    2 clients into 3 slots.  Not a first round of 2: the Adam steps of
    two slots' first step are +-lr, so a FedAvg of two leaves some
    biases at float32 rounding noise; 67% of the pixels are exactly 0,
    where the pre-activation is that bias, so the next round's ReLU
    gates them by the noise's sign, which differs by device, and the
    client gradients then differ by ~1e-3 relative (seed 1: 4.6e-3 in
    cyclesfl), a discontinuity of the task, not of either side.
    Tolerances: ``compare_runs``."""
    from repro_torch.api import ExperimentConfig, algorithm_names
    from repro_torch.core.feature_store import masked_resample_plan
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    def plan_fn(key, valid, epochs, sb):
        return masked_resample_plan(key, valid.cpu(), epochs, sb)

    out = {}
    for algo in algorithm_names():
        cfg = ExperimentConfig(algo=algo, rounds=2, eval_every=2,
                               n_clients=10, attendance=0.3, batch=8,
                               width=8, cut=2, seed=4,
                               variable_attendance=True
                               ).with_cycle(server_epochs=2)
        out[algo] = compare_runs(torch, algo, cpu_and_card(torch, cfg,
                                                           plan_fn))
    return out


def compare_runs(torch, label, runs, exempt=None, what="card-vs-cpu"):
    """Hold the card's run to the CPU's (``cpu_and_card``; ``what`` names
    the two sides in what it prints, when ``runs`` holds two others in
    their places): per-round
    metrics with the same keys to rtol 1e-4 (``feat_grad_norm_std`` also
    within 1e-5 of ``feat_grad_norm_mean``: SGLR's slots share one
    gradient, so the std of their equal norms is float32 rounding of the
    mean); the test loss to rtol 1e-4, the accuracy within one flipped
    test sample (another metric to rtol 1e-4); int32 steps equal;
    weights, a per-client store included, within 1e-5 but for 0.1% of a
    leaf (one value in a smaller leaf), each within the 2 * lr * steps
    that Adam's near-sign steps can move a weight, with steps the most
    any entity took.  ``exempt(path)`` marks leaves held to that bound
    alone (``bias_before_batchnorm``).  Raises on a miss."""
    from repro_torch.utils.tree import tree_leaves, tree_leaves_with_path
    (rows_c, sc, hc, eng), (rows_g, sg, hg, _) = runs["cpu"], runs["cuda"]
    worst = 0.0
    for rc, rg in zip(rows_c, rows_g):
        if set(rc) != set(rg):
            raise AssertionError(f"{what} {label}: metric keys "
                                 f"{sorted(rc)} vs {sorted(rg)}")
        for k in rc:
            atol = (1e-5 * abs(rc["feat_grad_norm_mean"])
                    if k == "feat_grad_norm_std" else 0.0)
            worst = max(worst, max(abs(rg[k] - rc[k]) - atol, 0.0)
                        / max(abs(rc[k]), 1e-12))
    loss_rel = abs(hg["test_loss"] - hc["test_loss"]) / abs(hc["test_loss"])
    key = eng.metric_key
    if key != "accuracy":
        metric_ok = abs(hg[key] - hc[key]) <= 1e-4 * abs(hc[key])
    else:
        if sc.clients is None:
            scored = len(eng.fed.test_arrays()[1])
        else:
            held = [c for c in eng.fed.clients if len(c.x_test)][:40]
            scored = min(len(c.x_test) for c in held) * len(held)
        metric_ok = abs(hg[key] - hc[key]) <= 1.0 / scored + 1e-6
    ints = [t for t in tree_leaves(sc) if t.dtype == torch.int32]
    steps = max(int(t.max()) for t in ints)
    w_max, over, steps_ok, exempted = 0.0, 0, True, 0
    for (path, a), b in zip(tree_leaves_with_path(sc), tree_leaves(sg)):
        d = (a.double() - b.cpu().double()).abs()
        if a.dtype == torch.int32:
            steps_ok &= bool((d == 0).all())
            continue
        w_max = max(w_max, float(d.max()))
        if exempt is not None and exempt(path):
            exempted += 1
            continue
        n = int((d > 1e-5).sum())
        over = max(over, n - max(1, int(1e-3 * d.numel())))
    store = (None if sc.clients is None else max(
        float((a.double() - b.cpu().double()).abs().max())
        for a, b in zip(tree_leaves(sc.clients.params),
                        tree_leaves(sg.clients.params))))
    print(f"{what} {label}: worst metric rel diff {worst:.3e} (tol "
          f"1e-4); test loss rel diff {loss_rel:.3e}, {key} "
          f"{hc[key]:.4f} / {hg[key]:.4f}; weights max abs "
          f"diff {w_max:.3e} (bound {2 * 1e-3 * steps:.0e})"
          + ("" if store is None else f", per-client store {store:.3e}")
          + f"; leaves over their outlier allowance {max(over, 0)}"
          + (f" ({exempted} bias leaves before a BatchNorm held to the "
             "bound alone)" if exempted else "")
          + f"; steps equal {steps_ok}")
    if not (worst <= 1e-4 and loss_rel <= 1e-4 and metric_ok
            and w_max <= 2 * 1e-3 * steps and over <= 0 and steps_ok):
        raise AssertionError(f"{what} {label}: the two runs disagree")
    return {"worst_metric_rel_diff": worst, "test_loss_rel_diff": loss_rel,
            "weights_max_abs": w_max, "store_max_abs": store, "steps": steps}


# phase 14: the paper's other workloads at the main path's protocol,
# each task with the two programs it runs, and ResNet9 at the six cuts of
# the paper's Table 4, TABLE4_ROUNDS rounds each
WORKLOADS = (("cifar", ("cyclesfl", "sflv1")), ("charlm", ("cyclesfl", "sflv1")),
             ("gaze", ("cyclepsl", "psl")))
TABLE4_ROUNDS = 3


def leaf_counts(task):
    """(server, client) leaves of a split task, read off its init trees."""
    import torch
    from repro_torch.utils.tree import tree_leaves
    gen = torch.Generator().manual_seed(0)
    return (len(tree_leaves(task.init_server(gen))),
            len(tree_leaves(task.init_client(gen))))


def task_launches(algo, rounds, fused=False):
    """``zoo_launches`` for the Engine's own task (a function of the
    Engine, for ``drive``)."""
    def expect(eng):
        ls, lc = leaf_counts(eng.task)
        out = zoo_launches(algo, rounds, ls, lc, fused)
        print(f"{eng.task.name}: {ls} server and {lc} client leaves; "
              f"{algo} launches a round: "
              + ", ".join(f"{k} {v // rounds}" for k, v in out.items()))
        return out
    return expect


def celeba(cut, width, n_clients, seed=0):
    """LEAF CelebA's CNN at 84 px, 2 classes, on the synthetic image task
    with 16 samples a client (135 MB of images at 100 clients).  Neither
    package registers it as a task, so the Engine takes the task and its
    data."""
    from repro_torch.core.split import make_stage_task
    from repro_torch.data.federated import FederatedDataset
    from repro_torch.data.synthetic import SyntheticImageTask
    from repro_torch.models.cnn import celeba_cnn
    x, y, _, idx = SyntheticImageTask(img=84, channels=3, n_classes=2,
                                      samples_per_client=16,
                                      n_clients=n_clients, seed=seed).build()
    return {"task": make_stage_task(celeba_cnn(2, width, 84), cut, "xent"),
            "fed": FederatedDataset.from_arrays(x, y, idx, seed=seed),
            "metric_key": "accuracy"}


def workloads(torch, rounds):
    """Phase 14: ``Engine.run()`` of each of the paper's other workloads
    at its model's full published width, at the main path's protocol (100
    clients, cohort 5, batch 16, padded cohorts, ``collect_timing``),
    with exact launch counts from the tasks' leaves: cifar (resnet9 width
    64, cut 2) and charlm (the LSTM, cut 2) with cyclesfl and sflv1, gaze
    (the mlp, mse, cut 1) with cyclepsl and psl, resnet9 at cuts 1-6,
    cifar again with the host syncing every round or every 5 rounds, in
    turns (1, 5, 5, 1), and celeba at cut 1 and cut 4 with
    ``fused_gather_loss``."""
    from repro_torch.api import ExperimentConfig, build_task
    from repro_torch.core.split import make_stage_task
    from repro_torch.models.cnn import resnet9

    def cfg(**kw):       # charlm and gaze fix their own cut and width
        return ExperimentConfig(**{**MAIN, "rounds": rounds,
                                   "eval_every": rounds, "cut": 2,
                                   "width": 64, "collect_timing": True,
                                   **kw})

    out = {}
    for task, algos in WORKLOADS:
        for algo in algos:
            out[f"{task}/{algo}"] = drive(
                torch, f"{task} {algo}", cfg(task=task, algo=algo),
                task_launches(algo, rounds))
    # one draw of the cifar data for the cut sweep and the sync runs
    _, fed, _ = build_task("cifar", MAIN["n_clients"], 0.5, 0, 64, 2)
    for cut in range(1, 7):
        out[f"cifar/cut{cut}"] = drive(
            torch, f"cifar cut{cut}",
            cfg(task="cifar", cut=cut, rounds=TABLE4_ROUNDS,
                eval_every=TABLE4_ROUNDS),
            task_launches("cyclesfl", TABLE4_ROUNDS),
            task=make_stage_task(resnet9(n_classes=20, width=64), cut),
            fed=fed, metric_key="accuracy")
    for turn, k in zip("aabb", (1, 5, 5, 1)):      # in turns: 1, 5, 5, 1
        out[f"cifar/sync_every{k}{turn}"] = drive(
            torch, f"cifar sync_every {k} ({turn})",
            cfg(task="cifar", sync_every=k),
            task_launches("cyclesfl", rounds), clock=False,
            task=make_stage_task(resnet9(n_classes=20, width=64), 2),
            fed=fed, metric_key="accuracy")
    for cut, fused in ((1, False), (4, True)):
        out[f"celeba/cut{cut}" + ("-fused" if fused else "")] = drive(
            torch, f"celeba cut{cut}" + (" fused" if fused else ""),
            cfg(cut=cut).with_cycle(fused_gather_loss=fused),
            task_launches("cyclesfl", rounds, fused),
            **celeba(cut, 32, MAIN["n_clients"]))
    print("workloads rounds/s by the host clock (host-bound; compare within "
          "this call only) and the Engine's round_time_s: " + ", ".join(
              f"{k} {v['rounds_per_s']:.2f} / {v['round_time_s']:.6f}s"
              for k, v in out.items()))
    return out


def workloads_card_against_cpu(torch):
    """Phase 15: phase 13 for each new task, two rounds of 10 clients,
    cohort 3, batch 8, server epochs 2, seed 4, TF32 off and cuDNN
    deterministic: cifar (resnet9 width 8) and charlm with cyclesfl,
    gaze with cyclepsl, celeba (width 8, 84 px) at cut 1 and cut 4
    fused.  Tolerances: ``compare_runs``; under resnet9 and celeba the
    conv biases in front of a BatchNorm are held to Adam's bound alone
    (``bias_before_batchnorm``)."""
    from repro_torch.api import ExperimentConfig
    from repro_torch.core.feature_store import masked_resample_plan
    from repro_torch.models.cnn import bias_before_batchnorm
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True

    def plan_fn(key, valid, epochs, sb):
        return masked_resample_plan(key, valid.cpu(), epochs, sb)

    small = dict(rounds=2, eval_every=2, n_clients=10, attendance=0.3,
                 batch=8, seed=4)
    cases = {"cifar": (dict(task="cifar", width=8), False, {}),
             "charlm": (dict(task="charlm"), False, {}),
             "gaze": (dict(task="gaze", algo="cyclepsl"), False, {}),
             "celeba cut1": (dict(cut=1), False, celeba(1, 8, 10, seed=4)),
             "celeba cut4 fused": (dict(cut=4), True,
                                   celeba(4, 8, 10, seed=4))}
    out = {}
    for label, (kw, fused, engine_kw) in cases.items():
        cfg = ExperimentConfig(**{**small, **kw}).with_cycle(
            server_epochs=2, fused_gather_loss=fused)
        bn = label.startswith(("cifar", "celeba"))
        out[label] = compare_runs(
            torch, label, cpu_and_card(torch, cfg, plan_fn, **engine_kw),
            exempt=bias_before_batchnorm if bn else None)
    return out


# phases 16-17: the serving path.  The slot table and budgets of the
# continuous runtime; SERVE_REQUESTS requests a model, at concurrency
# `slots`; gemma2-2b through the batched driver
SERVE = dict(slots=8, max_prompt_len=64, max_new_tokens=64, prefill_batch=4)
SERVE_REQUESTS = {"olmoe-1b-7b": 24, "zamba2-1.2b": 8}
BATCHED = dict(batch=4, prompt_len=64, steps=32)


def serve_schedule(n, sc):
    """Decode calls, prefill chunks and ticks of ``run_closed_loop`` over
    ``n`` requests at concurrency ``sc.slots``, every request generating
    ``sc.max_new_tokens`` with no deadline or fault: waves of ``slots``
    requests, each admitted at its wave's first tick in ``slots /
    prefill_batch`` chunks and decoded for ``max_new_tokens - 1`` ticks
    (the prefill gives the first token); the tick after, it retires and
    nothing decodes."""
    assert n % sc.slots == 0 and sc.slots % sc.prefill_batch == 0
    waves = n // sc.slots
    return {"decode": waves * (sc.max_new_tokens - 1),
            "prefill": waves * sc.slots // sc.prefill_batch,
            "ticks": waves * sc.max_new_tokens}


def free(torch):
    """Return the memory of dropped objects to the card: the runtime's
    step closures hold the runtime in a reference cycle, which only the
    cyclic collector frees, and a peak read after must not count it."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()


class Timed:
    """A runtime step with CUDA events around each call (no sync): the
    calls, and the device timeline's ms per call, which takes in the
    host's dispatch whenever the device waits for it."""

    def __init__(self, torch, fn):
        self.torch, self.fn, self.events = torch, fn, []

    def __call__(self, *args):
        a = self.torch.cuda.Event(enable_timing=True)
        b = self.torch.cuda.Event(enable_timing=True)
        a.record()
        out = self.fn(*args)
        b.record()
        self.events.append((a, b))
        return out

    def ms(self):
        return [a.elapsed_time(b) for a, b in self.events]


def serve_runtime(torch, label, cfg, n_requests, profile=False,
                  dev="cuda"):
    """Phase 16: ``run_closed_loop`` over ``make_prompts(n_requests, 64,
    vocab, 1)`` at concurrency 8 through ``ServeRuntime(SERVE)`` on the
    card, random init from seed 0, with the launch counters reset just
    before and read just after.  Every batched decode call runs each MoE
    layer's router once over its rows (``topk_gating``): the expected
    launches are (decode calls + prefill chunks x max_prompt_len) x
    layers, from ``serve_schedule``; no other kernel runs on the path."""
    import numpy as np
    from repro_torch.models.transformer import Transformer
    from repro_torch.serve import (ServeConfig, ServeRuntime, make_prompts,
                                   run_closed_loop)
    from repro_torch.utils.tree import tree_leaves
    sc = ServeConfig(**SERVE)
    free(torch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rt = ServeRuntime(cfg, sc, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(rt.params))
    table = sum(t.numel() * t.element_size() for t in tree_leaves(rt.state))
    prompts = make_prompts(n_requests, sc.max_prompt_len, cfg.vocab, seed=1)
    want = serve_schedule(n_requests, sc)
    rows = want["decode"] + want["prefill"] * sc.max_prompt_len
    expect = {k: 0 for k in counters()}
    expect["topk_gating"] = rows * cfg.n_layers if cfg.moe else 0
    rt._decode, rt._prefill = Timed(torch, rt._decode), Timed(torch,
                                                             rt._prefill)
    torch.cuda.synchronize()
    init_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.perf_counter()
    row = run_closed_loop(rt, prompts, concurrency=sc.slots)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in read_counters().items() if "/" not in k}
    peak = torch.cuda.max_memory_allocated()
    dec, pre = rt._decode.ms(), rt._prefill.ms()
    recs = rt.records()
    with torch.no_grad():       # the slot table still decodes: finite logits
        lg, _ = Transformer.decode_step(rt.params, cfg, rt.cur_tok[:, None],
                                        rt.state, moe_group_size=1)
    finite = bool(torch.isfinite(lg).all())
    toks = [rt.results[r["rid"]].tokens for r in recs]
    in_vocab = all(((t >= 0) & (t < cfg.vocab)).all() for t in toks)
    tick_ms = float(np.median(dec[1:]))
    pct = lambda d: " ".join(f"{k} {v:.4f}s" for k, v in d.items())
    print(f"{label}: {cfg.name} L={cfg.n_layers} d={cfg.d_model} "
          f"{cfg.dtype}, {n_params:,} params; slot table {table / 1e9:.3f} "
          f"GB; init {init_s:.2f}s; {n_requests} requests at concurrency "
          f"{sc.slots} in {wall:.3f}s: {row['throughput_tok_s']:.1f} "
          f"tokens/s, {row['throughput_req_s']:.3f} requests/s; latency "
          f"{pct(row['latency_s'])}; ttft {pct(row['ttft_s'])}; "
          f"{row['ticks']} ticks, {len(dec)} decode calls at "
          f"{tick_ms:.3f} ms (median; first {dec[0]:.3f} ms, mean "
          f"{sum(dec) / len(dec):.3f} ms), {len(pre)} prefill chunks at "
          f"{float(np.median(pre)):.3f} ms ({sc.max_prompt_len} positions "
          f"each); peak memory {peak / 1e9:.2f} GB serving, "
          f"{init_peak / 1e9:.2f} GB at init; launches {launches} "
          f"(expected {expect}: ({want['decode']} + {want['prefill']} x "
          f"{sc.max_prompt_len}) x {cfg.n_layers} layers); traces "
          f"{rt.traces}; next logits finite {finite}")
    if not (row["by_status"]["done"] == n_requests and finite and in_vocab
            and all(len(t) == sc.max_new_tokens for t in toks)):
        raise AssertionError(f"{label}: requests not all done with "
                             f"{sc.max_new_tokens} tokens in the vocab, or "
                             f"non-finite logits: {row['by_status']}")
    sched = {"decode": len(dec), "prefill": len(pre), "ticks": row["ticks"]}
    if sched != want or rt.traces != {"prefill": 1, "admit": 1,
                                      "decode": 1}:
        raise AssertionError(f"{label}: schedule {sched} (expected {want}), "
                             f"traces {rt.traces}")
    for k, n in expect.items():
        if launches[k] != n:
            raise AssertionError(f"{label}: {k} launched {launches[k]} "
                                 f"times, expected {n}")
    out = {"config": {"arch": cfg.name, "n_layers": cfg.n_layers,
                      "requests": n_requests, **SERVE},
           "params": n_params, "slot_table_bytes": table, "init_s": init_s,
           "wall_s": wall, "row": row, "decode_ms": dec, "prefill_ms": pre,
           "tick_ms_median": tick_ms, "peak_bytes": peak,
           "init_peak_bytes": init_peak,
           "launches": launches, "expected_launches": expect,
           "traces": dict(rt.traces)}
    if profile:                 # one more tick, on the final slot table
        live = torch.ones(sc.slots, dtype=torch.bool, device=dev)
        args = (rt.params, rt.state, rt.cur_tok, live, rt.counts,
                rt.out_buf)
        rt._decode.fn(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rt._decode.fn(*args)
        host_ms = (time.perf_counter() - t0) * 1e3
        out["profile"] = device_profile(torch, f"{label} decode tick",
                                        lambda: rt._decode.fn(*args))
        out["profile"]["host_enqueue_ms"] = host_ms
        out["where_slot_ms"] = device_ms(
            lambda: rt._where_slot(live, rt.state, rt.state))
        print(f"{label}: one tick's host enqueue {host_ms:.3f} ms; the "
              f"_where_slot select over the slot table "
              f"{out['where_slot_ms']:.4f} ms device")
    del rt
    free(torch)
    return out


def serve_batched(torch, label, cfg, dev="cuda"):
    """Phase 16: ``launch.serve.serve_decoder_only`` (``BATCHED``: batch
    4, prompt 64, 32 steps) on the card from a random init; the batch is
    one sequence a row, and no kernel runs on the dense decode."""
    from repro_torch.launch.serve import serve_decoder_only
    b, p, n = BATCHED["batch"], BATCHED["prompt_len"], BATCHED["steps"]
    free(torch)
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.perf_counter()
    res = serve_decoder_only(cfg, b, p, n, device=dev)
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in read_counters().items() if "/" not in k}
    peak = torch.cuda.max_memory_allocated()
    toks = res["tokens"]
    ms = res["decode_s_per_token"] * 1e3
    print(f"{label}: {cfg.name} L={cfg.n_layers} d={cfg.d_model} head_dim "
          f"{cfg.hd} window {cfg.attn.window} softcaps "
          f"{cfg.attn.logit_softcap}/{cfg.attn.final_softcap} {cfg.dtype}; "
          f"batch {b}, prompt {p}: prefill {res['prefill_s']:.3f}s "
          f"({p / res['prefill_s']:.1f} steps/s), {n} decode steps at "
          f"{ms:.3f} ms ({b * 1e3 / ms:.1f} tokens/s); {wall:.2f}s with "
          f"init; peak memory {peak / 1e9:.2f} GB; launches {launches}")
    if tuple(toks.shape) != (b, n) or not bool(
            ((toks >= 0) & (toks < cfg.vocab)).all()):
        raise AssertionError(f"{label}: tokens {tuple(toks.shape)} out of "
                             f"shape or vocab")
    if any(launches.values()):
        raise AssertionError(f"{label}: a kernel launched on the dense "
                             f"decode: {launches}")
    free(torch)
    return {"prefill_s": res["prefill_s"], "decode_ms": ms, "wall_s": wall,
            "peak_bytes": peak, "launches": launches, **BATCHED}


def teacher_forcing(torch, arch, B=2, S=64, dev="cuda"):
    """Phase 17, card against card at full width: the logits of decode
    step t against ``Transformer.forward``'s at position t (bf16, random
    init, tokens from numpy), the forward going through the
    ``flash_attention`` and ``ssd_scan`` kernels (launches checked) and
    the decode through the plain ring-cache product and recurrence.  MoE
    capacity factor 8, so neither side drops a token.

    Tolerance: two bf16 computations of one function differ by bf16's
    own rounding, which has no fixed size at this depth; it is measured
    here as the rms distance of the bf16 forward from a float32 forward
    on the same weights (upcast; TF32 off).  The decode must lie within
    3x that rms of the bf16 forward.  A wrong ring slot, position, conv
    shift or carried state moves the logits by their own size."""
    import dataclasses
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import Transformer
    from repro_torch.utils.tree import tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch)
    if cfg.moe is not None:
        cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    free(torch)
    params = Transformer.init(torch.Generator(device=dev).manual_seed(0),
                              cfg)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, size=(B, S), dtype=np.int32)).to(dev)
    with torch.no_grad():
        reset_counters()
        fwd, _ = Transformer.forward(params, cfg, toks)
        torch.cuda.synchronize()
        launches = read_counters()
        want = block_launches(cfg, 0, cfg.n_layers)
        p32 = tree_map(lambda t: t.float(), params)
        fwd32, _ = Transformer.forward(p32, cfg.with_(dtype="float32"), toks)
        del p32
        free(torch)
        state = Transformer.init_decode_state(cfg, B, S, device=dev)
        outs = []
        for t in range(S):
            lg, state = Transformer.decode_step(params, cfg,
                                                toks[:, t:t + 1], state)
            outs.append(lg[:, 0])
        dec = torch.stack(outs, 1)
    rms = lambda x: float(x.double().square().mean().sqrt())
    err, noise, scale = rms(dec - fwd), rms(fwd - fwd32), rms(fwd)
    top1 = float((dec.argmax(-1) == fwd.argmax(-1)).double().mean())
    print(f"teacher forcing {arch} (full width, bf16, B={B} S={S}): rms "
          f"|decode - forward| {err:.4e}, bf16 yardstick rms |forward - "
          f"f32 forward| {noise:.4e} (tol 3x: {3 * noise:.4e}), logits rms "
          f"{scale:.4e}, max abs diff {float((dec - fwd).abs().max()):.4e}; "
          f"argmax agreement {top1:.4f}; forward launches {launches} "
          f"(expected {want})")
    for k, n in want.items():
        if launches[k] != n:
            raise AssertionError(f"teacher forcing {arch}: {k} launched "
                                 f"{launches[k]} times, expected {n}")
    if not (math.isfinite(err) and err <= 3 * noise):
        raise AssertionError(f"teacher forcing {arch}: decode and forward "
                             f"disagree ({err} > 3 x {noise})")
    del params, state
    free(torch)
    return {"rms_err": err, "rms_bf16_noise": noise, "rms_logits": scale,
            "argmax_agreement": top1, "launches": launches}


def serve_card_against_cpu(torch, dev="cuda"):
    """Phase 17, card against CPU: the smoke configs of olmoe-1b-7b,
    zamba2-1.2b and gemma2-2b in float32 (TF32 off) through
    ``ServeRuntime`` on both, with one init drawn on the CPU, one prompt
    set and a clock that stands still: generated tokens, ``records()``
    and ``stats()`` equal, and one more decode from each final slot
    table: logits and the slot table within 1e-4."""
    from repro_torch.configs import smoke_config
    from repro_torch.models.transformer import Transformer
    from repro_torch.serve import (ServeConfig, ServeRuntime, make_prompts,
                                   run_closed_loop)
    from repro_torch.utils.tree import tree_leaves, tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    sc = ServeConfig(slots=4, max_prompt_len=8, max_new_tokens=6,
                     prefill_batch=2)
    out = {}
    for arch in ("olmoe-1b-7b", "zamba2-1.2b", "gemma2-2b"):
        cfg = smoke_config(arch)
        params = Transformer.init(torch.Generator().manual_seed(0), cfg)
        prompts = make_prompts(10, sc.max_prompt_len, cfg.vocab, seed=5)
        runs = {}
        for side, d in (("cpu", "cpu"), ("card", dev)):
            rt = ServeRuntime(cfg, sc, params=tree_map(lambda t: t.to(d),
                                                       params),
                              clock=lambda: 0.0, device=d)
            row = run_closed_loop(rt, prompts, concurrency=3)
            with torch.no_grad():
                lg, _ = Transformer.decode_step(
                    rt.params, cfg, rt.cur_tok[:, None], rt.state,
                    moe_group_size=1)
            runs[side] = (row, rt.records(), rt.stats(),
                         [rt.results[r].tokens.tolist()
                          for r in sorted(rt.results)],
                         lg.cpu(), [t.cpu() for t in tree_leaves(rt.state)])
        (rc, recc, stc, tc, lc, sc_), (rg, recg, stg, tg, lgc, sg) = \
            runs["cpu"], runs["card"]
        d_logits = float((lc - lgc).abs().max())
        d_state = max(float((a.double() - b.double()).abs().max())
                      for a, b in zip(sc_, sg))
        same = rc == rg and recc == recg and stc == stg and tc == tg
        print(f"serve card-vs-cpu {arch} (smoke, f32): tokens, records, "
              f"stats and the loop's row equal {same} ({len(tc)} requests, "
              f"{sum(map(len, tc))} tokens); next logits max abs diff "
              f"{d_logits:.3e}, slot table {d_state:.3e} (tol 1e-4)")
        if not (same and d_logits <= 1e-4 and d_state <= 1e-4):
            raise AssertionError(f"serve card-vs-cpu {arch}: card and CPU "
                                 f"disagree")
        out[arch] = {"logits_max_abs": d_logits, "state_max_abs": d_state,
                     "tokens": sum(map(len, tc))}
    return out


# phases 18-20: the Engine's fault and population paths at the main
# path's width.  Checkpoints go under build/ in the checkout (listed in
# .gitignore) and are removed after.
CKPT_ROOT = os.path.join(ROOT, "build", "chip_smoke_ckpt")
PHASE18_ROUNDS, PHASE19_ROUNDS, PHASE20_ROUNDS = 10, 24, 12


def _sync(torch, dev):
    if str(dev).startswith("cuda"):
        torch.cuda.synchronize()


def run_engine(torch, cfg, dev="cuda", state=None, **engine_kw):
    """``Engine.run()`` on ``dev`` with the launch counters reset just
    before and read just after: the result, the last committed state
    (whole, on a mesh: gathered after the last round's census), each
    round's scalar metrics and the host clock after each round (the
    Engine syncs every round under ``collect_timing``; without it the
    callback syncs), on a mesh the census of each round's collectives
    (both axes'; a round's evaluation lands in the next round's), the
    launches and the Engine."""
    from repro_torch.api import Engine
    stamps, rows, final, census = [], [], [], []

    def take(engine):
        c = dict(engine.mesh.comm.take_census())
        for other in (engine.mesh.model_comm, engine.mesh.data_comm):
            if other is not None and other is not engine.mesh.comm:
                c.update(other.take_census())
        return c

    class Rec:
        def on_round(self, engine, rnd, st, metrics):
            _sync(torch, dev)
            stamps.append(time.perf_counter())
            rows.append({k: v for k, v in metrics.items() if v.numel() == 1})
            if engine.mesh is not None:
                census.append(take(engine))
            if rnd == engine.cfg.rounds - 1:
                final[:] = [engine.whole_state(st)]

    eng = Engine(cfg, device=dev, callbacks=[Rec()], log=lambda msg: None,
                 **engine_kw)
    if eng.mesh is not None:
        take(eng)
    reset_counters()
    _sync(torch, dev)
    t0 = time.perf_counter()
    res = eng.run(state=state)
    _sync(torch, dev)
    wall = time.perf_counter() - t0
    launches = read_counters()
    rows = [{k: float(v) for k, v in r.items()} for r in rows]
    return {"res": res, "state": final[0] if final else None, "rows": rows,
            "stamps": [t0] + stamps, "wall_s": wall, "launches": launches,
            "census": census, "engine": eng}


def state_diff(torch, a, b) -> float:
    """Largest |a - b| over two states' leaves (0.0: bit-equal)."""
    from repro_torch.utils.tree import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    worst = 0.0
    for x, y in zip(la, lb):
        x, y = x.detach().cpu(), y.detach().cpu()
        if not torch.equal(x, y):
            d = float((x.double() - y.double()).abs().max())
            worst = max(worst, d if d == d else float("inf"))   # NaN
    return worst


def strip_elapsed(history):
    return [{k: v for k, v in r.items() if k != "elapsed_s"} for r in history]


def harness_crash_resume(torch, dev="cuda", rounds=6):
    """The port's SIGKILL harness: an unbroken run, then a run SIGKILLed
    once its step_3 exists, resumed; each a process of its own on
    ``dev``.  Returns the unbroken and resumed results and the step the
    kill left."""
    import shutil
    import signal
    from repro_torch.checkpoint import latest_step
    base = os.path.join(CKPT_ROOT, "harness")
    shutil.rmtree(base, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))

    def cmd(ck, *extra):
        return [sys.executable, "-m", "repro_torch.resilience.harness",
                "--device", dev, "--ckpt-dir", os.path.join(base, ck),
                "--rounds", str(rounds), *extra]

    golden = os.path.join(base, "golden.json")
    subprocess.run(cmd("golden", "--out", golden), env=env, cwd=ROOT,
                   check=True, timeout=240, stdout=subprocess.DEVNULL)
    ck = os.path.join(base, "killed")
    proc = subprocess.Popen(cmd("killed", "--sleep-per-round", "0.5"),
                            env=env, cwd=ROOT, stdout=subprocess.DEVNULL)
    try:
        deadline = time.time() + 240
        while (latest_step(ck) or 0) < 3:
            if proc.poll() is not None:
                raise AssertionError("harness exited before its step_3")
            if time.time() > deadline:
                raise AssertionError("harness never wrote step_3")
            time.sleep(0.05)
        os.kill(proc.pid, signal.SIGKILL)
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait()
    killed_at = latest_step(ck)
    out = os.path.join(base, "resumed.json")
    subprocess.run(cmd("killed", "--resume", "--out", out), env=env,
                   cwd=ROOT, check=True, timeout=240,
                   stdout=subprocess.DEVNULL)
    with open(golden) as f, open(out) as g:
        return json.load(f), json.load(g), killed_at


def checkpoint_resume(torch, dev="cuda"):
    """Phase 18: crash-safe checkpoints and resume at the main path's
    width.  cyclesfl on femnist_cnn width 32 (100 clients, cohort 5,
    batch 16, cut 2), ``PHASE18_ROUNDS`` rounds, eval and checkpoint
    every 2: the unbroken run twice (are two card runs bit-equal?), then
    4 rounds, stop, and a fresh Engine resumed to the end.  The resumed
    state is held to bit-equality when the two unbroken runs are
    bit-equal, else to twice their spread; its cohorts and telemetry,
    numpy draws, equal always.  Then a torn checkpoint (the fault stream
    tears step 4, leaves step 2): resume falls back to step 2 and ends
    as the unbroken run does.  Then the SIGKILL harness on the card.
    Last, ``save_checkpoint`` and ``load_checkpoint`` ms per step on the
    width-32 state."""
    import shutil
    from repro_torch.api import ExperimentConfig
    from repro_torch.checkpoint import (load_checkpoint, save_checkpoint,
                                        valid_steps)
    from repro_torch.resilience import (FaultConfig, FaultStream,
                                        ResilienceConfig)
    from repro_torch.utils.tree import tree_leaves
    shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    R = PHASE18_ROUNDS
    base = dict(rounds=R, eval_every=2, cut=2, **MAIN)
    ck = lambda name: os.path.join(CKPT_ROOT, name)
    u = [run_engine(torch, ExperimentConfig(
        ckpt_dir=ck(f"unbroken{i}"), **base), dev) for i in (0, 1)]
    spread = state_diff(torch, u[0]["state"], u[1]["state"])
    exact = spread == 0.0
    hist0 = strip_elapsed(u[0]["res"]["history"])
    tel0 = u[0]["res"]["telemetry"]["per_round"]
    print(f"ckpt: two unbroken card runs {'bit-equal' if exact else 'differ'}"
          f" (max |state diff| {spread:.3e})")

    def resumed(label, name, partial_kw, resume_kw, want_from):
        part = run_engine(torch, ExperimentConfig(
            **{**base, "rounds": 4, "ckpt_dir": ck(name), **partial_kw}),
            dev)
        steps = valid_steps(ck(name), warn=False)
        run = run_engine(torch, ExperimentConfig(
            **{**base, "ckpt_dir": ck(name), "resume": True, **resume_kw}),
            dev)
        res = run["res"]
        d = state_diff(torch, run["state"], u[0]["state"])
        held = d == 0.0 if exact else d <= 2 * spread
        tel = res["telemetry"]["per_round"]
        hist = strip_elapsed(res["history"])
        want_hist = [h for h in hist0 if h["round"] > want_from]
        hist_ok = (hist == want_hist if exact else
                   [h["round"] for h in hist] == [h["round"] for h in
                                                  want_hist])
        print(f"{label}: valid steps after the partial run {steps}; resumed "
              f"from round {res.get('resumed_from_round')} (expected "
              f"{want_from}); max |state diff| to unbroken {d:.3e} "
              f"({'bit-equality' if exact else 'twice the spread'} held: "
              f"{held}); telemetry equal {tel == tel0[want_from:]}; "
              f"history equal {hist_ok}")
        if not (res.get("resumed_from_round") == want_from and held
                and tel == tel0[want_from:] and hist_ok):
            raise AssertionError(f"{label}: the resumed run is not the "
                                 "unbroken one")
        return {"valid_steps": steps, "resumed_from": want_from,
                "max_abs_diff": d, "partial_wall_s": part["wall_s"],
                "resumed_wall_s": run["wall_s"]}

    out = {"unbroken_bit_equal": exact, "unbroken_spread": spread,
           "resume": resumed("ckpt resume", "partial", {}, {}, 4)}
    torn = FaultConfig(ckpt_rate=0.5, seed=1)
    stream = FaultStream(torn, 0)
    assert stream.ckpt_corrupt(4) and not stream.ckpt_corrupt(2)
    faults = {"resilience": ResilienceConfig(faults=torn)}
    out["torn"] = resumed("ckpt torn", "torn", faults, faults, 2)
    golden, res, killed_at = harness_crash_resume(torch, dev)
    g = {h["round"]: h for h in strip_elapsed(golden["history"])}
    got = strip_elapsed(res["history"])
    same = all(h == g[h["round"]] for h in got) if exact else all(
        abs(h["test_loss"] - g[h["round"]]["test_loss"])
        <= 1e-4 * abs(g[h["round"]]["test_loss"]) for h in got)
    print(f"ckpt harness: SIGKILLed with step_{killed_at} written, resumed "
          f"from round {res['resumed_from_round']}, {len(got)} evaluations "
          f"after it {'equal to' if same else 'NOT equal to'} the unbroken "
          "harness run's")
    if not (got and same and res["resumed_from_round"] == killed_at >= 3):
        raise AssertionError("ckpt harness: the resumed run is not the "
                             "unbroken one")
    out["harness"] = {"killed_at": killed_at, "rows": len(got)}
    state = u[0]["state"]
    nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(state))
    d = ck("timing")
    save_ms, load_ms = [], []
    for step in range(1, 6):
        _sync(torch, dev)
        t = time.perf_counter()
        save_checkpoint(d, step, state)
        save_ms.append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        back, _ = load_checkpoint(d, state, step=step)
        _sync(torch, dev)
        load_ms.append((time.perf_counter() - t) * 1e3)
        assert state_diff(torch, back, state) == 0.0
    print(f"ckpt timing: state {nbytes} bytes in {len(tree_leaves(state))} "
          f"leaves; save_checkpoint ms per step {save_ms}; load_checkpoint "
          f"ms per step {load_ms} (fsynced tmp dir + rename + CRC-32; "
          "the load includes the copy to the card)")
    out["timing"] = {"state_bytes": nbytes, "save_ms": save_ms,
                     "load_ms": load_ms}
    shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    return out


def resilience_configs():
    """The reference bench's six configs
    (benchmarks/bench_resilience.py:52-66)."""
    from repro_torch.resilience import FaultConfig, ResilienceConfig
    return {
        "guard_off": ResilienceConfig(),
        "guard_on": ResilienceConfig(guard=True),
        "nan_quarantine": ResilienceConfig(
            guard=True, on_nonfinite="quarantine",
            faults=FaultConfig(nan_rate=0.3, persist=10)),
        "nan_retry": ResilienceConfig(
            guard=True, on_nonfinite="retry",
            faults=FaultConfig(nan_rate=0.3)),
        "nan_rollback": ResilienceConfig(
            guard=True, on_nonfinite="rollback",
            faults=FaultConfig(nan_rate=0.3)),
        "dispatch_error": ResilienceConfig(
            faults=FaultConfig(error_rate=0.3)),
    }


def expected_faults(rcfg, seed, rounds, live):
    """What the deterministic stream fires over ``rounds`` rounds of
    ``live`` clients: the faulted rounds, the faults by kind, and the
    extra round dispatches recovery makes (a NaN round runs twice; a
    dispatch error raises before its round runs)."""
    from repro_torch.resilience import FaultInjectedError, FaultStream
    stream = FaultStream(rcfg.faults, seed)
    faulted, nan, err = 0, 0, 0
    for r in range(rounds):
        fired = bool(stream.nan_slots_for(r, 0, live).size)
        n_err, att = 0, 0
        while True:
            try:
                stream.check_dispatch(r, att)
                break
            except FaultInjectedError:
                n_err, att = n_err + 1, att + 1
        if n_err > rcfg.max_retries:
            raise AssertionError(f"round {r}: the stream exhausts the "
                                 "retry budget")
        faulted += fired or n_err > 0
        nan += fired
        err += n_err
    return {"faulted_rounds": faulted,
            "faults": {"nonfinite": nan, "spike": 0, "error": err},
            "extra_dispatches": nan}


def resilience(torch, dev="cuda", rounds=PHASE19_ROUNDS):
    """Phase 19: the main path at width 32 (cut 2, ``collect_timing``)
    under the reference bench's six resilience configs, guard_off and
    guard_on in turns (off, on, on, off, off, on): their histories
    equal (bit for bit when the first two guard_off runs are), each
    one's round_time_s.  Each faulted config: its summary holds exactly the faults the stream
    fires, every one recovered; feature_resample and fused_adam launch
    their per-round count times the rounds the dispatch ran (a NaN round
    runs twice), and each faulted round's extra time over the run's
    median clean round.  Then nan_quarantine at cut 3 with
    ``fused_gather_loss``, a poisoned slot through gather_loss."""
    from repro_torch.api import ExperimentConfig
    from repro_torch.utils.tree import tree_leaves
    per_round = {"feature_resample": 2 * 5, "fused_adam": 2 * 5 + 4}
    cfgs = resilience_configs()
    base = dict(rounds=rounds, eval_every=rounds, cut=2,
                collect_timing=True, **MAIN)
    runs, out = {}, {}
    for name in ("guard_off", "guard_on", "guard_on", "guard_off",
                 "guard_off", "guard_on", "nan_quarantine", "nan_retry", "nan_rollback",
                 "dispatch_error"):
        run = run_engine(torch, ExperimentConfig(
            resilience=cfgs[name], **base), dev)
        runs.setdefault(name, []).append(run)
    off, on = runs["guard_off"], runs["guard_on"]
    spread = state_diff(torch, off[0]["state"], off[1]["state"])
    exact = spread == 0.0
    hists = [strip_elapsed(r["res"]["history"]) for r in off + on]
    d_on = max(state_diff(torch, r["state"], off[0]["state"]) for r in on)
    same = (all(h == hists[0] for h in hists) and d_on == 0.0) if exact \
        else d_on <= 2 * spread
    rt = {k: [r["res"]["round_time_s"] for r in v] for k, v in runs.items()}
    # the median host-clock round of each run (rounds 2 on): the steady
    # state, without the first rounds' allocations
    med = {k: [sorted(b - a for a, b in zip(r["stamps"][1:],
                                             r["stamps"][2:]))[rounds // 2]
               for r in runs[k]] for k in ("guard_off", "guard_on")}
    held = ("DIFFER" if not same else "bit-equal" if exact
            else "within twice the guard_off spread")
    print(f"resilience: guard_on vs guard_off histories and states {held} "
          f"(guard_off runs bit-equal: {exact}); round_time_s guard_off "
          f"{rt['guard_off']}, guard_on {rt['guard_on']}; median round s "
          f"guard_off {med['guard_off']}, guard_on {med['guard_on']}")
    if not same:
        raise AssertionError("resilience: the guard changed the run")
    for k in ("feature_resample", "fused_adam"):
        for r in off + on:
            if r["launches"][k] != per_round[k] * rounds:
                raise AssertionError(f"resilience: {k} launched "
                                     f"{r['launches'][k]}")
    out["guard"] = {"round_time_s": {"guard_off": rt["guard_off"],
                                     "guard_on": rt["guard_on"]},
                    "median_round_s": med, "bit_equal": exact}
    for name in ("nan_quarantine", "nan_retry", "nan_rollback",
                 "dispatch_error"):
        run = runs[name][0]
        tel = run["res"]["resilience"]
        want = expected_faults(cfgs[name], 0, rounds, 5)
        got = {"faulted_rounds": tel["faulted_rounds"],
               "faults": tel["faults"]}
        # the policy's action took every fault: a quarantine, a retry,
        # a rollback (round 0's empty ring escalates to a retry), a retry
        # of each dispatch error
        acted = {"nan_quarantine": tel["quarantine_events"],
                 "nan_retry": tel["retries"],
                 "nan_rollback": tel["rollbacks"] + tel["retries"],
                 "dispatch_error": tel["retries"]}[name]
        faults = sum(want["faults"].values())
        n_dispatch = rounds + want["extra_dispatches"]
        launches_ok = all(run["launches"][k] == per_round[k] * n_dispatch
                          for k in per_round)
        finite = all(bool(torch.isfinite(t).all())
                     for t in tree_leaves(run["state"])
                     if t.is_floating_point())
        steps = [b - a for a, b in zip(run["stamps"][1:], run["stamps"][2:])]
        bad = {row["round"] for row in tel["per_round"]}
        clean = sorted(s for i, s in enumerate(steps, 1) if i not in bad)
        med = clean[len(clean) // 2]
        extra_ms = [(steps[r - 1] - med) * 1e3 for r in sorted(bad) if r > 0]
        print(f"resilience {name}: faulted rounds {tel['faulted_rounds']}, "
              f"faults {tel['faults']} (the stream fires "
              f"{want['faulted_rounds']} rounds, {want['faults']}); "
              f"quarantined clients {tel['quarantined_clients']}, retries "
              f"{tel['retries']}, rollbacks {tel['rollbacks']}; launches "
              f"{ {k: run['launches'][k] for k in per_round} } for "
              f"{n_dispatch} round dispatches; round_time_s "
              f"{run['res']['round_time_s']:.6f}; recovery ms per faulted "
              f"round over the median clean round ({med * 1e3:.3f} ms) "
              f"{[round(x, 3) for x in extra_ms]}; state finite {finite}")
        if not (got == {k: want[k] for k in got} and launches_ok and finite
                and acted == faults and want["faulted_rounds"] > 0):
            raise AssertionError(f"resilience {name}: not the stream's "
                                 "faults, all recovered")
        out[name] = {"summary": {k: v for k, v in tel.items()
                                 if k != "per_round"},
                     "round_time_s": run["res"]["round_time_s"],
                     "recovery_ms_per_faulted_round": extra_ms,
                     "median_clean_round_ms": med * 1e3,
                     "launches": run["launches"]}
    fused = run_engine(torch, ExperimentConfig(
        **{**base, "cut": 3}, resilience=cfgs["nan_quarantine"]
    ).with_cycle(fused_gather_loss=True), dev)
    tel = fused["res"]["resilience"]
    want = expected_faults(cfgs["nan_quarantine"], 0, rounds, 5)
    n_dispatch = rounds + want["extra_dispatches"]
    finite = all(bool(torch.isfinite(t).all())
                 for t in tree_leaves(fused["state"]) if t.is_floating_point())
    print(f"resilience nan_quarantine cut3 fused: {tel['quarantine_events']} "
          f"quarantines, clients {tel['quarantined_clients']}; gather_loss "
          f"launched {fused['launches']['gather_loss']} (expected "
          f"{5 * n_dispatch}); state finite {finite}")
    if not (finite and tel["quarantine_events"] == want["faulted_rounds"]
            and fused["launches"]["gather_loss"] == 5 * n_dispatch):
        raise AssertionError("resilience cut3 fused: a poisoned slot broke "
                             "the gather_loss path")
    out["nan_quarantine_cut3_fused"] = {
        "summary": {k: v for k, v in tel.items() if k != "per_round"},
        "launches": fused["launches"]}
    return out


def resilience_card_against_cpu(torch):
    """Phase 19, last part: nan_quarantine and nan_rollback on phase 13's
    configuration (2 rounds at width 8, 10 clients, variable attendance,
    batch 8, cut 2, server epochs 2, seed 4) on the CPU and on the card
    from one init and one plan, with the fault stream seeded 0, which
    poisons round 1 alone: a quarantine there, and a rollback to round
    0's snapshot.  Two rounds for phase 13's reason: later rounds of a
    cohort of two carry biases at float32 noise whose sign the devices
    round differently (a 6-round run drifts to 8e-4 of a metric on the
    H100, the task's discontinuity, not either side's).  Summaries and
    quarantined clients equal; the run held to ``compare_runs``."""
    from dataclasses import replace
    from repro_torch.api import ExperimentConfig
    from repro_torch.core.feature_store import masked_resample_plan

    def plan_fn(key, valid, epochs, sb):
        return masked_resample_plan(key, valid.cpu(), epochs, sb)

    cfgs = resilience_configs()
    out = {}
    for name in ("nan_quarantine", "nan_rollback"):
        rc = cfgs[name]
        cfg = ExperimentConfig(
            rounds=2, eval_every=2, n_clients=10, attendance=0.3, batch=8,
            width=8, cut=2, seed=4, variable_attendance=True,
            resilience=replace(rc, faults=replace(rc.faults, seed=0))
        ).with_cycle(server_epochs=2)
        runs = cpu_and_card(torch, cfg, plan_fn)
        sc = runs["cpu"][3].recovery.summary()
        sg = runs["cuda"][3].recovery.summary()
        print(f"card-vs-cpu resilience {name}: summaries equal {sc == sg} "
              f"(faulted rounds {[r['round'] for r in sc['per_round']]}, "
              f"quarantined {sc['quarantined_clients']}, rollbacks "
              f"{sc['rollbacks']})")
        acted = sc["quarantine_events"] if name == "nan_quarantine" \
            else sc["rollbacks"]
        if sc != sg or not acted:
            raise AssertionError(f"card-vs-cpu resilience {name}: the "
                                 "recovery differs")
        out[name] = compare_runs(torch, f"resilience {name}", runs)
    return out


# phase 20: the reference bench's population scenarios
# (benchmarks/bench_population.py:50-56, straggler_async with its
# pipelined async schedule at depth 1) and diurnal churn at its defaults
# (weighted O(N) cohort draws)
POPULATION = dict(n_clients=100_000, cohort=32, batch=8, width=32)


def population_scenarios():
    """name -> (scenario, ExperimentConfig overrides)."""
    from repro_torch.scenario import ScenarioConfig
    straggler = ScenarioConfig(kind="pareto-straggler", straggler=1.0,
                               staleness_bound=1)
    return {"no_churn": (ScenarioConfig(), {}),
            "dropout": (ScenarioConfig(kind="uniform", dropout=0.15), {}),
            "straggler": (straggler, {}),
            "straggler_async": (straggler, dict(pipeline_depth=1,
                                                pipeline_staleness="async")),
            "diurnal_churn": (ScenarioConfig(kind="diurnal-churn"), {})}


def population(torch, dev="cuda", rounds=PHASE20_ROUNDS):
    """Phase 20: ``run_population`` at 100,000 clients, cohort 32, batch
    8, mlp width 32 (cut 1), ``rounds`` rounds under each scenario, with
    the counters reset before and read after: rounds/s by the Engine's
    round_time_s, steady ms, clients materialized; feature_resample and
    fused_adam per round (32 server steps of the pooled 256 rows, 2
    gathers and 1 step each, plus 1 client step) times the rounds; the
    telemetry equal to a CPU run's exactly; and the sampler's own ms a
    round (``Engine.sample_round`` alone on a fresh fleet: the cohort
    draw, the clients' first materialization, the copy to ``dev``).
    straggler_async runs the pipelined async schedule at depth 1 (its
    extracts on the side stream): the same launches, and a maximum
    realized lag of 1."""
    import numpy as np
    from repro_torch.api import Engine
    from repro_torch.scenario.population import (PopulationSpec,
                                                 build_population,
                                                 population_config,
                                                 run_population)
    spec = PopulationSpec(n_clients=POPULATION["n_clients"])
    kw = dict(cohort=POPULATION["cohort"], rounds=rounds,
              batch=POPULATION["batch"], width=POPULATION["width"])
    steps = POPULATION["cohort"]      # pooled cohort * batch rows / batch
    want = {"feature_resample": 2 * steps * rounds,
            "fused_adam": (steps + 1) * rounds}
    out = {}
    for name, (sc, over) in population_scenarios().items():
        reset_counters()
        _sync(torch, dev)
        t0 = time.perf_counter()
        res = run_population(spec, sc, device=dev, **kw, **over)
        _sync(torch, dev)
        wall = time.perf_counter() - t0
        launches = read_counters()
        cpu = run_population(spec, sc, device="cpu", **kw, **over)
        task, fed, _ = build_population(spec, width=POPULATION["width"])
        eng = Engine(population_config(spec, sc, cohort=kw["cohort"],
                                       rounds=rounds, batch=kw["batch"],
                                       **over),
                     device=dev, task=task, fed=fed, log=lambda msg: None)
        rng = np.random.default_rng(eng.cfg.seed + 1)
        t0 = time.perf_counter()
        for _ in range(rounds):
            eng.sample_round(rng)
        _sync(torch, dev)
        sample_ms = (time.perf_counter() - t0) * 1e3 / rounds
        tel, pop = res["telemetry"], res["population"]
        rt = res["round_time_s"]
        print(f"population {name}: {rounds} rounds in {wall:.3f}s; "
              f"{1.0 / rt:.2f} rounds/s, steady {rt * 1e3:.3f} ms a round, "
              f"of which the sampler alone {sample_ms:.3f} ms; "
              f"clients materialized {pop['clients_materialized']}; live "
              f"cohort mean {tel['live_cohort_mean']}, dropped "
              f"{tel['dropped_total']} (hazard {tel['drop_hazard_total']}, "
              f"deadline {tel['drop_deadline_total']}), max drawn lag "
              f"{tel['max_drawn_lag']}, max realized lag "
              f"{tel['max_realized_lag']}; telemetry equal to the CPU run's "
              f"{tel == cpu['telemetry']}; accuracy "
              f"{res['history'][-1]['accuracy']:.4f} (CPU "
              f"{cpu['history'][-1]['accuracy']:.4f}); launches "
              f"{ {k: launches[k] for k in want} } (expected {want})")
        if not (tel == cpu["telemetry"]
                and pop["clients_materialized"]
                == cpu["population"]["clients_materialized"]
                and all(launches[k] == n for k, n in want.items())
                and tel["max_realized_lag"] <= over.get("pipeline_depth", 0)
                and math.isfinite(res["history"][-1]["test_loss"])):
            raise AssertionError(f"population {name}: the card's run is not "
                                 "the CPU's")
        out[name] = {"rounds_per_s": 1.0 / rt, "steady_ms": rt * 1e3,
                     "sampler_ms": sample_ms, "wall_s": wall,
                     "clients_materialized": pop["clients_materialized"],
                     "telemetry": {k: v for k, v in tel.items()
                                   if k != "per_round"},
                     "accuracy": res["history"][-1]["accuracy"],
                     "launches": launches}
    return out


# phases 21-22: whisper-base whole, the encoder-decoder family; the
# decode step at batch 8 over a context of 448, serve_whisper at batch 4
WHISPER_DECODE = dict(batch=8, steps=32)
WHISPER_SERVE = dict(batch=4, steps=32)


def whisper_forward_launches(cfg, encode=True, decode=True):
    """flash_attention launches of one forward: the encoder launches once
    a block (self-attention), the decoder twice a block (causal
    self-attention and cross-attention).  A decode step launches the
    cross-attention alone, ``cfg.n_layers`` (its self-attention is the
    plain ring-cache product).  Every whisper-base launch is bf16 at
    head_dim 64, on the tensor cores."""
    return (cfg.enc_layers if encode else 0) + (2 * cfg.n_layers if decode
                                                 else 0)


def whisper_decode(torch):
    """Phase 21: ``build_decode_step`` for whisper-base at batch 8 over a
    context of 448 and 1500 encoded frames: ``steps`` greedy steps timed
    between CUDA events on the device timeline, each launching the
    cross-attention's flash_attention once a decoder block (Sq = 1)."""
    from repro_torch.configs import InputShape, get_config
    from repro_torch.launch.steps import build_decode_step
    cfg = get_config("whisper-base")
    B, n = WHISPER_DECODE["batch"], WHISPER_DECODE["steps"]
    bundle = build_decode_step(cfg, InputShape("whisper decode", WHISPER_TEXT,
                                               B, "decode"), device="cuda")
    params, state = bundle.init_state(0)
    (tok,) = bundle.make_batch(0)
    lg, _ = bundle.fn(params, tok, state)          # warm
    torch.cuda.synchronize()
    reset_counters()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        lg, state = bundle.fn(params, tok, state)
        tok = torch.argmax(lg, dim=-1).to(torch.int32)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / n
    launches = read_counters()
    want = cfg.n_layers * n
    ok = bool(torch.isfinite(lg).all()) and int(state["pos"]) == n
    print(f"whisper decode: B={B} context {WHISPER_TEXT} frames "
          f"{WHISPER_FRAMES}: {n} steps at {ms:.3f} ms a token "
          f"({B * 1e3 / ms:.1f} tokens/s); finite={ok}; launches {launches} "
          f"(expected flash_attention {want}, all wgmma)")
    if not ok:
        raise AssertionError("whisper decode: non-finite logits or a wrong "
                             "position")
    if (launches["flash_attention"], launches["flash_attention/wgmma"]) != (
            want, want):
        raise AssertionError(f"whisper decode: flash_attention launched "
                             f"{launches['flash_attention']}, expected {want}")
    del params, state
    free(torch)
    return {"ms_per_token": ms, "launches": launches, **WHISPER_DECODE}


def whisper_serve(torch, dev="cuda"):
    """Phase 21: ``launch.serve.serve_whisper`` for whisper-base whole
    (batch 4, 32 greedy steps over 60 encoded frames, random init):
    6 flash_attention launches to encode, then 6 a step."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve_whisper
    cfg = get_config("whisper-base")
    b, n = WHISPER_SERVE["batch"], WHISPER_SERVE["steps"]
    free(torch)
    reset_counters()
    t0 = time.perf_counter()
    res = serve_whisper(cfg, b, n, device=dev)
    wall = time.perf_counter() - t0
    launches = read_counters()
    want = cfg.enc_layers + n * cfg.n_layers
    toks = res["tokens"]
    ms = res["decode_s_per_token"] * 1e3
    print(f"serve whisper: batch {b}, {n} steps at {ms:.3f} ms a token "
          f"({b * 1e3 / ms:.1f} tokens/s), {wall:.2f}s with init; launches "
          f"{launches} (expected flash_attention {want})")
    if tuple(toks.shape) != (b, n) or not bool(
            ((toks >= 0) & (toks < cfg.vocab)).all()):
        raise AssertionError(f"serve whisper: tokens {tuple(toks.shape)} out "
                             f"of shape or vocab")
    if launches["flash_attention"] != want:
        raise AssertionError(f"serve whisper: flash_attention launched "
                             f"{launches['flash_attention']}, expected {want}")
    return {"decode_ms": ms, "wall_s": wall, "launches": launches,
            **WHISPER_SERVE}


def whisper_teacher_forcing(torch, B=2, S=16, dev="cuda"):
    """Phase 22, card against card at full width: the logits of ``S``
    ``EncDec.decode_step`` calls against ``EncDec.forward``'s on the same
    tokens and 1500 frames (bf16, random init), within phase 17's
    yardstick: 3x the rms of the bf16 forward against a float32 forward
    on the same weights (TF32 off).  The decode's self-attention is the
    plain ring-cache product and its cross-attention the kernel at Sq =
    1; a wrong ring slot, position or encoder state moves the logits by
    their own size."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models.encdec import EncDec
    from repro_torch.utils.tree import tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("whisper-base")
    free(torch)
    params = EncDec.init(torch.Generator(device=dev).manual_seed(0), cfg)
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, size=(B, S),
                                         dtype=np.int32)).to(dev)
    frames = torch.from_numpy(rng.standard_normal(
        (B, WHISPER_FRAMES, cfg.enc_d_model)).astype(np.float32)).to(dev)
    with torch.no_grad():
        reset_counters()
        fwd = EncDec.forward(params, cfg, frames.to(cfg.torch_dtype), toks)
        torch.cuda.synchronize()
        launches = read_counters()
        p32 = tree_map(lambda t: t.float(), params)
        fwd32 = EncDec.forward(p32, cfg.with_(dtype="float32"), frames, toks)
        del p32
        state = EncDec.init_decode_state(params, cfg,
                                         frames.to(cfg.torch_dtype), S)
        outs = []
        for t in range(S):
            lg, state = EncDec.decode_step(params, cfg, toks[:, t:t + 1],
                                           state)
            outs.append(lg[:, 0])
        dec = torch.stack(outs, 1)
    rms = lambda x: float(x.double().square().mean().sqrt())
    err, noise, scale = rms(dec - fwd), rms(fwd - fwd32), rms(fwd)
    top1 = float((dec.argmax(-1) == fwd.argmax(-1)).double().mean())
    want = whisper_forward_launches(cfg)
    print(f"teacher forcing whisper-base (full width, bf16, B={B} S={S}, "
          f"{WHISPER_FRAMES} frames): rms |decode - forward| {err:.4e}, bf16 "
          f"yardstick rms |forward - f32 forward| {noise:.4e} (tol 3x: "
          f"{3 * noise:.4e}), logits rms {scale:.4e}, max abs diff "
          f"{float((dec - fwd).abs().max()):.4e}; argmax agreement "
          f"{top1:.4f}; forward launches {launches} (expected "
          f"flash_attention {want})")
    if launches["flash_attention/wgmma"] != want:
        raise AssertionError(f"teacher forcing whisper: flash_attention "
                             f"launched {launches}, expected {want}")
    if not (math.isfinite(err) and err <= 3 * noise):
        raise AssertionError(f"teacher forcing whisper: decode and forward "
                             f"disagree ({err} > 3 x {noise})")
    del params, state
    free(torch)
    return {"rms_err": err, "rms_bf16_noise": noise, "rms_logits": scale,
            "argmax_agreement": top1, "launches": launches}


def whisper(torch, profile=False):
    """Phases 21-22: the whisper round (``split_round`` of whisper-base
    whole: 6 encoder blocks on each client, 6 decoder blocks on the
    server, cohort 2, batch 2, 1500 frames, 448 text positions, bf16),
    the prefill (18 flash_attention launches), decode and serve on the
    card, then the round card against CPU at the smoke config (phase
    9's tolerances) and teacher forcing at full width."""
    from repro_torch.configs import get_config
    cfg = get_config("whisper-base")
    free(torch)
    out = {"round": split_round(torch, "whisper round", cfg, profile=profile)}
    free(torch)
    out["prefill"] = prefill(torch, "whisper prefill", cfg)
    free(torch)
    out.update(decode=whisper_decode(torch), serve=whisper_serve(torch))
    parity = transformer_card_against_cpu(torch, (("whisper-base", 2),))
    parity["teacher_forcing"] = whisper_teacher_forcing(torch)
    return out, parity


# phase 23: the pipelined rounds on the main path
PIPE_MODES = {"seq": {}, "sync1": dict(pipeline_depth=1),
              "async1": dict(pipeline_depth=1, pipeline_staleness="async"),
              "async2": dict(pipeline_depth=2, pipeline_staleness="async")}


def pipelined(torch, dev="cuda", rounds=PHASE18_ROUNDS):
    """Phase 23: the main path (cyclesfl, femnist width 32, cohort 5,
    ``rounds`` rounds, ``collect_timing``) sequential and pipelined.
    Timed in turns inside this phase (seq, sync1, async1, async1, sync1,
    seq; the host clock varies between calls): rounds/s by the Engine's
    round_time_s.  Sync at depth 1 equals the sequential run bit for
    bit.  Async at depths 1 and 2 with its extracts on the side stream
    equals the same schedule on one stream bit for bit, and its maximum
    realized lag is the depth.  A sync pipelined run stopped after 4
    rounds and resumed equals the unbroken one bit for bit; an async one
    re-primes its ring (lags restart at 0) within the bound.  A NaN-
    faulted async run (nan_retry) and a sync one (nan_quarantine) hold
    exactly their stream's faults, every one recovered, with
    feature_resample and fused_adam at their per-round count times the
    tails that ran (the femnist extract launches no kernel)."""
    import shutil
    from repro_torch.api import ExperimentConfig
    from repro_torch.utils.tree import tree_leaves
    per_round = {"feature_resample": 2 * 5, "fused_adam": 2 * 5 + 4}
    base = dict(rounds=rounds, eval_every=rounds, cut=2, collect_timing=True,
                **MAIN)
    runs = {}
    for name in ("seq", "sync1", "async1", "async1", "sync1", "seq"):
        runs.setdefault(name, []).append(run_engine(
            torch, ExperimentConfig(**base, **PIPE_MODES[name]), dev))
    for depth in (1, 2):
        for side in (True, False):
            runs.setdefault(f"async{depth}/{'side' if side else 'one'}",
                            []).append(run_engine(
                torch, ExperimentConfig(**base,
                                        **PIPE_MODES[f"async{depth}"]),
                dev, side_stream=side))
    out = {"round_time_s": {k: [r["res"]["round_time_s"] for r in runs[k]]
                            for k in ("seq", "sync1", "async1")}}
    rps = {k: [1.0 / t for t in v] for k, v in out["round_time_s"].items()}
    lags = {k: runs[f"{k}/side"][0]["res"]["pipeline"]["realized_lags"]
            for k in ("async1", "async2")}
    checks = {}

    def same(a, b):
        return (state_diff(torch, a["state"], b["state"]) == 0.0
                and a["rows"] == b["rows"])
    seq_spread = state_diff(torch, runs["seq"][0]["state"],
                            runs["seq"][1]["state"])
    checks["sync1 == seq"] = all(same(r, runs["seq"][0])
                                 for r in runs["sync1"])
    for depth in (1, 2):
        side, one = runs[f"async{depth}/side"][0], runs[f"async{depth}/one"][0]
        pipe = side["res"]["pipeline"]
        checks[f"async{depth} side == one stream"] = same(side, one)
        checks[f"async{depth} on the side stream"] = (
            pipe["side_stream"] and not one["res"]["pipeline"]["side_stream"])
        checks[f"async{depth} max lag == {depth}"] = (
            pipe["max_theta_s_lag_rounds"] == depth
            == side["res"]["telemetry"]["max_realized_lag"])
    for name, rs in runs.items():
        for r in rs:
            checks.setdefault("launches", True)
            checks["launches"] &= all(
                r["launches"][k] == n * rounds for k, n in per_round.items())
    print(f"pipeline: rounds/s in turns seq {rps['seq']}, sync1 "
          f"{rps['sync1']}, async1 (side stream) {rps['async1']}; the two "
          f"sequential runs bit-equal {seq_spread == 0.0}; realized lags "
          f"async1 {lags['async1']}, async2 {lags['async2']}")
    # resume: sync bit-equal to the unbroken run, async re-primed
    shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    ck = lambda name: os.path.join(CKPT_ROOT, name)
    for mode in ("sync1", "async1"):
        kw = dict(base, eval_every=2, **PIPE_MODES[mode])
        full = run_engine(torch, ExperimentConfig(ckpt_dir=ck(mode + "u"),
                                                  **kw), dev)
        run_engine(torch, ExperimentConfig(**{**kw, "rounds": 4,
                                              "ckpt_dir": ck(mode)}), dev)
        res = run_engine(torch, ExperimentConfig(ckpt_dir=ck(mode),
                                                 resume=True, **kw), dev)
        lags = res["res"]["pipeline"]["realized_lags"]
        hist = strip_elapsed(res["res"]["history"])
        want = [h for h in strip_elapsed(full["res"]["history"])
                if h["round"] > 4]
        if mode == "sync1":
            ok = (res["res"].get("resumed_from_round") == 4
                  and state_diff(torch, res["state"], full["state"]) == 0.0
                  and hist == want)
        else:
            ok = (res["res"].get("resumed_from_round") == 4
                  and lags[:2] == [0, 1] and max(lags) <= 1)
        checks[f"{mode} resume"] = ok
        print(f"pipeline {mode} resume: resumed from "
              f"{res['res'].get('resumed_from_round')}, realized lags {lags}, "
              f"max |state diff| to unbroken "
              f"{state_diff(torch, res['state'], full['state']):.3e}; "
              f"held {ok}")
    shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    # faults: each of the stream's faults recovered
    cfgs = resilience_configs()
    for name, mode in (("nan_retry", "async1"), ("nan_quarantine", "sync1")):
        run = run_engine(torch, ExperimentConfig(
            resilience=cfgs[name], **base, **PIPE_MODES[mode]), dev)
        tel = run["res"]["resilience"]
        want = expected_faults(cfgs[name], 0, rounds, 5)
        acted = (tel["retries"] if name == "nan_retry"
                 else tel["quarantine_events"])
        tails = rounds + want["extra_dispatches"]
        finite = all(bool(torch.isfinite(t).all())
                     for t in tree_leaves(run["state"])
                     if t.is_floating_point())
        ok = ({"faulted_rounds": tel["faulted_rounds"],
               "faults": tel["faults"]}
              == {k: want[k] for k in ("faulted_rounds", "faults")}
              and acted == sum(want["faults"].values()) and finite
              and want["faulted_rounds"] > 0
              and all(run["launches"][k] == n * tails
                      for k, n in per_round.items())
              and run["res"]["pipeline"]["max_theta_s_lag_rounds"] <= 1)
        checks[f"{mode} {name}"] = ok
        print(f"pipeline {mode} {name}: faulted rounds "
              f"{tel['faulted_rounds']}, faults {tel['faults']} (the stream "
              f"fires {want['faulted_rounds']} rounds, {want['faults']}); "
              f"retries {tel['retries']}, quarantines "
              f"{tel['quarantine_events']}; realized lags "
              f"{run['res']['pipeline']['realized_lags']}; launches "
              f"{ {k: run['launches'][k] for k in per_round} } for {tails} "
              f"tails; state finite {finite}; held {ok}")
        out[f"{mode}/{name}"] = {k: v for k, v in tel.items()
                                 if k != "per_round"}
    print(f"pipeline checks: {checks}")
    if not all(checks.values()):
        raise AssertionError(
            f"pipeline: {[k for k, v in checks.items() if not v]}")
    out.update(rounds_per_s=rps, checks=checks, realized_lags=lags)
    return out


# phase 24: the round on a device mesh over NCCL, in a process of its
# own (``python3 chip_smoke.py --mesh-phase OUT``)
MESH_ROUNDS = 10
# world N's main path at full width is held to the unsharded port as the
# card is held to the CPU (``compare_runs``, over phase 13's 2 rounds):
# the ranks' sums run in another order, and at width 32 that flips some
# of Adam's near-sign steps and ReLU gates (phase 13's docstring), so it
# moves weights by up to 2 * lr a step, more than 1e-5.  Over
# MESH_ROUNDS those moves compound; there only the exact checks hold
MESH_CHECK_ROUNDS = 2
PHASE13 = dict(rounds=2, eval_every=2, n_clients=10, attendance=0.3,
               batch=8, width=8, cut=2, seed=4, variable_attendance=True)


def _same(torch, a, b) -> bool:
    return state_diff(torch, a["state"], b["state"]) == 0.0 \
        and a["rows"] == b["rows"]


def _run_diff(torch, state, rows, want) -> float:
    """Largest |difference| of a run's state and metric rows to ``want``
    (a dict with "state" and "rows")."""
    d = state_diff(torch, state, want["state"])
    for ra, rb in zip(rows, want["rows"]):
        d = max([d] + [abs(ra[k] - rb[k]) for k in ra])
    return d


def _metric_rel_diff(rows, want_rows) -> float:
    """Worst relative difference of per-round metrics, the std of the
    feature-gradient norms measured against their mean (as phase 9's
    card-vs-CPU check measures it)."""
    def scale(rw, k):
        return max(abs(rw[k]), 1e-12, rw["feat_grad_norm_mean"]
                   if k == "feat_grad_norm_std" else 0.0)
    return max(abs(r[k] - rw[k]) / scale(rw, k)
               for r, rw in zip(rows, want_rows) for k in rw)


def _census_line(census) -> str:
    return ", ".join(f"{k} {v['calls']}x {v['bytes']}B"
                     for k, v in sorted(census.items()))


def _digest(torch, state, rows) -> str:
    """sha256 of a run's state (every leaf's bytes) and metric rows: two
    runs with one digest are bit for bit the same."""
    import hashlib
    from repro_torch.utils.tree import tree_leaves
    h = hashlib.sha256()
    for t in tree_leaves(state):
        t = t.detach().cpu().contiguous()
        h.update(str((t.dtype, tuple(t.shape))).encode())
        h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    h.update(repr(rows).encode())
    return h.hexdigest()


def mesh_world_runs(mesh, algos, rounds, profile=False):
    """The ten programs at phase 13's protocol on an (N, 1) mesh of the
    spawned ranks (rank ``mesh.comm.rank`` on its card), the
    gather-everything route and, for the cycle programs, the shard-local
    one: {algo: {route: (state, rows)}} on the CPU.  The main path (cut
    2) for ``MESH_CHECK_ROUNDS`` rounds on each route ("main short"),
    then for ``rounds`` rounds each route twice in turns ("main"; its
    ``round_time_s`` under "rounds/s", its census a round under
    "census"): for each, under "digests" each run's :func:`_digest` and,
    on rank 0 under "runs", the first run of each route, (state, rows,
    last evaluation) with the state on the CPU.  With ``profile``, one warm run of each route under the
    profiler on every rank (rank 0's report under "profile")."""
    import torch
    from repro_torch.api import ExperimentConfig
    from repro_torch.utils.tree import tree_map
    n = mesh.comm.size
    out = {"rounds/s": {}, "census": {}}
    timed = ExperimentConfig(rounds=rounds, eval_every=rounds, cut=2,
                             collect_timing=True, mesh_shape=(n, 1), **MAIN)
    short = dataclasses.replace(timed, rounds=MESH_CHECK_ROUNDS,
                                eval_every=MESH_CHECK_ROUNDS)
    for label, cfg, routes in (("main short", short, (False, True)),
                               ("main", timed, (False, True, True, False))):
        rec = out[label] = {"digests": {}, "runs": {}}
        for local in routes:
            key = "local" if local else "gather"
            r = run_engine(torch, cfg.with_cycle(shard_local_resample=local),
                           mesh.device)
            rec["digests"].setdefault(key, []).append(
                _digest(torch, r["state"], r["rows"]))
            if mesh.comm.rank == 0 and key not in rec["runs"]:
                rec["runs"][key] = (tree_map(lambda t: t.cpu(), r["state"]),
                                    r["rows"], r["res"]["history"][-1])
            if cfg is timed:
                out["rounds/s"].setdefault(key, []).append(
                    1.0 / r["res"]["round_time_s"])
                out["census"][key] = r["census"][-1]
    if profile:
        rep = mesh_profile(torch, {
            f"world {n} {key}": dataclasses.replace(
                timed, collect_timing=False).with_cycle(
                    shard_local_resample=key == "local")
            for key in ("gather", "local")}, mesh.device,
            quiet=mesh.comm.rank != 0)
        if mesh.comm.rank == 0:
            out["profile"] = rep
    for algo in algos:
        out[algo] = {}
        for local in ((False, True) if algo.startswith("cycle")
                      else (False,)):
            cfg = ExperimentConfig(algo=algo, mesh_shape=(n, 1), **PHASE13
                                   ).with_cycle(server_epochs=2,
                                                shard_local_resample=local)
            r = run_engine(torch, cfg, mesh.device)
            out[algo]["local" if local else "gather"] = (
                tree_map(lambda t: t.cpu(), r["state"]), r["rows"])
    return out


def mesh_profile(torch, cfgs, dev="cuda", quiet=False):
    """One warm ``Engine.run()`` of each config under the profiler: wall
    ms, device launches and busy ms, aten ops on the host, and the host
    ms of the c10d calls (``c10d::*``) with their count; printed unless
    ``quiet``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.api import Engine
    out = {}
    for name, cfg in cfgs.items():
        eng = Engine(cfg, device=dev, log=lambda msg: None)
        eng.run()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _sync(torch, dev)
            t0 = time.perf_counter()
            eng.run()
            _sync(torch, dev)
            wall = (time.perf_counter() - t0) * 1e3
        ev = prof.key_averages()
        devs = [e for e in ev if e.device_type == DeviceType.CUDA]
        c10d = [e for e in ev if e.key.startswith("c10d::")]
        out[name] = {
            "wall_ms": wall, "launches": sum(e.count for e in devs),
            "busy_ms": sum(e.self_device_time_total for e in devs) / 1e3,
            "aten_ops": sum(e.count for e in ev
                            if e.key.startswith("aten::")),
            "c10d_calls": sum(e.count for e in c10d),
            "c10d_host_ms": sum(e.cpu_time_total for e in c10d) / 1e3}
        if quiet:
            continue
        print(f"profile mesh {name} ({cfg.rounds} rounds + eval, warm): "
              + ", ".join(f"{k} {v:.3f}" if isinstance(v, float)
                          else f"{k} {v}" for k, v in out[name].items()))
    return out


def mesh_phase(torch, rounds=MESH_ROUNDS, dev="cuda", profile=False):
    """Phase 24: the monolithic round on a mesh whose ``model`` axis is 1,
    over NCCL.  World 1 (this process, one card): the main path (femnist
    width 32, 100 clients, cohort 5, batch 16) at cut 2 and at cut 3
    fused, ``rounds`` rounds, gather-everything and shard-local, each bit
    for bit the unsharded port on the card (state and metrics) with
    exact feature_resample, gather_loss and fused_adam launches and its
    census a round; rounds/s of mesh (1, 1) against unsharded in turns;
    then the ten programs at phase 13's protocol, bit for bit.  World
    min(cards, 4) when there are two cards or more: the ten programs in
    spawned ranks, within 1e-5 of world 1, shard-local bit for bit
    gather-everything, the same on every rank.  With ``profile``, last,
    one warm run of each of those three configs under the profiler."""
    from repro_torch.api import ExperimentConfig, algorithm_names
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.meshcheck import spawn_ranks
    from repro_torch.utils.tree import tree_map
    checks, out = {}, {"census": {}}
    mesh = make_local_mesh(dev)           # the world of 1, over NCCL
    print(f"mesh: world 1 over {torch.distributed.get_backend()} on "
          f"{torch.cuda.get_device_name(0)}")
    try:
        variants = {
            "cut2": (ExperimentConfig(rounds=rounds, eval_every=rounds,
                                      cut=2, **MAIN),
                     {"feature_resample": 2 * 5 * rounds,
                      "fused_adam": (2 * 5 + 4) * rounds, "gather_loss": 0}),
            "cut3 fused": (ExperimentConfig(
                rounds=rounds, eval_every=rounds, cut=3, **MAIN).with_cycle(
                    fused_gather_loss=True),
                {"feature_resample": 0, "fused_adam": (1 * 5 + 5) * rounds,
                 "gather_loss": 5 * rounds})}
        for name, (cfg, expect) in variants.items():
            base = run_engine(torch, cfg, dev)
            if name == "cut2":        # world N's main path is held to it
                short = run_engine(torch, dataclasses.replace(
                    cfg, rounds=MESH_CHECK_ROUNDS,
                    eval_every=MESH_CHECK_ROUNDS), dev)
                main_base = {lab: {"state": tree_map(lambda t: t.cpu(),
                                                     r["state"]),
                                   "rows": r["rows"], "engine": r["engine"],
                                   "last": r["res"]["history"][-1]}
                             for lab, r in (("main", base),
                                            ("main short", short))}
            for local in (False, True):
                route = "shard-local" if local else "gather-everything"
                run = run_engine(torch, dataclasses.replace(
                    cfg, mesh_shape=(1, 1)).with_cycle(
                        shard_local_resample=local), dev)
                same = _same(torch, run, base)
                launched = {k: run["launches"][k] for k in expect}
                checks[f"{name} {route} == unsharded"] = same
                checks[f"{name} {route} launches"] = launched == expect
                out["census"][f"{name} {route}"] = run["census"]
                steady = all(c == run["census"][0] for c in run["census"])
                print(f"mesh (1, 1) {name} {route}: bit-equal to the "
                      f"unsharded port {same}; launches {launched} "
                      f"(expected {expect}); census a round "
                      f"{_census_line(run['census'][0])} (every round the "
                      f"same: {steady})")
        # rounds/s in turns (host-bound: compare inside this phase only)
        timed = dataclasses.replace(variants["cut2"][0], collect_timing=True)
        turns = {"unsharded": timed,
                 "mesh": dataclasses.replace(timed, mesh_shape=(1, 1)),
                 "mesh local": dataclasses.replace(
                     timed, mesh_shape=(1, 1)).with_cycle(
                         shard_local_resample=True)}
        rps = {}
        for name in ("unsharded", "mesh", "mesh local", "mesh local",
                     "mesh", "unsharded"):
            t = run_engine(torch, turns[name], dev)["res"]["round_time_s"]
            rps.setdefault(name, []).append(1.0 / t)
        out["rounds_per_s"] = rps
        print("mesh: rounds/s in turns (cut 2, round_time_s) "
              + ", ".join(f"{k} {v}" for k, v in rps.items()))
        # the ten programs at phase 13's protocol
        world1 = {}
        for algo in algorithm_names():
            cfg = ExperimentConfig(algo=algo, **PHASE13).with_cycle(
                server_epochs=2)
            base = run_engine(torch, cfg, dev)
            world1[algo] = {}
            for local in ((False, True) if algo.startswith("cycle")
                          else (False,)):
                run = run_engine(torch, dataclasses.replace(
                    cfg, mesh_shape=(1, 1)).with_cycle(
                        shard_local_resample=local), dev)
                key = "local" if local else "gather"
                world1[algo][key] = run
                same = _same(torch, run, base)
                checks[f"zoo {algo} {key} == unsharded"] = same
                checks[f"zoo {algo} {key} launches"] = (
                    run["launches"] == base["launches"])
            print(f"mesh (1, 1) {algo}: bit-equal to unsharded "
                  + ", ".join(f"{k} {_same(torch, r, base)}"
                              for k, r in world1[algo].items())
                  + f"; launches {base['launches']['fused_adam']} fused_adam, "
                  f"{base['launches']['feature_resample']} feature_resample")
        if profile:
            out["profile"] = mesh_profile(torch, {
                k: dataclasses.replace(c, collect_timing=False)
                for k, c in turns.items()}, dev)
    finally:
        mesh.close()
    n = min(torch.cuda.device_count(), 4)
    out["world_n"] = n
    if n < 2:
        print(f"mesh: the world of N ranks needs two cards or more; this "
              f"machine has {torch.cuda.device_count()}, so phase 24 ran "
              "world 1 only")
    else:
        per_rank = spawn_ranks(n, mesh_world_runs, (algorithm_names(),
                                                    rounds, profile),
                               device=dev)
        rps_n = per_rank[0].pop("rounds/s")
        census_n = per_rank[0].pop("census")
        if profile:
            out["profile"].update(per_rank[0].pop("profile"))
        main_n = {lab: [r.pop(lab) for r in per_rank]
                  for lab in ("main short", "main")}
        for r in per_rank[1:]:
            r.pop("rounds/s"), r.pop("census")
        out["world_n_rounds_per_s"] = rps_n
        out["census"][f"world {n}"] = census_n
        print(f"mesh: world {n} main path (cut 2, capacity "
              f"{-(-5 // n) * n}), rank 0's rounds/s in turns "
              + ", ".join(f"{k} {v}" for k, v in rps_n.items()))
        for k, c in census_n.items():
            print(f"mesh: world {n} {k} census a round {_census_line(c)}")
        # the main path at full width, held to the unsharded port (its
        # capacity 5: the slots the mesh adds are dead, as padded slots)
        out["world_n_main"] = {}
        for lab, ranks in main_n.items():
            rec = {"diff": {}, "metric_rel_diff": {}}
            want = main_base[lab]
            for key, (st, rows, last) in ranks[0]["runs"].items():
                rec["diff"][key] = _run_diff(torch, st, rows, want)
                rec["metric_rel_diff"][key] = _metric_rel_diff(
                    rows, want["rows"])
                if lab != "main short":
                    continue
                try:
                    rec[f"compare {key}"] = compare_runs(
                        torch, f"world {n} {key} against unsharded "
                        f"({MESH_CHECK_ROUNDS} rounds)",
                        {"cpu": (want["rows"], want["state"], want["last"],
                                 want["engine"]),
                         "cuda": (rows, st, last, None)}, what="mesh")
                    held = True
                except AssertionError:
                    held = False
                checks[f"world {n} {lab} {key} held to unsharded"] = held
            runs = ranks[0]["runs"]
            rec["local == gather"] = (
                state_diff(torch, runs["local"][0], runs["gather"][0]) == 0.0
                and runs["local"][1] == runs["gather"][1])
            rec["repeat"] = all(len(set(v)) == 1
                                for v in ranks[0]["digests"].values())
            rec["same on every rank"] = all(
                r["digests"] == ranks[0]["digests"] for r in ranks[1:])
            for k in ("local == gather", "repeat", "same on every rank"):
                checks[f"world {n} {lab} {k}"] = rec[k]
            out["world_n_main"][lab] = rec
            print(f"mesh: world {n} {lab} path against the unsharded port "
                  f"(capacity 5, "
                  f"{MESH_CHECK_ROUNDS if lab == 'main short' else rounds} "
                  "rounds): max |diff| of state and metrics "
                  + ", ".join(f"{k} {v:.3e}" for k, v in rec["diff"].items())
                  + "; worst metric rel diff " + ", ".join(
                      f"{k} {v:.3e}" for k, v in
                      rec["metric_rel_diff"].items())
                  + f"; shard-local bit for bit gather-everything "
                  f"{rec['local == gather']}; each route's runs bit for bit "
                  f"{rec['repeat']}; every rank the same "
                  f"{rec['same on every rank']}")
        worst = 0.0
        for algo, routes in per_rank[0].items():
            want = world1[algo]["gather"]
            for key, (st, rows) in routes.items():
                d = _run_diff(torch, st, rows, want)
                worst = max(worst, d)
                checks[f"world {n} {algo} {key} within 1e-5"] = d <= 1e-5
                checks[f"world {n} {algo} {key} same on every rank"] = all(
                    state_diff(torch, st, o[algo][key][0]) == 0.0
                    and o[algo][key][1] == rows for o in per_rank[1:])
            if "local" in routes:
                checks[f"world {n} {algo} local == gather"] = (
                    state_diff(torch, routes["local"][0],
                               routes["gather"][0]) == 0.0
                    and routes["local"][1] == routes["gather"][1])
        out["world_n_worst_diff"] = worst
        print(f"mesh: world {n} over {'NCCL' if dev == 'cuda' else 'gloo'}, "
              f"ten programs: worst diff to world 1 {worst:.3e} (tol 1e-5)")
    bad = [k for k, v in checks.items() if not v]
    print(f"mesh checks: {len(checks) - len(bad)} of {len(checks)} held"
          + (f"; failed {bad}" if bad else ""))
    if bad:
        raise AssertionError(f"mesh: {bad}")
    out["checks"] = checks
    return out


def run_mesh_phase(out_path, profile=False):
    """The entry of ``--mesh-phase``: phase 24 alone, its report written
    to ``out_path``."""
    import torch
    from repro_torch.kernels import _build
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    _build.build_all()
    res = mesh_phase(torch, profile=profile)
    with open(out_path, "w") as f:
        json.dump(res, f, indent=1)
    return 0


# phase 25: the model axis, tensor- and expert-parallel weights for the
# transformer train and prefill steps, in a process of its own
# (``python3 chip_smoke.py --tp-phase OUT``)
TP_LR = 3e-4              # the step builders' Adam rate
TP_METRIC_RTOL = 3e-3     # depth 4 bf16 on (1, n) against unsharded
TP_SHARE_MAX = 0.25       # of the weights more than one bf16 ulp apart
TP_PARAMS = os.path.join(ROOT, "build", "chip_smoke_tp_unsharded.pt")


def tp_census(cfg, m, chunk=512, c_local=COHORT):
    """{census key: {"calls", "bytes"}} of the ``model`` axis in one round
    of ``build_train_step`` on a (d, m) mesh whose rank holds
    ``c_local`` of the cohort's slots (all of them when d is 1): written
    down from the shapes, before any run.  A block pass forward reduces its split
    attention output and its MoE (or FFN) output once each, a float32
    [b, S, d] (the MoE's [G, group, d]); backward, each split unit's
    input gradient once (``copy_to_model``: the attention's with the q
    and k norms' scales, the MoE's with the combine weights [G, group *
    k]).  The client blocks run forward in the extract and in each
    slot's VJP (backward there), the server blocks forward and backward
    in each server step and each slot's feature gradient.  A split vocab
    adds the embedding's reduce to each client forward and, to each
    server forward, a logits gather (the rank's [b, chunk, vocab / m] in
    the model's dtype) and (backward) the head input's float32 reduce
    per chunk of 512 positions; a split client half adds one norm (a
    float) a slot.  Each block is a group under ``module.remat``, so
    each backward pass first runs its forward again, up to its last op
    that saves a tensor: the attention's reduce and the MoE's (its
    router losses follow it) are issued again, a dense FFN's closing
    reduce is not (only the residual add follows it, unless a sandwich
    norm does), and each chunk's recompute gathers its logits again."""
    from repro_torch.sharding.parallel import sharded_units
    units = sharded_units(cfg, {"model": m})
    C, b, S = c_local, BATCH, SEQ
    steps = COHORT * b // b     # server steps: server batch b, 1 epoch
    out = {}

    def add(key, calls, nbytes):
        row = out.setdefault(f"model/{key}", {"calls": 0, "bytes": 0})
        row["calls"] += calls
        row["bytes"] += calls * nbytes
    cut, L, d, f32 = cfg.cut_layers, cfg.n_layers, cfg.d_model, 4
    act = b * S * d * f32
    fwd = 2 * C * cut + (steps + C) * (L - cut)
    bwd = C * cut + (steps + C) * (L - cut)
    if units["attn"]:
        norms = 2 * cfg.hd * f32 if cfg.attn.qk_norm else 0
        add("all_reduce/attn", fwd + bwd, act)
        add("all_reduce/act_grad", bwd, act + norms)
    if units["moe"]:
        gs = min(cfg.moe.group_size, b * S)
        tokens = -(-(b * S) // gs) * gs
        add("all_reduce/moe", fwd + bwd, tokens * d * f32)
        add("all_reduce/moe_grad", bwd, tokens * (d + cfg.moe.top_k) * f32)
    if units["ffn"]:
        add("all_reduce/ffn", fwd + (bwd if cfg.sandwich_norm else 0), act)
        add("all_reduce/act_grad", bwd, act)
    if units["vocab"]:
        cs = min(chunk, S)
        n_chunks = -(-S // cs)
        elt = 2 if cfg.dtype == "bfloat16" else 4
        add("all_reduce/embed", 2 * C, act)
        add("all_gather/logits", 2 * n_chunks * (steps + C),
            b * cs * cfg.vocab_padded // m * elt)
        add("all_reduce/act_grad", n_chunks * (steps + C), b * cs * d * f32)
    if any(units.values()):
        add("all_reduce/grad_norm", C, f32)
    return out


def fsdp_census(cfg, d, m, c_local, cohort=COHORT):
    """{census key: {"calls", "bytes"}} of the batch axes in one round of
    ``build_train_step`` on a (d, m) mesh, d > 1, whose rank holds
    ``c_local`` slots: written down from the shapes before any run.
    The server's minibatch is replicated (the model axis splits its
    units: the reference's ``tp_layout``), so each of the ``steps``
    server steps gathers each leaf the plan splits over ``data`` once
    (``all_gather/weights``, the payload a rank's block, bf16), and the
    feature gradients' frozen server once more; its gradients are
    sliced, with no collective.  A block's bytes are its leaf's dtype's
    (bf16, the router float32; a packed Mamba leaf's block holds its
    whole heads' columns and B/C).  The pool is gathered once (the
    features [c_local * b, S, d] in the model's dtype, whisper's encoder
    states [c_local * b, 1500, d], and the int32 labels, whisper's
    tokens with them, a call each) and the per-slot metrics twice (a
    float a slot)."""
    from repro_torch.models.module import SHAPES
    from repro_torch.sharding.specs import shard_plan
    from repro_torch.utils.tree import tree_leaves
    half = step_task(cfg).init_server(SHAPES)
    plan = shard_plan(half, {"data": d, "model": m}, {"data": 0, "model": 0},
                      "server", cfg)
    steps, b, elt = cohort * BATCH // BATCH, BATCH, 2 if \
        cfg.dtype == "bfloat16" else 4
    audio = cfg.family == "audio"
    frames, seq = (WHISPER_FRAMES, WHISPER_TEXT) if audio else (SEQ, SEQ)
    out = {}

    def add(key, calls, nbytes):
        row = out.setdefault(key, {"calls": 0, "bytes": 0})
        row["calls"] += calls
        row["bytes"] += calls * nbytes
    for x, s in zip(tree_leaves(half), tree_leaves(plan)):
        if s.ddim is not None:
            blk = x.numel() // d
            if s.dim is not None:       # the rank's columns of the leaf
                blk = blk // x.shape[s.dim] * (
                    x.shape[s.dim] // m if s.segs is None
                    else sum(hi - lo for lo, hi, _ in s.segs))
            add("all_gather/weights", steps + 1, blk * x.element_size())
    add("all_gather/pool", 1, c_local * b * frames * cfg.d_model * elt)
    add("all_gather/pool", 1, c_local * b * seq * 4 * (2 if audio else 1))
    add("all_gather/metrics", 2, c_local * 4)
    return out


def whole_step_state(mesh, cfg, server, clients):
    """The train step's state on ``mesh`` gathered whole: the server's
    params from their blocks over ``data`` and ``model``, the client
    slots' params over the batch axes and their ``model`` blocks."""
    from repro_torch.launch.mesh import cohort_size
    from repro_torch.models.module import SHAPES
    from repro_torch.sharding.specs import Shard, gather_params, shard_plan
    from repro_torch.utils.tree import (tree_leaves, tree_map,
                                        tree_unflatten_like)
    task = step_task(cfg)
    sp = shard_plan(task.init_server(SHAPES), mesh.shape, mesh.coords,
                    "server", cfg)
    cp = shard_plan(task.init_client(SHAPES), mesh.shape, mesh.coords,
                    "full", cfg)
    srv = gather_params(server.params, sp, mesh.model_comm, mesh.data_comm)
    cl = clients.params
    if cohort_size(mesh) > 1:
        cl = tree_unflatten_like(cl, mesh.comm.all_gather_tree(
            tree_leaves(cl), "state"))
    return srv, gather_params(cl, tree_map(Shard.stacked, cp),
                              mesh.model_comm)


@contextlib.contextmanager
def planted_data_fault():
    """The control of :func:`tp_against_unsharded` on a mesh whose
    ``data`` axis holds FSDP blocks: inside, the FSDP backward drops its
    cross-rank step, so a data-parallel gradient keeps this rank's own
    partial (no reduce-scatter) and a replicated one hands every rank
    the first block (no slice to its own), what a missing reduce or a
    misplaced block would do.  The forward is untouched; the check must
    refuse the run."""
    from repro_torch.sharding import parallel
    real = parallel._GatherFromData.__dict__["backward"]

    def first_block(ctx, *gs):
        return (None, None, None) + tuple(
            g.narrow(d, 0, s[d]).contiguous()
            for g, d, (s, _, _) in zip(gs, ctx.dims, ctx.meta))
    parallel._GatherFromData.backward = staticmethod(first_block)
    try:
        yield
    finally:
        parallel._GatherFromData.backward = real


def tp_kernel_checks(torch, dev):
    """The kernels of the model-axis path at its per-rank shapes, each
    against its plain version: ``flash_attention`` on a rank's heads of
    olmoe's 16 at m = 2 and 4 ([2, 2048, 16 / m, 128] bf16 causal,
    tensor-core design), ``fused_adam`` on a rank's expert stacks at
    m = 4 (the server's [14, 16, 2048, 1024] and the client slots' [2,
    2, 16, 2048, 1024], bf16 with float32 moments) and ``topk_gating``
    at the router's [4096, 64] k 8, which every rank computes whole."""
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import design, flash_attention
    from repro_torch.kernels.topk_gating import topk_gating
    gen = torch.Generator(device=dev).manual_seed(25)
    cfg = get_config("olmoe-1b-7b")
    rows = []
    for m in (2, 4):
        B, S, H, D = BATCH, SEQ, cfg.n_heads // m, cfg.hd
        q, k, v = (torch.randn(B, S, H, D, device=dev, generator=gen
                               ).to(torch.bfloat16) for _ in range(3))
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        row = check("flash_attention", f"[{B}, {S}, {H}, {D}] bf16 causal "
                    f"design={design(q.dtype, D)} (a rank's heads, model "
                    f"axis {m})",
                    lambda: (flash_attention(q, k, v, causal=True),),
                    lambda: (ref.flash_attention_ref(q, k, v, causal=True),),
                    2e-2, kernel_cost("flash_attention", q, k, v),
                    library=lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=True))
        row["design"] = design(q.dtype, D)
        rows.append(row)
        del q, k, v, qt, kt, vt
    mo, m = cfg.moe, 4
    L_srv = cfg.n_layers - cfg.cut_layers
    for shape, steps in (((L_srv, mo.n_experts // m, cfg.d_model,
                           mo.d_ff_expert), 3),
                         ((COHORT, cfg.cut_layers, mo.n_experts // m,
                           cfg.d_model, mo.d_ff_expert), [2, 0])):
        p = torch.randn(shape, device=dev, generator=gen).to(torch.bfloat16)
        g = torch.randn(shape, device=dev, generator=gen).to(torch.bfloat16)
        mm = torch.randn(shape, device=dev, generator=gen) * 0.1
        vv = torch.rand(shape, device=dev, generator=gen) * 0.1
        step = torch.tensor(steps, dtype=torch.int32, device=dev)
        rows.append(check(
            "fused_adam", f"{list(shape)} bf16 step{list(step.shape)} (a "
            f"rank's experts, model axis {m})",
            lambda: ops.fused_adam(p, g, mm, vv, step, lr=1e-3),
            lambda: ref.fused_adam_ref(p, g, mm, vv, step, lr=1e-3),
            1e-6, kernel_cost("fused_adam", p, g, mm, vv, step), ulps=1))
        del p, g, mm, vv
        torch.cuda.empty_cache()
    x = torch.randn(BATCH * SEQ, mo.n_experts, device=dev, generator=gen)
    got, want = topk_gating(x, mo.top_k), ref.topk_gating_ref(x, mo.top_k)
    if not torch.equal(got[1], want[1]):
        raise AssertionError("topk_gating: ids differ from the plain version")
    rows.append(check(
        "topk_gating", f"[{BATCH * SEQ}, {mo.n_experts}] k={mo.top_k} (the "
        "router, whole on every rank)",
        lambda: (topk_gating(x, mo.top_k)[0],),
        lambda: (ref.topk_gating_ref(x, mo.top_k)[0],), 1e-6,
        kernel_cost("topk_gating", x, mo.top_k)))
    return rows


def tp_smoke_grads(torch, mesh):
    """olmoe-1b-7b's smoke config (f32, TF32 off) on the mesh against the
    unsharded model on this rank's card: the end-to-end loss of one
    slot's batch and every leaf's gradient gathered whole, each within
    1e-5 of the leaf's largest entry, and the prefill's float32
    last-position logits likewise.  Returns the worst relative
    differences."""
    from repro_torch.configs import InputShape, smoke_config
    from repro_torch.core.cyclesl import _value_and_grad
    from repro_torch.core.split import make_transformer_task
    from repro_torch.launch import inputs as inputs_lib
    from repro_torch.models.transformer import Transformer
    from repro_torch.sharding.specs import (gather_params, shard_params,
                                            shard_plan)
    from repro_torch.utils.tree import tree_leaves
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = mesh.device
    cfg = smoke_config("olmoe-1b-7b")
    full = make_transformer_task(cfg)
    task = make_transformer_task(cfg, mesh=mesh)
    on_model = {"model": mesh.shape.get("model", 1)}
    cp = full.init_client(torch.Generator(device=dev).manual_seed(1))
    sp = full.init_server(torch.Generator(device=dev).manual_seed(0))
    plans = [shard_plan(t, on_model, mesh.coords, "full", cfg)
             for t in (cp, sp)]
    local = [shard_params(t, p) for t, p in zip((cp, sp), plans)]
    xs, ys = inputs_lib.make_train_batch(
        cfg, InputShape("smoke", 64, 4, "train"), COHORT, 0)
    x = {"tokens": torch.from_numpy(xs["tokens"][0]).to(dev)}
    y = torch.from_numpy(ys[0]).to(dev)
    l0, g0 = _value_and_grad(lambda p: full.e2e_loss(p[0], p[1], x, y),
                             (cp, sp))
    l1, g1 = _value_and_grad(lambda p: task.e2e_loss(p[0], p[1], x, y),
                             tuple(local))
    g1 = tuple(gather_params(g, p, mesh.model_comm)
               for g, p in zip(g1, plans))
    worst = max(float((a - b).abs().max() / a.abs().max())
                for a, b in zip(tree_leaves(g0), tree_leaves(g1))
                if a.numel() and float(a.abs().max()) > 0)
    params = Transformer.init(torch.Generator(device=dev).manual_seed(2),
                              cfg)
    plan = shard_plan(params, on_model, mesh.coords, "full", cfg)
    with torch.no_grad():
        want, _ = Transformer.forward(params, cfg, x["tokens"])
        got, _ = Transformer.forward(shard_params(params, plan), cfg,
                                     x["tokens"], tp=task.tp)
    logits = float((got[:, -1] - want[:, -1]).abs().max()
                   / want[:, -1].abs().max())
    loss = abs(float(l1) - float(l0)) / abs(float(l0))
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32
    return {"loss_rel": loss, "grad_worst_rel": worst,
            "prefill_logits_rel": logits,
            "ok": max(loss, worst, logits) <= 1e-5}


def _bf16_ulp(torch, t):
    _, e = torch.frexp(t.float())
    return torch.where(t == 0, 0.0, torch.exp2(e.float() - 8))


def tp_against_unsharded(torch, params, rows, want_rows, steps,
                         path=TP_PARAMS):
    """Hold a full-width bf16 run on the model axis to the unsharded run
    on one card: per-round metrics within rtol ``TP_METRIC_RTOL`` (the
    std of the feature-gradient norms against their mean); every weight
    within the 2 * lr * steps that Adam's near-sign steps can move it
    plus one bf16 ulp of its value (one rounding of the stored weight);
    and at most ``TP_SHARE_MAX`` of the weights more than one bf16 ulp
    of their value from the unsharded run's.  The partial sums round to
    bf16 once more than the unsharded products, so a few weights whose
    gradient is near zero step the other way: the limits sit above what
    sound runs read and below what a planted backward fault reads
    (:func:`planted_backward_fault`).  ``steps`` is the most steps an
    entity took; ``path`` holds the unsharded run's weights."""
    from repro_torch.utils.tree import tree_leaves
    want = torch.load(path, map_location="cpu", weights_only=False)
    worst = max(abs(r[k] - w[k]) / max(abs(w[k]), w["feat_grad_norm_mean"]
                                       if k == "feat_grad_norm_std" else 0.0)
                for r, w in zip(rows, want_rows) for k in w)
    bound = 2 * TP_LR * steps
    over, w_max, moved, past_ulp, total = 0.0, 0.0, 0, 0, 0
    for a, b in zip(tree_leaves(want), tree_leaves(params)):
        a = a.to(b.device)
        d = (a.float() - b.float()).abs()
        ulp = _bf16_ulp(torch, a)
        w_max = max(w_max, float(d.max()))
        over = max(over, float((d - bound - ulp).max()))
        moved += int((d > 0).sum())
        past_ulp += int((d > ulp).sum())
        total += d.numel()
        del a, d, ulp
    ok = (worst <= TP_METRIC_RTOL and over <= 0.0
          and past_ulp / total <= TP_SHARE_MAX)
    return {"worst_metric_rel_diff": worst, "weights_max_abs": w_max,
            "bound": bound, "over_bound": over,
            "share_differing": moved / total,
            "share_past_one_ulp": past_ulp / total, "ok": ok}


@contextlib.contextmanager
def planted_backward_fault():
    """The control of :func:`tp_against_unsharded`: inside, each
    ``copy_to_model`` drops its gradient's all-reduce, so every rank
    keeps its own partial input gradient (what a missing reduce would
    do).  The forward is untouched; the check must refuse the run."""
    from repro_torch.sharding import parallel
    real = parallel._CopyToModel.__dict__["backward"]
    parallel._CopyToModel.backward = staticmethod(
        lambda ctx, *gs: (None, None) + gs)
    try:
        yield
    finally:
        parallel._CopyToModel.backward = real


def tp_rank_runs(mesh, rounds, profile, want_rows):
    """Phase 25 on a (d, m) mesh of spawned ranks, one card each: (1) the
    smoke check (:func:`tp_smoke_grads`); (2) olmoe-1b-7b at full width,
    depth 4, bf16, ``rounds`` rounds gathered whole and held to the
    unsharded run of this phase's one-card part (rank 0 reads its
    weights from ``TP_PARAMS``; :func:`tp_against_unsharded`), then
    again under :func:`planted_backward_fault` (on (1, n)) or
    :func:`planted_data_fault` (d > 1, FSDP over ``data``), which that
    check must refuse; (3) olmoe-1b-7b whole, 16 blocks: ``rounds``
    timed rounds with exact launches, each round's census, peak memory,
    and the prefill.  Only rank 0 prints; every rank returns its own
    numbers."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import cohort_size
    rank = torch.distributed.get_rank()
    if rank != 0:
        sys.stdout = open(os.devnull, "w")
    d, m = mesh.shape["data"], mesh.shape["model"]
    lab = f"({d}, {m})"
    out = {"smoke": tp_smoke_grads(torch, mesh)}
    print(f"tp {lab}: TF32 products "
          f"{torch.backends.cuda.matmul.allow_tf32}, as unsharded")
    full = get_config("olmoe-1b-7b")
    cfg4 = full.with_(n_layers=OLMOE_DEPTH)
    fault_ctx = planted_data_fault if d > 1 else planted_backward_fault

    def depth4(label, fault):
        with fault_ctx() if fault else contextlib.nullcontext():
            run = split_round(torch, f"tp {lab} depth {OLMOE_DEPTH}"
                              + label, cfg4, rounds, mesh=mesh,
                              keep_state=True)
        server, clients = run.pop("state")
        params = whole_step_state(mesh, cfg4, server, clients)
        del server, clients
        held = (tp_against_unsharded(torch, params, run["metrics"],
                                     want_rows, 2 * rounds)
                if rank == 0 else None)
        del params
        torch.cuda.empty_cache()
        return run, held

    out["depth4"], out["against_unsharded"] = depth4("", False)
    _, out["planted_fault"] = depth4(
        f" (planted {'data' if d > 1 else 'backward'} fault)", True)
    out["whole"] = split_round(torch, f"tp {lab} whole", full, rounds,
                               profile=profile, mesh=mesh)
    torch.cuda.empty_cache()
    out["prefill"] = prefill(torch, f"tp {lab} whole prefill", full,
                             mesh=mesh)
    out["expected_census"] = step_census(full, d, m)
    out["expected_census_depth4"] = step_census(cfg4, d, m)
    return out


def step_census(cfg, d, m, cohort=COHORT):
    """The census of one train round of ``cohort`` slots on a (d, m)
    mesh: the model axis' (:func:`tp_census`, :func:`ssm_tp_census` for
    the Mamba-2, hybrid and whisper families) and, where ``data`` splits
    the cohort and the weights, the batch axes' (:func:`fsdp_census`)."""
    c_local = cohort // d
    out = (ssm_tp_census(cfg, m, c_local, cohort)
           if cfg.family in ("ssm", "hybrid", "audio")
           else tp_census(cfg, m, c_local=c_local))
    if d > 1:
        out.update(fsdp_census(cfg, d, m, c_local, cohort))
    return out


def tp_phase(torch, rounds=ROUNDS, dev="cuda", profile=False):
    """Phase 25: the ``model`` axis.  One card: a (1, 1) mesh through the
    model-axis code at olmoe-1b-7b's full width (depth 4, bf16, cohort
    2, batch 2, sequence 2048), ``rounds`` train rounds and the prefill,
    each bit for bit the unsharded step (every leaf of the state, held
    in host memory between the runs, the metrics, the logits) with the
    unsharded launches and no collective; then the
    kernels at the per-rank shapes of a model axis of 2 and 4
    (:func:`tp_kernel_checks`).  With four cards :func:`tp_rank_runs` on
    (1, 4) and then on (2, 2) (FSDP over ``data`` and TP over
    ``model``), with two on (1, 2): each census held exactly to
    :func:`step_census`, the same launches and metrics on every rank.
    Raises on any miss."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.meshcheck import spawn_ranks
    from repro_torch.utils.tree import tree_leaves, tree_map
    out, checks = {}, {}
    cards = torch.cuda.device_count()
    cfg4 = get_config("olmoe-1b-7b").with_(n_layers=OLMOE_DEPTH)
    mesh = make_local_mesh(dev)
    try:
        runs, logits = {}, {}
        for label, m in (("unsharded", None), ("mesh (1, 1)", mesh)):
            torch.cuda.empty_cache()
            r = split_round(torch, f"tp {label}", cfg4, rounds, mesh=m,
                            keep_state=True)
            state = r.pop("state")
            if m is None:             # the unsharded state, in host memory
                want = tree_map(lambda t: t.cpu(), state)
                if cards >= 2:
                    os.makedirs(os.path.dirname(TP_PARAMS), exist_ok=True)
                    torch.save((want[0].params, want[1].params), TP_PARAMS)
            else:
                checks["(1, 1) round == unsharded"] = all(
                    torch.equal(x, y.cpu()) for x, y in zip(
                        tree_leaves(want), tree_leaves(state)))
                del want
            del state
            torch.cuda.empty_cache()
            p = prefill(torch, f"tp {label} prefill", cfg4, mesh=m, keep=True)
            logits[label] = p.pop("logits")
            runs[label] = {"round": r, "prefill": p}
        a, b = runs["unsharded"], runs["mesh (1, 1)"]
        checks["(1, 1) round == unsharded"] &= (
            a["round"]["metrics"] == b["round"]["metrics"])
        checks["(1, 1) launches == unsharded"] = (
            a["round"]["launches"] == b["round"]["launches"]
            and a["prefill"]["launches"] == b["prefill"]["launches"])
        checks["(1, 1) prefill == unsharded"] = bool(torch.equal(
            logits["unsharded"], logits["mesh (1, 1)"]))
        checks["(1, 1) takes no collective"] = all(
            c == {} for c in b["round"]["census"]) and \
            mesh.comm.take_census() == {}
        print("tp (1, 1) at full width (depth 4): " + ", ".join(
            f"{k} {v}" for k, v in checks.items()))
        out["one_card"] = runs
    finally:
        mesh.close()
    del logits
    torch.cuda.empty_cache()
    out["kernel_checks"] = tp_kernel_checks(torch, torch.device(dev))
    torch.cuda.empty_cache()
    worlds = ([(1, 4), (2, 2)] if cards >= 4 else
              [(1, 2)] if cards >= 2 else [])
    out["worlds"] = {}
    for d, m in worlds:
        lab, n = f"({d}, {m})", d * m
        torch.cuda.empty_cache()
        ranks = spawn_ranks(n, tp_rank_runs, (
            rounds, profile, runs["unsharded"]["round"]["metrics"]),
            "cuda", shape=(d, m), timeout=900)
        r0 = ranks[0]
        want, want4 = r0["expected_census"], r0["expected_census_depth4"]
        fault = "data" if d > 1 else "backward"
        checks[f"{lab} smoke loss and gradients within 1e-5"] = all(
            r["smoke"]["ok"] for r in ranks)
        checks[f"{lab} depth 4 against unsharded"] = \
            r0["against_unsharded"]["ok"]
        checks[f"{lab} depth 4 check refuses a planted {fault} "
               "fault"] = not r0["planted_fault"]["ok"]
        for part in ("depth4", "whole"):
            # ranks that share a batch coordinate run the same slots
            checks[f"{lab} {part} same metrics and launches on every "
                   "rank"] = all(
                r[part]["metrics"] == r0[part]["metrics"]
                and r[part]["launches"] == r0[part]["launches"]
                for r in ranks)
        checks[f"{lab} whole census == predicted"] = all(
            c == want for r in ranks for c in r["whole"]["census"])
        checks[f"{lab} depth 4 census == predicted"] = all(
            c == want4 for r in ranks for c in r["depth4"]["census"])
        peak = max(r["whole"]["peak_bytes"] for r in ranks)
        checks[f"{lab} whole fits a card"] = peak < 80e9
        w = r0["whole"]
        print(f"tp {lab} olmoe-1b-7b whole: {w['rounds_per_s']:.3f} "
              f"rounds/s, {w['tokens_per_s']:.1f} tokens/s, peak "
              f"{peak / 1e9:.2f} GB a card (max over ranks), entity states "
              f"{w['state_bytes'] / 1e9:.2f} GB a card, prefill "
              f"{r0['prefill']['ms']:.2f} ms; census a round "
              f"{_census_line(w['census'][0])} (predicted "
              f"{_census_line(want)}); smoke {r0['smoke']}; depth 4 "
              f"against unsharded {r0['against_unsharded']}; with a "
              f"planted {fault} fault {r0['planted_fault']}")
        out["worlds"][lab] = {
            "n": n, "rank0": r0, "peak_bytes_max": peak,
            "census_predicted": want,
            "ranks": [{k: r[k] for k in ("smoke",)}
                      | {"peak_bytes": r["whole"]["peak_bytes"],
                         "state_bytes": r["whole"]["state_bytes"]}
                      for r in ranks]}
    if not worlds:
        print("tp: one card, so the (d, m) part of phase 25 did not run")
    bad = [k for k, v in checks.items() if not v]
    out["checks"] = checks
    if bad:
        raise AssertionError(f"tp: {bad}")
    return out


def run_tp_phase(out_path, profile=False):
    """The entry of ``--tp-phase``: phase 25 alone, its report written
    to ``out_path``."""
    import torch
    from repro_torch.kernels import _build
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(f"tp: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    _build.build_all()
    res = tp_phase(torch, profile=profile)
    res["nvidia_smi"] = smi
    with open(out_path, "w") as f:
        json.dump(res, f, indent=1, default=str)
    return 0


# phase 26: the Engine on the reference's 2-D mesh, its weights placed
# as the reference places them (FSDP over data, the dense stages'
# columns over model), in a process of its own
# (``python3 chip_smoke.py --engine-mesh-phase OUT``)
# the meshes of each world: four cards run (2, 2), (4, 1) (FSDP only)
# and (1, 4) (the 62-class head whole: 62 % 4 != 0), two run (1, 2)
ENGINE_MESHES = {4: ((2, 2), (4, 1), (1, 4)), 2: ((1, 2),)}
# the census keys the placement adds (every "model/..." key too)
PLACEMENT_KEYS = ("all_gather/weights", "reduce_scatter/wgrads",
                  "reduce_scatter/slot_mean")


def engine_mesh_variants(rounds):
    """The main path's two variants (cut 2; cut 3 with the fused
    ``gather_loss``) at ``rounds`` rounds, each with its launches a
    round at a capacity of ``cap`` slots (the masked server loop runs
    ``cap`` steps of one server batch of 16): at cut 2 the features and
    labels gathered a step and Adam on the server's 2 leaves a step and
    the client stack's 4 once; at cut 3 one ``gather_loss`` and Adam on
    the head a step, the client stack's 5 leaves once."""
    from repro_torch.api import ExperimentConfig
    return {
        "cut2": (ExperimentConfig(rounds=rounds, eval_every=rounds, cut=2,
                                  **MAIN),
                 lambda cap: {"feature_resample": 2 * cap * rounds,
                              "fused_adam": (2 * cap + 4) * rounds,
                              "gather_loss": 0}),
        "cut3 fused": (ExperimentConfig(rounds=rounds, eval_every=rounds,
                                        cut=3, **MAIN).with_cycle(
                                            fused_gather_loss=True),
                       lambda cap: {"feature_resample": 0,
                                    "fused_adam": (cap + 5) * rounds,
                                    "gather_loss": cap * rounds})}


def engine_mesh_census(cut, shape, cap, width=32, b=16, n_cls=10):
    """{census key: {"calls", "bytes"}} of the keys the placement adds to
    one round of the main path on a (d, m) mesh at capacity ``cap``
    (``cap / d`` slots a rank), written down from the shapes before any
    run.  femnist's ``lin/w`` leaves: stage 2's [7 * 7 * 2w, 2048] (the
    server's at cut 2, the client's at cut 3) and the head [2048, 10]
    (the image task's 10 classes; the server's), float32; each splits
    its rows over ``data`` (roles server and full) and its columns over
    ``model`` where they divide (the head's 10 over 2, not over 4).

    ``data`` (the batch axes' collectives): each of the ``cap`` server
    steps gathers each of the server's blocks once and the feature
    gradients' frozen server once more (``all_gather/weights``, a call
    a leaf, the payload a rank's block); a server that splits no column
    over ``model`` steps data-parallel (2-D meshes keep the minibatch
    replicated) and reduce-scatters each float32 gradient a step (the
    payload the leaf whole over ``data``), its ``all_reduce/grads``
    then the loss alone; at cut 3
    the shared client model's stage 2 is gathered for the cohort's
    copies (its params and each Adam moment, a call each) and FedAvg'd
    back into the blocks in one call (``reduce_scatter/slot_mean``).  ``model``: a split dense
    stage gathers its output's columns (``act``, a rank's [rows, n /
    m]) each forward and, in a backward that reaches its input, sums
    the input's gradient (``act_grad``, [rows, d_in]); the server
    forwards ``b`` rows a step (with the fused loss, the head is
    gathered whole instead, ``head``) and each of the rank's slots'
    feature gradients ``b`` rows, reaching the features; at cut 3 each
    slot's client forward runs in the extract and in its VJP, whose
    norm is summed over the axis (``grad_norm``)."""
    d, m = shape
    f32, rows2 = 4, 7 * 7 * 2 * width
    lin2, head = (rows2, 2048), (2048, n_cls)
    server, client = ([lin2, head], []) if cut == 2 else ([head], [lin2])
    c_local = cap // d
    msplit = lambda n: m > 1 and n % m == 0
    dsplit = lambda n: d > 1 and n % d == 0
    cols = lambda c: c // m if msplit(c) else c
    out = {}

    def add(key, calls, nbytes):
        if calls and nbytes:
            row = out.setdefault(key, {"calls": 0, "bytes": 0})
            row["calls"] += calls
            row["bytes"] += calls * nbytes
    tp_layout = any(msplit(c) for _, c in server)
    fused = cut == 3
    for r, c in server:
        if dsplit(r):
            add("all_gather/weights", cap + 1, r // d * cols(c) * f32)
            if d > 1 and not tp_layout and not fused:
                add("reduce_scatter/wgrads", cap, r * cols(c) * f32)
    if d > 1 and not tp_layout and not fused:
        add("all_reduce/grads", cap, f32)
    for r, c in client:
        if dsplit(r):
            add("all_gather/weights", 3, r // d * cols(c) * f32)
            add("reduce_scatter/slot_mean", 1, 3 * r * cols(c) * f32)

    def dense(rows, stage, grad_in):
        r, c = stage
        if msplit(c):
            add("model/all_gather/act", 1, rows * c // m * f32)
            if grad_in:
                add("model/all_reduce/act_grad", 1, rows * r * f32)
    for step in range(cap):
        if fused:
            if msplit(head[1]):
                add("model/all_gather/head", 1, head[0] * head[1] // m * f32)
        else:
            for i, st in enumerate(server):
                dense(b, st, i > 0)
    for slot in range(c_local):
        for st in server:
            dense(b, st, True)
        for st in client:
            dense(b, st, False)        # the extract, no gradient
            dense(b, st, True)         # the VJP
            if msplit(st[1]):
                add("model/all_reduce/grad_norm", 1, f32)
    return out


def _placement_keys(census) -> dict:
    return {k: v for k, v in census.items()
            if k.startswith("model/") or k in PLACEMENT_KEYS
            or k == "all_reduce/grads"}


def engine_mesh_world_runs(mesh, shapes, rounds):
    """Phase 26 on the spawned ranks, one card each, for each mesh shape
    of ``shapes`` (over this world): the main path's two variants for
    ``MESH_CHECK_ROUNDS`` rounds (metrics, launches, each round's
    census, the capacity, the last evaluation and, on rank 0, the state
    gathered whole), then ``rounds`` timed rounds of cut 2, the mesh and
    the unsharded Engine on this rank's card in turns; on (2, 2) also
    the ten programs at phase 13's protocol.  Only rank 0 prints."""
    import torch
    from repro_torch.api import ExperimentConfig, algorithm_names
    from repro_torch.utils.tree import tree_map
    lead = torch.distributed.get_rank() == 0
    if not lead:
        sys.stdout = open(os.devnull, "w")

    def keep(r):
        rec = {"rows": r["rows"], "launches": r["launches"],
               "census": r["census"], "last": r["res"]["history"][-1],
               "capacity": r["engine"].padded_capacity}
        if lead:
            rec["state"] = tree_map(lambda t: t.cpu(), r["state"])
        return rec
    out = {}
    for shape in shapes:
        rec = out[str(tuple(shape))] = {}
        for name, (cfg, _) in engine_mesh_variants(
                MESH_CHECK_ROUNDS).items():
            rec[name] = keep(run_engine(torch, dataclasses.replace(
                cfg, mesh_shape=tuple(shape)), mesh.device))
        timed = dataclasses.replace(engine_mesh_variants(rounds)["cut2"][0],
                                    collect_timing=True)
        rps = {}
        for label in ("mesh", "unsharded", "unsharded", "mesh"):
            cfg = (dataclasses.replace(timed, mesh_shape=tuple(shape))
                   if label == "mesh" else timed)
            t = run_engine(torch, cfg, mesh.device)["res"]["round_time_s"]
            rps.setdefault(label, []).append(1.0 / t)
        rec["rounds/s"] = rps
        if tuple(shape) == (2, 2):
            out["zoo (2, 2)"] = {algo: keep(run_engine(
                torch, ExperimentConfig(algo=algo, mesh_shape=(2, 2),
                                        **PHASE13).with_cycle(
                                            server_epochs=2),
                mesh.device)) for algo in algorithm_names()}
    return out


def engine_mesh_phase(torch, rounds=MESH_ROUNDS, dev="cuda"):
    """Phase 26: the Engine on the reference's 2-D mesh.  One card: a
    (1, 1) mesh through the placement code is bit for bit the unsharded
    Engine (state, metrics), with equal launches and no weight moved, at
    the main path's protocol (femnist width 32, 100 clients, cohort 5,
    batch 16, ``rounds`` rounds), cut 2 and cut 3 fused.  Four cards:
    (2, 2), (4, 1) and (1, 4) in one spawned world, (1, 2) in a world of
    two: each variant's ``MESH_CHECK_ROUNDS`` rounds held to the
    unsharded run as the card is held to the CPU (``compare_runs``), the
    census of the keys the placement adds exact against
    :func:`engine_mesh_census` on every rank (round 1; every round the
    same), launches by kernel exact on every rank at the mesh's
    capacity, the same metrics on every rank, rounds/s against
    unsharded in turns; on (2, 2) the ten programs at phase 13's
    protocol, each held to its unsharded run the same way.  Raises on
    any miss."""
    from repro_torch.api import ExperimentConfig, algorithm_names
    from repro_torch.launch.meshcheck import spawn_ranks
    from repro_torch.utils.tree import tree_map
    checks, out = {}, {"one_card": {}, "worlds": {}}
    variants = engine_mesh_variants(rounds)
    print(f"engine mesh: on {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} card(s)")
    for name, (cfg, expect) in variants.items():
        base = run_engine(torch, cfg, dev)
        one = run_engine(torch, dataclasses.replace(cfg, mesh_shape=(1, 1)),
                         dev)
        want = expect(5)
        got = {k: one["launches"][k] for k in want}
        placed = [k for c in one["census"] for k in c
                  if k.startswith("model/") or k in PLACEMENT_KEYS]
        checks[f"(1, 1) {name} == unsharded"] = _same(torch, one, base)
        checks[f"(1, 1) {name} launches == unsharded"] = (
            one["launches"] == base["launches"] and got == want)
        checks[f"(1, 1) {name} moves no weight"] = not placed
        out["one_card"][name] = {"launches": one["launches"],
                                 "census": one["census"][0]}
        print(f"engine mesh (1, 1) {name}: bit for bit the unsharded "
              f"Engine {checks[f'(1, 1) {name} == unsharded']}; launches "
              f"{got} (expected {want}); census a round "
              f"{_census_line(one['census'][0])}")
    cards = torch.cuda.device_count()
    worlds = [n for n in ENGINE_MESHES if cards >= n]
    if not worlds:
        print("engine mesh: one card, so the 2-D meshes of phase 26 did not "
              "run")
    else:
        short = {name: run_engine(torch, dataclasses.replace(
            cfg, rounds=MESH_CHECK_ROUNDS, eval_every=MESH_CHECK_ROUNDS),
            dev) for name, (cfg, _) in variants.items()}
        zoo_base = {algo: run_engine(torch, ExperimentConfig(
            algo=algo, **PHASE13).with_cycle(server_epochs=2), dev)
            for algo in algorithm_names()}

        def held(label, base, got):
            try:
                compare_runs(torch, label, {
                    "cpu": (base["rows"],
                            tree_map(lambda t: t.cpu(), base["state"]),
                            base["res"]["history"][-1], base["engine"]),
                    "cuda": (got["rows"], got["state"], got["last"], None)},
                    what="mesh")
                return True
            except AssertionError:
                return False
        short_expect = engine_mesh_variants(MESH_CHECK_ROUNDS)
        for n in worlds:
            shapes = ENGINE_MESHES[n]
            torch.cuda.empty_cache()
            ranks = spawn_ranks(n, engine_mesh_world_runs, (shapes, rounds),
                                dev, shape=shapes[0], timeout=900)
            r0 = ranks[0]
            for shape in shapes:
                key = str(tuple(shape))
                lab = f"({shape[0]}, {shape[1]})"
                rec = out["worlds"][key] = {"rounds/s": r0[key]["rounds/s"]}
                for name in variants:
                    got = r0[key][name]
                    cap = got["capacity"]
                    cut = 2 if name == "cut2" else 3
                    want_c = engine_mesh_census(cut, shape, cap)
                    want_l = short_expect[name][1](cap)
                    checks[f"{lab} {name} held to unsharded"] = held(
                        f"{lab} {name} against unsharded "
                        f"({MESH_CHECK_ROUNDS} rounds)", short[name], got)
                    checks[f"{lab} {name} census == predicted"] = all(
                        _placement_keys(c) == want_c
                        for r in ranks for c in r[key][name]["census"][:1])
                    checks[f"{lab} {name} every round's census the same"] = \
                        all(c == r[key][name]["census"][0] for r in ranks
                            for c in r[key][name]["census"][1:])
                    checks[f"{lab} {name} launches"] = all(
                        {k: r[key][name]["launches"][k] for k in want_l}
                        == want_l for r in ranks)
                    checks[f"{lab} {name} same metrics on every rank"] = all(
                        r[key][name]["rows"] == got["rows"] for r in ranks)
                    rec[name] = {"capacity": cap, "census": got["census"][0],
                                 "census_predicted": want_c,
                                 "launches": got["launches"],
                                 "rows": got["rows"]}
                    print(f"engine mesh {lab} {name}: capacity {cap}; "
                          f"launches {[{k: r[key][name]['launches'][k] for k in want_l} for r in ranks]} "
                          f"(expected {want_l} on every rank); census a "
                          f"round {_census_line(got['census'][0])} "
                          f"(placement predicted {_census_line(want_c)})")
                print(f"engine mesh {lab} cut 2: rank 0's rounds/s in turns "
                      + ", ".join(f"{k} {v}" for k, v in
                                  r0[key]["rounds/s"].items()))
            if "zoo (2, 2)" in r0:
                for algo, got in r0["zoo (2, 2)"].items():
                    checks[f"(2, 2) {algo} held to unsharded"] = held(
                        f"(2, 2) {algo} against unsharded (phase 13's "
                        "protocol)", zoo_base[algo], got)
                    checks[f"(2, 2) {algo} same metrics on every rank"] = all(
                        r["zoo (2, 2)"][algo]["rows"] == got["rows"]
                        for r in ranks)
                out["worlds"]["zoo (2, 2)"] = {
                    a: {"launches": g["launches"], "census": g["census"][0]}
                    for a, g in r0["zoo (2, 2)"].items()}
    bad = [k for k, v in checks.items() if not v]
    print(f"engine mesh checks: {len(checks) - len(bad)} of {len(checks)} "
          "held" + (f"; failed {bad}" if bad else ""))
    out["checks"] = checks
    if bad:
        raise AssertionError(f"engine mesh: {bad}")
    return out


def run_engine_mesh_phase(out_path):
    """The entry of ``--engine-mesh-phase``: phase 26 alone, its report
    written to ``out_path``."""
    import torch
    from repro_torch.kernels import _build
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(f"engine mesh: {smi}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    _build.build_all()
    res = engine_mesh_phase(torch)
    res["nvidia_smi"] = smi
    with open(out_path, "w") as f:
        json.dump(res, f, indent=1, default=str)
    return 0


# phase 27: the Mamba-2, hybrid and whisper steps on the ``model`` axis
# (whisper's FSDP over ``data`` too), in a process of its own
# (``python3 chip_smoke.py --ssm-tp-phase OUT``)
MAMBA_DEPTH = 8           # mamba2-2.7b on (1, 4): 8 of its 64 blocks
SSM_TP_PARAMS = os.path.join(ROOT, "build", "chip_smoke_ssm_tp_{}.pt")
# each world's runs: (label, arch, depth (None: whole), cohort); four
# cards run (1, 4), (2, 2) and (4, 1), two run (1, 2)
SSM_TP_WORLDS = {
    4: {(1, 4): (("zamba2", "zamba2-1.2b", None, COHORT),
                 ("whisper", "whisper-base", None, COHORT),
                 ("mamba2", "mamba2-2.7b", MAMBA_DEPTH, COHORT)),
        (2, 2): (("zamba2", "zamba2-1.2b", None, COHORT),
                 ("whisper", "whisper-base", None, COHORT)),
        # FSDP alone: a cohort of 4 gives each of the 4 ranks a slot
        (4, 1): (("whisper", "whisper-base", None, 4),)},
    2: {(1, 2): (("zamba2", "zamba2-1.2b", None, COHORT),
                 ("whisper", "whisper-base", None, COHORT))}}


def ssm_tp_config(arch, depth):
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return cfg if depth is None else cfg.with_(n_layers=depth)


def ssm_tp_key(arch, depth, cohort) -> str:
    return f"{arch}-{depth or 'whole'}-c{cohort}"


def step_task(cfg, mesh=None):
    """The train step's split task of ``cfg``: whisper's encoder and
    decoder, or the decoder-only cut."""
    from repro_torch.core.split import make_transformer_task
    from repro_torch.launch.steps import make_whisper_task
    return (make_whisper_task(cfg, mesh=mesh) if cfg.family == "audio"
            else make_transformer_task(cfg, mesh=mesh))


def ssm_tp_census(cfg, m, c_local, cohort=COHORT, chunk=512):
    """{census key: {"calls", "bytes"}} of the ``model`` axis in one round
    of ``build_train_step`` for a Mamba-2, hybrid or whisper ``cfg`` on a
    (d, m) mesh whose rank holds ``c_local`` of the ``cohort`` slots:
    written down from the shapes, before any run.  Client blocks run
    forward twice a slot (the extract, the VJP) and backward once; the
    server's forward and backward once a server step and once a slot
    (its feature gradient).  A Mamba block reduces forward its gate
    norm's float32 sum of squares [b, S, 1] and its output [b, S, d];
    backward its gate norm's gradient and, in one call, its input's
    gradient with those of ``conv_b`` (whole, [conv_ch]) and of the
    B/C branch's weights (``w_in``'s [d, 2 G N] and ``conv_w``'s [K, 2 G
    N]), all float32.  zamba2's shared block after each of its server
    positions reduces its attention and FFN outputs and, backward, their
    inputs' gradients.  Whisper's encoder blocks ([b, 1500, d]) reduce
    their attention and MLP forward and backward; its decoder blocks
    ([b, 448, d]) their self-attention, cross-attention and MLP, the
    cross-attention's input gradient with that of the encoder states; a
    slot's feature gradient never asks the first self-attention's input
    gradient (it reads frozen weights alone).  A split vocab adds the
    embedding's reduce to each forward of the half that embeds and to
    each server forward a logits gather (the rank's vocab / m columns in
    the model's dtype) and the head input's reduce, per chunk of 512
    positions (whisper: the whole 448); a split client half adds one
    norm (a float) a slot.  Each Mamba block and each whisper block is a
    group under ``module.remat`` (the hybrid's shared block is not), so
    each backward pass first runs the block's forward again, up to its
    last op that saves a tensor: the gate norm's and the attentions'
    reduces are issued again, the closing reduce of a Mamba block's
    output or of an MLP is not (only the residual add follows it); each
    loss chunk's recompute gathers its logits again (whisper's loss is
    no chunk)."""
    from repro_torch.sharding.parallel import sharded_units
    units = sharded_units(cfg, {"model": m})
    b, f32 = BATCH, 4
    elt = 2 if cfg.dtype == "bfloat16" else 4
    steps = cohort * b // b       # server batch b, one epoch
    srv, d = steps + c_local, cfg.d_model
    out = {}

    def add(key, calls, nbytes):
        if calls:
            row = out.setdefault(f"model/{key}", {"calls": 0, "bytes": 0})
            row["calls"] += calls
            row["bytes"] += calls * nbytes
    if cfg.family == "audio":
        E, D, S = cfg.enc_layers, cfg.n_layers, WHISPER_TEXT
        enc, dec = b * WHISPER_FRAMES * d * f32, b * S * d * f32
        if units["attn"]:
            add("all_reduce/attn", 3 * c_local * E, enc)
            add("all_reduce/attn", 4 * srv * D, dec)
            add("all_reduce/act_grad", c_local * E, enc)
            add("all_reduce/act_grad", srv * D - c_local, dec)
            add("all_reduce/act_grad", srv * D, dec + enc)
        if units["ffn"]:
            add("all_reduce/ffn", 2 * c_local * E, enc)
            add("all_reduce/ffn", srv * D, dec)
            add("all_reduce/act_grad", c_local * E, enc)
            add("all_reduce/act_grad", srv * D, dec)
        if units["vocab"]:
            add("all_reduce/embed", srv, dec)
            add("all_gather/logits", srv, b * S * cfg.vocab_padded // m * elt)
            add("all_reduce/act_grad", srv, dec)
    else:
        s, S = cfg.ssm, SEQ
        cut, L = cfg.cut_layers, cfg.n_layers
        act, norm = b * S * d * f32, b * S * f32
        fwd = 2 * c_local * cut + srv * (L - cut)
        bwd = c_local * cut + srv * (L - cut)
        if units["mamba"]:
            gn2 = 2 * s.n_groups * s.d_state
            conv_ch = s.expand * d + gn2
            bc = (d + s.d_conv) * gn2 if s.n_groups == 1 else 0
            add("all_reduce/norm", fwd + bwd, norm)
            add("all_reduce/mamba", fwd, act)
            add("all_reduce/norm_grad", bwd, norm)
            add("all_reduce/mamba_grad", bwd, act + (conv_ch + bc) * f32)
        shared = (sum(cut <= p < L for p in s.shared_attn_positions)
                  if cfg.family == "hybrid" else 0)
        norms = 2 * cfg.hd * f32 if cfg.attn.qk_norm else 0
        if units["attn"]:
            add("all_reduce/attn", srv * shared, act)
            add("all_reduce/act_grad", srv * shared, act + norms)
        if units["ffn"]:
            add("all_reduce/ffn", srv * shared, act)
            add("all_reduce/act_grad", srv * shared, act)
        if units["vocab"]:
            cs = min(chunk, S)
            n_chunks = -(-S // cs)
            add("all_reduce/embed", 2 * c_local, act)
            add("all_gather/logits", 2 * n_chunks * srv,
                b * cs * cfg.vocab_padded // m * elt)
            add("all_reduce/act_grad", n_chunks * srv, b * cs * d * f32)
    if any(units.values()):
        add("all_reduce/grad_norm", c_local, f32)
    return out


@contextlib.contextmanager
def planted_bc_fault():
    """The control of phase 27's Mamba runs: inside, the ``B``/``C``
    branch's weights and ``conv_b`` enter a Mamba block without
    ``copy_to_model``, so each rank keeps its own heads' share of their
    gradients, not the sum over the axis (the block input's gradient is
    still summed).  The forward is untouched; the check must refuse the
    run."""
    from repro_torch.models import mamba2
    real = mamba2.copy_to_model

    def drop(tp, x, *rest, what="act_grad"):
        if what != "mamba_grad":
            return real(tp, x, *rest, what=what)
        return (real(tp, x, what=what),) + rest
    mamba2.copy_to_model = drop
    try:
        yield
    finally:
        mamba2.copy_to_model = real


def replicated_digests(torch, mesh, cfg, server, clients):
    """sha256 of what every rank of a ``model`` group must hold alike:
    each leaf whole over the axis and the whole segments (B, C) of a
    packed Mamba leaf, the server's (its FSDP blocks gathered over
    ``data`` first) and the client slots'.  A gradient that is not
    summed over the axis leaves these apart."""
    import hashlib
    from repro_torch.models.module import SHAPES
    from repro_torch.sharding.specs import Shard, gather_params, shard_plan
    from repro_torch.utils.tree import tree_leaves, tree_map
    task = step_task(cfg)
    sp = shard_plan(task.init_server(SHAPES), mesh.shape, mesh.coords,
                    "server", cfg)
    cp = tree_map(Shard.stacked, shard_plan(task.init_client(SHAPES),
                                            mesh.shape, mesh.coords, "full",
                                            cfg))
    srv = gather_params(server.params, sp, None, mesh.data_comm)

    def digest(tree, plan):
        h = hashlib.sha256()
        for x, s in zip(tree_leaves(tree), tree_leaves(plan)):
            if s.dim is None:
                parts = [x]
            elif s.segs is None:
                continue
            else:
                parts = [p for p, (_, _, split) in zip(torch.split(
                    x, [hi - lo for lo, hi, _ in s.segs], s.dim), s.segs)
                         if not split]
            for p in parts:
                h.update(p.detach().contiguous().reshape(-1)
                         .view(torch.uint8).cpu().numpy().tobytes())
        return h.hexdigest()
    return {"server": digest(srv, sp), "clients": digest(clients.params, cp)}


def ssm_tp_kernel_checks(torch, dev):
    """The kernels of phase 27's path at a rank's shapes on a model axis
    of 2 and 4, each against its plain version: ``ssd_scan`` on a rank's
    SSD heads of zamba2-1.2b ([2, 2048, 32 | 16, 64], N 64) and of
    mamba2-2.7b ([2, 2048, 40 | 20, 64], N 128), bf16, chunk 256, x whole
    and B, C column slices of the rank's [B, L, 2 N] conv output (the
    tensor-core design); ``flash_attention`` on a rank's heads of
    zamba2's shared block ([2, 2048, 16 | 8, 64] causal) and of
    whisper-base's encoder ([2, 1500, 4 | 2, 64]), causal decoder ([2,
    448, 4 | 2, 64]) and cross-attention (448 queries over 1500 keys),
    bf16, with SDPA's time; ``fused_adam`` on a rank's block of
    zamba2's server ``w_in`` stack ([34, 2048, 4256 | 2192]: its heads'
    z, x and dt columns and B, C whole), bf16 with float32 moments."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev).manual_seed(27)
    rows = []
    z = ssm_tp_config("zamba2-1.2b", None)
    for m in (2, 4):
        s = z.ssm
        d_in, gn = s.expand * z.d_model // m, 2 * s.n_groups * s.d_state
        shape = (z.n_layers - z.cut_layers, z.d_model,
                 2 * d_in + gn + d_in // s.head_dim)
        p = torch.randn(shape, device=dev, generator=gen).to(torch.bfloat16)
        g = torch.randn(shape, device=dev, generator=gen).to(torch.bfloat16)
        mm = torch.randn(shape, device=dev, generator=gen) * 0.1
        vv = torch.rand(shape, device=dev, generator=gen) * 0.1
        step = torch.tensor(3, dtype=torch.int32, device=dev)
        rows.append(check(
            "fused_adam", f"{list(shape)} bf16 (a rank's packed w_in, "
            f"model axis {m})",
            lambda: ops.fused_adam(p, g, mm, vv, step, lr=1e-3),
            lambda: ref.fused_adam_ref(p, g, mm, vv, step, lr=1e-3),
            1e-6, kernel_cost("fused_adam", p, g, mm, vv, step), ulps=1))
        del p, g, mm, vv
        torch.cuda.empty_cache()
    for m in (2, 4):
        for arch in ("zamba2-1.2b", "mamba2-2.7b"):
            s = ssm_tp_config(arch, None).ssm
            H = s.expand * ssm_tp_config(arch, None).d_model // s.head_dim
            rows.append(ssd_check(
                torch, dev, gen, f"{arch.split('-')[0]} (a rank's heads, "
                f"model axis {m})", BATCH, SEQ, H // m, s.head_dim,
                s.d_state, s.n_groups, torch.bfloat16, s.chunk,
                sliced="rank"))
        z = ssm_tp_config("zamba2-1.2b", None)
        note = f" (a rank's heads, model axis {m})"
        rows.append(attention_check(
            torch, dev, gen, BATCH, SEQ, SEQ, z.n_heads // m,
            z.n_kv_heads // m, z.hd, torch.bfloat16, library=True,
            note=" zamba2 shared block" + note))
        w = ssm_tp_config("whisper-base", None)
        H = w.n_heads // m
        for Sq, Sk, causal, what in (
                (WHISPER_FRAMES, WHISPER_FRAMES, False, "encoder"),
                (WHISPER_TEXT, WHISPER_TEXT, True, "decoder"),
                (WHISPER_TEXT, WHISPER_FRAMES, False, "cross")):
            rows.append(attention_check(
                torch, dev, gen, BATCH, Sq, Sk, H, H, w.hd, torch.bfloat16,
                causal=causal, library=True,
                note=f" whisper {what}" + note))
        torch.cuda.empty_cache()
    return rows


def ssm_tp_rank_runs(mesh, runs, rounds, want_rows, profile=False):
    """Phase 27 on a (d, m) mesh of spawned ranks, one card each: for
    each run ``(label, arch, depth, cohort)``, ``rounds`` train rounds
    at published widths (bf16, batch 2 a client, sequence 2048; whisper
    1500 frames, 448 tokens) with exact launches and each round's
    census, gathered whole and held to the unsharded run of this
    phase's one-card part (rank 0 reads its weights from
    ``SSM_TP_PARAMS``; :func:`tp_against_unsharded`), with the digests
    of the weights every rank must hold alike
    (:func:`replicated_digests`); then the same run under a planted
    fault, which those checks must refuse: :func:`planted_bc_fault`
    where the model has Mamba blocks, else :func:`planted_backward_fault`
    on a model axis, :func:`planted_data_fault` without one; then the
    prefill.  ``profile`` profiles one more round of the first run.
    Only rank 0 prints; every rank returns its own numbers."""
    import torch
    rank = torch.distributed.get_rank()
    if rank != 0:
        sys.stdout = open(os.devnull, "w")
    d, m = mesh.shape["data"], mesh.shape["model"]
    lab = f"({d}, {m})"
    out = {}
    for label, arch, depth, cohort in runs:
        cfg = ssm_tp_config(arch, depth)
        key = ssm_tp_key(arch, depth, cohort)
        fault = (planted_bc_fault if cfg.ssm is not None and m > 1 else
                 planted_backward_fault if m > 1 else planted_data_fault)
        res = {"fault": fault.__name__}
        for part, ctx in (("run", contextlib.nullcontext), ("planted", fault)):
            torch.cuda.empty_cache()
            with ctx():
                run = split_round(
                    torch, f"ssm-tp {lab} {label}"
                    + (f" ({fault.__name__})" if part == "planted" else ""),
                    cfg, rounds, mesh=mesh, keep_state=True, cohort=cohort,
                    profile=(profile and part == "run"
                             and label == runs[0][0]))
            server, clients = run.pop("state")
            run["replicated"] = replicated_digests(torch, mesh, cfg, server,
                                                   clients)
            params = whole_step_state(mesh, cfg, server, clients)
            del server, clients
            run["held"] = (tp_against_unsharded(
                torch, params, run["metrics"], want_rows[key], 2 * rounds,
                SSM_TP_PARAMS.format(key)) if rank == 0 else None)
            del params
            torch.cuda.empty_cache()
            res[part] = run
        res["prefill"] = prefill(torch, f"ssm-tp {lab} {label} prefill", cfg,
                                 mesh=mesh)
        res["expected_census"] = step_census(cfg, d, m, cohort)
        out[label] = res
    out["coords"] = dict(mesh.coords)
    return out


def ssm_tp_phase(torch, rounds=ROUNDS, dev="cuda", profile=False):
    """Phase 27: the Mamba-2, hybrid and whisper steps on the ``model``
    axis.  One card: a (1, 1) mesh through the model-axis code for
    zamba2-1.2b whole and whisper-base whole at the protocol of phases
    10 and 21 (bf16, cohort 2, batch 2, sequence 2048; whisper 1500
    frames, 448 tokens), ``rounds`` rounds and the prefill, each bit for
    bit the unsharded step (every leaf of the state, held in host
    memory between the runs, the metrics, the logits) with the
    unsharded launches and no collective; then the kernels at a rank's
    shapes (:func:`ssm_tp_kernel_checks`).  With four cards
    :func:`ssm_tp_rank_runs` on the meshes of ``SSM_TP_WORLDS`` (two
    cards: (1, 2)), each run held to the unsharded run of this part
    (phase 25's criteria, and the weights every rank holds alike the
    same), its planted fault refused, its census exactly
    :func:`step_census`, the same metrics and launches on every rank of
    a batch coordinate, and its peak memory a card.  ``profile``
    profiles one more round of the unsharded zamba2 run and of each
    world's first run.  Raises on any miss."""
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.meshcheck import spawn_ranks
    from repro_torch.utils.tree import tree_leaves, tree_map
    out, checks = {"one_card": {}, "worlds": {}}, {}
    cards = torch.cuda.device_count()
    worlds = SSM_TP_WORLDS[4] if cards >= 4 else (
        SSM_TP_WORLDS[2] if cards >= 2 else {})
    # the (1, 1) pairs, and the unsharded runs the worlds are held to
    pairs = [("zamba2-1.2b", None, COHORT), ("whisper-base", None, COHORT)]
    held = {ssm_tp_key(a, dp, c): (a, dp, c) for runs in worlds.values()
            for _, a, dp, c in runs}
    needed = {**{ssm_tp_key(*p): p for p in pairs}, **held}
    want_rows = {}
    mesh = make_local_mesh(dev)
    try:
        for key, (arch, depth, cohort) in needed.items():
            cfg, lab = ssm_tp_config(arch, depth), arch.split("-")[0]
            meshes = ((("unsharded", None), ("mesh (1, 1)", mesh))
                      if (arch, depth, cohort) in pairs
                      else (("unsharded", None),))
            runs, logits = {}, {}
            for label, mm in meshes:
                free(torch)
                r = split_round(torch, f"ssm-tp {lab} {label}", cfg, rounds,
                                mesh=mm, keep_state=True, cohort=cohort,
                                profile=(profile and mm is None
                                         and key == ssm_tp_key(*pairs[0])))
                state = r.pop("state")
                if mm is None:       # the unsharded state, in host memory
                    want = tree_map(lambda t: t.cpu(), state)
                    want_rows[key] = r["metrics"]
                    if key in held:
                        os.makedirs(os.path.dirname(SSM_TP_PARAMS),
                                    exist_ok=True)
                        torch.save((want[0].params, want[1].params),
                                   SSM_TP_PARAMS.format(key))
                else:
                    checks[f"{lab} (1, 1) round == unsharded"] = all(
                        torch.equal(x, y.cpu()) for x, y in zip(
                            tree_leaves(want), tree_leaves(state)))
                del state
                free(torch)
                if len(meshes) > 1:
                    p = prefill(torch, f"ssm-tp {lab} {label} prefill", cfg,
                                mesh=mm, keep=True)
                    logits[label] = p.pop("logits")
                    runs[label] = {"round": r, "prefill": p}
                else:
                    runs[label] = {"round": r}
            del want
            if len(meshes) > 1:
                a, b = runs["unsharded"], runs["mesh (1, 1)"]
                checks[f"{lab} (1, 1) round == unsharded"] &= (
                    a["round"]["metrics"] == b["round"]["metrics"])
                checks[f"{lab} (1, 1) launches == unsharded"] = (
                    a["round"]["launches"] == b["round"]["launches"]
                    and a["prefill"]["launches"] == b["prefill"]["launches"])
                checks[f"{lab} (1, 1) prefill == unsharded"] = bool(
                    torch.equal(logits["unsharded"], logits["mesh (1, 1)"]))
                checks[f"{lab} (1, 1) takes no collective"] = all(
                    c == {} for c in b["round"]["census"]) and \
                    take_census(mesh) == {}
            del logits
            out["one_card"][key] = runs
        print("ssm-tp (1, 1) at full width: " + ", ".join(
            f"{k} {v}" for k, v in checks.items()))
    finally:
        mesh.close()
    free(torch)
    out["kernel_checks"] = ssm_tp_kernel_checks(torch, torch.device(dev))
    free(torch)
    for (d, m), runs in worlds.items():
        lab, n = f"({d}, {m})", d * m
        free(torch)
        ranks = spawn_ranks(n, ssm_tp_rank_runs,
                            (runs, rounds, want_rows, profile), "cuda",
                            shape=(d, m), timeout=900)
        r0 = ranks[0]
        world = {"n": n, "runs": {}}
        for label, arch, depth, cohort in runs:
            res = r0[label]
            want = res["expected_census"]
            groups = {}        # a batch coordinate's ranks run one slot set
            for r in ranks:
                groups.setdefault(r["coords"]["data"], []).append(r[label])

            def alike(part, what):
                """Every rank's digest of ``what`` the same: the server's
                over all ranks, the clients' within a batch coordinate."""
                sets = (([x[part]["replicated"]["server"] for r in ranks
                          for x in [r[label]]],) if what == "server" else
                        [[x[part]["replicated"]["clients"] for x in g]
                         for g in groups.values()])
                return all(len(set(s)) == 1 for s in sets)

            def held(part):
                return (res[part]["held"]["ok"] and alike(part, "server")
                        and alike(part, "clients"))
            name = f"{lab} {label}"
            checks[f"{name} held to unsharded"] = held("run")
            checks[f"{name} refuses a planted fault ({res['fault']})"] = (
                not held("planted"))
            checks[f"{name} census == predicted"] = all(
                c == want for r in ranks for c in r[label]["run"]["census"])
            checks[f"{name} same metrics and launches on every rank"] = all(
                x["run"]["metrics"] == g[0]["run"]["metrics"]
                and x["run"]["launches"] == res["run"]["launches"]
                for g in groups.values() for x in g)
            peak = max(r[label]["run"]["peak_bytes"] for r in ranks)
            checks[f"{name} fits a card"] = peak < 80e9
            w = res["run"]
            print(f"ssm-tp {name} {w['config']['arch']} L "
                  f"{w['config']['n_layers']}: {w['rounds_per_s']:.3f} "
                  f"rounds/s, {w['tokens_per_s']:.1f} tokens/s, peak "
                  f"{peak / 1e9:.2f} GB a card (max over ranks), entity "
                  f"states {w['state_bytes'] / 1e9:.2f} GB a card, prefill "
                  f"{res['prefill']['ms']:.2f} ms; census a round "
                  f"{_census_line(w['census'][0])} (predicted "
                  f"{_census_line(want)}); against unsharded {w['held']}; "
                  f"with {res['fault']} {res['planted']['held']}, "
                  "replicated weights alike "
                  f"{alike('planted', 'server')}, "
                  f"{alike('planted', 'clients')} (server, clients)")
            world["runs"][label] = {
                "rank0": res, "peak_bytes_max": peak,
                "peak_bytes": [r[label]["run"]["peak_bytes"] for r in ranks],
                "census_predicted": want}
        out["worlds"][lab] = world
    if not worlds:
        print("ssm-tp: one card, so the (d, m) part of phase 27 did not run")
    bad = [k for k, v in checks.items() if not v]
    out["checks"] = checks
    if bad:
        raise AssertionError(f"ssm-tp: {bad}")
    return out


def run_ssm_tp_phase(out_path, profile=False):
    """The entry of ``--ssm-tp-phase``: phase 27 alone, its report
    written to ``out_path``."""
    import torch
    from repro_torch.kernels import _build
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(f"ssm-tp: {smi}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    _build.build_all()
    res = ssm_tp_phase(torch, profile=profile)
    res["nvidia_smi"] = smi
    with open(out_path, "w") as f:
        json.dump(res, f, indent=1, default=str)
    return 0


# ---------------------------------------------------------------- phase 28
# decode and the serving slot table on a mesh, in a process of its own
# (``python3 chip_smoke.py --decode-mesh-phase OUT``)
DM_ONE_CARD_REQUESTS = 8       # one wave of phase 16's stream on (1, 1)
DM_TF = dict(batch=4, steps=16)  # teacher forcing: rows, steps (= context)
# each world's runs: (kind, arch, depth (None: whole)); "serve" runs
# ServeRuntime over SERVE_REQUESTS[arch] requests and teacher-forces the
# decode step, "decode" teacher-forces the decode step alone
# a stream may part from the unsharded one where the unsharded top-2 gap
# lies within DM_PART_K x the rms of the bf16 gap against the float32
# one: phase 17's 3, times sqrt(2), because a parting compares two bf16
# runs (the mesh's and one card's), each with its own rounding
DM_PART_K = 3 * math.sqrt(2)
DM_WORLDS = {
    (1, 4): (("serve", "olmoe-1b-7b", None), ("serve", "zamba2-1.2b", None),
             ("decode", "whisper-base", None),
             ("decode", "mamba2-2.7b", MAMBA_DEPTH)),
    (2, 2): (("serve", "olmoe-1b-7b", None), ("serve", "zamba2-1.2b", None))}
DM_ONE_CARD = (("olmoe-1b-7b", None), ("zamba2-1.2b", None),
               ("whisper-base", None), ("mamba2-2.7b", MAMBA_DEPTH))


def dm_config(arch, depth):
    """The arch at ``depth``, its MoE at capacity factor 8 for teacher
    forcing (as phase 17: no side drops a token, so the yardstick reads
    rounding alone); the serving runs keep the config's (one token a
    group never drops)."""
    cfg = ssm_tp_config(arch, depth)
    if cfg.moe is not None:
        cfg = cfg.with_(moe=dataclasses.replace(cfg.moe,
                                                capacity_factor=8.0))
    return cfg


def dm_teacher(torch, cfg, mesh=None, dev="cuda", f32=False, planted=False):
    """``DM_TF["steps"]`` teacher-forced steps of ``build_decode_step`` at
    ``DM_TF["batch"]`` rows from ``init_state(0)`` (on ``mesh``, the
    rank's rows and shards), fed numpy tokens (seed 2): ``{"tf":
    (logits, launches)}``, the float32 logits [B, steps, V] of every row
    (gathered over the batch axes), on the card, and the launches; with
    ``planted`` also ``"planted"``, the same steps from the same weights
    and empty state under :func:`planted_decode_reduce_fault` (the
    control).  ``f32`` (unsharded only) runs the same weights upcast in
    float32 (the yardstick's other side; TF32 off)."""
    import numpy as np
    from repro_torch.configs import InputShape
    from repro_torch.launch import inputs as inputs_lib
    from repro_torch.launch.steps import build_decode_step
    from repro_torch.models.encdec import EncDec
    from repro_torch.models.transformer import Transformer
    from repro_torch.sharding.specs import decode_rows, rows_comm
    from repro_torch.utils.tree import tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = dev if mesh is None else mesh.device
    B, S = DM_TF["batch"], DM_TF["steps"]
    shape = InputShape("decode-mesh tf", S, B, "decode")
    bundle = build_decode_step(cfg, shape, device=dev, mesh=mesh)
    params, state0 = bundle.init_state(0)
    if f32:
        cfg32 = cfg.with_(dtype="float32")
        params = tree_map(lambda t: t.float(), params)
        bundle = build_decode_step(cfg32, shape, device=dev)
        if cfg.family == "audio":
            frames = torch.from_numpy(np.random.default_rng(0).standard_normal(
                (B, inputs_lib.WHISPER_FRAMES, cfg.enc_d_model)).astype(
                    np.float32)).to(dev).to(cfg.torch_dtype).float()
            with torch.no_grad():
                state0 = EncDec.init_decode_state(params, cfg32, frames, S)
        else:
            state0 = Transformer.init_decode_state(cfg32, B, S, device=dev)
    lo, hi, axes = ((0, B, None) if mesh is None
                    else decode_rows(mesh.shape, mesh.coords, B))
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, size=(B, S), dtype=np.int32)[lo:hi]).to(dev)
    rc = None if mesh is None else rows_comm(mesh, axes)
    out = {}
    for part in ("tf", "planted") if planted else ("tf",):
        ctx = (planted_decode_reduce_fault(cfg) if part == "planted"
               else contextlib.nullcontext())
        state, outs = state0, []       # a decode leaves its state as it was
        reset_counters()
        with ctx:
            for t in range(S):
                lg, state = bundle.fn(params, toks[:, t:t + 1], state)
                outs.append(lg[:, 0].float())
        torch.cuda.synchronize()
        launches = {k: v for k, v in read_counters().items() if v}
        logits = torch.stack(outs, 1)
        if rc is not None:
            logits = rc.all_gather(logits, "logits")
        out[part] = (logits, launches)
        del state, outs
    del params, state0
    return out


def _rms(x) -> float:
    return float(x.double().square().mean().sqrt())


@contextlib.contextmanager
def planted_decode_reduce_fault(cfg):
    """The control: the decode attention's ``reduce_from_model`` dropped
    (each rank keeps its heads' partial sum); in a model without
    attention (mamba2-2.7b) the Mamba block's."""
    from repro_torch.models import attention, mamba2
    mod = attention if cfg.family != "ssm" else mamba2
    real = mod.reduce_from_model
    mod.reduce_from_model = lambda tp, x, what: x
    try:
        yield
    finally:
        mod.reduce_from_model = real


class ServedGaps:
    """The top-2 logit gap behind every token a ``ServeRuntime`` run
    generates, read inside the run itself (no replay): while on,
    ``Transformer.decode_step`` leaves each call's last-position gap [B]
    on the card, and the runtime's admission and decode are wrapped to
    note on the host which request, and which of its tokens, each row's
    logits choose (a chunk row's first token comes from the prefill
    position of its prompt's last token; a live slot's next from the
    tick's decode).  :meth:`gaps` reads them once, after the run:
    ``{(rid, j): gap}``.  The topk adds one small kernel a decode body
    call to the run it records."""

    def __init__(self, torch, rt):
        from repro_torch.models.transformer import Transformer
        self.torch, self.rt, self.T = torch, rt, Transformer
        self.raw = Transformer.__dict__["decode_step"]
        self.calls, self.marks, self.chunk = [], [], None
        real = Transformer.decode_step

        def step(*a, **k):
            lg, st = real(*a, **k)
            top = torch.topk(lg[:, -1].float(), 2).values
            self.calls.append(top[:, 0] - top[:, 1])
            return lg, st
        Transformer.decode_step = staticmethod(step)
        admit, prefill, decode = rt._admit_chunk, rt._prefill, rt._decode

        def admit_chunk(now):
            n = min(len(rt.queue), len(rt.free), rt.serve.prefill_batch)
            self.chunk = [(r.rid, len(r.prompt)) for r in list(rt.queue)[:n]]
            return admit(now)

        def prefill_call(*args):
            self.marks.append(("prefill", len(self.calls), self.chunk))
            return prefill(*args)

        def decode_call(*args):
            self.marks.append(("decode", len(self.calls), [
                (s, r.rid, int(rt.counts_host[s]))
                for s, r in enumerate(rt.slot_req) if r is not None]))
            return decode(*args)
        rt._admit_chunk, rt._prefill, rt._decode = (admit_chunk, prefill_call,
                                                    decode_call)

    def off(self):
        self.T.decode_step = self.raw

    def gaps(self) -> dict:
        sizes = [c.numel() for c in self.calls]
        flat = self.torch.cat(self.calls).cpu().tolist()
        vals, at = [], 0
        for n in sizes:
            vals.append(flat[at:at + n])
            at += n
        out = {}
        for kind, start, rows in self.marks:
            if kind == "prefill":
                for i, (rid, n) in enumerate(rows):
                    out[(rid, 0)] = vals[start + n - 1][i]
            else:
                for s, rid, j in rows:
                    out[(rid, j)] = vals[start][s]
        return out


def dm_serve(torch, cfg, n_requests, mesh=None, dev="cuda", keep=False,
             gaps=False):
    """``run_closed_loop`` over phase 16's stream (``make_prompts(n, 64,
    vocab, 1)``) at concurrency 8 through ``ServeRuntime(SERVE, seed=0,
    mesh=)``: every request's tokens, its records without their times,
    the stats, the census of every collective group (the host group's
    too) over the loop, ms a tick (the decode calls' device timeline),
    tokens/s, TTFT, peak memory and the launches, which must be phase
    16's count: (decode calls + chunks x max_prompt_len) x layers of
    ``topk_gating`` in an MoE model, none otherwise.  ``keep`` keeps the
    final slot table (on the host); ``gaps`` records the top-2 logit gap
    behind every generated token in the run (:class:`ServedGaps`), as
    ``gaps`` [[rid, j, gap], ...]."""
    import numpy as np
    from repro_torch.serve import (ServeConfig, ServeRuntime, make_prompts,
                                   run_closed_loop)
    from repro_torch.utils.tree import tree_leaves
    sc = ServeConfig(**SERVE)
    free(torch)
    rt = ServeRuntime(cfg, sc, seed=0, mesh=mesh, device=dev)
    prompts = make_prompts(n_requests, sc.max_prompt_len, cfg.vocab, seed=1)
    rec = ServedGaps(torch, rt) if gaps else None
    rt._decode, rt._prefill = Timed(torch, rt._decode), Timed(torch,
                                                             rt._prefill)
    host = rt._host                 # the scheduler's group, on a mesh
    take_census(mesh)
    if host is not None:
        host.take_census()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.perf_counter()
    try:
        row = run_closed_loop(rt, prompts, concurrency=sc.slots)
        torch.cuda.synchronize()
    finally:
        if rec is not None:
            rec.off()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in read_counters().items() if "/" not in k}
    census = take_census(mesh)
    if host is not None:
        census.update(host.take_census())
    dec, pre = rt._decode.ms(), rt._prefill.ms()
    want = serve_schedule(n_requests, sc)
    expect = {k: 0 for k in counters()}
    expect["topk_gating"] = ((len(dec) + len(pre) * sc.max_prompt_len)
                             * cfg.n_layers if cfg.moe else 0)
    out = {"tokens": [rt.results[r].tokens.tolist()
                      for r in sorted(rt.results)],
           "records": [{k: v for k, v in r.items()
                        if k not in ("latency_s", "ttft_s")}
                       for r in rt.records()],
           "stats": rt.stats(), "census": census, "wall_s": wall,
           "tick_ms": float(np.median(dec[1:])), "decode_calls": len(dec),
           "prefill_chunks": len(pre), "ticks": row["ticks"],
           "tokens_per_s": row["throughput_tok_s"],
           "ttft_p50_s": row["ttft_s"]["p50"],
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "launches": launches, "expected_launches": expect,
           "schedule_ok": ({"decode": len(dec), "prefill": len(pre),
                            "ticks": row["ticks"]} == want),
           "done": row["by_status"]["done"]}
    if rec is not None:
        got = rec.gaps()
        out["gaps"] = {(i, j): got[(rid, j)]
                       for i, rid in enumerate(sorted(rt.results))
                       for j in range(len(rt.results[rid].tokens))}
    if keep:
        out["table"] = [t.cpu() for t in tree_leaves(rt.state)]
    del rt
    free(torch)
    return out


def _stream_digest(run) -> str:
    import hashlib
    return hashlib.sha256(repr((run["tokens"], run["records"],
                                run["stats"])).encode()).hexdigest()


def dm_rank_runs(mesh, worlds, requests):
    """Phase 28 in spawned ranks, one card each: for each ``((d, m),
    runs)`` of ``worlds``, in order, on ``mesh`` (the spawn's, for the
    first) or a (d, m) mesh built over the same ranks, and for each run
    ``(kind, arch, depth)`` the teacher-forced bf16 logits of the decode
    step and the same under :func:`planted_decode_reduce_fault` (from
    the same weights), and for ``"serve"`` the served
    stream of ``requests[arch]`` requests (:func:`dm_serve`).  Rank 0
    returns the logits; every rank returns their digests, its stream's
    digest, its numbers and its launches, by world.  Only rank 0
    prints."""
    import hashlib
    import torch
    from repro_torch.launch.mesh import make_engine_mesh
    rank = torch.distributed.get_rank()
    if rank != 0:
        sys.stdout = open(os.devnull, "w")
    out = {}
    for shape, runs in worlds:
        if (mesh.shape["data"], mesh.shape["model"]) != tuple(shape):
            mesh = make_engine_mesh(shape, ("data", "model"), "cuda")
        lab = f"({shape[0]}, {shape[1]})"
        t0 = time.perf_counter()
        res_w = {"coords": dict(mesh.coords), "s": {}}
        for kind, arch, depth in runs:
            cfg = dm_config(arch, depth)
            res = {}
            free(torch)
            t1 = time.perf_counter()
            for part, (logits, launches) in dm_teacher(
                    torch, cfg, mesh, planted=True).items():
                lg = logits.cpu()
                res[part] = {"digest": hashlib.sha256(
                    lg.numpy().tobytes()).hexdigest(), "launches": launches}
                if rank == 0:
                    res[part]["logits"] = lg
            free(torch)
            res_w["s"][f"{arch} teacher"] = time.perf_counter() - t1
            if kind == "serve":
                t1 = time.perf_counter()
                run = dm_serve(torch, ssm_tp_config(arch, depth),
                               requests[arch], mesh)
                res_w["s"][f"{arch} serve"] = time.perf_counter() - t1
                run["digest"] = _stream_digest(run)
                res["serve"] = run
                print(f"decode-mesh {lab} {arch}: {run['tick_ms']:.3f} ms "
                      f"a tick, {run['tokens_per_s']:.1f} tokens/s, TTFT "
                      f"p50 {run['ttft_p50_s']:.4f}s, peak "
                      f"{run['peak_bytes'] / 1e9:.2f} GB; launches "
                      f"{run['launches']}")
            res_w[arch] = res
        res_w["s"]["world"] = time.perf_counter() - t0
        out[lab] = res_w
    return out


def dm_kernel_checks(torch, dev):
    """``topk_gating`` against its plain version at the router rows a
    rank's serving step gives it: olmoe's [8, 64] (a decode tick on (1,
    4), whose slots are whole over the batch axes), [4, 64] (a prefill
    chunk there, a decode tick on (2, 2)) and [2, 64] (a prefill chunk
    on (2, 2)), k 8; the router is whole on every rank."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.topk_gating import topk_gating
    gen = torch.Generator(device=dev).manual_seed(28)
    rows = []
    for T, where in ((8, "a decode tick on (1, 4)"),
                     (4, "a prefill chunk on (1, 4), a decode tick on "
                         "(2, 2)"),
                     (2, "a prefill chunk on (2, 2)")):
        x = torch.randn(T, 64, device=dev, generator=gen)
        got, want = topk_gating(x, 8), ref.topk_gating_ref(x, 8)
        if not torch.equal(got[1], want[1]):
            raise AssertionError(f"topk_gating [{T}, 64]: ids differ from "
                                 "the plain version")
        rows.append(check(
            "topk_gating", f"[{T}, 64] k=8 ({where})",
            lambda: (topk_gating(x, 8)[0],),
            lambda: (ref.topk_gating_ref(x, 8)[0],), 1e-6,
            kernel_cost("topk_gating", x, 8)))
    return rows


def _gap_noise(bf, f32) -> float:
    """The rms over rows and steps of the bf16 decode's top-2 logit gap
    less the float32 decode's gap of the same two logits: the yardstick's
    noise for a difference of two logits."""
    import torch
    ids = torch.topk(bf, 2).indices
    g = lambda x: (x.gather(-1, ids[..., :1]) - x.gather(-1, ids[..., 1:]))
    return _rms(g(bf) - g(f32))


def decode_mesh_phase(torch, dev="cuda"):
    """Phase 28: decode and the serving slot table on a mesh.  One card:
    a (1, 1) mesh through ``ServeRuntime`` (olmoe-1b-7b whole, one wave
    of phase 16's stream) and ``build_decode_step`` (``DM_ONE_CARD``,
    teacher forcing), each bit for bit the unsharded run (the served
    tokens, records and stats, the final slot table, the logits) with
    the unsharded launches and no collective; then ``topk_gating`` at a
    rank's serving rows.  With four cards, the runs of ``DM_WORLDS`` in
    one spawn of four ranks, each held to the unsharded runs of this
    process: teacher-forced bf16 logits within phase 17's yardstick (3x
    the rms of the bf16 decode against a float32 decode), the same
    decode without its reduce refused by it, every served request's
    tokens the unsharded ones up to a step whose unsharded top-2 gap,
    read in the unsharded served run itself, lies within the yardstick
    of a parting (:data:`DM_PART_K` x the rms of the bf16 top-2 gap
    against the float32 one,
    :func:`_gap_noise`), every rank alike, phase 16's launches on every
    rank.  Raises on any miss."""
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.meshcheck import spawn_ranks
    t_phase = time.perf_counter()
    out, checks = {"one_card": {}, "worlds": {}, "s": {}}, {}
    cards = torch.cuda.device_count()
    worlds = DM_WORLDS if cards >= 4 else {}
    mesh = make_local_mesh(dev)
    unsharded = {}                  # arch: its unsharded bf16 teacher run
    try:
        cfg = ssm_tp_config("olmoe-1b-7b", None)
        runs = {}
        for label, mm in (("unsharded", None), ("mesh (1, 1)", mesh)):
            runs[label] = dm_serve(torch, cfg, DM_ONE_CARD_REQUESTS, mm,
                                   dev, keep=True)
        a, b = runs["unsharded"], runs["mesh (1, 1)"]
        checks["olmoe (1, 1) serving == unsharded"] = (
            a["tokens"] == b["tokens"] and a["records"] == b["records"]
            and a["stats"] == b["stats"] and all(
                torch.equal(x, y) for x, y in zip(a.pop("table"),
                                                  b.pop("table"))))
        checks["olmoe (1, 1) serving launches == unsharded"] = (
            a["launches"] == b["launches"] == a["expected_launches"]
            and a["launches"]["topk_gating"] > 0)
        checks["olmoe (1, 1) serving takes no collective"] = (
            b["census"] == {})
        print(f"decode-mesh (1, 1) olmoe serving: {b['tick_ms']:.3f} ms a "
              f"tick ({a['tick_ms']:.3f} unsharded), {b['tokens_per_s']:.1f} "
              f"tokens/s ({a['tokens_per_s']:.1f}); launches {b['launches']}")
        out["one_card"]["serve olmoe-1b-7b"] = runs
        out["s"]["one card serving"] = time.perf_counter() - t_phase
        for arch, depth in DM_ONE_CARD:
            cfg = dm_config(arch, depth)
            free(torch)
            want, wl = dm_teacher(torch, cfg, None, dev)["tf"]
            want = want.cpu()
            unsharded[arch] = want
            free(torch)
            got, gl = dm_teacher(torch, cfg, mesh, dev)["tf"]
            lab = arch.split("-")[0]
            checks[f"{lab} (1, 1) decode == unsharded"] = bool(
                torch.equal(want, got.cpu()))
            checks[f"{lab} (1, 1) decode launches == unsharded"] = wl == gl
            checks[f"{lab} (1, 1) decode takes no collective"] = (
                take_census(mesh) == {})
            out["one_card"][f"decode {arch}"] = {"launches": gl}
            del got
        print("decode-mesh (1, 1) at full width: " + ", ".join(
            f"{k} {v}" for k, v in checks.items()))
    finally:
        mesh.close()
    free(torch)
    out["kernel_checks"] = dm_kernel_checks(torch, torch.device(dev))
    out["s"]["one card"] = time.perf_counter() - t_phase
    if not worlds:
        print("decode-mesh: fewer than four cards, so the (d, m) part of "
              "phase 28 did not run")
    # the unsharded runs every world is held to (the bf16 teacher runs
    # are the one-card check's)
    want = {}
    arch_runs = {(kind, arch, depth) for runs in worlds.values()
                 for kind, arch, depth in runs}
    for kind, arch, depth in sorted(arch_runs, key=str):
        cfg = dm_config(arch, depth)
        bf = unsharded[arch]
        free(torch)
        f32 = dm_teacher(torch, cfg, None, dev, f32=True)["tf"][0].cpu()
        w = {"logits": bf, "noise": _rms(bf - f32), "scale": _rms(bf),
             "gap_noise": _gap_noise(bf, f32)}
        del f32
        if kind == "serve":
            w["serve"] = dm_serve(torch, ssm_tp_config(arch, depth),
                                  SERVE_REQUESTS[arch], None, dev,
                                  gaps=True)
        want[arch] = w
    out["s"]["unsharded references"] = time.perf_counter() - t_phase
    # one spawn of four ranks runs every world
    plan = list(worlds.items())
    ranks = []
    if plan:
        free(torch)
        ranks = spawn_ranks(4, dm_rank_runs, (plan, SERVE_REQUESTS), "cuda",
                            shape=plan[0][0], timeout=900)
    out["s"]["worlds"] = time.perf_counter() - t_phase
    for (d, m), runs in plan:
        lab = f"({d}, {m})"
        world = {"n": d * m, "s": ranks[0][lab]["s"], "runs": {}}
        for kind, arch, depth in runs:
            w = want[arch]
            per = [r[lab][arch] for r in ranks]
            r0 = per[0]
            name = f"{lab} {arch.split('-')[0]}"
            tol = 3 * w["noise"]
            err = _rms(r0["tf"]["logits"] - w["logits"])
            bad = _rms(r0["planted"]["logits"] - w["logits"])
            checks[f"{name} decode held to unsharded"] = err <= tol
            checks[f"{name} refuses the decode without its reduce"] = (
                bad > tol)
            checks[f"{name} decode alike on every rank"] = all(
                len({r[p]["digest"] for r in per}) == 1
                for p in ("tf", "planted"))
            rec = {"rms_err": err, "rms_planted": bad, "rms_bf16_noise":
                   w["noise"], "rms_gap_noise": w["gap_noise"],
                   "rms_logits": w["scale"], "launches": r0["tf"]["launches"]}
            line = (f"decode-mesh {name}: teacher forcing rms {err:.4e} "
                    f"(tol 3 x {w['noise']:.4e} = {tol:.4e}, logits rms "
                    f"{w['scale']:.4e}); without its reduce {bad:.4e}; "
                    f"launches {r0['tf']['launches']}")
            if kind == "serve":
                s, u = r0["serve"], w["serve"]
                cfg = ssm_tp_config(arch, depth)
                checks[f"{name} serving alike on every rank"] = len(
                    {r["serve"]["digest"] for r in per}) == 1
                checks[f"{name} serving launches on every rank"] = all(
                    r["serve"]["launches"] == r["serve"]["expected_launches"]
                    and r["serve"]["schedule_ok"] for r in per) and (
                    cfg.moe is None or s["launches"]["topk_gating"] > 0)
                checks[f"{name} serving all done"] = (
                    s["done"] == SERVE_REQUESTS[arch]
                    and s["stats"]["traces"] == {"prefill": 1, "admit": 1,
                                                 "decode": 1})
                # where each stream first parts, and the unsharded top-2
                # gap the unsharded run itself chose that token by
                parted = [(i, next(j for j, (x, y) in enumerate(zip(a, b))
                                   if x != y))
                          for i, (a, b) in enumerate(zip(s["tokens"],
                                                         u["tokens"]))
                          if a != b]
                gaps = [(i, j, u["gaps"][(i, j)]) for i, j in parted]
                ks = {"bound": DM_PART_K * w["gap_noise"],
                      "3 x gap noise": 3 * w["gap_noise"],
                      "3 x logit noise": tol}
                within = {k: sum(g <= v for *_, g in gaps)
                          for k, v in ks.items()}
                checks[f"{name} streams part only within the yardstick"] = (
                    within["bound"] == len(gaps))
                rec.update(gaps=gaps, gap_bounds=ks, gaps_within=within)
                rec["serve"] = {k: s[k] for k in (
                    "tick_ms", "tokens_per_s", "ttft_p50_s", "peak_bytes",
                    "wall_s", "ticks", "decode_calls", "prefill_chunks",
                    "launches")}
                rec["peak_bytes_max"] = max(r["serve"]["peak_bytes"]
                                            for r in per)
                rec["census"] = s["census"]
                rec["unsharded"] = {k: u[k] for k in (
                    "tick_ms", "tokens_per_s", "ttft_p50_s", "peak_bytes",
                    "wall_s")}
                per_tick = {k: {"calls": v["calls"] / s["ticks"],
                                "bytes": v["bytes"] / s["ticks"]}
                            for k, v in s["census"].items()}
                rec["census_per_tick"] = per_tick
                first = min(gaps, key=lambda g: (g[1], g[0]), default=None)
                line += (f"; served {len(s['tokens'])} requests: "
                         f"{s['tick_ms']:.3f} ms a tick ({u['tick_ms']:.3f} "
                         f"on one card), {s['tokens_per_s']:.1f} tokens/s "
                         f"({u['tokens_per_s']:.1f}), TTFT p50 "
                         f"{s['ttft_p50_s']:.4f}s ({u['ttft_p50_s']:.4f}), "
                         f"peak {rec['peak_bytes_max'] / 1e9:.2f} GB a card "
                         f"({u['peak_bytes'] / 1e9:.2f}); {len(gaps)} "
                         f"streams part from unsharded, first at (request, "
                         f"step, unsharded top-2 gap) {first}, the widest "
                         f"gap {max((g for *_, g in gaps), default=0):.4e}; "
                         f"within " + ", ".join(
                             f"{k} {v:.4e}: {within[k]}"
                             for k, v in ks.items())
                         + "; census a tick "
                         + ", ".join(f"{k} {v['calls']:.2f}x "
                                     f"{v['bytes']:.0f}B"
                                     for k, v in sorted(per_tick.items())))
            world["runs"][arch] = rec
            print(line)
        out["worlds"][lab] = world
    bad = [k for k, v in checks.items() if not v]
    out["checks"] = checks
    print("decode-mesh: seconds " + json.dumps(
        {k: round(v, 1) for k, v in out["s"].items()}))
    if bad:
        raise AssertionError(f"decode-mesh: {bad}")
    return out


def run_decode_mesh_phase(out_path):
    """The entry of ``--decode-mesh-phase``: phase 28 alone, its report
    written to ``out_path``."""
    import torch
    from repro_torch.kernels import _build
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(f"decode-mesh: {smi}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    _build.build_all()
    t0 = time.perf_counter()
    res = decode_mesh_phase(torch)
    res["s"] = time.perf_counter() - t0
    res["nvidia_smi"] = smi
    print(f"decode-mesh: phase 28 took {res['s']:.1f}s")
    with open(out_path, "w") as f:
        json.dump(res, f, indent=1, default=str)
    return 0


# phase 29: the Engine's pipelined rounds, health guard and recovery,
# checkpoints and scenarios on a mesh, and the pipelined transformer
# steps on one, in a process of its own
# (``python3 chip_smoke.py --engine-paths-mesh-phase OUT``)
PATHS_ROUNDS = 6
PATHS_TIMED_ROUNDS = 10
PATHS_WORLDS = ((2, 2), (4, 1))
PATHS_ROOT = os.path.join(ROOT, "build", "chip_smoke_paths")


def paths_cases(root, rounds=None):
    """Phase 29's runs of the Engine at its defaults (femnist width 16,
    cut 2, 100 clients, cohort 5, batch 16), ``rounds`` rounds, in the
    order they run: name -> (ExperimentConfig, launches a round at a
    capacity of ``cap`` slots, as ``engine_mesh_variants`` counts them).
    The guard runs phase 19's fault rates (NaN and dispatch errors at
    0.3) with torn checkpoints at 0.5, NaN quarantined and a dispatch
    error rolled back (escalated to a retry while the snapshot ring is
    empty), at cut 2 and at cut 3 with ``fused_gather_loss``, and on the
    async pipelined run at cut 3 fused (a recovered round extracts its
    ring again; on a mesh its extract, on the side stream, gathers the
    client's ``lin`` blocks over ``data`` and its columns over
    ``model``); the checkpointed runs are cyclepsl (a per-client store) under phase 20's
    diurnal churn with a dropout of 0.15, checkpointed at half time and
    resumed from there by a fresh Engine.  Checkpoints go under
    ``root``."""
    from repro_torch.api import ExperimentConfig
    from repro_torch.core.cyclesl import CycleConfig
    from repro_torch.resilience import FaultConfig, ResilienceConfig
    from repro_torch.scenario import ScenarioConfig
    rounds = rounds or PATHS_ROUNDS
    half = rounds // 2
    guard = ResilienceConfig(
        guard=True, on_nonfinite="quarantine", on_error="rollback",
        faults=FaultConfig(nan_rate=0.3, error_rate=0.3, ckpt_rate=0.5))
    churn = dict(algo="cyclepsl", eval_every=half, scenario=ScenarioConfig(
        kind="diurnal-churn", dropout=0.15))
    part = os.path.join(root, "part")
    kw = {"sync2": dict(pipeline_depth=2),
          "async1 cut3 fused": dict(
              pipeline_depth=1, pipeline_staleness="async",
              staleness_weighting="inverse", resilience=guard, cut=3,
              cycle=CycleConfig(fused_gather_loss=True)),
          "guard": dict(resilience=guard, eval_every=2,
                        ckpt_dir=os.path.join(root, "guard")),
          "guard cut3 fused": dict(resilience=guard, cut=3,
                                   cycle=CycleConfig(fused_gather_loss=True)),
          "ckpt": dict(churn, ckpt_dir=os.path.join(root, "ckpt")),
          "partial": dict(churn, rounds=half, ckpt_dir=part),
          "resume": dict(churn, resume=True, ckpt_dir=part)}

    def cut2(cap):
        return {"feature_resample": 2 * cap, "fused_adam": 2 * cap + 4,
                "gather_loss": 0}

    def cut3(cap):
        return {"feature_resample": 0, "fused_adam": cap + 5,
                "gather_loss": cap}
    return {name: (ExperimentConfig(**{"rounds": rounds,
                                       "eval_every": rounds, **k}),
                   cut3 if "cut3" in name else cut2)
            for name, k in kw.items()}


@contextlib.contextmanager
def drawn_cohorts(out: list):
    """Inside, every Engine appends each sampled round's cohort ids and
    attendance mask to ``out``."""
    from repro_torch.api import Engine
    real = Engine.sample_round

    def sample(self, rng):
        got = real(self, rng)
        out.append((got[0].tolist(),
                    None if got[3] is None else got[3].tolist()))
        return got
    Engine.sample_round = sample
    try:
        yield out
    finally:
        Engine.sample_round = real


def paths_run(torch, cfg, dev):
    """``run_engine`` with each round's cohort and mask (the sampler's
    capacity of them), the host group's census, the padded capacity and
    the host-side outcomes that must agree with the unsharded run's
    exactly (``host``)."""
    drawn = []
    with drawn_cohorts(drawn):
        run = run_engine(torch, cfg, dev)
    eng, res = run["engine"], run["res"]
    run["host_census"] = ({} if eng.host is None
                          else eng.host.take_census())
    run["capacity"] = eng.padded_capacity
    # a mesh pads the cohort past the sampler's capacity with dead slots
    cap = eng.cohort_capacity
    drawn = [(ids[:cap], mask if mask is None else mask[:cap])
             for ids, mask in drawn]
    run["host"] = {"drawn": drawn, "history": strip_elapsed(res["history"]),
                   **{k: res.get(k) for k in ("telemetry", "resilience",
                                              "pipeline",
                                              "resumed_from_round")}}
    return run


def paths_expected(cfg, res, per_round, cap) -> dict:
    """Launches of a run of ``cfg``: ``per_round(cap)`` for each round it
    ran, a resumed run from its resume round, a round the guard rejected
    once more for each NaN verdict (a dispatch fault raises before the
    round runs)."""
    ran = cfg.rounds - res.get("resumed_from_round", 0)
    ran += (res.get("resilience") or {}).get("faults", {}).get(
        "nonfinite", 0)
    return {k: n * ran for k, n in per_round(cap).items()}


def paths_guard_control(torch, mesh, cfg):
    """The guard's check at a round's end on this rank's part of a state
    whose ``model`` block of the server's first split leaf holds a NaN
    on the world's last rank alone (its slots' features finite): the
    health vector as the port agrees it, and with the flag left unsummed
    over ``model`` (the planted control)."""
    from repro_torch.api import Engine
    from repro_torch.api.phases import guard_axes, slot_split
    from repro_torch.resilience import guards
    from repro_torch.utils.tree import tree_leaves, tree_unflatten_like
    eng = Engine(cfg, device=mesh.device, log=lambda *a: None)
    state = eng.init_state()
    plan = tree_leaves(eng.algo.task.plans["server"])
    i = next(j for j, s in enumerate(plan) if s.dim is not None)
    leaves = [t.clone() for t in tree_leaves(state.server.params)]
    dist = torch.distributed
    if dist.get_rank() == dist.get_world_size() - 1:
        leaves[i].view(-1)[0] = float("nan")
    bad = state._replace(server=state.server._replace(
        params=tree_unflatten_like(state.server.params, leaves)))
    split = slot_split(eng.algo.mesh, eng.padded_capacity)
    feats = torch.zeros(split.hi - split.lo, 2, 3, device=mesh.device)
    axes = guard_axes(eng.mesh, eng.algo.mesh, eng.algo.task)
    loss = torch.ones((), device=mesh.device)
    out = {}
    for name, used in (("agreed", axes), ("unreduced over model", tuple(
            a for a in axes if a.axis != "model"))):
        h, _ = guards.health_vector(bad, loss, feats, None, None, None,
                                    0.1, 4.0, split, used)
        out[name] = h.tolist()
    return out


def pipelined_olmoe(torch, mesh):
    """olmoe-1b-7b at depth ``OLMOE_DEPTH`` (cut 2, bf16, random init) on
    ``mesh``: one round of ``build_train_step(mesh=)`` and one of
    ``build_pipelined_train_steps(mesh=)`` (extract, then tail) from the
    same init and batch (cohort 2, batch 2 a client, sequence 2048), the
    launch counters reset before each: whether they are bit for bit the
    same (state and metrics), and each one's launches against
    ``split_round``'s count of one round."""
    from repro_torch.configs import InputShape, get_config
    from repro_torch.core.cyclesl import CycleConfig
    from repro_torch.launch.mesh import cohort_size
    from repro_torch.launch.steps import (build_pipelined_train_steps,
                                          build_train_step)
    from repro_torch.utils.tree import tree_leaves
    cfg = get_config("olmoe-1b-7b").with_(n_layers=OLMOE_DEPTH)
    C, b = COHORT, BATCH
    shape = InputShape("paths olmoe", SEQ, C * b, "train")
    cycle = CycleConfig(server_epochs=1, server_batch=b)
    whole = build_train_step(cfg, shape, cycle, cohort=C, device="cuda",
                             mesh=mesh)
    ext, tail = build_pipelined_train_steps(cfg, shape, cycle, cohort=C,
                                            device="cuda", mesh=mesh)
    server, clients = whole.init_state(0)
    xs, ys = whole.make_batch(0)
    c_local, steps = C // cohort_size(mesh), C
    expect = round_launches(cfg, c_local, steps)
    expect.update(feature_resample=2 * steps, gather_loss=0,
                  fused_adam=len(tree_leaves(server.params)) * steps
                  + len(tree_leaves(clients.params)))
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    s1, c1, m1 = whole.fn(server, clients, xs, ys, 0)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    l1 = read_counters()
    reset_counters()
    feats, store = ext.fn(clients, xs, ys)
    s2, c2, m2 = tail.fn(server, clients, xs, ys, 0, feats, store)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    l2 = read_counters()
    m1 = {k: float(v) for k, v in m1.items()}
    m2 = {k: float(v) for k, v in m2.items()}
    same = (state_diff(torch, (s1, c1), (s2, c2)) == 0.0 and m1 == m2)
    got = [{k: ls[k] for k in expect} for ls in (l1, l2)]
    del server, clients, s1, c1, s2, c2, feats, store
    torch.cuda.empty_cache()
    return {"same": same, "launches": got, "expected": expect,
            "metrics": m2, "round_s": t1 - t0, "pipelined_s": t2 - t1,
            "launches_ok": all(g == expect for g in got)}


def engine_paths_world_runs(mesh, shapes, timed_rounds):
    """Phase 29 on the spawned ranks, one card each: for each mesh shape
    of ``shapes`` (over this world) every run of :func:`paths_cases`
    (metrics, launches, census, host outcomes, digests; on rank 0 the
    state), each again at ``MESH_CHECK_ROUNDS`` rounds (``short``:
    metrics, the last evaluation, on rank 0 the state), and
    ``timed_rounds`` timed rounds of the async pipelined run without
    the guard (which syncs the host every round), the mesh and the
    unsharded Engine on this rank's card in turns; then the guard's
    planted control and the pipelined olmoe steps on the spawned (2, 2)
    mesh.  Only rank 0 prints."""
    import torch
    from repro_torch.resilience import ResilienceConfig
    from repro_torch.utils.tree import tree_map
    lead = torch.distributed.get_rank() == 0
    if not lead:
        sys.stdout = open(os.devnull, "w")
    out = {}
    for shape in shapes:
        rec = out[str(tuple(shape))] = {}
        root = os.path.join(PATHS_ROOT, "x".join(map(str, shape)))
        for name, (cfg, _) in paths_cases(root).items():
            run = paths_run(torch, dataclasses.replace(
                cfg, mesh_shape=tuple(shape)), mesh.device)
            rec[name] = {k: run[k] for k in ("rows", "launches", "census",
                                             "host", "host_census",
                                             "capacity")}
            rec[name]["last"] = run["res"]["history"][-1]
            rec[name]["digest"] = _digest(torch, run["state"], [])
            if lead:
                rec[name]["state"] = tree_map(lambda t: t.cpu(),
                                              run["state"])
            del run
        rec["short"] = {}
        for name, (cfg, _) in paths_cases(os.path.join(root, "short"),
                                          MESH_CHECK_ROUNDS).items():
            run = run_engine(torch, dataclasses.replace(
                cfg, mesh_shape=tuple(shape)), mesh.device)
            rec["short"][name] = {"rows": run["rows"],
                                  "last": run["res"]["history"][-1]}
            if lead:
                rec["short"][name]["state"] = tree_map(lambda t: t.cpu(),
                                                       run["state"])
            del run
        timed = dataclasses.replace(
            paths_cases(root, timed_rounds)["async1 cut3 fused"][0],
            collect_timing=True, resilience=ResilienceConfig())
        rps = {}
        for label in ("mesh", "unsharded", "unsharded", "mesh"):
            cfg = (dataclasses.replace(timed, mesh_shape=tuple(shape))
                   if label == "mesh" else timed)
            t = run_engine(torch, cfg, mesh.device)["res"]["round_time_s"]
            rps.setdefault(label, []).append(1.0 / t)
        rec["rounds/s"] = rps
    guard = paths_cases(os.path.join(PATHS_ROOT, "control"))["guard"][0]
    out["control"] = paths_guard_control(torch, mesh, dataclasses.replace(
        guard, mesh_shape=tuple(mesh.shape.values()), ckpt_dir=None))
    torch.cuda.empty_cache()
    out["olmoe"] = pipelined_olmoe(torch, mesh)
    return out


def paths_kernel_checks(torch, dev):
    """The kernels of the pipelined olmoe steps on (2, 2) at a rank's
    shapes against their plain versions: ``flash_attention`` on the
    rank's 8 of 16 heads ([2, 2048, 8, 128] bf16 causal, the
    tensor-core design), ``topk_gating`` on the router's [4096, 64] k 8
    (whole on every rank), ``fused_adam`` on the rank's expert block of a
    server layer ([32, 1024, 1024] bf16: 32 of 64 experts over
    ``model``, half the rows over ``data``; float32 moments), and
    ``feature_resample`` on the rank's pool slice (its one slot's two
    [2048, 2048] bf16 rows, the server batch 2)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import design, flash_attention
    from repro_torch.kernels.topk_gating import topk_gating
    import torch.nn.functional as F
    gen = torch.Generator(device=dev).manual_seed(29)
    cfg = get_config("olmoe-1b-7b")
    rows = []
    B, S, H, D = BATCH, SEQ, cfg.n_heads // 2, cfg.hd
    q, k, v = (torch.randn(B, S, H, D, device=dev, generator=gen
                           ).to(torch.bfloat16) for _ in range(3))
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    row = check("flash_attention", f"[{B}, {S}, {H}, {D}] bf16 causal "
                f"design={design(q.dtype, D)} (a rank's heads on (2, 2))",
                lambda: (flash_attention(q, k, v, causal=True),),
                lambda: (ref.flash_attention_ref(q, k, v, causal=True),),
                2e-2, kernel_cost("flash_attention", q, k, v),
                library=lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True))
    row["design"] = design(q.dtype, D)
    rows.append(row)
    del q, k, v, qt, kt, vt
    mo = cfg.moe
    x = torch.randn(BATCH * SEQ, mo.n_experts, device=dev, generator=gen)
    got, want = topk_gating(x, mo.top_k), ref.topk_gating_ref(x, mo.top_k)
    if not torch.equal(got[1], want[1]):
        raise AssertionError("topk_gating: ids differ from the plain version")
    rows.append(check(
        "topk_gating", f"[{BATCH * SEQ}, {mo.n_experts}] k={mo.top_k} (the "
        "router, whole on every rank)",
        lambda: (topk_gating(x, mo.top_k)[0],),
        lambda: (ref.topk_gating_ref(x, mo.top_k)[0],), 1e-6,
        kernel_cost("topk_gating", x, mo.top_k)))
    shape = (mo.n_experts // 2, cfg.d_model // 2, mo.d_ff_expert)
    p = torch.randn(shape, device=dev, generator=gen).to(torch.bfloat16)
    g = torch.randn(shape, device=dev, generator=gen).to(torch.bfloat16)
    mm = torch.randn(shape, device=dev, generator=gen) * 0.1
    vv = torch.rand(shape, device=dev, generator=gen) * 0.1
    step = torch.tensor(3, dtype=torch.int32, device=dev)
    rows.append(check(
        "fused_adam", f"{list(shape)} bf16 (a rank's expert block on (2, 2))",
        lambda: ops.fused_adam(p, g, mm, vv, step, lr=1e-3),
        lambda: ref.fused_adam_ref(p, g, mm, vv, step, lr=1e-3),
        1e-6, kernel_cost("fused_adam", p, g, mm, vv, step), ulps=1))
    del p, g, mm, vv
    src = torch.randn(BATCH, SEQ, cfg.d_model, device=dev,
                      generator=gen).bfloat16()
    idx = torch.tensor([1, 0], dtype=torch.int32, device=dev)
    flat = src.reshape(src.shape[0], -1)
    rows.append(check(
        "feature_resample", f"{list(src.shape)} bf16 idx[2] (a rank's pool "
        "slice on (2, 2))",
        lambda: (ops.resample_rows(src, idx),),
        lambda: (ref.feature_resample_ref(flat, idx).reshape(src.shape),),
        0.0, kernel_cost("feature_resample", flat, idx),
        library=lambda: torch.index_select(src, 0, idx)))
    torch.cuda.empty_cache()
    return rows


def engine_paths_phase(torch, dev="cuda"):
    """Phase 29: the Engine's pipelined rounds, health guard and
    recovery, checkpoints and scenarios on a mesh (:func:`paths_cases`).
    One card: each run unsharded and on a (1, 1) mesh, bit for bit the
    same (state, metrics, history, telemetry, recovery summary, pipeline
    stats, resume round, every round's cohort and mask), with equal
    launches, each as counted from the schedule (:func:`paths_expected`),
    and no collective of its own: every census key is one the plain
    (1, 1) round of its program takes (a world of one's calls), none on
    the host group; then the kernels of the pipelined olmoe steps at a
    rank's shapes on (2, 2) (:func:`paths_kernel_checks`).  Four cards:
    every run on (2, 2) and (4, 1) in one spawned world, its host
    outcomes equal to the unsharded run's on every rank, its launches as
    counted at the mesh's capacity on every rank, every rank the same
    bits, and each run again over ``MESH_CHECK_ROUNDS`` rounds held to
    the unsharded run by phase 26's criteria (``compare_runs``: at
    femnist's widths the ranks' other summation order flips Adam's
    near-sign steps, which compound over more rounds, as phase 26
    found); the resume bit for bit the unbroken run on the same mesh, the
    host group's census a checkpoint one flag (and the resume's step),
    the guard's agreement census as counted; rounds/s of the async
    pipelined run beside unsharded in turns; the planted control (the
    guard's flag left unsummed over ``model``) refused; olmoe-1b-7b at
    depth 4 through ``build_pipelined_train_steps(mesh=)`` on (2, 2) bit
    for bit ``build_train_step(mesh=)``, launches as counted.  Raises on
    any miss."""
    import shutil
    from repro_torch.api import ExperimentConfig
    from repro_torch.core.cyclesl import CycleConfig
    from repro_torch.launch.meshcheck import spawn_ranks
    from repro_torch.utils.tree import tree_map
    checks, out = {}, {"one_card": {}, "worlds": {}}
    shutil.rmtree(PATHS_ROOT, ignore_errors=True)
    t0 = time.perf_counter()
    print(f"engine paths: on {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} card(s)")
    plain = {}
    for prog, kw in (("cut2", {}), ("cyclepsl", dict(algo="cyclepsl")),
                     ("cut3", dict(cut=3, cycle=CycleConfig(
                         fused_gather_loss=True)))):
        r = run_engine(torch, ExperimentConfig(
            rounds=2, eval_every=2, mesh_shape=(1, 1), **kw), dev)
        plain[prog] = set().union(*r["census"])
    cases = paths_cases(os.path.join(PATHS_ROOT, "unsharded"))
    ones = paths_cases(os.path.join(PATHS_ROOT, "one"))
    base = {}
    for name, (cfg, per_round) in cases.items():
        b = base[name] = paths_run(torch, cfg, dev)
        one = paths_run(torch, dataclasses.replace(ones[name][0],
                                                   mesh_shape=(1, 1)), dev)
        prog = ("cut3" if "cut3" in name else
                "cyclepsl" if cfg.algo == "cyclepsl" else "cut2")
        want = paths_expected(cfg, b["res"], per_round, b["capacity"])
        got = {k: one["launches"][k] for k in want}
        keys = set().union(*one["census"])
        checks[f"(1, 1) {name} == unsharded"] = (
            _same(torch, one, b) and one["host"] == b["host"])
        checks[f"(1, 1) {name} launches"] = (
            one["launches"] == b["launches"] and got == want)
        checks[f"(1, 1) {name} adds no collective"] = (
            keys <= plain[prog] and not one["host_census"])
        out["one_card"][name] = {"launches": got, "expected": want,
                                 "census": one["census"][-1],
                                 "resilience": b["res"].get("resilience")}
        res = b["res"].get("resilience") or {}
        print(f"engine paths (1, 1) {name}: bit for bit the unsharded "
              f"Engine {checks[f'(1, 1) {name} == unsharded']}; launches "
              f"{got} (expected {want}); census keys {sorted(keys)}"
              + (f"; faults {res['faults']}, quarantined "
                 f"{res['quarantined_clients']}, rollbacks "
                 f"{res['rollbacks']}, retries {res['retries']}, torn "
                 f"checkpoints {res['ckpt_corruptions']}" if res else ""))
    out["kernel_checks"] = paths_kernel_checks(torch, torch.device(dev))
    out["one_card_s"] = time.perf_counter() - t0
    print(f"engine paths: the one-card part took {out['one_card_s']:.1f}s")
    if torch.cuda.device_count() < 4:
        print("engine paths: fewer than four cards, so the meshes of phase "
              "29 did not run")
    else:
        t1 = time.perf_counter()
        short = {name: run_engine(torch, cfg, dev) for name, (cfg, _) in
                 paths_cases(os.path.join(PATHS_ROOT, "unsharded short"),
                             MESH_CHECK_ROUNDS).items()}
        torch.cuda.empty_cache()
        ranks = spawn_ranks(4, engine_paths_world_runs,
                            (PATHS_WORLDS, PATHS_TIMED_ROUNDS), dev,
                            shape=(2, 2), timeout=900)
        r0 = ranks[0]
        half = PATHS_ROUNDS // 2
        for shape in PATHS_WORLDS:
            key = str(tuple(shape))
            lab = f"({shape[0]}, {shape[1]})"
            rec = out["worlds"][key] = {"rounds/s": r0[key]["rounds/s"]}
            for name, (cfg, per_round) in cases.items():
                got, b = r0[key][name], base[name]
                cap = got["capacity"]
                s, sb = r0[key]["short"][name], short[name]
                try:
                    compare_runs(torch, f"{lab} {name} against unsharded "
                                 f"({MESH_CHECK_ROUNDS} rounds)", {
                                     "cpu": (sb["rows"], tree_map(
                                         lambda t: t.cpu(), sb["state"]),
                                         sb["res"]["history"][-1],
                                         sb["engine"]),
                                     "cuda": (s["rows"], s["state"],
                                              s["last"], None)},
                                 what="paths")
                    held = True
                except AssertionError:
                    held = False
                checks[f"{lab} {name} held to unsharded"] = held
                want_host = dict(b["host"], history=None)
                checks[f"{lab} {name} host outcomes == unsharded on "
                       "every rank"] = all(
                    dict(r[key][name]["host"], history=None) == want_host
                    for r in ranks)
                checks[f"{lab} {name} launches"] = all(
                    {k: r[key][name]["launches"][k] for k in per_round(cap)}
                    == paths_expected(cfg, b["res"], per_round, cap)
                    for r in ranks)
                checks[f"{lab} {name} every rank the same"] = all(
                    r[key][name]["digest"] == got["digest"]
                    and r[key][name]["rows"] == got["rows"] for r in ranks)
                rec[name] = {"capacity": cap, "census": got["census"][1],
                             "launches": got["launches"],
                             "host_census": got["host_census"]}
                print(f"engine paths {lab} {name}: capacity {cap}; census a "
                      f"round {_census_line(got['census'][1])}; host "
                      f"{_census_line(got['host_census']) or 'none'}")
            for r in ranks:
                a, u = r[key]["resume"], r[key]["ckpt"]
                checks[f"{lab} resume == the unbroken run there"] = (
                    checks.get(f"{lab} resume == the unbroken run there",
                               True) and a["digest"] == u["digest"]
                    and a["rows"] == u["rows"][half:])
                checks[f"{lab} host group's census"] = (
                    checks.get(f"{lab} host group's census", True)
                    and r[key]["partial"]["host_census"] == {
                        "host/all_reduce/ckpt": {"calls": 1, "bytes": 4}}
                    and a["host_census"] == {
                        "host/broadcast/ckpt_step": {"calls": 1, "bytes": 8},
                        "host/all_reduce/ckpt": {"calls": 1, "bytes": 4}})
            g = r0[key]["guard"]
            faults = base["guard"]["res"]["resilience"]["faults"]
            ran = PATHS_ROUNDS + faults["nonfinite"]
            c_local = g["capacity"] // shape[0]
            want = {"all_gather/health": {"calls": ran, "bytes":
                                          ran * (c_local + 1) * 4}}
            if shape[1] > 1:
                want["model/all_reduce/health"] = {"calls": ran,
                                                   "bytes": ran * 4}
            for r in ranks:
                tot = {}
                for c in r[key]["guard"]["census"]:
                    for k, v in c.items():
                        if "health" in k:
                            t = tot.setdefault(k, {"calls": 0, "bytes": 0})
                            t["calls"] += v["calls"]
                            t["bytes"] += v["bytes"]
                checks[f"{lab} guard census == counted"] = (
                    checks.get(f"{lab} guard census == counted", True)
                    and tot == want)
            print(f"engine paths {lab} async1 cut3 fused (no guard): rank "
                  "0's rounds/s in turns "
                  + ", ".join(f"{k} {v}" for k, v in
                              r0[key]["rounds/s"].items()))
        agreed = [r["control"]["agreed"] for r in ranks]
        parted = [r["control"]["unreduced over model"] for r in ranks]
        checks["control: agreed guard reads non-finite on every rank"] = (
            all(h == agreed[0] for h in agreed) and agreed[0][0] == 1.0)
        checks["control: flag unsummed over model refused"] = not all(
            h == parted[0] for h in parted)
        ol = [r["olmoe"] for r in ranks]
        checks["olmoe (2, 2) pipelined == train step"] = all(
            o["same"] for o in ol)
        checks["olmoe (2, 2) launches"] = all(o["launches_ok"] for o in ol)
        out["worlds"]["olmoe (2, 2)"] = ol[0]
        print(f"engine paths olmoe-1b-7b depth {OLMOE_DEPTH} on (2, 2): "
              f"pipelined bit for bit the train step on every rank "
              f"{checks['olmoe (2, 2) pipelined == train step']}; launches "
              f"{ol[0]['launches']} (expected {ol[0]['expected']}); round "
              f"{ol[0]['round_s']:.3f}s, pipelined {ol[0]['pipelined_s']:.3f}s "
              f"(first calls); control {agreed[0]} agreed, "
              f"{[h[0] for h in parted]} unsummed over model")
        out["worlds_s"] = time.perf_counter() - t1
        print(f"engine paths: the four-card part took {out['worlds_s']:.1f}s")
    shutil.rmtree(PATHS_ROOT, ignore_errors=True)
    bad = [k for k, v in checks.items() if not v]
    print(f"engine paths checks: {len(checks) - len(bad)} of {len(checks)} "
          "held" + (f"; failed {bad}" if bad else ""))
    out["checks"] = checks
    if bad:
        raise AssertionError(f"engine paths: {bad}")
    return out


def run_engine_paths_phase(out_path):
    """The entry of ``--engine-paths-mesh-phase``: phase 29 alone, its
    report written to ``out_path``."""
    import torch
    from repro_torch.kernels import _build
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(f"engine paths: {smi}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    _build.build_all()
    t0 = time.perf_counter()
    res = engine_paths_phase(torch)
    res["s"] = time.perf_counter() - t0
    res["nvidia_smi"] = smi
    print(f"engine paths: phase 29 took {res['s']:.1f}s")
    with open(out_path, "w") as f:
        json.dump(res, f, indent=1, default=str)
    return 0


def kernel_profile(torch, run, dev="cuda"):
    """``run()`` under the profiler: device launches (kernels and copies),
    device busy ms, wall ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _sync(torch, dev)
        t0 = time.perf_counter()
        run()
        _sync(torch, dev)
        wall = (time.perf_counter() - t0) * 1e3
    dev_rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
    return (sum(e.count for e in dev_rows),
            sum(e.self_device_time_total for e in dev_rows) / 1e3, wall)


def fault_path_profiles(torch, dev="cuda"):
    """The profiled part of phases 19-20, run last (a profiler session
    slows later launches of its process): the guard's device launches a
    round, ``health_vector`` on a main path round's state, loss,
    features and feature gradients, with its eager ms taken before any
    profile; and one warm population round (no churn): its launches and
    the card's busy share.  Also checks that the guard's whole-tree
    max-abs pass sees a NaN and an Inf on the card."""
    from repro_torch.api import ExperimentConfig
    from repro_torch.resilience import health_vector, tree_all_finite
    from repro_torch.scenario.population import PopulationSpec, run_population
    from repro_torch.utils.tree import tree_leaves
    from repro_torch.api import Engine
    eng = Engine(ExperimentConfig(rounds=1, eval_every=1, cut=2, **MAIN),
                 device=dev, log=lambda msg: None)
    state = eng.init_state()
    feats = torch.randn(5, 16, 7, 7, 64, device=dev)
    fgrads = torch.randn_like(feats)
    mask = torch.ones(5, device=dev)
    loss, ema = torch.tensor(2.0, device=dev), torch.tensor(1.5, device=dev)
    call = lambda: health_vector(state, loss, feats, fgrads, mask, ema,
                                 0.1, 4.0)
    call()
    _sync(torch, dev)
    bad_nan = [torch.ones(3, device=dev), torch.tensor([1.0, float("nan")],
                                                       device=dev)]
    bad_inf = [torch.tensor([float("inf")], device=dev)]
    if bool(tree_all_finite(bad_nan)) or bool(tree_all_finite(bad_inf)) \
            or not bool(tree_all_finite(state)):
        raise AssertionError("guard: the max-abs pass missed a NaN or Inf")
    eager = eager_ms(call)
    launches, busy, _ = kernel_profile(torch, call, dev)
    print(f"guard: health_vector takes {launches} device launches a round "
          f"(the state's {len(tree_leaves(state))} leaves in one max-abs "
          f"pass) and {eager:.4f} ms eager a call, {busy:.4f} ms of device "
          "time")
    spec = PopulationSpec(n_clients=POPULATION["n_clients"])
    kw = dict(cohort=POPULATION["cohort"], rounds=1, batch=POPULATION["batch"],
              width=POPULATION["width"], device=dev)
    run = lambda: run_population(spec, population_scenarios()["no_churn"][0],
                                 **kw)
    run()
    n, busy_p, wall = kernel_profile(torch, run, dev)
    print(f"profile population round (no churn, 1 round + eval, warm): "
          f"{n} device launches, device busy {busy_p:.3f} ms of "
          f"{wall:.3f} ms wall ({busy_p / wall:.1%})")
    return {"guard": {"launches": launches, "eager_ms": eager,
                      "device_ms": busy},
            "population_round": {"launches": n, "device_busy_ms": busy_p,
                                 "wall_ms": wall}}


# ------------------------------------------------------------- phase 30
TOOLING_ROUNDS = 4


def profiled_runs(torch, cfg, dev="cuda"):
    """``Engine.run()`` of ``cfg`` on ``dev`` without a profiler and with
    one, and with one on the CPU: each run's per-round metrics (read
    after the run, so no callback syncs), result, wall seconds and
    Engine."""
    from repro_torch.api import Engine
    from repro_torch.utils.profiling import RoundProfiler
    runs = {}
    for where, d, prof in (("plain", dev, None),
                           ("profiled", dev, RoundProfiler()),
                           ("cpu", "cpu", RoundProfiler())):
        rows = []

        class Rec:
            def on_round(self, engine, rnd, state, metrics):
                rows.append({k: v.clone() for k, v in metrics.items()})

        eng = Engine(cfg, device=d, profiler=prof, callbacks=[Rec()],
                     log=lambda msg: None)
        _sync(torch, d)
        t0 = time.perf_counter()
        res = eng.run()
        _sync(torch, d)
        wall = time.perf_counter() - t0
        rows = [{k: v.cpu() for k, v in r.items()} for r in rows]
        runs[where] = (rows, res, wall, eng)
    return runs


def profiler_check(torch, label, cfg, dev="cuda"):
    """Phase 30a for one config: the profiled run bit for bit the
    unprofiled one, its sections and call counts those of a profiled
    CPU run, the sections' total within the run's wall time, and
    ``phase_costs`` keyed by the program's phases."""
    from repro_torch.api.registry import get_program
    from repro_torch.utils.profiling import phase_costs, phase_names
    runs = profiled_runs(torch, cfg, dev)
    (plain, res0, _, _), (prof, res1, wall, eng) = runs["plain"], \
        runs["profiled"]
    same = (len(plain) == len(prof) and all(
        a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
        for a, b in zip(plain, prof))
        and strip_elapsed(res0["history"]) == strip_elapsed(res1["history"]))
    profile, cpu = res1["profile"], runs["cpu"][1]["profile"]
    calls = {k: v["calls"] for k, v in profile.items()}
    want = {k: v["calls"] for k, v in cpu.items()}
    total = sum(v["total_s"] for v in profile.values())
    costs = phase_costs(eng)
    names = phase_names(get_program(cfg.algo))
    print(f"profiler {label}: metrics of {len(prof)} rounds bit for bit the "
          f"unprofiled run's: {same}; sections "
          + ", ".join(f"{k} {v['calls']}x {v['mean_ms']:.3f}ms"
                      for k, v in profile.items())
          + f" (CPU calls {want}); sections {total:.4f}s of {wall:.4f}s wall")
    print(f"profiler {label}: phase_costs "
          + ", ".join(f"{k} {v['cum_ms']:.3f}/{v['delta_ms']:+.3f}ms"
                      for k, v in costs.items()))
    if not same:
        raise AssertionError(f"profiler {label}: the profiled run's metrics "
                             "differ from the unprofiled run's")
    if calls != want:
        raise AssertionError(f"profiler {label}: sections {calls}, the CPU "
                             f"run's {want}")
    if total > wall:
        raise AssertionError(f"profiler {label}: sections {total}s exceed "
                             f"the wall {wall}s")
    if list(costs) != names:
        raise AssertionError(f"profiler {label}: phase_costs keys "
                             f"{list(costs)}, the program's {names}")
    return {"profile": profile, "cpu_calls": want, "wall_s": wall,
            "phase_costs": costs, "bit_for_bit": same}


def _cost_diff(a, b) -> dict:
    """The rows of two ``StepCost.summary()``'s by_op and by_kernel that
    differ."""
    out = {}
    for part in ("by_op", "by_kernel"):
        for k in sorted(set(a[part]) | set(b[part])):
            if a[part].get(k) != b[part].get(k):
                out[f"{part}/{k}"] = (a[part].get(k), b[part].get(k))
    return out


def counted_round(torch, label, cfg, rounds=3):
    """Phase 30b for one transformer round (phase 7's protocol): the dry
    run's record of the step on ``meta`` against the card: state bytes
    exactly, the peak estimate within 25% of the card's peak, ``count``
    on the card equal to ``count`` on meta in FLOPs, bytes and kernel
    calls, the measured round at 0.95 or more of the roofline's time,
    and the round's MFU."""
    import gc
    from repro_torch.configs import InputShape
    from repro_torch.core.cyclesl import CycleConfig
    from repro_torch.launch import roofline
    from repro_torch.launch.dryrun import dry_run, state_bytes
    from repro_torch.launch.steps import build_train_step
    from repro_torch.utils.cost import count
    shape = InputShape(label, SEQ, COHORT * BATCH, "train")
    cycle = CycleConfig(server_epochs=1, server_batch=BATCH)
    t0 = time.perf_counter()
    # the card runs bundle.fn, which keeps its arguments: so does the
    # dry run it is held to (phase 32 holds the donated step)
    rec = dry_run(cfg, shape, None, cohort=COHORT, cycle=cycle,
                  donate=False)
    meta_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    bundle = build_train_step(cfg, shape, cycle, cohort=COHORT, device="cuda")
    server, clients = bundle.init_state(0)
    card_state = state_bytes((server, clients), "train")
    batches = [bundle.make_batch(r) for r in range(rounds + 1)]
    server, clients, _ = bundle.fn(server, clients, *batches[0], 0)  # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for r in range(1, rounds + 1):
        t0 = time.perf_counter()
        server, clients, m = bundle.fn(server, clients, *batches[r], r)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() - base
    metrics = {k: float(v) for k, v in m.items()}
    card = count(bundle.fn, server, clients, *batches[0], 0)
    torch.cuda.synchronize()
    del server, clients, batches, bundle
    gc.collect()
    torch.cuda.empty_cache()
    card = card.summary()
    meta = rec["cost"]
    round_s = sorted(times)[len(times) // 2]
    terms = roofline.terms(meta)
    roof = max(terms.values())
    mf = roofline.model_flops(cfg, shape)
    mfu = roofline.mfu(mf, round_s)
    peak_err = (rec["peak_bytes"] - peak) / peak
    same = (card["flops"] == meta["flops"]
            and card["traffic_bytes"] == meta["traffic_bytes"]
            and {k: v["calls"] for k, v in card["by_kernel"].items()}
            == {k: v["calls"] for k, v in meta["by_kernel"].items()})
    print(f"{label}: dry run on meta {meta_s:.2f}s: state "
          f"{rec['state_bytes']:,} B (card {card_state:,}), peak estimate "
          f"{rec['peak_bytes'] / 1e9:.3f} GB against the card's "
          f"{peak / 1e9:.3f} GB ({peak_err:+.2%}); count on meta and on the "
          f"card equal: {same} (flops {meta['flops']:.6e}, bytes "
          f"{meta['traffic_bytes']:.6e}, kernels "
          f"{ {k: v['calls'] for k, v in meta['by_kernel'].items()} })")
    print(f"{label}: rounds {[round(t, 4) for t in times]} s, median "
          f"{round_s:.4f} s; roofline "
          + ", ".join(f"{k} {v * 1e3:.2f} ms" for k, v in terms.items())
          + f" -> {roof * 1e3:.2f} ms ({max(terms, key=terms.get)}); "
          f"measured/roofline {round_s / roof:.3f}; model_flops {mf:.4e}, "
          f"mfu {mfu:.4f} (bf16 peak); metrics {metrics}")
    if not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"{label}: non-finite metrics {metrics}")
    if rec["state_bytes"] != card_state:
        raise AssertionError(f"{label}: the dry run's state "
                             f"{rec['state_bytes']} B, the card's "
                             f"{card_state} B")
    if abs(peak_err) > 0.25:
        raise AssertionError(f"{label}: peak estimate off by {peak_err:.2%}")
    if not same:
        raise AssertionError(f"{label}: count on the card differs from "
                             f"count on meta: {_cost_diff(card, meta)}")
    if round_s / roof < 0.95:
        raise AssertionError(f"{label}: the card beat the roofline "
                             f"({round_s} s against {roof} s): the count "
                             "is wrong")
    return {"state_bytes": card_state, "peak_estimate": rec["peak_bytes"],
            "peak_bytes": peak, "peak_err": peak_err, "meta_s": meta_s,
            "round_s": times, "roofline_terms_s": terms, "roofline_s": roof,
            "measured_over_roofline": round_s / roof, "model_flops": mf,
            "mfu": mfu, "cost": {k: meta[k] for k in (
                "flops", "traffic_bytes", "flops_by_dtype", "by_kernel")}}


def tooling(torch, dev="cuda"):
    """Phase 30: the profiler on the main path (cut 2, and cut 3 fused),
    the olmoe and zamba2 rounds against their dry runs and the
    roofline."""
    from repro_torch.api import ExperimentConfig
    from repro_torch.configs import get_config
    r = TOOLING_ROUNDS
    out = {"profiler": {}, "rounds": {}}
    for cut in (2, 3):
        cfg = ExperimentConfig(rounds=r, eval_every=r, cut=cut,
                               collect_timing=True, sync_every=2, **MAIN
                               ).with_cycle(fused_gather_loss=cut == 3)
        out["profiler"][f"cut{cut}"] = profiler_check(torch, f"cut{cut}",
                                                      cfg, dev)
    out["rounds"]["olmoe-1b-7b"] = counted_round(
        torch, "olmoe counted round",
        get_config("olmoe-1b-7b").with_(n_layers=OLMOE_DEPTH))
    out["rounds"]["zamba2-1.2b"] = counted_round(
        torch, "zamba2 counted round", get_config("zamba2-1.2b"))
    return out


# phase 31: the attention split over kv head groups (glm4-9b's 2 kv heads
# on a model axis of 4), in a process of its own
# (``python3 chip_smoke.py --kv-groups-phase OUT``)
KV_ARCH, KV_DEPTH = "glm4-9b", 4
KV_PARAMS = os.path.join(ROOT, "build", "chip_smoke_kv_unsharded.pt")
KV_SERVE_REQUESTS = 8          # one wave of SERVE's 8 slots
KV_PEAK_RTOL = 0.05            # a card's peak against the dry run's


def kv_census(cfg, m):
    """The kv groups' census of one train round of ``build_train_step``
    on a (1, m) mesh (every rank all ``COHORT`` slots), written down
    from the shapes before any run: a
    weight-gradient pass of a block sums its ``wk`` and ``wv`` gradients
    (float32 [d, hd] each, the group's one kv head) over the group in
    one call: the server blocks in each server step, the client blocks
    in each slot's VJP; the feature gradients' pass holds the server
    frozen and sums nothing.  Empty where the attention does not split
    over kv head groups."""
    from repro_torch.sharding.parallel import kv_replicas, sharded_units
    if not (sharded_units(cfg, {"model": m})["attn"]
            and kv_replicas(cfg, m) > 1):
        return {}
    steps = COHORT * BATCH // BATCH
    calls = (steps * (cfg.n_layers - cfg.cut_layers)
             + COHORT * cfg.cut_layers)
    return {"kv/all_reduce/kv_grad": {
        "calls": calls, "bytes": calls * 2 * cfg.d_model * cfg.hd * 4}}


@contextlib.contextmanager
def dropped_group_sum():
    """The control of phase 31's depth-4 check: the kv group's gradient
    sum dropped, so each rank steps its copy of the group's kv head by
    its own query heads' part of the gradient.  The forward is
    untouched; the check must refuse the run.  (The function inherits
    its backward from ``_CopyToModel``: the plant shadows it on the
    subclass alone.)"""
    from repro_torch.sharding import parallel
    cls = parallel._KVGroupSum
    if "backward" in vars(cls):
        raise RuntimeError("_KVGroupSum has a backward of its own")
    cls.backward = staticmethod(lambda ctx, *gs: (None, None) + gs)
    try:
        yield
    finally:
        del cls.backward


def kv_group_digest(torch, mesh, cfg, server, clients) -> str:
    """sha256 of the leaves the plan gives to a kv group (``Shard.rep`` >
    1: the group's ``wk`` and ``wv``), the server's and the client
    slots': every rank of a group must hold the same bits, and a
    gradient not summed over the group leaves them apart."""
    import hashlib
    from repro_torch.models.module import SHAPES
    from repro_torch.sharding.specs import Shard, shard_plan
    from repro_torch.utils.tree import tree_leaves, tree_map
    task = step_task(cfg)
    sp = shard_plan(task.init_server(SHAPES), mesh.shape, mesh.coords,
                    "server", cfg)
    cp = tree_map(Shard.stacked, shard_plan(task.init_client(SHAPES),
                                            mesh.shape, mesh.coords, "full",
                                            cfg))
    h = hashlib.sha256()
    for tree, plan in ((server.params, sp), (clients.params, cp)):
        for x, s in zip(tree_leaves(tree), tree_leaves(plan)):
            if s.rep > 1:
                h.update(x.detach().contiguous().reshape(-1)
                         .view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def kv_rank_runs(mesh, rounds, want_rows):
    """Phase 31 on (1, 4), one card a rank: (1) glm4-9b at depth 4, bf16,
    ``rounds`` rounds gathered whole and held to this phase's one-card
    run (rank 0 reads its weights from ``KV_PARAMS``;
    :func:`tp_against_unsharded`), with each rank's digest of its kv
    group's leaves and of its whole-over-the-axis leaves, then again
    under :func:`dropped_group_sum`; (2) glm4-9b whole, ``rounds`` timed
    rounds with exact launches, each round's census and the card's
    peak above what it held before; (3) teacher forcing (with its
    control) and a serving wave of glm4-9b whole (:func:`dm_teacher`,
    :func:`dm_serve`).  Only rank 0 prints; every rank returns its own
    numbers."""
    import hashlib
    import torch
    from repro_torch.configs import get_config
    rank = torch.distributed.get_rank()
    if rank != 0:
        sys.stdout = open(os.devnull, "w")
    t0 = time.perf_counter()
    full = get_config(KV_ARCH)
    cfg4 = full.with_(n_layers=KV_DEPTH)
    out = {"s": {}}

    def depth4(label, fault):
        with dropped_group_sum() if fault else contextlib.nullcontext():
            run = split_round(torch, f"kv (1, 4) depth {KV_DEPTH}" + label,
                              cfg4, rounds, mesh=mesh, keep_state=True)
        server, clients = run.pop("state")
        run["group_digest"] = kv_group_digest(torch, mesh, cfg4, server,
                                              clients)
        run["replicated"] = replicated_digests(torch, mesh, cfg4, server,
                                               clients)
        params = whole_step_state(mesh, cfg4, server, clients)
        del server, clients
        held = (tp_against_unsharded(torch, params, run["metrics"],
                                     want_rows, 2 * rounds, path=KV_PARAMS)
                if rank == 0 else None)
        del params
        free(torch)
        return run, held

    out["depth4"], out["against_unsharded"] = depth4("", False)
    out["planted"], out["planted_against_unsharded"] = depth4(
        " (the group sum dropped)", True)
    out["s"]["depth 4"] = time.perf_counter() - t0
    free(torch)
    base = torch.cuda.memory_allocated()
    out["whole"] = split_round(torch, "kv (1, 4) whole", full, rounds,
                               mesh=mesh)
    out["whole"]["base_bytes"] = base
    out["s"]["whole"] = time.perf_counter() - t0
    free(torch)
    tf = {}
    for part, (logits, launches) in dm_teacher(torch, dm_config(KV_ARCH,
                                                                None),
                                               mesh, planted=True).items():
        lg = logits.cpu()
        tf[part] = {"digest": hashlib.sha256(lg.numpy().tobytes()
                                             ).hexdigest(),
                    "launches": launches}
        if rank == 0:
            tf[part]["logits"] = lg
    out["tf"] = tf
    free(torch)
    run = dm_serve(torch, full, KV_SERVE_REQUESTS, mesh)
    run["digest"] = _stream_digest(run)
    out["serve"] = run
    out["s"]["world"] = time.perf_counter() - t0
    print(f"kv (1, 4) serving {KV_ARCH}: {run['tick_ms']:.3f} ms a tick, "
          f"{run['tokens_per_s']:.1f} tokens/s, TTFT p50 "
          f"{run['ttft_p50_s']:.4f}s, peak {run['peak_bytes'] / 1e9:.2f} "
          f"GB; launches {run['launches']}")
    return out


def kv_dry_run(torch, cfg, m, d=1, donate=False):
    """The dry run's record of ``cfg``'s train step at phase 25's protocol
    (cohort 2, batch 2 a client, sequence 2048, server batch 2) as rank 0
    of a (d, m) mesh on ``meta``, over torch's fake process group, which
    it ends after; ``donate`` runs the step as its bundle donates."""
    from repro_torch.configs import InputShape
    from repro_torch.core.cyclesl import CycleConfig
    from repro_torch.launch.dryrun import dry_run
    shape = InputShape("kv dry run", SEQ, COHORT * BATCH, "train")
    cycle = CycleConfig(server_epochs=1, server_batch=BATCH)
    try:
        return dry_run(cfg, shape, (d, m), cohort=COHORT, cycle=cycle,
                       donate=donate)
    finally:
        torch.distributed.destroy_process_group()


def kv_groups_phase(torch, rounds=ROUNDS, dev="cuda"):
    """Phase 31: the attention split over kv head groups, glm4-9b (32
    query heads, 2 kv heads of 128) on a model axis of 4: a rank runs 8
    query heads against its group's one kv head, held alike by the 2
    ranks of the group, which sum its weights' gradients.  One card: a
    (1, 1) mesh through the same code at depth 4 (bf16, cohort 2, batch
    2, sequence 2048), bit for bit the unsharded run with its launches
    and no collective.  With four cards: the dry run of glm4-9b whole on
    (1, 4) on ``meta``; one spawn of four ranks on (1, 4)
    (:func:`kv_rank_runs`); then the unsharded references (teacher
    forcing in bf16 and float32 and a served wave of
    ``KV_SERVE_REQUESTS``, phase 28's criteria), and the ranks' runs held
    to them: depth 4 to the unsharded run by
    phase 25's criteria and each group's copies bit-equal, the run
    without the group sum refused; glm4-9b whole with every census as
    predicted, exact launches, and a card's peak under 80 GB and within
    ``KV_PEAK_RTOL`` of the dry run's estimate; the teacher-forced and
    served decode by phase 28's criteria.  Raises on any miss."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.utils.tree import tree_leaves, tree_map
    t_phase = time.perf_counter()
    out, checks = {"s": {}}, {}
    cards = torch.cuda.device_count()
    full = get_config(KV_ARCH)
    cfg4 = full.with_(n_layers=KV_DEPTH)
    mesh = make_local_mesh(dev)
    try:
        runs = {}
        for label, mm in (("unsharded", None), ("mesh (1, 1)", mesh)):
            free(torch)
            r = split_round(torch, f"kv {label} depth {KV_DEPTH}", cfg4,
                            rounds, mesh=mm, keep_state=True)
            state = r.pop("state")
            if mm is None:
                want = tree_map(lambda t: t.cpu(), state)
                if cards >= 4:
                    os.makedirs(os.path.dirname(KV_PARAMS), exist_ok=True)
                    torch.save((want[0].params, want[1].params), KV_PARAMS)
            else:
                checks["(1, 1) depth 4 == unsharded"] = all(
                    torch.equal(x, y.cpu()) for x, y in zip(
                        tree_leaves(want), tree_leaves(state))) and (
                    runs["unsharded"]["metrics"] == r["metrics"])
                del want
            del state
            runs[label] = r
        checks["(1, 1) depth 4 launches == unsharded"] = (
            runs["unsharded"]["launches"] == runs["mesh (1, 1)"]["launches"])
        checks["(1, 1) depth 4 takes no collective"] = all(
            c == {} for c in runs["mesh (1, 1)"]["census"])
        print("kv (1, 1) at full width (depth 4): " + ", ".join(
            f"{k} {v}" for k, v in checks.items()))
        out["one_card"] = runs
    finally:
        mesh.close()
    free(torch)
    out["s"]["one card"] = time.perf_counter() - t_phase
    if cards < 4:
        print("kv: fewer than four cards, so the (1, 4) part of phase 31 "
              "did not run")
    else:
        kv_world(torch, out, checks, runs["unsharded"]["metrics"], full,
                 rounds, dev)
    out["s"]["phase"] = time.perf_counter() - t_phase
    bad = [k for k, v in checks.items() if not v]
    out["checks"] = checks
    print("kv: seconds " + json.dumps({k: round(v, 1)
                                       for k, v in out["s"].items()}))
    if bad:
        raise AssertionError(f"kv: {bad}")
    return out


def kv_world(torch, out, checks, want_rows, full, rounds, dev):
    """The (1, 4) part of :func:`kv_groups_phase`, into ``out`` and
    ``checks``."""
    from repro_torch.launch.meshcheck import spawn_ranks
    t0 = time.perf_counter()
    dry = kv_dry_run(torch, full, 4)
    print(f"kv dry run of {KV_ARCH} whole on (1, 4): state "
          f"{dry['state_bytes'] / 1e9:.2f} GB, peak "
          f"{dry['peak_bytes'] / 1e9:.2f} GB, fits {dry['fits']}; census "
          f"{_census_line(dry['census'])}")
    out["dry_run"] = {k: dry[k] for k in ("state_bytes", "peak_bytes",
                                          "fits", "census")}
    out["s"]["dry run"] = time.perf_counter() - t0
    # the whole model's peak is ~68 of the card's 79 GiB: the ranks'
    # allocator maps memory in expandable segments, so that blocks freed
    # across the round do not strand GiBs in fragments (a run with the
    # default allocator held 10 GiB reserved but unallocated at the peak
    # and ran out); rank 0 shares its card with this process
    free(torch)
    env = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        ranks = spawn_ranks(4, kv_rank_runs, (rounds, want_rows), "cuda",
                            shape=(1, 4), timeout=600)
    finally:
        if env is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = env
    out["s"]["world"] = time.perf_counter() - t0
    # the unsharded references, on this process's card once the ranks
    # are gone
    cfg = dm_config(KV_ARCH, None)
    free(torch)
    bf = dm_teacher(torch, cfg, None, dev)["tf"][0].cpu()
    free(torch)
    f32 = dm_teacher(torch, cfg, None, dev, f32=True)["tf"][0].cpu()
    noise, gap_noise = _rms(bf - f32), _gap_noise(bf, f32)
    del f32
    free(torch)
    u = dm_serve(torch, full, KV_SERVE_REQUESTS, None, dev, gaps=True)
    out["s"]["unsharded references"] = time.perf_counter() - t0
    r0 = ranks[0]
    rep = 2
    for part, label in (("depth4", "sound"), ("planted", "planted")):
        d = [r[part]["group_digest"] for r in ranks]
        same = all(d[i] == d[i - i % rep] for i in range(4))
        out[f"{label}_groups_alike"] = same
        out[f"{label}_replicated_alike"] = all(
            r[part]["replicated"] == r0[part]["replicated"] for r in ranks)
    held = r0["against_unsharded"]
    checks["(1, 4) depth 4 against unsharded"] = held["ok"]
    checks["(1, 4) depth 4 kv group copies bit-equal"] = \
        out["sound_groups_alike"]
    checks["(1, 4) depth 4 whole-over-the-axis leaves alike"] = \
        out["sound_replicated_alike"]
    checks["(1, 4) depth 4 check refuses the dropped group sum"] = not (
        r0["planted_against_unsharded"]["ok"]
        and out["planted_groups_alike"])
    want4 = {**step_census(full.with_(n_layers=KV_DEPTH), 1, 4),
             **kv_census(full.with_(n_layers=KV_DEPTH), 4)}
    want = {**step_census(full, 1, 4), **kv_census(full, 4)}
    checks["(1, 4) depth 4 census == predicted"] = all(
        c == want4 for r in ranks for c in r["depth4"]["census"])
    checks["(1, 4) whole census == predicted"] = all(
        c == want for r in ranks for c in r["whole"]["census"])
    for part in ("depth4", "whole"):
        checks[f"(1, 4) {part} same metrics and launches on every rank"] = \
            all(r[part]["metrics"] == r0[part]["metrics"]
                and r[part]["launches"] == r0[part]["launches"]
                for r in ranks)
    peak = max(r["whole"]["peak_bytes"] - r["whole"]["base_bytes"]
               for r in ranks)
    step_peak = max(r["whole"]["step_peak_bytes"] - r["whole"]["base_bytes"]
                    for r in ranks)
    peak_err = (step_peak - dry["peak_bytes"]) / dry["peak_bytes"]
    checks["(1, 4) whole fits a card"] = peak < 80e9
    checks["(1, 4) whole peak within 5% of the dry run's"] = \
        abs(peak_err) <= KV_PEAK_RTOL
    w = r0["whole"]
    print(f"kv (1, 4) {KV_ARCH} whole: {w['rounds_per_s']:.3f} rounds/s, "
          f"{w['tokens_per_s']:.1f} tokens/s, peak {peak / 1e9:.2f} GB a "
          f"card (max over ranks, above {w['base_bytes'] / 1e9:.2f} GB held "
          f"before), its rounds' {step_peak / 1e9:.2f} GB (the dry run's "
          f"{dry['peak_bytes'] / 1e9:.2f} GB, {peak_err:+.2%}), entity "
          f"states {w['state_bytes'] / 1e9:.2f} GB a card; census a round {_census_line(w['census'][0])} "
          f"(predicted {_census_line(want)}); depth 4 against unsharded "
          f"{held}; with the group sum dropped "
          f"{r0['planted_against_unsharded']}, kv group copies alike "
          f"{out['planted_groups_alike']}")
    tol = 3 * noise
    err = _rms(r0["tf"]["tf"]["logits"] - bf)
    bad = _rms(r0["tf"]["planted"]["logits"] - bf)
    checks["(1, 4) decode held to unsharded"] = err <= tol
    checks["(1, 4) refuses the decode without its reduce"] = bad > tol
    checks["(1, 4) decode alike on every rank"] = all(
        len({r["tf"][p]["digest"] for r in ranks}) == 1
        for p in ("tf", "planted"))
    s = r0["serve"]
    checks["(1, 4) serving alike on every rank"] = len(
        {r["serve"]["digest"] for r in ranks}) == 1
    checks["(1, 4) serving launches on every rank"] = all(
        r["serve"]["launches"] == r["serve"]["expected_launches"]
        and r["serve"]["schedule_ok"] for r in ranks)
    checks["(1, 4) serving all done"] = (
        s["done"] == KV_SERVE_REQUESTS
        and s["stats"]["traces"] == {"prefill": 1, "admit": 1, "decode": 1})
    parted = [(i, next(j for j, (x, y) in enumerate(zip(a, b)) if x != y))
              for i, (a, b) in enumerate(zip(s["tokens"], u["tokens"]))
              if a != b]
    gaps = [(i, j, u["gaps"][(i, j)]) for i, j in parted]
    bound = DM_PART_K * gap_noise
    checks["(1, 4) streams part only within the yardstick"] = all(
        g <= bound for *_, g in gaps)
    per_tick = {k: {"calls": v["calls"] / s["ticks"],
                    "bytes": v["bytes"] / s["ticks"]}
                for k, v in s["census"].items()}
    print(f"kv (1, 4) decode: teacher forcing rms {err:.4e} (tol 3 x "
          f"{noise:.4e} = {tol:.4e}, logits rms {_rms(bf):.4e}); without "
          f"its reduce {bad:.4e}; served {len(s['tokens'])} requests: "
          f"{s['tick_ms']:.3f} ms a tick ({u['tick_ms']:.3f} on one card), "
          f"{s['tokens_per_s']:.1f} tokens/s ({u['tokens_per_s']:.1f}), "
          f"peak {max(r['serve']['peak_bytes'] for r in ranks) / 1e9:.2f} "
          f"GB a card ({u['peak_bytes'] / 1e9:.2f}); {len(gaps)} streams "
          f"part from unsharded (bound {bound:.4e}: {gaps}); census a tick "
          + ", ".join(f"{k} {v['calls']:.2f}x {v['bytes']:.0f}B"
                      for k, v in sorted(per_tick.items())))
    out["world"] = {
        "rank0": {k: r0[k] for k in ("depth4", "against_unsharded",
                                     "planted", "planted_against_unsharded",
                                     "whole", "s")},
        "peak_bytes_max": peak, "step_peak_bytes_max": step_peak,
        "peak_err": peak_err, "census_predicted": want, "census_predicted_depth4": want4,
        "decode": {"rms_err": err, "rms_planted": bad,
                   "rms_bf16_noise": noise, "rms_gap_noise": gap_noise,
                   "launches": r0["tf"]["tf"]["launches"]},
        "serve": {k: s[k] for k in ("tick_ms", "tokens_per_s", "ttft_p50_s",
                                    "peak_bytes", "wall_s", "ticks",
                                    "decode_calls", "prefill_chunks",
                                    "launches", "census")},
        "serve_per_tick_census": per_tick, "gaps": gaps,
        "serve_unsharded": {k: u[k] for k in ("tick_ms", "tokens_per_s",
                                              "ttft_p50_s", "peak_bytes",
                                              "wall_s")}}


def run_kv_groups_phase(out_path):
    """The entry of ``--kv-groups-phase``: phase 31 alone, its report
    written to ``out_path``."""
    import torch
    from repro_torch.kernels import _build
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(f"kv: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    _build.build_all()
    t0 = time.perf_counter()
    res = kv_groups_phase(torch)
    res["s"]["total"] = time.perf_counter() - t0
    res["nvidia_smi"] = smi
    print(f"kv: phase 31 took {res['s']['total']:.1f}s")
    with open(out_path, "w") as f:
        json.dump(res, f, indent=1, default=str)
    return 0


# ------------------------------------------------ phase 32: donated state
DONATE_ARCH = "glm4-9b"
DONATE_DEPTH = 4
DONATE_PARAMS = os.path.join(ROOT, "build", "chip_smoke_donate_unsharded.pt")
DONATE_PEAK_RTOL = 0.05        # a card's peak against the donated dry run's
# the undonated peaks a card that PERF.md records: olmoe-1b-7b whole on
# (1, 4) and (2, 2) as the cards read them, glm4-9b whole on (1, 4) as
# the dry run reads it
UNDONATED_PEAKS = {("olmoe-1b-7b", (1, 4)): 52.70e9,
                   ("olmoe-1b-7b", (2, 2)): 58.42e9,
                   ("glm4-9b", (1, 4)): 72.85e9}
# the donated whole runs' peaks a card before remat, as four H100s read
# them (PERF.md)
DONATED_PEAKS = {("glm4-9b", (2, 2)): 66.76e9, ("glm4-9b", (1, 4)): 50.42e9}
DONATE_WORLD = ((2, 2), (1, 4))
DONATE_WHOLE = ("glm4-9b", "olmoe-1b-7b")


def adam_path_cases(torch):
    """The main path's fused_adam leaves that phases 32a and 33 hold both
    entries at: (label, shape, step counts, dtype)."""
    from repro_torch.configs import get_config
    olmoe = get_config("olmoe-1b-7b")
    mo = olmoe.moe
    f32, bf16 = torch.float32, torch.bfloat16
    return (
        ("femnist server dense", (3136, 2048), 3, f32),
        ("femnist client stack", (5, 5, 5, 32, 64), [0, 1, 2, 3, 4], f32),
        ("femnist server replicas", (5, 3136, 2048), [4, 4, 4, 9, 0], f32),
        ("olmoe client embedding", (COHORT, olmoe.vocab_padded,
                                    olmoe.d_model), [0, 3], bf16),
        ("olmoe server experts, a rank of (1, 4)",
         (olmoe.n_layers - olmoe.cut_layers, mo.n_experts // 4,
          olmoe.d_model, mo.d_ff_expert), 3, bf16))


def donate_kernel_checks(torch, dev):
    """Phase 32a: ``fused_adam_`` (the in-place entry) at the femnist
    server's dense leaf, the femnist client stack and server replicas,
    olmoe's stacked client embedding and the olmoe server experts a rank
    of (1, 4) holds: bit-equal to the out-of-place kernel on the same
    inputs; with ``keep`` turning one slot off (for a single entity, the
    entity) that slot's p, m and v bit-equal to their inputs and the
    others to the out-of-place result; against ``ref.fused_adam_ref_`` on
    the card to ``fused_adam``'s tolerance (phase 3's ``check``), and the
    device ms of both entries in this one call.  Returns the femnist
    server row (the kernels line's) and every shape's numbers."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev).manual_seed(32)
    kw = dict(lr=1e-3)
    out, checks, row = [], {}, None
    for label, shape, steps, dtype in adam_path_cases(torch):
        q = lib = None
        p0 = torch.randn(shape, device=dev, generator=gen).to(dtype)
        g = torch.randn(shape, device=dev, generator=gen).to(dtype)
        m0 = torch.randn(shape, device=dev, generator=gen) * 0.1
        v0 = torch.rand(shape, device=dev, generator=gen) * 0.1
        step = torch.tensor(steps, dtype=torch.int32, device=dev)
        fresh = lambda: (p0.clone(), m0.clone(), v0.clone())
        want = ops.fused_adam(p0, g, m0, v0, step, **kw)
        p, m, v = fresh()
        got = ops.fused_adam_(p, g, m, v, step, **kw)
        same = (got[0] is p and got[1] is m and got[2] is v
                and all(torch.equal(a, b) for a, b in zip(got, want)))
        # one slot off: the middle row of a stack, a lone entity whole
        keep = torch.ones(step.shape, dtype=torch.int32, device=dev)
        off = step.numel() // 2
        keep.view(-1)[off] = 0
        p, m, v = fresh()
        ops.fused_adam_(p, g, m, v, step, keep=keep, **kw)
        if step.dim():
            on = torch.arange(step.numel(), device=dev) != off
            kept = all(torch.equal(a[off], b[off]) for a, b in
                       zip((p, m, v), (p0, m0, v0)))
            stepped = all(torch.equal(a[on], b[on]) for a, b in
                          zip((p, m, v), want))
        else:
            kept = all(torch.equal(a, b) for a, b in
                       zip((p, m, v), (p0, m0, v0)))
            p, m, v = fresh()
            ops.fused_adam_(p, g, m, v, step, keep=torch.ones_like(keep),
                            **kw)
            stepped = all(torch.equal(a, b) for a, b in
                          zip((p, m, v), want))
        del want, p, m, v
        checks[f"{label}: in place == out of place"] = same
        checks[f"{label}: a slot off kept, the others stepped"] = (
            kept and stepped)
        copy_ms = device_ms(lambda: ops.fused_adam(p0, g, m0, v0, step,
                                                   **kw))
        pk, mk, vk = fresh()
        pp, mp, vp = fresh()
        if label == "femnist server dense":
            q = p0.clone().requires_grad_(True)
            q.grad = g.clone()
            lib = torch.optim.Adam([q], lr=1e-3, fused=True,
                                   capturable=True).step
        r = check("fused_adam_inplace",
                  f"{list(shape)} {str(dtype)[6:]} step{list(step.shape)}",
                  lambda: ops.fused_adam_(pk, g, mk, vk, step, **kw),
                  lambda: ref.fused_adam_ref_(pp, g, mp, vp, step, **kw),
                  1e-6, kernel_cost("fused_adam", p0, g, m0, v0, step),
                  library=lib, ulps=1)
        r = {**r, "label": label, "copy_ms": copy_ms}
        print(f"donate kernel {label} {list(shape)} {str(dtype)[6:]}: in "
              f"place {r['ms']:.4f} ms, out of place {copy_ms:.4f} ms "
              f"(device ms, one call); bit-equal {same}; a slot off kept "
              f"{kept}, the others stepped {stepped}")
        out.append(r)
        if row is None:
            row = r
        del p0, g, m0, v0, pk, mk, vk, pp, mp, vp, q, lib
        free(torch)
    return row, out, checks


# label: (config fields, cycle fields); under async pipelining the state
# is not donated (the server steps out of place, its copies in place)
DONATE_PAIRS = {
    "cut2": ({"cut": 2}, {}),
    "cut3 fused": ({"cut": 3}, {"fused_gather_loss": True}),
    "cyclepsl padded": ({"cut": 2, "algo": "cyclepsl",
                         "variable_attendance": True}, {}),
    "sync1": ({"cut": 2, "pipeline_depth": 1}, {}),
    "async1": ({"cut": 2, "pipeline_depth": 1,
                "pipeline_staleness": "async"}, {}),
}


def _form_launches(run) -> dict:
    """A run's launches without fused_adam's split by entry."""
    return {k: v for k, v in run["launches"].items()
            if not k.startswith("fused_adam/")}


def donate_engine(torch, rounds, dev="cuda"):
    """Phase 32b: the Engine at its defaults (donated on the card)
    against ``donate=False`` on the main path's config (cut 2, cut 3
    with ``fused_gather_loss``, cyclepsl under variable attendance with
    padded slots, pipelined sync and async at depth 1), ``rounds``
    rounds each: every metric and the final state bit-equal, the
    launches equal with every fused_adam launch in place (under async
    pipelining those of the round's copies alone), and ``torch.cuda.max_memory_allocated`` above what the
    card held before, donated no more than undonated; then a guarded run
    at the defaults: donation off (no in-place launch), its state the
    undonated cut-2 run's."""
    from repro_torch.api import ExperimentConfig
    from repro_torch.resilience import ResilienceConfig
    out, checks = {}, {}

    def one(label, cfg, donate):
        free(torch)
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        r = run_engine(torch, cfg, dev, donate=donate)
        r["peak_bytes"] = torch.cuda.max_memory_allocated() - base
        r["donate"] = r.pop("engine").donate
        r.pop("res")
        return r

    for label, (kw, cyc) in DONATE_PAIRS.items():
        cfg = ExperimentConfig(rounds=rounds, eval_every=rounds,
                               **{**MAIN, **kw}).with_cycle(**cyc)
        d, u = one(label, cfg, None), one(label, cfg, False)
        fa = d["launches"]["fused_adam"]
        inplace = d["launches"]["fused_adam/inplace"]
        state = kw.get("pipeline_staleness") != "async"
        checks[f"{label}: donated by default, bit-equal to donate=False"] = (
            d["donate"] is True and u["donate"] is False and _same(torch, d, u))
        checks[f"{label}: launches equal, "
               + ("every fused_adam in place" if state
                  else "the copies' fused_adam in place")] = (
            _form_launches(d) == _form_launches(u) and fa > 0
            and (inplace == fa if state else 0 < inplace < fa)
            and d["launches"]["fused_adam/copy"] == fa - inplace
            and u["launches"]["fused_adam/copy"] == fa
            and u["launches"]["fused_adam/inplace"] == 0)
        checks[f"{label}: donated peak <= undonated"] = (
            d["peak_bytes"] <= u["peak_bytes"])
        print(f"donate {label}: {rounds} rounds bit-equal "
              f"{_same(torch, d, u)}; peak {d['peak_bytes'] / 1e6:.2f} MB "
              f"donated, {u['peak_bytes'] / 1e6:.2f} MB undonated; launches "
              f"{d['launches']} / {u['launches']}; wall {d['wall_s']:.3f}s "
              f"/ {u['wall_s']:.3f}s")
        out[label] = {k: {f: r[f] for f in ("rows", "launches", "peak_bytes",
                                            "wall_s", "donate")}
                      for k, r in (("donated", d), ("undonated", u))}
        if label == "cut2":
            want = u
    cfg = ExperimentConfig(rounds=rounds, eval_every=rounds, cut=2,
                           resilience=ResilienceConfig(guard=True), **MAIN)
    g = one("guarded", cfg, None)
    checks["guarded: donation off, no in-place launch"] = (
        g["donate"] is False and g["launches"]["fused_adam/inplace"] == 0
        and g["launches"]["fused_adam/copy"] > 0)
    checks["guarded: state bit-equal to the undonated run"] = state_diff(
        torch, g["state"], want["state"]) == 0.0
    print(f"donate guarded: donate {g['donate']}, launches {g['launches']}, "
          f"state diff to undonated cut2 "
          f"{state_diff(torch, g['state'], want['state'])}")
    out["guarded"] = {f: g[f] for f in ("launches", "peak_bytes", "donate")}
    return out, checks


def donate_rank_runs(mesh, rounds, want_rows):
    """Phase 32c in spawned ranks, one card each, on the spawn's (2, 2)
    mesh: glm4-9b at depth 4 undonated and donated, each rank's digest
    of its state and metrics, the donated run gathered whole and held to
    this phase's one-card run (rank 0 reads its weights from
    ``DONATE_PARAMS``; :func:`tp_against_unsharded`); then for each mesh
    of ``DONATE_WORLD`` (built over the same ranks) each arch of
    ``DONATE_WHOLE`` whole, donated, ``rounds`` timed rounds with exact
    launches and the card's peak above what it held before.  Only rank 0
    prints; every rank returns its own numbers."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_engine_mesh
    rank = torch.distributed.get_rank()
    if rank != 0:
        sys.stdout = open(os.devnull, "w")
    t0 = time.perf_counter()
    cfg4 = get_config(DONATE_ARCH).with_(n_layers=DONATE_DEPTH)
    out = {"s": {}}
    for label, donate in (("undonated", False), ("donated", True)):
        free(torch)
        run = split_round(torch, f"donate (2, 2) depth {DONATE_DEPTH} "
                          f"{label}", cfg4, rounds, mesh=mesh,
                          keep_state=True, donate=donate)
        server, clients = run.pop("state")
        run["digest"] = _digest(torch, (server, clients), run["metrics"])
        if donate:
            params = whole_step_state(mesh, cfg4, server, clients)
            del server, clients
            out["against_unsharded"] = (
                tp_against_unsharded(torch, params, run["metrics"],
                                     want_rows, 2 * rounds,
                                     path=DONATE_PARAMS)
                if rank == 0 else None)
            del params
        else:
            del server, clients
        out[f"depth4 {label}"] = run
    out["s"]["depth 4"] = time.perf_counter() - t0
    for shape in DONATE_WORLD:
        if (mesh.shape["data"], mesh.shape["model"]) != shape:
            mesh = make_engine_mesh(shape, ("data", "model"), "cuda")
        lab = f"({shape[0]}, {shape[1]})"
        for arch in DONATE_WHOLE:
            free(torch)
            base = torch.cuda.memory_allocated()
            run = split_round(torch, f"donate {lab} {arch} whole",
                              get_config(arch), rounds, mesh=mesh,
                              donate=True)
            run["base_bytes"] = base
            run.pop("census", None)
            out[f"{lab} {arch}"] = run
            out["s"][f"{lab} {arch}"] = time.perf_counter() - t0
    return out


def donate_world(torch, out, checks, want_rows, rounds):
    """The four-card part of :func:`donate_phase`, into ``out`` and
    ``checks``: the donated dry runs of every whole run, one spawn of
    four ranks (:func:`donate_rank_runs`), and the ranks' runs held to
    them."""
    from repro_torch.configs import get_config
    from repro_torch.launch.meshcheck import spawn_ranks
    t0 = time.perf_counter()
    dry = {}
    for shape in DONATE_WORLD:
        for arch in DONATE_WHOLE:
            rec = kv_dry_run(torch, get_config(arch), shape[1], d=shape[0],
                             donate=True)
            dry[(arch, shape)] = rec
            print(f"donate dry run of {arch} whole on {shape}, donated: "
                  f"state {rec['state_bytes'] / 1e9:.2f} GB, peak "
                  f"{rec['peak_bytes'] / 1e9:.2f} GB, fits {rec['fits']}")
    out["dry_runs"] = {f"{a} {s}": {k: r[k] for k in ("state_bytes",
                                                      "peak_bytes", "fits")}
                       for (a, s), r in dry.items()}
    out["s"]["dry runs"] = time.perf_counter() - t0
    # glm4-9b whole peaks near 70 GB on (2, 2): the ranks allocate in
    # expandable segments (phase 31's reason); a failing rank ends all
    free(torch)
    env = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        ranks = spawn_ranks(4, donate_rank_runs, (rounds, want_rows), "cuda",
                            shape=DONATE_WORLD[0], timeout=900)
    finally:
        if env is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = env
    out["s"]["world"] = time.perf_counter() - t0
    r0 = ranks[0]
    held = r0["against_unsharded"]
    checks["(2, 2) depth 4 donated bit-equal to undonated on every rank"] = \
        all(r["depth4 donated"]["digest"] == r["depth4 undonated"]["digest"]
            for r in ranks)
    checks["(2, 2) depth 4 launches: donated == undonated"] = all(
        _form_launches(r["depth4 donated"])
        == _form_launches(r["depth4 undonated"]) for r in ranks)
    checks["(2, 2) depth 4 donated against one card"] = held["ok"]
    print(f"donate (2, 2) depth {DONATE_DEPTH}: donated against undonated "
          f"bit-equal on every rank "
          f"{checks['(2, 2) depth 4 donated bit-equal to undonated on every rank']}"
          f"; against one card {held}; peak a card "
          f"{r0['depth4 donated']['peak_bytes'] / 1e9:.2f} GB donated, "
          f"{r0['depth4 undonated']['peak_bytes'] / 1e9:.2f} GB undonated")
    whole = {}
    for (arch, shape), rec in dry.items():
        key = f"({shape[0]}, {shape[1]}) {arch}"
        runs = [r[key] for r in ranks]
        peak = max(r["peak_bytes"] - r["base_bytes"] for r in runs)
        step_peak = max(r["step_peak_bytes"] - r["base_bytes"] for r in runs)
        err = (step_peak - rec["peak_bytes"]) / rec["peak_bytes"]
        w = runs[0]
        before = UNDONATED_PEAKS.get((arch, shape))
        unremat = DONATED_PEAKS.get((arch, shape))
        checks[f"{key} whole fits a card"] = peak < 80e9
        checks[f"{key} whole alike on every rank"] = all(
            r["metrics"] == w["metrics"] and r["launches"] == w["launches"]
            for r in runs)
        if arch == DONATE_ARCH:
            checks[f"{key} whole peak within 5% of the donated dry run's"] = \
                abs(err) <= DONATE_PEAK_RTOL
        print(f"donate {key} whole, donated: {w['rounds_per_s']:.3f} "
              f"rounds/s, {w['tokens_per_s']:.1f} tokens/s, peak "
              f"{peak / 1e9:.2f} GB a card (max over ranks, init included), "
              f"its rounds' {step_peak / 1e9:.2f} GB (the donated dry "
              f"run's {rec['peak_bytes'] / 1e9:.2f} GB, {err:+.2%}; "
              + ("" if before is None else
                 f"undonated before {before / 1e9:.2f} GB; ")
              + ("" if unremat is None else
                 f"donated before remat {unremat / 1e9:.2f} GB; ")
              + f"entity states {w['state_bytes'] / 1e9:.2f} GB a card, the "
              f"dry run's {rec['state_bytes'] / 1e9:.2f} GB)")
        whole[key] = {"peak_bytes_max": peak, "step_peak_bytes_max": step_peak,
                      "peak_err": err,
                      "dry_peak_bytes": rec["peak_bytes"],
                      "undonated_peak_before": before,
                      "donated_peak_before_remat": unremat,
                      "state_bytes": w["state_bytes"],
                      "rounds_per_s": w["rounds_per_s"],
                      "tokens_per_s": w["tokens_per_s"],
                      "round_s": w["round_s"], "launches": w["launches"],
                      "metrics": w["metrics"]}
    out["world"] = {"whole": whole, "against_unsharded": held,
                    "depth4": {k: {f: r0[k][f] for f in (
                        "metrics", "launches", "peak_bytes", "rounds_per_s")}
                        for k in ("depth4 undonated", "depth4 donated")},
                    "s": r0["s"]}


def donate_phase(torch, rounds=ROUNDS, engine_rounds=10, dev="cuda"):
    """Phase 32: the donated TrainState.  One card: (a) the in-place
    kernel (:func:`donate_kernel_checks`); (b) the Engine donated
    against undonated (:func:`donate_engine`); glm4-9b at depth 4
    (bf16, cohort 2, batch 2, sequence 2048) through
    ``build_train_step``'s ``fn`` and its ``donated()``, bit for bit with
    the same launches.  With four cards (c): :func:`donate_world`.
    Raises on any miss."""
    from repro_torch.configs import get_config
    from repro_torch.utils.tree import tree_leaves, tree_map
    t_phase = time.perf_counter()
    out, checks = {"s": {}}, {}
    cards = torch.cuda.device_count()
    row, shapes, kchecks = donate_kernel_checks(torch, dev)
    checks.update(kchecks)
    out["kernel_row"], out["kernel_shapes"] = row, shapes
    out["s"]["kernels"] = time.perf_counter() - t_phase
    out["engine"], echecks = donate_engine(torch, engine_rounds, dev)
    checks.update(echecks)
    out["s"]["engine"] = time.perf_counter() - t_phase
    cfg4 = get_config(DONATE_ARCH).with_(n_layers=DONATE_DEPTH)
    runs = {}
    for label, donate in (("undonated", False), ("donated", True)):
        free(torch)
        r = split_round(torch, f"donate one card depth {DONATE_DEPTH} "
                        f"{label}", cfg4, rounds, keep_state=True,
                        donate=donate)
        state = r.pop("state")
        if not donate:
            want = tree_map(lambda t: t.cpu(), state)
            if cards >= 4:
                os.makedirs(os.path.dirname(DONATE_PARAMS), exist_ok=True)
                torch.save((want[0].params, want[1].params), DONATE_PARAMS)
        else:
            checks["one card depth 4 donated bit-equal to undonated"] = all(
                torch.equal(x, y.cpu()) for x, y in zip(
                    tree_leaves(want), tree_leaves(state))) and (
                runs["undonated"]["metrics"] == r["metrics"])
            del want
        del state
        runs[label] = r
    d, u = runs["donated"], runs["undonated"]
    fa = d["launches"]["fused_adam"]
    checks["one card depth 4 launches equal, donated all in place"] = (
        _form_launches(d) == _form_launches(u)
        and d["launches"]["fused_adam/inplace"] == fa
        and u["launches"]["fused_adam/copy"] == fa)
    checks["one card depth 4 donated peak below undonated"] = (
        d["peak_bytes"] < u["peak_bytes"])
    print(f"donate one card {DONATE_ARCH} depth {DONATE_DEPTH}: peak "
          f"{d['peak_bytes'] / 1e9:.2f} GB donated, "
          f"{u['peak_bytes'] / 1e9:.2f} GB undonated; rounds/s "
          f"{d['rounds_per_s']:.3f} / {u['rounds_per_s']:.3f}; "
          + ", ".join(f"{k} {v}" for k, v in checks.items()
                      if k.startswith("one card")))
    out["one_card"] = {k: {f: r[f] for f in (
        "metrics", "launches", "peak_bytes", "rounds_per_s", "state_bytes")}
        for k, r in runs.items()}
    out["s"]["one card"] = time.perf_counter() - t_phase
    free(torch)
    if cards < 4:
        print("donate: fewer than four cards, so the four-card part of "
              "phase 32 did not run")
    else:
        donate_world(torch, out, checks, u["metrics"], rounds)
    out["s"]["phase"] = time.perf_counter() - t_phase
    bad = [k for k, v in checks.items() if not v]
    out["checks"] = checks
    print("donate: seconds " + json.dumps({k: round(v, 1)
                                           for k, v in out["s"].items()}))
    if bad:
        raise AssertionError(f"donate: {bad}")
    return out


def run_donate_phase(out_path):
    """The entry of ``--donate-phase``: phase 32 alone, its report written
    to ``out_path``."""
    import torch
    from repro_torch.kernels import _build
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(f"donate: {smi}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    _build.build_all()
    t0 = time.perf_counter()
    res = donate_phase(torch)
    res["s"]["total"] = time.perf_counter() - t0
    res["nvidia_smi"] = smi
    print(f"donate: phase 32 took {res['s']['total']:.1f}s")
    with open(out_path, "w") as f:
        json.dump(res, f, indent=1, default=str)
    return 0


# phase 33: edge shapes that force a row's scalar head and tail (label,
# shape, step counts, dtype name), the cases that also run on views one
# element into a larger buffer, and the redesign's targets: a share of
# the byte bound, and in place within 3% of out of place
ADAM_EDGES = (("one element", (1,), 3, "float32"),
              ("entities of 5", (3, 5), [0, 1, 2], "float32"),
              ("entities of 1001", (7, 1001), list(range(7)), "bfloat16"))
ADAM_OFFSET = ("femnist server dense", "entities of 5", "entities of 1001")
ADAM_TARGETED = ("femnist server dense", "femnist server replicas",
                 "olmoe client embedding",
                 "olmoe server experts, a rank of (1, 4)")
ADAM_TARGET_SHARE, ADAM_INPLACE_SLACK = 0.85, 1.03


def _one_in(torch, t):
    """``t``'s values in a contiguous view one element into a larger
    buffer (its base 4 or 2 bytes off 16)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def _adam_path(tensors, rows) -> str:
    """The kernel's path for these operands (p first): "vector" where
    they share a 16-byte aligned element, else "scalar"."""
    from repro_torch.kernels.fused_adam import plan_of
    return "vector" if plan_of(tensors, rows).phase >= 0 else "scalar"


def adam_build_facts():
    """Each fused_adam kernel's registers and 16-byte loads and stores in
    its SASS, read with the toolkit's cuobjdump from the built library;
    None where the toolkit has no cuobjdump."""
    from repro_torch.kernels import _build
    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    lib = str(_build.build_all(("fused_adam",))["fused_adam"])
    res = subprocess.run([tool, "-res-usage", lib], capture_output=True,
                         text=True, check=True, timeout=120).stdout
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True, timeout=120).stdout

    def label(fn):
        return (("bf16" if "nv_bfloat16" in fn else "f32") + " "
                + ("in place" if "Lb1E" in fn else "out of place"))
    facts = {label(fn): {"registers": int(r)} for fn, r in re.findall(
        r"Function (\S+):\s*REG:(\d+)", res)}
    for block in sass.split("Function : ")[1:]:
        f = facts.setdefault(label(block.split("\n", 1)[0]), {})
        f["LDG.128"] = block.count("LDG.E.128")
        f["STG.128"] = block.count("STG.E.128")
    for k, f in sorted(facts.items()):
        print(f"adam build {k}: {f}")
    return facts


def adam_case(torch, label, shape, steps, dtype, gen, dev):
    """One phase 33 shape: both entries against the plain version, in
    place bit-equal to out of place, a slot whose ``keep`` is 0 untouched,
    the offset views (where ``label`` is in ``ADAM_OFFSET``) bit-equal to
    the aligned run, and the device ms of both entries (out of place, in
    place, in place, out of place) and, at the femnist server's dense
    leaf, of ``Adam(fused=True, capturable=True)``.  Returns (row,
    checks)."""
    from repro_torch.kernels import ops, ref
    kw = dict(lr=1e-3)
    p0 = torch.randn(shape, device=dev, generator=gen).to(dtype)
    g = torch.randn(shape, device=dev, generator=gen).to(dtype)
    m0 = torch.randn(shape, device=dev, generator=gen) * 0.1
    v0 = torch.rand(shape, device=dev, generator=gen) * 0.1
    step = torch.tensor(steps, dtype=torch.int32, device=dev)
    rows = step.numel()
    fresh = lambda: (p0.clone(), m0.clone(), v0.clone())
    checks = {}
    want = ref.fused_adam_ref(p0, g, m0, v0, step, **kw)
    copy = ops.fused_adam(p0, g, m0, v0, step, **kw)
    path = _adam_path((p0, g, m0, v0, *copy), rows)
    err = max(float((a.double() - b.double()).abs().max())
              for a, b in zip(copy, want))
    checks["out of place against the plain version"] = all(
        within(a, b, 1e-6, 1) for a, b in zip(copy, want))
    del want
    pp, mp, vp = fresh()
    ref.fused_adam_ref_(pp, g, mp, vp, step, **kw)
    p, m, v = fresh()
    ops.fused_adam_(p, g, m, v, step, **kw)
    checks["in place against the plain version"] = all(
        within(a, b, 1e-6, 1) for a, b in zip((p, m, v), (pp, mp, vp)))
    checks["in place == out of place"] = all(
        torch.equal(a, b) for a, b in zip((p, m, v), copy))
    del pp, mp, vp
    # one slot off: the middle row of a stack, a lone entity whole
    keep = torch.ones(step.shape, dtype=torch.int32, device=dev)
    off = rows // 2
    keep.view(-1)[off] = 0
    p, m, v = fresh()
    ops.fused_adam_(p, g, m, v, step, keep=keep, **kw)
    if step.dim():
        on = torch.arange(rows, device=dev) != off
        checks["a slot off kept, the others stepped"] = all(
            torch.equal(a[off], b[off]) for a, b in
            zip((p, m, v), (p0, m0, v0))) and all(
            torch.equal(a[on], b[on]) for a, b in zip((p, m, v), copy))
    else:
        checks["a slot off kept"] = all(
            torch.equal(a, b) for a, b in zip((p, m, v), (p0, m0, v0)))
    del p, m, v
    paths = {"aligned": path}
    if label in ADAM_OFFSET:
        # every operand one element in: out of place against aligned
        # outputs the operands share no 16-byte element (the scalar
        # path), in place they do, one element later (a head, then
        # vectors); m alone one element in leaves them none
        po, go, mo, vo = (_one_in(torch, t) for t in (p0, g, m0, v0))
        oc = ops.fused_adam(po, go, mo, vo, step, **kw)
        paths["offset, out of place"] = _adam_path((po, go, mo, vo, *oc),
                                                   rows)
        checks["offset out of place (scalar path) == aligned (vector "
               "path)"] = (paths["offset, out of place"] == "scalar"
                           and path == "vector" and all(
                               torch.equal(a, b) for a, b in zip(oc, copy)))
        paths["offset, in place"] = _adam_path((po, go, mo, vo), rows)
        ops.fused_adam_(po, go, mo, vo, step, **kw)
        checks["offset in place (a head, then vectors) == aligned"] = (
            paths["offset, in place"] == "vector" and all(
                torch.equal(a, b) for a, b in zip((po, mo, vo), copy)))
        p, v, mo = p0.clone(), v0.clone(), _one_in(torch, m0)
        paths["m alone offset, in place"] = _adam_path((p, g, mo, v), rows)
        ops.fused_adam_(p, g, mo, v, step, **kw)
        checks["m alone offset in place (scalar path) == aligned"] = (
            paths["m alone offset, in place"] == "scalar" and all(
                torch.equal(a, b) for a, b in zip((p, mo, v), copy)))
        del po, go, mo, vo, oc, p, v
    del copy
    pk, mk, vk = fresh()
    out_ms = [device_ms(lambda: ops.fused_adam(p0, g, m0, v0, step, **kw))]
    in_ms = [device_ms(lambda: ops.fused_adam_(pk, g, mk, vk, step, **kw))]
    lib_ms = None
    if label == "femnist server dense":
        q = p0.clone().requires_grad_(True)
        q.grad = g.clone()
        opt = torch.optim.Adam([q], lr=1e-3, fused=True, capturable=True)
        lib_ms = [device_ms(opt.step), device_ms(opt.step)]
        del q, opt
    in_ms.append(device_ms(lambda: ops.fused_adam_(pk, g, mk, vk, step,
                                                   **kw)))
    out_ms.append(device_ms(lambda: ops.fused_adam(p0, g, m0, v0, step,
                                                   **kw)))
    from repro_torch.launch.roofline import bound
    flops, nbytes, cdt = kernel_cost("fused_adam", p0, g, m0, v0, step)
    b_ms, b_by = bound(nbytes, flops, cdt)
    o, i = sum(out_ms) / 2, sum(in_ms) / 2
    lib = None if lib_ms is None else sum(lib_ms) / 2
    row = {"label": label, "shape": list(shape), "dtype": str(dtype)[6:],
           "step": list(step.shape), "paths": paths, "max_abs_err": err,
           "out_ms": out_ms, "in_ms": in_ms, "library_ms": lib_ms,
           "bound_ms": b_ms, "bound_by": b_by, "out_share": b_ms / o,
           "in_share": b_ms / i, "in_over_out": i / o}
    print(f"adam {label} {list(shape)} {row['dtype']} step{row['step']}: "
          f"{path} path, max_abs_err {err:.3e}; out of place {o:.4f} ms "
          f"({out_ms[0]:.4f}, {out_ms[1]:.4f}), in place {i:.4f} ms "
          f"({in_ms[0]:.4f}, {in_ms[1]:.4f}); bound {b_ms:.5f} ms ({b_by}), "
          f"share {b_ms / o:.1%} / {b_ms / i:.1%}; in place / out of place "
          f"{i / o:.4f}; Adam(fused=True) "
          + ("n/a" if lib is None else f"{lib:.4f} ms ({lib_ms[0]:.4f}, "
             f"{lib_ms[1]:.4f})"))
    del p0, g, m0, v0, pk, mk, vk
    free(torch)
    return row, checks


def adam_phase(torch, dev="cuda"):
    """Phase 33: the redesigned ``fused_adam`` (one body for both
    entries, 16-byte accesses, the entity known per block) at phase 32a's
    shapes and at edge shapes that force a row's scalar head and tail
    (:func:`adam_case`), with each kernel's registers and 16-byte
    accesses (:func:`adam_build_facts`), and whether the redesign's
    targets held at the four timed path shapes (printed, not asserted:
    they are times).  Raises on any miss of a check."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(33)
    out = {"build": adam_build_facts(), "rows": [], "targets": {}}
    checks = {}
    cases = [*adam_path_cases(torch),
             *((lb, sh, st, getattr(torch, dt)) for lb, sh, st, dt in
               ADAM_EDGES)]
    for label, shape, steps, dtype in cases:
        row, c = adam_case(torch, label, shape, steps, dtype, gen, dev)
        checks.update({f"{label}: {k}": v for k, v in c.items()})
        out["rows"].append(row)
    for r in out["rows"]:
        if r["label"] not in ADAM_TARGETED:
            continue
        t = {"share": min(r["out_share"], r["in_share"]) >= ADAM_TARGET_SHARE,
             "in place within 3%": r["in_over_out"] <= ADAM_INPLACE_SLACK}
        if r["library_ms"] is not None:
            t["in place faster than Adam(fused=True)"] = (
                sum(r["in_ms"]) < sum(r["library_ms"]))
        out["targets"][r["label"]] = t
        print(f"adam target {r['label']}: {t}")
    out["checks"] = checks
    out["s"] = time.perf_counter() - t0
    bad = [k for k, v in checks.items() if not v]
    print(f"adam: {len(checks) - len(bad)} of {len(checks)} checks held in "
          f"{out['s']:.1f}s")
    if bad:
        raise AssertionError(f"adam: {bad}")
    return out


def run_adam_phase(out_path):
    """The entry of ``--adam-phase``: phase 33 alone, its report written
    to ``out_path``."""
    import torch
    from repro_torch.kernels import _build
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(f"adam: {smi}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    _build.build_all()
    res = adam_phase(torch)
    res["nvidia_smi"] = smi
    print(f"adam: phase 33 took {res['s']:.1f}s")
    with open(out_path, "w") as f:
        json.dump(res, f, indent=1, default=str)
    return 0


# phase 34: rematerialisation, in a process of its own
# (``python3 chip_smoke.py --remat-phase OUT``): each config at phase 7's
# protocol as the port runs it and with ``module.remat`` swapped for a
# plain call (arch, depth or None for the whole model)
REMAT_CONFIGS = (("olmoe-1b-7b", OLMOE_DEPTH), ("zamba2-1.2b", None),
                 ("whisper-base", None))
# the configs whose round peaks outside the training passes, so that
# remat leaves it (``remat_dry_runs``: olmoe at depth 4 peaks in its
# clients' Adam step, 65.88 GB both ways), and how close it stays there
# (the caching allocator's own bytes; an H100 read 65.96 GB both ways)
REMAT_PEAK_ELSEWHERE = ("olmoe-1b-7b",)
REMAT_SAME_PEAK_RTOL = 1e-3


@contextlib.contextmanager
def remat_swapped():
    """Inside, ``models.module.remat`` is a plain call: every group's
    activations stay for the backward and no forward runs twice, as
    before the port rematerialised."""
    from repro_torch.models import module
    real = module.remat
    module.remat = lambda fn, *args: fn(*args)
    try:
        yield
    finally:
        module.remat = real


def remat_config(arch, depth):
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return cfg if depth is None else cfg.with_(n_layers=depth)


def feature_grad_task(cfg):
    from repro_torch.core.split import make_transformer_task
    from repro_torch.launch.steps import make_whisper_task
    return (make_whisper_task(cfg) if cfg.family == "audio"
            else make_transformer_task(cfg))


def feature_grad_pass(cfg, server, feats, ys):
    """The feature gradients of a round (``core.cyclesl.feature_gradients``
    of the frozen server over every slot's features, their losses summed
    before one backward): the pass that holds the most activations at
    once, C server forwards, and that remat cuts to C server inputs a
    group."""
    from repro_torch.core.cyclesl import CycleConfig, feature_gradients
    return feature_gradients(feature_grad_task(cfg), server.params, feats,
                             ys, CycleConfig())


def feature_grad_inputs(cfg, clients, xs):
    """``feature_grad_pass``'s features: the extract of ``clients`` on
    ``xs``."""
    from repro_torch.core.cyclesl import extract_features
    return extract_features(feature_grad_task(cfg), clients.params, xs)


def card_feature_grad_bytes(torch, cfg, server, clients):
    """The most bytes ``feature_grad_pass`` allocates on the card above
    what was allocated before it, at phase 7's batch of seed 0 and the
    features of ``clients``."""
    from repro_torch.configs import InputShape
    from repro_torch.core.cyclesl import CycleConfig
    from repro_torch.launch.steps import build_train_step
    seq = WHISPER_TEXT if cfg.family == "audio" else SEQ
    bundle = build_train_step(cfg, InputShape("fg", seq, COHORT * BATCH,
                                              "train"),
                              CycleConfig(server_epochs=1,
                                          server_batch=BATCH),
                              cohort=COHORT, device="cuda")
    xs, ys = bundle.make_batch(0)
    feats = feature_grad_inputs(cfg, clients, xs)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    g = feature_grad_pass(cfg, server, feats, ys)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(g.float()).all()):
        raise AssertionError(f"{cfg.name}: non-finite feature gradients")
    return torch.cuda.max_memory_allocated() - base


def remat_dry_runs(torch, configs=REMAT_CONFIGS):
    """The dry run on ``meta`` of each config's train step at phase 7's
    protocol (``bundle.fn``, which keeps its arguments, as the card
    runs it), rematerialised and with the swap: {arch: {"peak_bytes",
    "plain_peak_bytes", "flops", "plain_flops", "fg_bytes",
    "plain_fg_bytes"}}, ``fg_bytes`` the most bytes
    ``feature_grad_pass`` holds above its arguments.  Needs no card."""
    from repro_torch.configs import InputShape
    from repro_torch.core.cyclesl import CycleConfig
    from repro_torch.launch.dryrun import dry_run, step_args
    from repro_torch.launch.steps import build_train_step
    from repro_torch.utils.cost import count
    from repro_torch.utils.tree import tree_leaves
    out = {}
    for arch, depth in configs:
        cfg = remat_config(arch, depth)
        seq = WHISPER_TEXT if cfg.family == "audio" else SEQ
        shape = InputShape(f"remat {arch}", seq, COHORT * BATCH, "train")
        cycle = CycleConfig(server_epochs=1, server_batch=BATCH)
        bundle = build_train_step(cfg, shape, cycle, cohort=COHORT,
                                  device="meta")
        server, clients, xs, ys, _ = step_args(bundle, "train")
        feats = feature_grad_inputs(cfg, clients, xs)
        held = sum(t.numel() * t.element_size()
                   for t in tree_leaves((server, feats, ys))
                   if isinstance(t, torch.Tensor))
        r = out[arch] = {}
        for key, ctx in (("", contextlib.nullcontext),
                         ("plain_", remat_swapped)):
            with ctx():
                rec = dry_run(cfg, shape, None, cohort=COHORT, cycle=cycle,
                              donate=False)
                fg = count(feature_grad_pass, cfg, server, feats, ys)
            r.update({f"{key}peak_bytes": rec["peak_bytes"],
                      f"{key}flops": rec["cost"]["flops"],
                      f"{key}fg_bytes": fg.peak_bytes - held})
        print(f"remat dry run {arch} (depth {cfg.n_layers}): peak "
              f"{r['peak_bytes'] / 1e9:.2f} GB with remat, "
              f"{r['plain_peak_bytes'] / 1e9:.2f} GB without; the feature "
              f"gradients' pass {r['fg_bytes'] / 1e9:.2f} / "
              f"{r['plain_fg_bytes'] / 1e9:.2f} GB above its inputs; FLOPs "
              f"{r['flops']:.4e} / {r['plain_flops']:.4e} = "
              f"{r['flops'] / r['plain_flops']:.4f}x")
    return out


def remat_phase(torch, rounds=ROUNDS):
    """Phase 34: each of ``REMAT_CONFIGS`` through ``split_round`` as the
    port runs it (remat), with ``module.remat`` swapped for a plain call
    (plain), and as the port again, in one process: the states and
    metrics after ``rounds`` rounds bit for bit the same in all three,
    the launches by kernel exactly ``round_launches`` with the recompute
    and without it, ``max_memory_allocated`` over the rounds lower with
    remat (within ``REMAT_SAME_PEAK_RTOL`` where the round peaks
    outside the training passes: ``REMAT_PEAK_ELSEWHERE``), the feature
    gradients' pass (``card_feature_grad_bytes``) lower with remat, and
    rounds/s of each run (the two remat runs around the plain one).
    Raises on any miss.  The dry run's side (``remat_dry_runs``) needs
    no card and is not run here."""
    from repro_torch.utils.tree import tree_map
    t0 = time.perf_counter()
    out = {"runs": {}, "s": {}}
    checks = {}
    for arch, depth in REMAT_CONFIGS:
        cfg = remat_config(arch, depth)
        runs, first = [], None
        for turn, remat in enumerate((True, False, True)):
            free(torch)
            label = (f"remat {arch} {'remat' if remat else 'plain'} "
                     f"{turn + 1}")
            with (contextlib.nullcontext() if remat else remat_swapped()):
                r = split_round(torch, label, cfg, rounds, keep_state=True,
                                remat=remat)
                state = r.pop("state")
                r["fg_bytes"] = card_feature_grad_bytes(torch, cfg, *state)
            if first is None:
                first = tree_map(lambda t: t.cpu(), state)
                r["bit_equal"] = True
            else:
                r["bit_equal"] = (state_diff(torch, first, state) == 0.0
                                  and r["metrics"] == runs[0]["metrics"])
            del state
            runs.append(r)
        del first
        a, p, b = runs
        rps = (a["rounds_per_s"] + b["rounds_per_s"]) / 2
        checks[f"{arch} states bit-equal with and without remat"] = (
            p["bit_equal"] and b["bit_equal"])
        top = max(a["step_peak_bytes"], b["step_peak_bytes"])
        plain = p["step_peak_bytes"]
        if arch not in REMAT_PEAK_ELSEWHERE:
            checks[f"{arch} round peak lower with remat"] = top < plain
        else:
            checks[f"{arch} round peak within {REMAT_SAME_PEAK_RTOL:.1%} "
                   "with and without remat (its clients' step sets it)"] = (
                abs(top - plain) <= REMAT_SAME_PEAK_RTOL * plain)
        checks[f"{arch} feature gradients' peak lower with remat"] = (
            max(a["fg_bytes"], b["fg_bytes"]) < p["fg_bytes"])
        print(f"remat {arch} (depth {cfg.n_layers}): the rounds' peak "
              f"{a['step_peak_bytes']:,} / {b['step_peak_bytes']:,} B with "
              f"remat, {p['step_peak_bytes']:,} B without; the feature "
              f"gradients' pass {a['fg_bytes']:,} / {b['fg_bytes']:,} B "
              f"above its inputs, {p['fg_bytes']:,} without; rounds/s "
              f"{a['rounds_per_s']:.4f}, {p['rounds_per_s']:.4f} plain, "
              f"{b['rounds_per_s']:.4f} in turns: {rps / p['rounds_per_s']:.4f}"
              f"x the plain run; bit-equal "
              f"{p['bit_equal']} / {b['bit_equal']}; launches a round "
              f"{ {k: v // rounds for k, v in a['launches'].items()} } with "
              f"remat, "
              f"{ {k: v // rounds for k, v in p['launches'].items()} } "
              f"without")
        out["runs"][arch] = {
            "n_layers": cfg.n_layers,
            "turns": [{k: r[k] for k in (
                "peak_bytes", "step_peak_bytes", "fg_bytes", "rounds_per_s",
                "round_s", "metrics", "launches", "expected_launches",
                "bit_equal")} for r in runs],
            "rounds_per_s_remat": rps, "step_peak_bytes_remat": top,
            "step_peak_bytes_plain": plain,
            "rounds_per_s_plain": p["rounds_per_s"]}
        out["s"][arch] = time.perf_counter() - t0
    free(torch)
    out["checks"] = checks
    bad = [k for k, v in checks.items() if not v]
    print(f"remat: {len(checks) - len(bad)} of {len(checks)} checks held; "
          "seconds " + json.dumps({k: round(v, 1)
                                   for k, v in out["s"].items()}))
    if bad:
        raise AssertionError(f"remat: {bad}")
    return out


def run_remat_phase(out_path):
    """The entry of ``--remat-phase``: phase 34 alone, its report written
    to ``out_path``."""
    import torch
    from repro_torch.kernels import _build
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(f"remat: {smi}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    _build.build_all()
    t0 = time.perf_counter()
    res = remat_phase(torch)
    res["s"]["total"] = time.perf_counter() - t0
    res["nvidia_smi"] = smi
    print(f"remat: phase 34 took {res['s']['total']:.1f}s")
    with open(out_path, "w") as f:
        json.dump(res, f, indent=1, default=str)
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=10,
                    help="rounds of the main path, of the fused variant "
                         "and of each program of the zoo")
    ap.add_argument("--out", default=None, help="write the full report here")
    ap.add_argument("--profile", action="store_true",
                    help="also profile the main path, its fused variant, "
                         "psl and ssl, one olmoe and one zamba2 round, and "
                         "the main path unsharded and on a (1, 1) mesh, and "
                         "phase 27's unsharded zamba2 round and each "
                         "world's first run")
    ap.add_argument("--mesh-phase", default=None, metavar="OUT",
                    help="run phase 24 alone (the process main() starts "
                         "for it) and write its report to OUT")
    ap.add_argument("--tp-phase", default=None, metavar="OUT",
                    help="run phase 25 alone (the process main() starts "
                         "for it) and write its report to OUT")
    ap.add_argument("--engine-mesh-phase", default=None, metavar="OUT",
                    help="run phase 26 alone (the process main() starts "
                         "for it) and write its report to OUT")
    ap.add_argument("--ssm-tp-phase", default=None, metavar="OUT",
                    help="run phase 27 alone (the process main() starts "
                         "for it) and write its report to OUT")
    ap.add_argument("--decode-mesh-phase", default=None, metavar="OUT",
                    help="run phase 28 alone (the process main() starts "
                         "for it) and write its report to OUT")
    ap.add_argument("--engine-paths-mesh-phase", default=None, metavar="OUT",
                    help="run phase 29 alone (the process main() starts "
                         "for it) and write its report to OUT")
    ap.add_argument("--kv-groups-phase", default=None, metavar="OUT",
                    help="run phase 31 alone (the process main() starts "
                         "for it) and write its report to OUT")
    ap.add_argument("--donate-phase", default=None, metavar="OUT",
                    help="run phase 32 alone (the process main() starts "
                         "for it) and write its report to OUT")
    ap.add_argument("--adam-phase", default=None, metavar="OUT",
                    help="run phase 33 alone (the process main() starts "
                         "for it) and write its report to OUT")
    ap.add_argument("--remat-phase", default=None, metavar="OUT",
                    help="run phase 34 alone (the process main() starts "
                         "for it) and write its report to OUT")
    args = ap.parse_args(argv)
    if args.mesh_phase:
        return run_mesh_phase(args.mesh_phase, args.profile)
    if args.tp_phase:
        return run_tp_phase(args.tp_phase, args.profile)
    if args.engine_mesh_phase:
        return run_engine_mesh_phase(args.engine_mesh_phase)
    if args.ssm_tp_phase:
        return run_ssm_tp_phase(args.ssm_tp_phase, args.profile)
    if args.decode_mesh_phase:
        return run_decode_mesh_phase(args.decode_mesh_phase)
    if args.engine_paths_mesh_phase:
        return run_engine_paths_phase(args.engine_paths_mesh_phase)
    if args.kv_groups_phase:
        return run_kv_groups_phase(args.kv_groups_phase)
    if args.donate_phase:
        return run_donate_phase(args.donate_phase)
    if args.adam_phase:
        return run_adam_phase(args.adam_phase)
    if args.remat_phase:
        return run_remat_phase(args.remat_phase)

    t_start = time.perf_counter()
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
    # the Engine donates its state on the card: every fused_adam launch
    # is the in-place entry
    main_run = drive(torch, "main cut2", ExperimentConfig(
        rounds=r, eval_every=r, cut=2, **MAIN),
        {"feature_resample": 2 * 5 * r, "fused_adam": (2 * 5 + 4) * r,
         "fused_adam/inplace": (2 * 5 + 4) * r, "gather_loss": 0})
    fused_run = drive(torch, "fused cut3", ExperimentConfig(
        rounds=r, eval_every=r, cut=3, **MAIN).with_cycle(
            fused_gather_loss=True),
        {"feature_resample": 0, "fused_adam": (1 * 5 + 5) * r,
         "fused_adam/inplace": (1 * 5 + 5) * r, "gather_loss": 5 * r})

    profiles = {}
    if args.profile:
        for cut in (2, 3):
            profiles[f"cut{cut}"] = profile_rounds(torch, ExperimentConfig(
                rounds=r, eval_every=r, cut=cut, **MAIN).with_cycle(
                    fused_gather_loss=cut == 3))
        for algo in ("psl", "ssl"):
            profiles[algo] = profile_rounds(torch, ExperimentConfig(
                algo=algo, rounds=r, eval_every=r, cut=2, **MAIN))

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

    # 12-13. the algorithm zoo at the main path's width, card against CPU
    zoo_runs = zoo(torch, r)
    parity.update({f"zoo/{k}": v for k, v in
                   zoo_card_against_cpu(torch).items()})

    # 14-15. the paper's other workloads, card against CPU
    t14 = time.perf_counter()
    workload_runs = workloads(torch, r)
    t15 = time.perf_counter()
    parity.update({f"workloads/{k}": v for k, v in
                   workloads_card_against_cpu(torch).items()})
    t16 = time.perf_counter()
    phase_s = {"14": t15 - t14, "15": t16 - t15}

    # 16-17. serving: the continuous runtime at olmoe-1b-7b and
    # zamba2-1.2b whole, the batched driver at gemma2-2b whole; decode
    # against forward on the card, and the runtime card against CPU
    serving = {arch: serve_runtime(torch, f"serve {arch.split('-')[0]}",
                                   get_config(arch), n,
                                   profile=args.profile and arch.startswith(
                                       "olmoe"))
               for arch, n in SERVE_REQUESTS.items()}
    serving["gemma2-2b"] = serve_batched(torch, "serve gemma2 batched",
                                         get_config("gemma2-2b"))
    t17 = time.perf_counter()
    parity.update({f"teacher_forcing/{a}": teacher_forcing(torch, a)
                   for a in ("olmoe-1b-7b", "zamba2-1.2b")})
    parity.update({f"serve/{k}": v for k, v in
                   serve_card_against_cpu(torch).items()})
    t18 = time.perf_counter()
    phase_s.update({"16": t17 - t16, "17": t18 - t17})

    # 18-20. the Engine's fault and population paths: checkpoints and
    # resume, the resilience runtime (card against CPU too), population
    # scenarios; the guard's launches last (a profiler session)
    fault_paths = {"checkpoint": checkpoint_resume(torch)}
    t19 = time.perf_counter()
    fault_paths["resilience"] = resilience(torch)
    parity.update({f"resilience/{k}": v for k, v in
                   resilience_card_against_cpu(torch).items()})
    t20 = time.perf_counter()
    fault_paths["population"] = population(torch)
    t21 = time.perf_counter()
    fault_paths["profiles"] = fault_path_profiles(torch)
    t21b = time.perf_counter()

    # 21-22. whisper-base whole: round, prefill, decode, serve; card
    # against CPU and teacher forcing
    whisper_runs, whisper_parity = whisper(torch, profile=args.profile)
    parity.update({f"whisper/{k}": v for k, v in whisper_parity.items()})
    t22 = time.perf_counter()

    # 23. the pipelined rounds on the main path
    fault_paths["pipeline"] = pipelined(torch)
    t23 = time.perf_counter()

    # 24. the round on a device mesh, in a process of its own (it starts
    # a process group; a world of N spawns N ranks)
    mesh_out = os.path.join(ROOT, "build", "chip_smoke_mesh.json")
    os.makedirs(os.path.dirname(mesh_out), exist_ok=True)
    torch.cuda.empty_cache()          # the card's memory to the new process
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--mesh-phase", mesh_out]
                          + (["--profile"] if args.profile else []),
                          timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"phase 24 (mesh) exited {proc.returncode}")
    with open(mesh_out) as f:
        mesh_runs = json.load(f)
    t24 = time.perf_counter()

    # 25. the model axis, in a process of its own (a (1, 1) mesh on this
    # card; with two cards or more, (1, n) in spawned ranks)
    tp_out = os.path.join(ROOT, "build", "chip_smoke_tp.json")
    torch.cuda.empty_cache()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--tp-phase", tp_out]
                          + (["--profile"] if args.profile else []),
                          timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"phase 25 (model axis) exited {proc.returncode}")
    with open(tp_out) as f:
        tp_runs = json.load(f)
    t25 = time.perf_counter()

    # 26. the Engine on the reference's 2-D mesh, in a process of its own
    # (a (1, 1) mesh on this card; with four cards and two, the 2-D
    # meshes in spawned ranks)
    em_out = os.path.join(ROOT, "build", "chip_smoke_engine_mesh.json")
    torch.cuda.empty_cache()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--engine-mesh-phase", em_out], timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"phase 26 (engine mesh) exited "
                           f"{proc.returncode}")
    with open(em_out) as f:
        engine_mesh_runs = json.load(f)
    t26 = time.perf_counter()

    # 27. the Mamba-2, hybrid and whisper steps on the model axis, in a
    # process of its own (a (1, 1) mesh on this card; with four cards and
    # two, the meshes of SSM_TP_WORLDS in spawned ranks)
    st_out = os.path.join(ROOT, "build", "chip_smoke_ssm_tp.json")
    torch.cuda.empty_cache()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--ssm-tp-phase", st_out]
                          + (["--profile"] if args.profile else []),
                          timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"phase 27 (Mamba, hybrid and whisper on the "
                           f"model axis) exited {proc.returncode}")
    with open(st_out) as f:
        ssm_tp_runs = json.load(f)
    t27 = time.perf_counter()

    # 28. decode and the serving slot table on a mesh, in a process of its
    # own (a (1, 1) mesh on this card; with four cards the meshes of
    # DM_WORLDS in spawned ranks)
    dm_out = os.path.join(ROOT, "build", "chip_smoke_decode_mesh.json")
    torch.cuda.empty_cache()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--decode-mesh-phase", dm_out], timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"phase 28 (decode and serving on a mesh) "
                           f"exited {proc.returncode}")
    with open(dm_out) as f:
        decode_mesh_runs = json.load(f)
    t28 = time.perf_counter()

    # 29. the Engine's pipelined rounds, guard, checkpoints and scenarios
    # on a mesh, in a process of its own (a (1, 1) mesh on this card; with
    # four cards the meshes of PATHS_WORLDS in spawned ranks)
    ep_out = os.path.join(ROOT, "build", "chip_smoke_engine_paths.json")
    torch.cuda.empty_cache()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--engine-paths-mesh-phase", ep_out], timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"phase 29 (the Engine's paths on a mesh) exited "
                           f"{proc.returncode}")
    with open(ep_out) as f:
        engine_paths_runs = json.load(f)
    t29 = time.perf_counter()

    # 30. the tooling: the profiler on the main path, the olmoe and zamba2
    # rounds against their dry runs on meta and the roofline
    tooling_runs = tooling(torch)
    t30 = time.perf_counter()

    # 31. the attention split over kv head groups, in a process of its own
    # (a (1, 1) mesh on this card; with four cards glm4-9b on (1, 4) in
    # spawned ranks)
    kv_out = os.path.join(ROOT, "build", "chip_smoke_kv_groups.json")
    torch.cuda.empty_cache()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--kv-groups-phase", kv_out], timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"phase 31 (kv head groups) exited "
                           f"{proc.returncode}")
    with open(kv_out) as f:
        kv_group_runs = json.load(f)
    t31 = time.perf_counter()

    # 32. the donated TrainState, in a process of its own (with four
    # cards glm4-9b and olmoe-1b-7b whole on (2, 2) and (1, 4) in spawned
    # ranks)
    dn_out = os.path.join(ROOT, "build", "chip_smoke_donate.json")
    torch.cuda.empty_cache()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--donate-phase", dn_out], timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"phase 32 (donated state) exited "
                           f"{proc.returncode}")
    with open(dn_out) as f:
        donate_runs = json.load(f)
    t32 = time.perf_counter()

    # 33. the redesigned fused_adam, in a process of its own: both entries
    # at the path's shapes and the edge shapes, timed in one call
    ad_out = os.path.join(ROOT, "build", "chip_smoke_adam.json")
    torch.cuda.empty_cache()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--adam-phase", ad_out], timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"phase 33 (fused_adam) exited {proc.returncode}")
    with open(ad_out) as f:
        adam_runs = json.load(f)
    t33 = time.perf_counter()

    # 34. rematerialisation, in a process of its own: olmoe-1b-7b at depth
    # 4, zamba2-1.2b and whisper-base whole with and without remat
    rm_out = os.path.join(ROOT, "build", "chip_smoke_remat.json")
    torch.cuda.empty_cache()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--remat-phase", rm_out], timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"phase 34 (remat) exited {proc.returncode}")
    with open(rm_out) as f:
        remat_runs = json.load(f)
    t34 = time.perf_counter()
    phase_s.update({"18": t19 - t18, "19": t20 - t19, "20": t21 - t20,
                    "21-22": t22 - t21b, "23": t23 - t22, "24": t24 - t23,
                    "25": t25 - t24, "26": t26 - t25, "27": t27 - t26,
                    "28": t28 - t27, "29": t29 - t28, "30": t30 - t29,
                    "31": t31 - t30, "32": t32 - t31, "33": t33 - t32,
                    "34": t34 - t33})
    print("phases took " + ", ".join(f"{k}: {v:.1f}s"
                                     for k, v in phase_s.items()))
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f}s in all")

    sources = {"feature_resample": "src/repro/kernels/feature_resample.py:24",
               "fused_adam": "src/repro/kernels/fused_adam.py:44",
               "gather_loss": "src/repro/kernels/gather_loss.py:47",
               "flash_attention": "src/repro/kernels/flash_attention.py:70",
               "topk_gating": "src/repro/kernels/topk_gating.py:38",
               "ssd_scan": "src/repro/kernels/ssd_scan.py:61"}
    # phase 32's in-place entry, at the femnist server's dense leaf: the
    # main path's (donated) Adam kernel; the out-of-place entry's
    # launches are the olmoe round's, whose step keeps its arguments
    sources["fused_adam_inplace"] = sources["fused_adam"]
    rows["fused_adam_inplace"] = donate_runs["kernel_row"]
    counts = {"fused_adam": ("fused_adam/copy", olmoe),
              "fused_adam_inplace": ("fused_adam/inplace", main_run)}
    kernels = []
    for name, row in rows.items():
        run = {"gather_loss": fused_run, "flash_attention": olmoe,
               "topk_gating": olmoe, "ssd_scan": zamba}.get(name, main_run)
        key, run = counts.get(name, (name, run))
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/"
                      f"{name.replace('_inplace', '')}.cu",
            "replaces": sources[name], "launches": run["launches"][key],
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
                       "launch_floor": floor, "zoo": zoo_runs,
                       "workloads": workload_runs, "serving": serving,
                       "fault_paths": fault_paths, "whisper": whisper_runs,
                       "mesh": mesh_runs, "model_axis": tp_runs,
                       "engine_mesh": engine_mesh_runs,
                       "ssm_model_axis": ssm_tp_runs,
                       "decode_mesh": decode_mesh_runs,
                       "engine_paths_mesh": engine_paths_runs,
                       "tooling": tooling_runs,
                       "kv_groups": kv_group_runs,
                       "donate": donate_runs, "adam": adam_runs,
                       "remat": remat_runs,
                       "phase_s": phase_s}, f,
                      indent=1)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
