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
   card, at the main path's shapes and at one larger shape, with its
   time, its bound and a one-call PyTorch yardstick where one exists;
4. main path: ``Engine.run()`` of cyclesfl on femnist_cnn at the paper's
   width 32 (cut 2), with the kernels' launch counters reset before and
   read after;
5. fused variant: the same at cut 3 with ``fused_gather_loss``;
6. card against CPU: two rounds at a small width with TF32 off, one
   carried init and one injected plan, on the CPU (plain versions) and
   on the card (kernels).

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

# H100 SXM peaks (NVIDIA data sheet, dense, at the full 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
MAIN = dict(n_clients=100, attendance=0.05, batch=16, width=32)


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


def bound(nbytes, flops):
    """Least time (ms) for the work: bytes over the memory rate against
    float32 operations over the float32 rate; the larger bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check(name, shape, kernel, plain, tol, nbytes, flops, library=None):
    """Run ``kernel`` and ``plain`` once on the same inputs, compare,
    time both (and ``library``) on the device, and print one line.
    Raises when the kernel disagrees with its plain version beyond
    ``tol``."""
    import torch
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    err = max(float((a.double() - b.double()).abs().max()) if a.numel() else 0.0
              for a, b in zip(got, want))
    ms, plain_ms = device_ms(kernel), device_ms(plain)
    lib_ms = device_ms(library) if library is not None else None
    eager = eager_ms(kernel)
    b_ms, b_by = bound(nbytes, flops)
    row = {"name": name, "shape": shape, "max_abs_err": err, "tol": tol,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": lib_ms, "eager_ms": eager}
    print(f"check {name} {shape}: max_abs_err={err:.3e} (tol {tol:.0e}) "
          f"kernel={ms:.4f}ms (eager {eager:.4f}ms) plain={plain_ms:.4f}ms "
          f"bound={b_ms:.5f}ms ({b_by}) "
          f"library={'n/a' if lib_ms is None else f'{lib_ms:.4f}ms'}")
    if not err <= tol:
        raise AssertionError(f"{name} {shape}: kernel differs from its plain "
                             f"version by {err} > {tol}")
    return row


def kernel_checks(torch, dev):
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {}

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
    # rows too short or misaligned for wide vectors: the 2- and 1-byte paths
    resample("feature_resample", torch.randn(38, 13, device=dev,
                                             generator=gen).bfloat16()[1:], 16)
    resample("feature_resample", torch.randint(0, 100, (81, 3), device=dev,
                                               generator=gen).to(torch.uint8),
             16)

    # ---- fused_adam: the server's dense leaves and a client stack
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
                     1e-6 if dtype == torch.float32 else 2e-2, nbytes, 14 * n,
                     library=lib)

    rows["fused_adam"] = adam((3136, 2048), 3, main=True)
    adam((2048, 10), 3)
    adam((5, 5, 5, 32, 64), [0, 1, 2, 3, 4])
    adam((5, 3136, 2048), [4, 4, 4, 9, 0])
    adam((3136, 2048), 3, dtype=torch.bfloat16)
    adam((2048, 10), 7, wd=0.01)

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
                     1e-4, nbytes, 2 * m * d * k + 6 * m * k)

    rows["gather_loss"] = gather_loss(80, 2048, 10, 16)
    gather_loss(8192, 2048, 62, 2048)
    gather_loss(37, 33, 7, 19, dtype=torch.bfloat16, labels=torch.int32)
    return rows


def counters():
    from repro_torch.kernels import feature_resample, fused_adam, gather_loss
    return {"feature_resample": feature_resample, "fused_adam": fused_adam,
            "gather_loss": gather_loss}


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
    for mod in counters().values():
        mod.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: mod.launches for k, mod in counters().items()}
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


def profile_rounds(torch, cfg):
    """``Engine.run()`` under torch.profiler: device busy share of the
    wall time and the kernels that take the device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.api import Engine
    eng = Engine(cfg, device="cuda", log=lambda msg: None)
    eng.run()                                   # warm: cuDNN picks, caches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events only (kernels, copies): the host ops that
    # launched them carry the same device time again
    rows = sorted(((e.key, e.count, e.self_device_time_total)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), key=lambda r: -r[2])
    busy = sum(r[2] for r in rows)
    print(f"profile cut{cfg.cut}: {cfg.rounds} rounds + eval in "
          f"{wall_us / 1e3:.1f}ms wall, device busy {busy / 1e3:.1f}ms "
          f"({busy / wall_us:.1%})")
    for name, count, t in rows[:12]:
        print(f"profile cut{cfg.cut}:   {t / 1e3:8.3f}ms {count:6d}x {name[:90]}")
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "top": [{"name": n, "count": c, "device_ms": t / 1e3}
                    for n, c, t in rows[:25]]}


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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=10,
                    help="rounds of the main path and of the fused variant")
    ap.add_argument("--out", default=None, help="write the full report here")
    ap.add_argument("--profile", action="store_true",
                    help="also profile the main path and its fused variant")
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

    sources = {"feature_resample": "src/repro/kernels/feature_resample.py:24",
               "fused_adam": "src/repro/kernels/fused_adam.py:44",
               "gather_loss": "src/repro/kernels/gather_loss.py:47"}
    kernels = []
    for name, row in rows.items():
        run = fused_run if name == "gather_loss" else main_run
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
                       "profile": profiles, "card_vs_cpu": parity}, f,
                      indent=1)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
