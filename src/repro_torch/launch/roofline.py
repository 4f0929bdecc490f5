"""The H100 roofline over the dry run's records.

Port of ``repro/launch/roofline.py`` with the card's peaks in place of
the TPU's.  Per card, from a record of ``launch.dryrun``:

    compute    = Σ FLOPs of a dtype / that dtype's peak
    memory     = traffic bytes / HBM rate
    collective = collective bytes / NVLink rate

The dry run counts one rank's step (``utils.cost.count``), so each term
is a card's; the largest, the ``dominant`` one, is ``roofline_s``,
the least time the card could take.  The work is the
eager step's (see ``utils.cost``): a card that beats ``roofline_s`` by
more than its L2 cache can explain means the count is wrong.

``model_flops`` is the reference's 6·N·D (training, N_active for a MoE)
and 2·N·D (inference); ``useful_ratio`` is it over the FLOPs the cards
run together, and :func:`mfu` its share of the cards' peak in a measured
time.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.roofline [--in dryrun.json]
      [--out roofline.json] [--md]
"""
from __future__ import annotations

import argparse
import json

import torch

# H100 SXM (NVIDIA data sheet, dense, at the full 700 W limit), a card
BF16_FLOPS_PER_S = 989e12       # bf16 / fp16 on the tensor cores
FP32_FLOPS_PER_S = 67e12        # float32 on the CUDA cores (TF32 kept off)
HBM_BYTES_PER_S = 3.35e12       # HBM3
NVLINK_BYTES_PER_S = 450e9      # NVLink 4, a card, each direction
MEMORY_BYTES = 80e9             # the card's memory, as sold ("80 GB")

_TENSOR_CORE = {"bfloat16", "float16"}


def peak_flops(dtype) -> float:
    """The card's peak for operands of ``dtype`` (a torch dtype or its
    name): the tensor cores' for bf16 and fp16, else float32's."""
    name = str(dtype).replace("torch.", "")
    return BF16_FLOPS_PER_S if name in _TENSOR_CORE else FP32_FLOPS_PER_S


def bound(nbytes, flops, dtype=None) -> tuple[float, str]:
    """Least time (ms) for one kernel's work: bytes over the memory rate
    against operations over the peak for ``dtype``; the larger bounds
    it.  Returns ``(ms, "bytes" or "operations")``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops(dtype) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compute_seconds(flops_by_dtype: dict) -> float:
    """The compute term: each dtype's FLOPs over its peak."""
    return sum(f / peak_flops(d) for d, f in flops_by_dtype.items())


def terms(cost: dict) -> dict:
    """A card's three roofline terms (s) from ``StepCost.summary()``."""
    return {"compute": compute_seconds(cost["flops_by_dtype"]),
            "memory": cost["traffic_bytes"] / HBM_BYTES_PER_S,
            "collective": cost["collective_bytes"] / NVLINK_BYTES_PER_S}


def _config(arch):
    from repro_torch.configs import get_config
    return get_config(arch) if isinstance(arch, str) else arch


def _shape(shape):
    from repro_torch.configs import INPUT_SHAPES
    return INPUT_SHAPES[shape] if isinstance(shape, str) else shape


def model_flops(arch, shape) -> float:
    """6·N·D for train (forward and backward), 2·N·D for inference; a
    MoE counts its active parameters.  whisper: the decoder's horizon is
    448 and the encoder runs over 1500 frames, so its tokens are
    B·(448 + 1500).  ``arch`` and ``shape`` are names (or an
    ``ArchConfig`` and an ``InputShape``)."""
    cfg, shape = _config(arch), _shape(shape)
    n = cfg.n_active_params()
    if cfg.family == "audio":
        tokens = shape.global_batch * (min(shape.seq_len, 448) + 1500)
    else:
        tokens = shape.global_batch * shape.seq_len
    if shape.kind == "train":
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch        # decode: a token a sequence


def mfu(model_flops: float, seconds: float, chips: int = 1,
        dtype=torch.bfloat16) -> float:
    """The share of ``chips`` cards' peak for ``dtype`` that
    ``model_flops`` in ``seconds`` is."""
    return model_flops / (seconds * chips * peak_flops(dtype))


def analyze_record(rec: dict):
    """A card's roofline of a dry-run record (None unless it is ok):
    the three terms, the ``dominant`` one, ``roofline_s``, the model's
    FLOPs and their share of the FLOPs the cards run (``useful_ratio``),
    and whether the step ``fits`` the card's memory."""
    if rec.get("status") != "ok":
        return None
    cost, chips = rec["cost"], rec["chips"]
    t = terms(cost)
    mf = rec.get("model_flops") or model_flops(rec["arch"], rec["shape"])
    flops_glob = cost["flops"] * chips
    return {
        **{f"t_{k}_s": v for k, v in t.items()},
        "dominant": max(t, key=t.get),
        "roofline_s": max(t.values()),
        "flops_per_card": cost["flops"],
        "traffic_bytes_per_card": cost["traffic_bytes"],
        "collective_bytes_per_card": cost["collective_bytes"],
        "model_flops": mf,
        "useful_ratio": mf / flops_glob if flops_glob else float("nan"),
        "chips": chips,
        "fits": rec.get("fits"),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--in", dest="inp", default="build/dryrun.json")
    ap.add_argument("--out", default="build/roofline.json")
    ap.add_argument("--md", action="store_true", help="print a markdown table")
    args = ap.parse_args(argv)
    with open(args.inp) as f:
        records = json.load(f)
    rows = []
    for rec in sorted(records, key=lambda r: (r["mesh"], r["arch"],
                                              r["shape"])):
        a = analyze_record(rec)
        base = {"arch": rec["arch"], "shape": rec["shape"],
                "mesh": rec["mesh"]}
        if a is None:
            rows.append({**base, "status": rec["status"],
                         "reason": rec.get("reason", rec.get("error", ""))})
        else:
            rows.append({**base, "status": "ok", **a})
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)
    if args.md:
        print("| arch | shape | mesh | compute s | memory s | coll s | "
              "dominant | useful | fits |")
        print("|" + "---|" * 9)
        for r in rows:
            if r["status"] != "ok":
                print(f"| {r['arch']} | {r['shape']} | {r['mesh']} | — | — "
                      f"| — | {r['status']}: {r['reason'][:60]} | — | — |")
                continue
            print(f"| {r['arch']} | {r['shape']} | {r['mesh']} "
                  f"| {r['t_compute_s']:.4f} | {r['t_memory_s']:.4f} "
                  f"| {r['t_collective_s']:.4f} | {r['dominant']} "
                  f"| {r['useful_ratio']:.2f} | {r['fits']} |")
    print(f"wrote {args.out} ({len(rows)} rows)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
