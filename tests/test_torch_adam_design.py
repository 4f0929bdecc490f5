"""The redesigned fused_adam kernel's host side, on the CPU.

The kernel (``csrc/fused_adam.cu``) runs only on the card
(``chip_smoke.py --adam-phase``).  What decides which elements it steps
is made here, in ``kernels.fused_adam.plan``: the first element at which
every operand lies on 16 bytes (``phase``, or -1 for the scalar path) and
the tiles along a row.  These tests

- walk the kernel's split of a leaf (each row's head and tail in its
  first block, whole vectors in tiles of 256, the scalar path over the
  same tiles, rows past 65535 in strides of the grid) over the plan, at
  edge shapes and operand offsets, and count every element stepped
  exactly once, with the path each offset takes;
- hold the plan's constants to the kernel source's;
- run both entries on the CPU at contiguous views one element into a
  larger buffer against the aligned result, bit for bit;
- check that ``_check_inplace`` still refuses operands that share bytes;
- check that ``chip_smoke.port_kernels`` names every ``__global__``
  function of the port's sources, and that a profile's name of either
  fused_adam entry maps to the port's kernel.
"""
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build, ops
from repro_torch.kernels import fused_adam as fa

from torch_threads import one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
RNG = np.random.default_rng(32)
KW = dict(lr=1e-3, weight_decay=0.01)
GRID_Y = 65535           # the kernel's most entities a launch lays out

# (shape, step counts): one element, rows of 5, 1001 and 12293, a row
# of exactly one tile and one of one tile and a vector, the femnist client
# stack, and more entities than the grid holds rows
SHAPES = {
    "one element": ((1,), 3),
    "entities of 5": ((3, 5), [0, 1, 2]),
    "entities of 1001": ((7, 1001), list(range(7))),
    "entities of 12293": ((2, 12293), [0, 3]),
    "a tile": ((2048,), 1),
    "a tile and a vector": ((2, 2048 + 8), [1, 2]),
    "client stack": ((5, 5, 5, 32, 64), [0, 1, 2, 3, 4]),
    "more rows than the grid": ((GRID_Y + 3, 3), None),
}
# operand offsets in elements from a 16-byte aligned base: p, g, m, v,
# then the out-of-place entry's p_out, m_out, v_out (fresh, aligned)
OFFSETS = {
    "aligned": (0, 0, 0, 0),
    "all one in": (1, 1, 1, 1),
    "m alone one in": (0, 0, 1, 0),
    "p and g three in": (3, 3, 0, 0),
}


def _spans(dtype, offsets, inplace):
    """(address, element size) of each operand the entry touches, each on
    its own 4 KB-aligned base moved ``offsets`` elements in."""
    size = torch.empty((), dtype=dtype).element_size()
    sizes = (size, size, 4, 4)
    spans = [(4096 * (k + 1) + o * s, s)
             for k, (o, s) in enumerate(zip(offsets, sizes))]
    if not inplace:
        spans += [(4096 * (k + 5), s) for k, s in enumerate((size, 4, 4))]
    return spans


def _row_steps(pl, base):
    """How many times the kernel's blocks along one row (entity at
    element ``base``) step each of its elements: csrc/fused_adam.cu's
    fused_adam_kernel, tile by tile, with the head and the tail of the row
    in its first block's threads [0, V) and [V, 2V)."""
    npe, vec, tile = pl.n_per_entity, pl.vec, pl.tile
    counts = np.zeros(npe, np.int64)
    if pl.phase < 0:
        for x in range(pl.tiles):
            i = x * tile + np.arange(tile)
            counts[i[i < npe]] += 1
        return counts
    head = min((pl.phase - base) & (vec - 1), npe)
    nvec = (npe - head) // vec
    tail = head + nvec * vec
    assert head < vec and npe - tail < vec      # under the threads [0, 2V)
    counts[:head] += 1
    counts[tail:] += 1
    for x in range(pl.tiles):
        k = x * (tile // vec) + np.arange(tile // vec)
        k = k[k < nvec]
        counts[(head + k[:, None] * vec + np.arange(vec)).ravel()] += 1
    return counts


def _stepped(pl):
    """How many times the kernel steps each element of the leaf under
    plan ``pl``: rows walked by the grid's blocks y in strides of its
    height, each row as :func:`_row_steps` steps it (a row's split
    depends on its base only through ``base % vec``)."""
    visits = np.zeros(pl.rows, np.int64)
    for y in range(min(pl.rows, GRID_Y)):
        visits[y::GRID_Y] += 1
    bases = np.arange(pl.rows) * pl.n_per_entity
    by_class = {c: _row_steps(pl, c) for c in np.unique(bases % pl.vec)}
    rows = np.stack([by_class[c] for c in bases % pl.vec])
    return (visits[:, None] * rows).ravel()


@pytest.mark.parametrize("inplace", [True, False], ids=["inplace", "copy"])
@pytest.mark.parametrize("offsets", list(OFFSETS), ids=list(OFFSETS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", list(SHAPES), ids=list(SHAPES))
def test_plan_covers_each_element_once(shape, dtype, offsets, inplace):
    dims, steps = SHAPES[shape]
    rows = dims[0] if steps is None or isinstance(steps, list) else 1
    n = int(np.prod(dims))
    spans = _spans(dtype, OFFSETS[offsets], inplace)
    pl = fa.plan(spans, dtype, n, rows)
    assert np.all(_stepped(pl) == 1)
    if pl.phase >= 0:
        assert all((a + pl.phase * s) % 16 == 0 for a, s in spans)
        assert 0 <= pl.phase < pl.vec
    # where the operands share a 16-byte element they take the vectors:
    # one element in everywhere is a common shift in place, but not
    # against the copy's aligned outputs
    vector = offsets == "aligned" or (inplace and offsets == "all one in")
    assert (pl.phase >= 0) == vector, pl
    assert pl.tiles == -(-pl.n_per_entity // pl.tile)


def test_plan_constants_are_the_kernels():
    src = (_build.CSRC / "fused_adam.cu").read_text()
    assert int(re.search(r"constexpr int kThreads = (\d+);", src)[1]) == (
        fa.THREADS)
    for ctype, dtype in (("float", torch.float32),
                         ("__nv_bfloat16", torch.bfloat16)):
        vec, unroll = re.search(
            rf"struct Width<{ctype}> {{\s*static constexpr int kVec = "
            rf"(\d+), kUnroll = (\d+);", src).groups()
        assert (int(vec), int(unroll)) == (fa.VEC[dtype], fa.UNROLL[dtype])
        assert fa.VEC[dtype] * torch.empty((), dtype=dtype).element_size() \
            == 16


def _operands(shape, steps, dtype):
    p = torch.from_numpy(RNG.normal(size=shape).astype(np.float32)).to(dtype)
    g = torch.from_numpy(RNG.normal(size=shape).astype(np.float32)).to(dtype)
    m = torch.from_numpy((RNG.normal(size=shape) * 0.1).astype(np.float32))
    v = torch.from_numpy(np.abs(RNG.normal(size=shape) * 0.1)
                         .astype(np.float32))
    return p, g, m, v, torch.tensor(steps, dtype=torch.int32)


def _one_in(t):
    buf = torch.empty(t.numel() + 1, dtype=t.dtype)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", ["one element", "entities of 5",
                                   "entities of 1001"])
def test_entries_take_views_one_element_in(shape, dtype):
    dims, steps = SHAPES[shape]
    p, g, m, v, step = _operands(dims, steps, dtype)
    want = ops.fused_adam(p, g, m, v, step, **KW)
    po, go, mo, vo = (_one_in(t) for t in (p, g, m, v))
    assert po.is_contiguous() and po.data_ptr() % 16 != 0
    got = ops.fused_adam(po, go, mo, vo, step, **KW)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    res = ops.fused_adam_(po, go, mo, vo, step, **KW)
    assert res[0] is po and res[1] is mo and res[2] is vo
    assert all(torch.equal(a, b) for a, b in zip(res, want))


@pytest.mark.parametrize("pair", ["p g", "m v", "p m", "g v", "v keep",
                                  "one element of m in v"])
def test_check_inplace_refuses_shared_bytes(pair):
    n = 12
    buf = torch.zeros(4 * n)
    p, g, m, v = buf[:n], buf[n:2 * n], buf[2 * n:3 * n], buf[3 * n:]
    step = torch.zeros((), dtype=torch.int32)
    keep = None
    if pair == "p g":
        g = p
    elif pair == "m v":
        v = m
    elif pair == "p m":
        m = buf[n // 2:n // 2 + n]
    elif pair == "g v":
        v = buf[n + 1:2 * n + 1]
    elif pair == "v keep":
        keep = torch.ones((), dtype=torch.int32)
        step = keep
    else:
        v = buf[3 * n - 1:4 * n - 1]
    with pytest.raises(ValueError, match="overlap"):
        fa._check_inplace(p, g, m, v, step, keep)


def test_check_inplace_takes_neighbours_in_one_buffer():
    n = 12
    buf = torch.zeros(4 * n)
    p, g, m, v = buf[:n], buf[n:2 * n], buf[2 * n:3 * n], buf[3 * n:]
    fa._check_inplace(p, g, m, v, torch.zeros((), dtype=torch.int32), None)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_port_kernels_name_every_global_function():
    cs = _chip_smoke()
    names = cs.port_kernels()
    total = sum((_build.CSRC / f"{s}.cu").read_text().count("__global__")
                for s in _build.SOURCES)
    assert len(names) == len(set(names)) == total
    assert {"fused_adam_kernel", "gather_rows_kernel", "gather_loss_kernel",
            "flash_fwd_kernel", "flash_wgmma_kernel", "topk_gating_kernel",
            "ssd_scan_kernel", "ssd_wgmma_kernel"} == set(names)
    # the profiler's names of both entries, bf16 and f32
    for dtype in ("float", "__nv_bfloat16"):
        for inplace in ("true", "false"):
            n = (f"void (anonymous namespace)::fused_adam_kernel<{dtype}, "
                 f"{inplace}>((anonymous namespace)::Operands<{dtype}>, "
                 f"long, long, int, (anonymous namespace)::Hyper)")
            assert cs.port_kernel_of(n, names) == "fused_adam_kernel"
    assert cs.port_kernel_of("ampere_sgemm_128x64_nn", names) is None
