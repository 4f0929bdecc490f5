"""The launch plans of the topk_gating and gather_loss kernels, their C
entry points as the wrappers call them, and a CPU rehearsal of both
kernels' arithmetic.

Both kernels run only on the card (chip_smoke.py).  What surrounds them
is plain Python and runs here: how many lanes a router row takes, the
gather_loss launch shape (class tile, row tiles, cluster size, kept to
one wave) and the bytes of a copy, and the ctypes argument lists against
the C signatures in csrc/.

The rehearsals repeat, in plain torch, the arithmetic the kernels do in
another order than the plain versions:

- topk_gating packs each probability p >= +0 into one 64-bit key,
  (bits(p) << 32) | ~index, sorts a lane's 8 keys with the network
  written in csrc/topk_gating.cu, and takes k rounds of the maximum of
  the lanes' heads.  The rehearsal holds its ids exactly equal to
  ``ref.topk_gating_ref``'s (ties, rows all equal, probabilities that
  underflow to +0) and its weights within 1e-6.
- gather_loss sums a row's logits as partials over the D slices of a
  cluster's ranks and the D steps of a block's warps, then folds class
  tiles of at most 64 into a running log-sum-exp.  The rehearsal holds
  that to ``ref.gather_loss_microbatch_ref`` within 1e-6.
"""
import ctypes
import itertools
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels import gather_loss as gl
from repro_torch.kernels import topk_gating as tk
from torch_threads import one_thread  # noqa: F401

RNG = np.random.default_rng(17)
LANE = 8                 # experts a lane owns (csrc/topk_gating.cu)
BD, STEPS, WARPS = 128, 4, 8  # gather_loss: D a chunk, 4-wide steps a warp


# ------------------------------------------------------------ launch plans
@pytest.mark.parametrize("E,lanes", [(1, 1), (4, 1), (8, 1), (9, 2), (16, 2),
                                     (32, 4), (60, 8), (64, 8), (65, 16),
                                     (128, 16), (200, 32), (256, 32)])
def test_lanes_per_row_gives_each_lane_at_most_eight_experts(E, lanes):
    assert tk.lanes_per_row(E) == lanes
    assert E <= lanes * LANE and (lanes == 1 or lanes // 2 * LANE < E)


@pytest.mark.parametrize("E", [0, 257])
def test_lanes_per_row_refuses_what_has_no_kernel(E):
    with pytest.raises(ValueError):
        tk.lanes_per_row(E)


@pytest.mark.parametrize("K,tile", [(1, 16), (10, 16), (16, 16), (17, 32),
                                    (62, 64), (64, 64), (65, 64), (300, 64)])
def test_class_tile_is_the_smallest_that_holds_k_at_most_64(K, tile):
    assert gl.class_tile(K) == tile


# the H100's answers for one block an SM (132 SMs): clusters of c blocks
# the card holds at once (chip_smoke.py prints them)
H100 = {1: 132, 2: 66, 4: 30, 8: 15}


@pytest.mark.parametrize("M,D,K,want", [
    (16, 2048, 10, dict(row_tiles=1, k_tile=16, cluster=8)),     # femnist
    (2048, 2048, 62, dict(row_tiles=64, k_tile=64, cluster=2)),  # large
    (200, 512, 300, dict(row_tiles=7, k_tile=64, cluster=4)),
    (1, 256, 62, dict(row_tiles=1, k_tile=64, cluster=2)),       # 2 chunks
    (1, 96, 62, dict(row_tiles=1, k_tile=64, cluster=1)),        # 1 chunk
    (19, 33, 7, dict(row_tiles=1, k_tile=16, cluster=1)),        # 1 chunk
    (8192, 2048, 10, dict(row_tiles=256, k_tile=16, cluster=1)),
])
def test_launch_shape_fills_the_card_in_one_wave(M, D, K, want):
    shape = gl.launch_shape(M, D, K, 132, H100.__getitem__)
    assert shape == want
    c = shape["cluster"]
    assert shape["row_tiles"] * c <= 132 or c == 1
    assert shape["row_tiles"] <= H100[c] or c == 1
    assert c <= -(-D // BD)          # every rank keeps a chunk of D


def test_launch_shape_without_an_occupancy_answer_counts_sms_alone():
    # 64 row tiles x 4 fit 132 SMs by count, but not 30 clusters of 4
    assert gl.launch_shape(2048, 2048, 62, 264)["cluster"] == 4
    assert gl.launch_shape(2048, 2048, 62, 264, H100.__getitem__
                           )["cluster"] == 2


@pytest.mark.parametrize("shape,dtype,offset,want", [
    ((8, 2048), torch.float32, 0, 16),
    ((8, 1000), torch.float32, 0, 16),
    ((8, 10), torch.float32, 0, 8),      # 40-byte rows
    ((8, 7), torch.float32, 0, 4),
    ((8, 62), torch.float32, 0, 8),
    ((8, 64), torch.float32, 1, 4),      # base 4 bytes past a 16
    ((8, 64), torch.bfloat16, 0, 16),
    ((8, 10), torch.bfloat16, 0, 4),
    ((8, 33), torch.bfloat16, 0, 2),     # odd bf16 rows: plain loads
])
def test_copy_bytes_never_straddle_a_row(shape, dtype, offset, want):
    base = torch.zeros(shape[0] * shape[1] + 16, dtype=dtype)
    t = base[offset:offset + shape[0] * shape[1]].view(shape)
    got = gl.copy_bytes(t)
    assert got == want
    assert (shape[1] * t.element_size()) % got == 0
    assert t.data_ptr() % got == 0


def _c_params(name: str, source: str) -> list:
    """The parameter types of ``extern "C" int name(...)`` in csrc."""
    text = (_build.CSRC / f"{source}.cu").read_text()
    m = re.search(r'extern "C" int ' + name + r"\((.*?)\)\s*\{", text, re.S)
    assert m, name
    kinds = []
    for p in m.group(1).split(","):
        p = " ".join(p.split())
        kinds.append("p" if "*" in p else "i64" if "int64_t" in p else "i")
    return kinds


@pytest.mark.parametrize("name,source,argtypes", [
    ("topk_gating_launch", "topk_gating", tk._ARGTYPES),
    ("gather_loss_launch", "gather_loss", gl._ARGTYPES),
    ("gather_loss_max_clusters", "gather_loss", [ctypes.c_int] * 4),
])
def test_ctypes_argtypes_match_the_c_entry_points(name, source, argtypes):
    kind = {ctypes.c_void_p: "p", ctypes.c_int64: "i64", ctypes.c_int: "i"}
    assert [kind[a] for a in argtypes] == _c_params(name, source)


# ------------------------------------------------- topk_gating rehearsal
def _network() -> list:
    """The compare-exchange pairs of sort8 in csrc/topk_gating.cu."""
    text = (_build.CSRC / "topk_gating.cu").read_text()
    body = text[text.index("void sort8("):]
    body = body[:body.index("}")]
    return [(int(a), int(b)) for a, b in
            re.findall(r"cas\(k\[(\d)\], k\[(\d)\]\)", body)]


def test_sort_network_sorts_every_input_of_eight():
    pairs = _network()
    assert len(pairs) == 19
    for bits in itertools.product((0, 1), repeat=8):   # the 0-1 principle
        a = list(bits)
        for i, j in pairs:
            if a[i] < a[j]:
                a[i], a[j] = a[j], a[i]
        assert a == sorted(bits, reverse=True)


def _keys(probs: torch.Tensor) -> torch.Tensor:
    """(bits(p) << 32) | ~index as the kernel packs them, in int64 (a
    probability's bits are below 2^31, so the key is non-negative)."""
    E = probs.shape[-1]
    bits = probs.contiguous().view(torch.int32).to(torch.int64)
    low = (~torch.arange(E, dtype=torch.int64)) & 0xFFFFFFFF
    return (bits << 32) | low


def emulate_topk(logits: torch.Tensor, k: int):
    """The kernel's arithmetic: softmax as exp(x - max) / sum, a row's E
    experts dealt to lanes of 8 (dead slots key 0), each lane's keys
    sorted by the network, then k rounds of the largest head."""
    T, E = logits.shape
    lanes = tk.lanes_per_row(E)
    x = logits.float()
    e = torch.exp(x - x.max(-1, keepdim=True).values)
    p = e / e.sum(-1, keepdim=True)
    keys = torch.zeros((T, lanes * LANE), dtype=torch.int64)
    keys[:, :E] = _keys(p)
    keys = keys.view(T, lanes, LANE).clone()
    for i, j in _network():
        hi = torch.maximum(keys[..., i], keys[..., j])
        lo = torch.minimum(keys[..., i], keys[..., j])
        keys[..., i], keys[..., j] = hi, lo
    rows = torch.arange(T)
    won = []
    for _ in range(k):
        heads = keys[..., 0]
        best, lane = heads.max(-1)
        keys[rows, lane] = torch.cat(
            [keys[rows, lane, 1:], torch.zeros((T, 1), dtype=torch.int64)], 1)
        won.append(best)
    won = torch.stack(won, -1)
    w = (won >> 32).to(torch.int32).view(torch.float32)
    ids = (~(won & 0xFFFFFFFF)) & 0xFFFFFFFF
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    return w, ids.to(torch.int32)


def _logits(T, E, kind):
    if kind == "tied":
        return torch.from_numpy(
            RNG.integers(-2, 3, size=(T, E)).astype(np.float32))
    if kind == "equal":
        return torch.full((T, E), 0.75)
    if kind == "underflow":
        return torch.from_numpy(
            (RNG.normal(size=(T, E)) * 200).astype(np.float32))
    return torch.from_numpy(RNG.normal(size=(T, E)).astype(np.float32))


@pytest.mark.parametrize("E,k", [(4, 1), (4, 4), (7, 7), (8, 2), (60, 6),
                                 (64, 8), (64, 64), (256, 8), (256, 256)])
@pytest.mark.parametrize("kind", ["randn", "tied", "equal", "underflow"])
def test_packed_key_rounds_give_the_plain_versions_ids(E, k, kind):
    x = _logits(37, E, kind)
    w, ids = emulate_topk(x, k)
    w_ref, ids_ref = ref.topk_gating_ref(x, k)
    assert torch.equal(ids, ids_ref)
    torch.testing.assert_close(w, w_ref, rtol=0, atol=1e-6)


def test_underflowed_probabilities_still_order_by_index():
    x = torch.tensor([[0.0, -200.0, -300.0, -150.0, 5.0, -400.0, -120.0,
                       -90.0]])
    probs = torch.softmax(x, -1)
    assert int((probs == 0).sum()) >= 4            # several underflow to +0
    _, ids = emulate_topk(x, 8)
    _, ids_ref = ref.topk_gating_ref(x, 8)
    assert torch.equal(ids, ids_ref)
    zeros = [i for i in ids[0].tolist() if probs[0, i] == 0]
    assert zeros == sorted(zeros)                  # ties to the lower index


def test_a_taken_key_lies_below_every_live_one():
    keys = _keys(torch.tensor([[0.0, 0.0, 1e-45, 0.5]]))
    assert bool((keys > 0).all())                  # +0 too stays above 0
    assert keys[0, 0] > keys[0, 1]                 # equal p: lower index


def test_bf16_logits_rehearse_like_their_float32_values():
    x = _logits(33, 16, "tied").to(torch.bfloat16)
    w, ids = emulate_topk(x, 16)
    w_ref, ids_ref = ref.topk_gating_ref(x, 16)
    assert torch.equal(ids, ids_ref)
    torch.testing.assert_close(w, w_ref, rtol=0, atol=1e-6)


# ------------------------------------------------- gather_loss rehearsal
def emulate_gather_loss(src, labels, idx, w, b, cluster, k_tile):
    """The kernel's sums: D in chunks of 128 dealt to the cluster's ranks
    as contiguous runs, each chunk's 4-wide steps to the 8 warps (steps
    w + 8 h, h < 4), the warps' partials summed in warp order, the ranks'
    in rank order; then class tiles folded into a running max and a
    rescaled sum of exponentials."""
    f = torch.index_select(src, 0, idx).float()
    wf = w.float()
    M, D = f.shape
    K = wf.shape[1]
    nch = -(-D // BD)
    ranks = []
    for r in range(cluster):
        lo, hi = r * nch // cluster, (r + 1) * nch // cluster
        warps = torch.zeros((WARPS, M, K))
        for c in range(lo, hi):
            for wp in range(WARPS):
                for h in range(STEPS):
                    d0 = c * BD + 4 * (wp + WARPS * h)
                    d1 = min(d0 + 4, D)
                    if d0 < D:
                        warps[wp] += f[:, d0:d1] @ wf[d0:d1]
        blk = warps[0].clone()
        for wp in range(1, WARPS):
            blk += warps[wp]
        ranks.append(blk)
    logits = ranks[0].clone()
    for r in range(1, cluster):
        logits += ranks[r]
    if b is not None:
        logits = logits + b.float()
    y = torch.index_select(labels, 0, idx).long()
    m = torch.full((M,), -float("inf"))
    s = torch.zeros(M)
    pick = torch.zeros(M)
    for k0 in range(0, K, k_tile):
        v = logits[:, k0:k0 + k_tile]
        m_new = torch.maximum(m, v.max(-1).values)
        s = s * torch.exp(m - m_new) + torch.exp(v - m_new[:, None]).sum(-1)
        m = m_new
        inside = (y >= k0) & (y < k0 + v.shape[1])
        pick = torch.where(inside, v.gather(1, (y - k0).clamp(0, v.shape[1] - 1
                                                            )[:, None])[:, 0],
                           pick)
    return -((pick - m) - torch.log(s))


@pytest.mark.parametrize("T,D,K,M", [(80, 512, 10, 16), (64, 100, 7, 33),
                                     (40, 130, 62, 1), (50, 200, 300, 20),
                                     (33, 65, 129, 17)])
@pytest.mark.parametrize("bias", [False, True])
def test_split_d_partials_and_tiled_logsumexp_match_the_plain_version(
        T, D, K, M, bias):
    # logits of a few units, as a trained head gives: float32 keeps the
    # losses to ~1e-7 whatever the order of the sums
    src = torch.from_numpy(RNG.normal(size=(T, D)).astype(np.float32)) * 0.3
    w = torch.from_numpy(RNG.normal(size=(D, K)).astype(np.float32)) * 0.1
    labels = torch.from_numpy(RNG.integers(0, K, size=T))
    idx = torch.from_numpy(RNG.integers(0, T, size=M).astype(np.int32))
    b = torch.from_numpy(RNG.normal(size=(K,)).astype(np.float32)) if bias \
        else None
    shape = gl.launch_shape(M, D, K, 132, H100.__getitem__)
    want = ref.gather_loss_microbatch_ref(src, labels, idx, w, b)
    for cluster in sorted({1, shape["cluster"]}):
        got = emulate_gather_loss(src, labels, idx, w, b, cluster,
                                  shape["k_tile"])
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_dropping_a_ranks_slice_or_the_rescale_is_caught():
    """The rehearsal is sharp: losing one rank's partials, or folding a
    class tile without rescaling the running sum, moves the loss far past
    the 1e-6 the whole arithmetic keeps."""
    T, D, K, M = 40, 1024, 130, 24
    src = torch.from_numpy(RNG.normal(size=(T, D)).astype(np.float32))
    w = torch.from_numpy(RNG.normal(size=(D, K)).astype(np.float32)) * 0.3
    labels = torch.from_numpy(RNG.integers(0, K, size=T))
    idx = torch.from_numpy(RNG.integers(0, T, size=M).astype(np.int32))
    want = ref.gather_loss_microbatch_ref(src, labels, idx, w)
    half = w.clone()
    half[D // 2:] = 0                           # rank 1 of 2 lost
    lost = emulate_gather_loss(src, labels, idx, half, None, 2, 64)
    assert float((emulate_gather_loss(src, labels, idx, w, None, 2, 64)
                  - want).abs().max()) < 1e-4
    assert float((lost - want).abs().max()) > 1e-2
    f = torch.index_select(src, 0, idx) @ w
    y = torch.index_select(labels, 0, idx)
    tiles = [f[:, k0:k0 + 64] for k0 in range(0, K, 64)]
    m = torch.stack([t.max(-1).values for t in tiles], -1).max(-1).values
    no_rescale = sum(torch.exp(t - t.max(-1, keepdim=True).values).sum(-1)
                     for t in tiles)
    wrong = -(f.gather(1, y[:, None])[:, 0] - m - torch.log(no_rescale))
    assert float((wrong - want).abs().max()) > 1e-2
