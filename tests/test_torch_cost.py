"""The port's work count (``repro_torch.utils.cost``) and the H100
roofline (``repro_torch.launch.roofline``).

``count`` is exact on a linear layer and a convolution, counts a loop's
trips and the backward pass, and counts each hand-written kernel's
wrapper once at ``kernel_cost`` with none of its plain version's ops;
``kernel_cost`` at ``chip_smoke.py``'s shapes gives the bound column
``PERF.md`` holds; ``model_flops`` is the reference's.
"""
import pytest
import torch
import torch.nn.functional as F

from repro.configs import INPUT_SHAPES as J_SHAPES
from repro.configs.registry import list_archs as j_archs
from repro.launch import roofline as j_roofline
from repro_torch.configs import INPUT_SHAPES, get_config, list_archs
from repro_torch.kernels import ops, ref
from repro_torch.launch import roofline
from repro_torch.utils.cost import count, kernel_cost
from torch_threads import one_thread  # noqa: F401


def _f32(*shape, device="cpu"):
    return torch.randn(*shape, generator=torch.Generator().manual_seed(0)
                       ).to(device)


def test_model_flops_match_the_reference():
    assert list_archs() == list(j_archs())
    assert list(INPUT_SHAPES) == list(J_SHAPES)
    for arch in list_archs():
        for shape in INPUT_SHAPES:
            assert roofline.model_flops(arch, shape) == \
                j_roofline.model_flops(arch, shape), (arch, shape)


def test_analyze_record_terms_on_a_hand_built_record():
    rec = {"status": "ok", "arch": "olmoe-1b-7b", "shape": "train_4k",
           "chips": 4, "fits": True,
           "cost": {"flops": 2e15, "traffic_bytes": 6.7e12,
                    "collective_bytes": 9e10,
                    "flops_by_dtype": {"bfloat16": 989e12 * 1.5,
                                       "float32": 67e12 * 0.25}}}
    a = roofline.analyze_record(rec)
    assert a["t_compute_s"] == pytest.approx(1.75)
    assert a["t_memory_s"] == pytest.approx(2.0)
    assert a["t_collective_s"] == pytest.approx(0.2)
    assert a["dominant"] == "memory" and a["roofline_s"] == pytest.approx(2.0)
    mf = roofline.model_flops("olmoe-1b-7b", "train_4k")
    assert a["useful_ratio"] == pytest.approx(mf / 8e15)
    assert a["fits"] is True and a["chips"] == 4
    assert roofline.analyze_record({**rec, "status": "error"}) is None
    assert roofline.mfu(989e12, 1.0) == pytest.approx(1.0)
    assert roofline.mfu(67e12, 2.0, chips=2, dtype=torch.float32) == \
        pytest.approx(0.25)


def test_count_is_exact_on_a_linear_layer_and_a_conv():
    x, w, b = _f32(8, 16), _f32(32, 16), _f32(32)
    c = count(F.linear, x, w, b)
    assert c.flops == 2 * 8 * 16 * 32
    assert c.traffic_bytes == 4 * (8 * 16 + 32 * 16 + 32 + 8 * 32)
    assert c.flops_by_dtype == {"float32": 2 * 8 * 16 * 32}
    x, w = _f32(2, 3, 10, 10), _f32(4, 3, 3, 3)
    c = count(F.conv2d, x, w, None, 1, 1)
    assert c.flops == 2 * (2 * 4 * 10 * 10) * (3 * 3 * 3)
    assert c.traffic_bytes == 4 * (x.numel() + w.numel() + 2 * 4 * 10 * 10)


def test_count_counts_a_loop_trip_by_trip_and_the_backward():
    x, w = _f32(8, 16), _f32(16, 16)

    def loop(x, k):
        for _ in range(k):
            x = x @ w
        return x

    one = count(loop, x, 1)
    assert one.flops == 2 * 8 * 16 * 16
    assert count(loop, x, 5).flops == 5 * one.flops
    assert count(loop, x, 5).traffic_bytes == 5 * one.traffic_bytes
    xg, wg = x.clone().requires_grad_(True), w.clone().requires_grad_(True)

    def fwd_bwd(x, w):
        (x @ w).sum().backward()

    # forward, and the gradients of x and w: three products of one size
    assert count(fwd_bwd, xg, wg).flops == 3 * one.flops


def _kernel_calls():
    """One call of each kernel's public entry point and the wrapper's
    (name, arguments, keywords) on the CPU, at small shapes."""
    g = torch.Generator().manual_seed(1)
    src = torch.randn(12, 3, 4, generator=g)
    idx = torch.tensor([0, 3, 3, 7, 11], dtype=torch.int32)
    labels = torch.randint(0, 5, (12,), generator=g)
    w = torch.randn(12, 5, generator=g)
    p, gr = torch.randn(6, 4, generator=g), torch.randn(6, 4, generator=g)
    m, v = torch.zeros(6, 4), torch.rand(6, 4, generator=g)
    step = torch.tensor(2, dtype=torch.int32)
    q = torch.randn(2, 16, 4, 8, generator=g)
    kv = torch.randn(2, 16, 2, 8, generator=g)
    logits = torch.randn(10, 8, generator=g)
    x = torch.randn(2, 16, 4, 8, generator=g)
    dt = torch.rand(2, 16, 4, generator=g)
    A = -torch.rand(4, generator=g)
    Bm, Cm = (torch.randn(2, 16, 1, 8, generator=g) for _ in range(2))
    flat = src.reshape(12, -1)
    return [
        (lambda: ops.resample_rows(src, idx),
         ("feature_resample", (flat, idx), {}),
         lambda: ref.feature_resample_ref(flat, idx)),
        (lambda: ops.gather_loss_microbatch(src, labels, idx, w),
         ("gather_loss", (flat, labels, idx, w, None), {}),
         lambda: ref.gather_loss_microbatch_ref(flat, labels, idx, w)),
        (lambda: ops.fused_adam(p, gr, m, v, step, lr=1e-3),
         ("fused_adam", (p, gr, m, v, step), {}),
         lambda: ref.fused_adam_ref(p, gr, m, v, step, lr=1e-3)),
        (lambda: ops.flash_attention(q, kv, kv, causal=True, window=5),
         ("flash_attention", (q, kv, kv), dict(causal=True, window=5)),
         lambda: ref.flash_attention_ref(q, kv, kv, causal=True, window=5)),
        (lambda: ops.topk_gating(logits, 3),
         ("topk_gating", (logits, 3), {}),
         lambda: ref.topk_gating_ref(logits, 3)),
        (lambda: ops.ssd_scan(x, dt, A, Bm, Cm, chunk=8),
         ("ssd_scan", (x, dt, A, Bm, Cm), dict(chunk=8)),
         lambda: ref.ssd_chunked(x, dt, A, Bm, Cm, 8)),
    ]


@pytest.mark.parametrize("i", range(6))
def test_each_kernel_is_counted_once_without_its_plain_ops(i):
    call, (name, args, kw), plain = _kernel_calls()[i]
    c = count(call)
    flops, nbytes, _ = kernel_cost(name, *args, data=False, **kw)
    assert c.by_kernel == {name: {"calls": 1, "flops": flops,
                                  "bytes": nbytes}}
    assert c.by_op == {}
    assert (c.flops, c.traffic_bytes) == (flops, nbytes)
    # the plain version alone runs aten ops, which count would otherwise
    # have added
    assert count(plain).by_op


def test_kernel_cost_counts_distinct_gathered_rows_from_data():
    src = torch.zeros(10, 4)
    idx = torch.tensor([1, 1, 1, 2], dtype=torch.int32)
    assert kernel_cost("feature_resample", src, idx)[1] == (2 + 4) * 16 + 16
    assert kernel_cost("feature_resample", src, idx, data=False)[1] == \
        (4 + 4) * 16 + 16
    with pytest.raises(KeyError):
        kernel_cost("conv", src)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _bound(name, *args, **kw):
    flops, nbytes, dtype = kernel_cost(name, *args, **kw)
    return f"{roofline.bound(nbytes, flops, dtype)[0]:.5f}"


def test_kernel_cost_reproduces_the_bound_column():
    """chip_smoke.py's phase 3 shapes (distinct gathered rows), printed
    as it prints them, against PERF.md's bound column."""
    bf = torch.bfloat16
    olmoe, whisper = get_config("olmoe-1b-7b"), get_config("whisper-base")
    zamba = get_config("zamba2-1.2b")
    i32 = dict(dtype=torch.int32)
    assert _bound("feature_resample", _meta(80, 3136),
                  _meta(16, **i32)) == "0.00012"
    assert _bound("feature_resample", _meta(4, 2048 * olmoe.d_model,
                                            dtype=bf),
                  _meta(2, **i32)) == "0.01002"
    step2 = _meta(2, **i32)
    adam = lambda *s: (_meta(*s, dtype=bf), _meta(*s, dtype=bf), _meta(*s),
                       _meta(*s), step2)
    mo = olmoe.moe
    assert _bound("fused_adam", *adam(2, olmoe.vocab_padded,
                                      olmoe.d_model)) == "1.35313"
    assert _bound("fused_adam", *adam(2, olmoe.cut_layers, mo.n_experts,
                                      olmoe.d_model,
                                      mo.d_ff_expert)) == "3.52572"
    assert _bound("gather_loss", _meta(8192, 2048),
                  _meta(8192, dtype=torch.int64), _meta(2048, **i32),
                  _meta(2048, 62)) == "0.00777"
    qkv = [_meta(2, 2048, 16, 128, dtype=bf)] * 3
    assert _bound("flash_attention", *qkv, causal=True) == "0.03476"
    enc = [_meta(2, 1500, whisper.n_heads, 64, dtype=bf)] * 3
    assert _bound("flash_attention", *enc, causal=False) == "0.00932"
    s = zamba.ssm
    H = s.expand * zamba.d_model // s.head_dim
    assert _bound("ssd_scan", _meta(2, 2048, H, s.head_dim, dtype=bf),
                  _meta(2, 2048, H), _meta(H),
                  _meta(2, 2048, s.n_groups, s.d_state, dtype=bf),
                  _meta(2, 2048, s.n_groups, s.d_state, dtype=bf),
                  chunk=s.chunk) == "0.02128"
    assert _bound("topk_gating", _meta(4096, 64), 8) == "0.00039"
