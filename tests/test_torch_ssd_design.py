"""The ssd_scan wrapper's routing and layout contract, and a CPU
rehearsal of the tensor-core kernel's precision plan.

On a CUDA tensor the wrapper takes the tensor-core kernel (``wgmma``) or
the CUDA-core kernel (``simt``) by ``design``, and the tensor-core
kernel's 16-byte copies need aligned rows, which the wrapper checks and
refuses with ValueError (never a fallback).  Both are pure Python and
run here; the kernels run only on the card (chip_smoke.py).

The tensor-core kernel multiplies bf16 operands into float32
accumulators.  C, B and x are bf16 already, but three operands are
float32: the intra-tile weights W = (C B^T) o exp(cum_i - cum_j) dt_j,
B o u with u_j = dt_j exp(cum_last - cum_j), and the carried state h.
The kernel splits each into hi = bf16(v) and lo = bf16(v - hi) and
takes two products.  The rehearsal repeats that arithmetic a 64-row
tile at a time in plain torch and holds it to chip_smoke.py's bf16
criterion against the plain version, ``ref.ssd_chunked``: y within one
bf16 ulp (or 1e-4 of max|y, h| near zero), the float32 final state
within 1e-4 of max|y, h|.  Rounding the three operands to bf16 alone
fails that criterion, which the last test shows.  The parity of the
function with the JAX kernel is held in tests/test_torch_ssm.py.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import get_config
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as ssd
from torch_threads import one_thread  # noqa: F401

QT = 64                 # the kernel's rows per tile
REL = 1e-4              # chip_smoke.SSD_F32_REL


@pytest.mark.parametrize("dtype,N,P,want", [
    (torch.bfloat16, 64, 64, "wgmma"),      # zamba2-1.2b
    (torch.bfloat16, 128, 64, "wgmma"),     # mamba2-2.7b
    (torch.float32, 64, 64, "simt"),        # float32 products stay exact
    (torch.float32, 128, 64, "simt"),
    (torch.bfloat16, 32, 64, "simt"),       # no tensor-core instance
    (torch.bfloat16, 64, 48, "simt"),
    (torch.bfloat16, 20, 48, "simt"),
])
def test_design_routes_by_dtype_and_shape(dtype, N, P, want):
    assert ssd.design(dtype, N, P) == want


@pytest.mark.parametrize("dtype,N,exc", [
    (torch.float16, 64, TypeError),
    (torch.bfloat16, 0, ValueError),
    (torch.bfloat16, 256, ValueError),
    (torch.float32, 129, ValueError),
])
def test_design_refuses_what_has_no_kernel(dtype, N, exc):
    with pytest.raises(exc):
        ssd.design(dtype, N, 64)


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "mamba2-2.7b"])
def test_the_paths_scans_take_the_tensor_cores(arch):
    cfg = get_config(arch)
    assert ssd.design(cfg.torch_dtype, cfg.ssm.d_state,
                      cfg.ssm.head_dim) == "wgmma"


def test_every_design_has_a_counter_and_a_code():
    assert set(ssd.design_launches) == set(ssd._DESIGNS) == {"wgmma", "simt"}


def _conv_slices(H, P, G, N, L=16):
    """x, B and C as the model passes them: column slices of one
    [B, L, H P + 2 G N] conv output."""
    flat = torch.zeros(2, L, H * P + 2 * G * N, dtype=torch.bfloat16)
    x, bm, cm = torch.split(flat, [H * P, G * N, G * N], dim=-1)
    return (x.unflatten(2, (H, P)), bm.unflatten(2, (G, N)),
            cm.unflatten(2, (G, N)))


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "mamba2-2.7b"])
def test_wgmma_layout_takes_the_paths_tensors(arch):
    s = get_config(arch).ssm
    H = s.expand * get_config(arch).d_model // s.head_dim
    for name, t in zip("xBC", _conv_slices(H, s.head_dim, s.n_groups,
                                           s.d_state)):
        ssd.check_wgmma_layout(name, t)


@pytest.mark.parametrize("case", ["row-stride", "head-stride",
                                  "batch-stride", "base"])
def test_wgmma_layout_refuses_misaligned_rows(case):
    buf = torch.zeros(2 * 16 * 4 * 72 + 8, dtype=torch.bfloat16)
    if case == "row-stride":        # 4 * 64 + 4 elements a position
        t = buf[:2 * 16 * 260].view(2, 16, 260)[:, :, :256].unflatten(
            2, (4, 64))
    elif case == "head-stride":     # 68 elements: 136 bytes a head
        t = buf[:2 * 16 * 4 * 68].view(2, 16, 4, 68)[..., :64]
    elif case == "batch-stride":    # 16 positions packed, + 4 a batch
        t = buf[:2 * 4100].view(2, 4100)[:, :4096].unflatten(1, (16, 4, 64))
    else:                           # 2 bytes past a 16-byte boundary
        t = buf[1:1 + 2 * 16 * 4 * 64].view(2, 16, 4, 64)
    with pytest.raises(ValueError, match="tensor-core kernel"):
        ssd.check_wgmma_layout("x", t)


# ------------------------------------------- the precision plan, on the CPU
def _inputs(N, decay, seed, B=2, L=256, H=4, P=64, G=1):
    """bf16 x, B, C ~ N(0, 1), dt = softplus(N(0, 1)), and A =
    -linspace(1, 16, H) or the slow decay -1e-3, as chip_smoke.py's
    ssd_checks draws them."""
    rng = np.random.default_rng(seed)
    bf = lambda *s: torch.from_numpy(
        rng.normal(size=s).astype(np.float32)).bfloat16()
    x, bm, cm = bf(B, L, H, P), bf(B, L, G, N), bf(B, L, G, N)
    dt = F.softplus(torch.from_numpy(
        rng.normal(size=(B, L, H)).astype(np.float32)))
    A = (-torch.linspace(1.0, 16.0, H) if decay == "fast"
         else torch.full((H,), -1e-3))
    return x, dt, A, bm, cm


def _split(v, lo=True):
    """float32 -> (hi, lo) bf16 values held in float32."""
    hi = v.bfloat16().float()
    return hi, (v - hi).bfloat16().float() if lo else torch.zeros_like(v)


def _tensor_core_arithmetic(x, dt, A, Bm, Cm, lo=True):
    """The wgmma kernel's arithmetic, one 64-row tile at a time: bf16 x
    bf16 products in float32, and W, B o u and h as hi/lo pairs (or as
    bf16 alone when ``lo`` is false)."""
    Bsz, L, H, P = x.shape
    rep, N = H // Bm.shape[2], Bm.shape[3]
    xf = x.float().permute(0, 2, 1, 3)                      # [B, H, L, P]
    bf = Bm.float().repeat_interleave(rep, 2).permute(0, 2, 1, 3)
    cf = Cm.float().repeat_interleave(rep, 2).permute(0, 2, 1, 3)
    dts = dt.permute(0, 2, 1)                               # [B, H, L]
    tri = torch.tril(torch.ones(QT, QT, dtype=torch.bool))
    h = torch.zeros(Bsz, H, N, P)
    ys = []
    for l0 in range(0, L, QT):
        xt, bt, ct, d = (t[:, :, l0:l0 + QT] for t in (xf, bf, cf, dts))
        cum = torch.cumsum(d * A[:, None], dim=-1)
        last = cum[..., -1:]
        diff = cum[..., :, None] - cum[..., None, :]
        w = torch.where(tri, ct @ bt.transpose(-1, -2)
                        * torch.exp(torch.where(tri, diff, 0.0))
                        * d[..., None, :], 0.0)
        z = sum(ct @ part for part in _split(h, lo))
        y = torch.exp(cum)[..., None] * z
        ys.append(y + sum(part @ xt for part in _split(w, lo)))
        bu = bt * (d * torch.exp(last - cum))[..., None]
        h = (torch.exp(last)[..., None] * h
             + sum(part.transpose(-1, -2) @ xt for part in _split(bu, lo)))
    return torch.cat(ys, 2).permute(0, 2, 1, 3).to(x.dtype), h


def _meets_bf16_check(got, want):
    """chip_smoke.py's criterion for a bf16 ssd_scan call: the bf16 y
    within one bf16 ulp of the plain version's (or 1e-4 of max|y, h|),
    the float32 state within 1e-4 of max|y, h|."""
    tol = REL * max(float(w.float().abs().max()) for w in want)
    (gy, gh), (wy, wh) = got, want
    _, e = torch.frexp(wy.float())
    ulp = torch.where(wy == 0, 0.0, torch.exp2(e.double() - 8))
    y_ok = bool(((gy.double() - wy.double()).abs()
                 <= torch.clamp(ulp, min=tol)).all())
    return y_ok, float((gh.double() - wh.double()).abs().max()) <= tol


@pytest.mark.parametrize("decay", ["fast", "slow"])
@pytest.mark.parametrize("N", [64, 128])
def test_split_bf16_products_meet_the_bf16_check(N, decay):
    x, dt, A, bm, cm = _inputs(N, decay, seed=N)
    want = ref.ssd_chunked(x, dt, A, bm, cm, 64)
    assert _meets_bf16_check(_tensor_core_arithmetic(x, dt, A, bm, cm),
                             want) == (True, True)


@pytest.mark.parametrize("N", [64, 128])
def test_bf16_operands_alone_fail_the_bf16_check(N):
    """At the slow decay the state sums ~256 rows' updates, so its
    rounding shows in the state as well as in y."""
    x, dt, A, bm, cm = _inputs(N, "slow", seed=N)
    want = ref.ssd_chunked(x, dt, A, bm, cm, 64)
    got = _tensor_core_arithmetic(x, dt, A, bm, cm, lo=False)
    assert _meets_bf16_check(got, want) == (False, False)
