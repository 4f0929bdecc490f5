"""The flash_attention wrapper's routing and layout contract, and the
kernel build's content hash.

On a CUDA tensor the wrapper takes the tensor-core kernel (``wgmma``) or
the CUDA-core kernel (``simt``) by ``design``, and the tensor-core
kernel's 16-byte copies need aligned rows, which the wrapper checks and
refuses with ValueError (never a fallback).  Both are pure Python and
run here; the kernels themselves run only on the card (chip_smoke.py).
The parity of the function with the JAX kernel is held in
tests/test_torch_kernels.py.
"""
import shutil

import pytest
import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa
from torch_threads import one_thread  # noqa: F401


@pytest.mark.parametrize("dtype,head_dim,want", [
    (torch.bfloat16, 64, "wgmma"),      # zamba2-1.2b's shared block
    (torch.bfloat16, 128, "wgmma"),     # olmoe-1b-7b
    (torch.bfloat16, 96, "simt"),       # phi3-mini-3.8b: 64-col blocks
    (torch.bfloat16, 256, "simt"),      # gemma2-2b: tiles too large
    (torch.bfloat16, 32, "simt"),       # whisper-base's smoke config
    (torch.float32, 32, "simt"),
    (torch.float32, 64, "simt"),        # float32 products stay exact
    (torch.float32, 96, "simt"),
    (torch.float32, 128, "simt"),
    (torch.float32, 256, "simt"),
])
def test_design_routes_by_dtype_and_head_dim(dtype, head_dim, want):
    assert fa.design(dtype, head_dim) == want


@pytest.mark.parametrize("dtype,head_dim,exc", [
    (torch.bfloat16, 48, ValueError),
    (torch.bfloat16, 80, ValueError),
    (torch.float32, 512, ValueError),
    (torch.float16, 64, TypeError),
])
def test_design_refuses_what_has_no_kernel(dtype, head_dim, exc):
    with pytest.raises(exc):
        fa.design(dtype, head_dim)


# every config the port runs that has attention (mamba2 has none;
# whisper-base's bf16 heads of 64 take the tensor-core design)
ATTENTION_ARCHS = [a for a in list_archs() if get_config(a).family != "ssm"]


@pytest.mark.parametrize("arch", ATTENTION_ARCHS)
def test_every_registered_config_has_a_kernel_for_its_heads(arch):
    cfg = get_config(arch)
    assert fa.design(cfg.torch_dtype, cfg.hd) in fa._DESIGNS


def test_every_design_has_a_counter_and_a_code():
    assert set(fa.design_launches) == set(fa._DESIGNS) == {"wgmma", "simt"}


@pytest.mark.parametrize("layout", ["contiguous", "fused-qkv", "gqa-kv"])
def test_wgmma_layout_takes_the_paths_tensors(layout):
    if layout == "contiguous":
        t = torch.zeros(2, 16, 4, 128, dtype=torch.bfloat16)
    elif layout == "fused-qkv":     # [B, S, 3, H, D], sliced
        t = torch.zeros(2, 16, 3, 4, 64, dtype=torch.bfloat16)[:, :, 2]
    else:
        t = torch.zeros(2, 16, 1, 64, dtype=torch.bfloat16)
    fa.check_wgmma_layout("q", t)


@pytest.mark.parametrize("case", ["head-stride", "seq-stride",
                                  "batch-stride", "base"])
def test_wgmma_layout_refuses_misaligned_rows(case):
    buf = torch.zeros(2 * 16 * 4 * 128 + 8, dtype=torch.bfloat16)
    if case == "head-stride":       # 68 elements: 136 bytes a head
        t = buf[:2 * 16 * 4 * 68].view(2, 16, 4, 68)[..., :64]
    elif case == "seq-stride":      # heads packed, 4 * 64 + 4 a position
        t = buf[:2 * 16 * 260].view(2, 16, 260)[:, :, :256].unflatten(
            2, (4, 64))
    elif case == "batch-stride":    # 16 positions packed, + 4 a batch
        t = buf[:2 * 4100].view(2, 4100)[:, :4096].unflatten(1, (16, 4, 64))
    else:                           # 2 bytes past a 16-byte boundary
        t = buf[1:1 + 2 * 16 * 4 * 64].view(2, 16, 4, 64)
    with pytest.raises(ValueError, match="tensor-core kernel"):
        fa.check_wgmma_layout("q", t)


def test_build_hash_covers_shared_headers(tmp_path, monkeypatch):
    """An edited header under csrc/ renames every library (so a stale one
    is never loaded), as an edited source renames its own."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    headers = sorted(csrc.glob("*.cuh"))
    assert headers, "the kernels share a header"
    before = {n: _build._target(n) for n in _build.SOURCES}
    assert before == {n: _build._target(n) for n in _build.SOURCES}
    headers[0].write_text(headers[0].read_text() + "\n// edited\n")
    after = {n: _build._target(n) for n in _build.SOURCES}
    assert all(after[n] != before[n] for n in _build.SOURCES)
    (csrc / "extra.cuh").write_text("#pragma once\n")
    added = {n: _build._target(n) for n in _build.SOURCES}
    assert added["flash_attention"] != after["flash_attention"]
    src = csrc / "ssd_scan.cu"
    src.write_text(src.read_text() + "\n")
    assert _build._target("ssd_scan") != added["ssd_scan"]
    assert _build._target("flash_attention") == added["flash_attention"]
