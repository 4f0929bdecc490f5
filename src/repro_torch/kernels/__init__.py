"""Hand-written Hopper kernels for the training round's hot spots.

Layout:
  csrc/<name>.cu — CUDA C++ for sm_90a with a plain C entry point
  <name>.py      — the ctypes-bound wrapper and its launch counter
  _build.py      — builds csrc/ with nvcc at first use
  ops.py         — public entry points (device-dispatched)
  ref.py         — plain PyTorch versions the tests hold the kernels to

Kernels:
  feature_resample — CycleSL resampling gather (one block per row)
  fused_adam       — one-pass Adam step with a device step counter
  gather_loss      — fused gather + linear-head cross-entropy
  flash_attention  — full-sequence attention, online softmax (forward)
  topk_gating      — MoE router softmax + top-k + renormalization
"""
