"""Device kernels beside the plain XLA path.

- ``ntt_gpu``: the row-fused negacyclic NTT/INTT for NVIDIA GPUs (Pallas,
  Triton route), dispatched by core/ntt.py when the backend is a GPU.
- ``ntt_mxu``: the opt-in digit-plane four-step NTT on matrix units (plain
  XLA).
"""
