"""PyTorch/CUDA port of the processing chain for NVIDIA Hopper (H100).

The JAX package `processing_chain_tpu` is the reference; this package
mirrors its layout and names where a reader looks for the counterpart,
imports `torch` and never `jax`, and shares no code with the reference
package (what it needs of the jax-free host modules it carries as its own
copy). Entry points run on `cuda:0` unless the caller passes a device.

Ported so far: the p03 AVPVS device render — canvas resize of Y/U/V,
container-depth quantize, per-frame SI/TI sidecar — with hand-written
CUDA kernels for the three TPU kernels on that path (ops/cuda_kernels.py).
"""
