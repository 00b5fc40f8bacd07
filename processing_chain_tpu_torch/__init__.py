"""PyTorch/CUDA port of the processing chain for NVIDIA Hopper (H100).

The JAX package `processing_chain_tpu` is the reference; this package
mirrors its layout and names where a reader looks for the counterpart,
imports `torch` and never `jax`, and shares no code with the reference
package (what it needs of the jax-free host modules it carries as its own
copy). Entry points run on `cuda:0` unless the caller passes a device.

Ported so far: the p03 AVPVS device render (canvas resize of Y/U/V,
container-depth quantize, per-frame SI/TI sidecar), the batched wave
render on one device (parallel/p03_batch.run_bucket), the flagship step
(parallel/pipeline.avpvs_siti_step), the stalling pass and the device
half of p04 (ops/overlay, models/cpvs, models/fused), the device halves
of p01 and the tools, and the chain-serve daemon with its wave executor
(serve/, store/, `python -m processing_chain_tpu_torch tools
chain-serve`), with a hand-written CUDA kernel for each of the five TPU
kernels (ops/cuda_kernels.py).
"""

#: the fallback chain version when neither `git describe` nor VERSION
#: answers (the reference package's, so plan hashes agree)
__version__ = "0.1.0"
