"""PyTorch/CUDA port of the ResiHP model stack for one NVIDIA H100.

`repro` (JAX, TPU) is the reference; this package mirrors its module paths and
function names. It imports `torch` and never `jax`, and nothing from `repro`:
the jax-free pieces it needs (configs, data packing, the Eq. 1 predictor) are
copied here. The one TPU kernel of the reference, packed flash attention, is a
hand-written CUDA kernel for sm_90a (`kernels/csrc/packed_flash_attn.cu`).

Covered so far: the serving path of dense attention LMs (packed prefill
through the kernel, greedy decode over a KV cache) and the forward pass and
loss used to time Eq. 1 micro-batches.
"""
