"""PyTorch/CUDA port of adversarialvlm_tpu for one NVIDIA H100 (Hopper, sm_90a).

The JAX package ``adversarialvlm_tpu`` stays the reference; this package mirrors its layout
(ops/, models/, processors/, attack/, data/, utils/, cli/) and imports nothing from it. Every
Pallas TPU kernel on the ported path is a hand-written CUDA kernel under ``csrc/``, built with
nvcc at first use.
"""
