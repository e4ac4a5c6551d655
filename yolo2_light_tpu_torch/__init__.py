"""PyTorch/CUDA port of yolo2_light_tpu for NVIDIA Hopper (H100).

The JAX package ``yolo2_light_tpu`` stays the reference; this package reuses
its pure-NumPy host code (cfg parsing, weights, quantization, decode, NMS,
image I/O) and replaces its device code: PyTorch ops for what the JAX package
left to XLA, and hand-written CUDA kernels (``csrc/``) for its Pallas kernels.
It imports no JAX, directly or through the reused modules.
"""
