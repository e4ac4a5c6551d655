"""PyTorch/CUDA port of yolo2_light_tpu for NVIDIA Hopper (H100).

The JAX package ``yolo2_light_tpu`` stays the reference. This package carries
its own copies of the JAX package's pure-NumPy host code (``cfg``, ``tree``,
``datacfg``, ``weights``, ``quant``, ``native``, ``io.image``,
``post.boxes``, ``utils.crand``) and replaces its device code: PyTorch ops
for what the JAX package left to XLA, and hand-written CUDA kernels
(``csrc/``) for its Pallas kernels. It imports neither JAX nor anything of
the JAX package.
"""
