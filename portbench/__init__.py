"""The benchmark of yolo2_light_tpu_torch, the PyTorch/CUDA port: a harness
driven by ``BENCHMARK.json`` at the root of the checkout (``run.py``)."""
