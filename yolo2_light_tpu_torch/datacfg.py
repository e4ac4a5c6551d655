# Mirrors yolo2_light_tpu/datacfg.py: a copy, so that the port imports
# nothing of the JAX package.
"""``.data`` dataset-descriptor and ``.names`` file readers.

Reference: read_data_cfg / option_find_* (src/additionally.c:3260-3398); names loading
in run_detector (src/main.c:608-620).
"""

from __future__ import annotations


def read_data_cfg(path: str) -> dict:
    """key=value file with #-comments (reference: read_data_cfg,
    src/additionally.c:3301-3327)."""
    opts = {}
    with open(path) as f:
        for raw in f:
            line = "".join(ch for ch in raw if ch not in " \t\n\r")
            if not line or line[0] in "#;":
                continue
            if "=" in line:
                k, _, v = line.partition("=")
                opts[k] = v
    return opts


def load_names(path: str) -> list:
    """One class name per line (reference: src/main.c:608-620 fgetl loop)."""
    with open(path) as f:
        return [line.rstrip("\n\r") for line in f if line.rstrip("\n\r") != ""]
