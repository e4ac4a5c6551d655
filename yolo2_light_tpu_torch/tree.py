# Mirrors yolo2_light_tpu/tree.py: a copy, so that the port imports
# nothing of the JAX package.
"""YOLO9000 softmax-tree (class hierarchy) support.

Reference: read_tree (src/additionally.c:1895-1944), hierarchy_predictions
(src/additionally.c:1878-1893), softmax_tree grouping in the region forward
(src/yolov2_forward_network.c:494-508,556-563) and tree decode in
get_region_boxes_cpu (src/yolov2_forward_network.c:694-716).

Tree file format: one ``name parent_index`` line per class, children grouped
contiguously by parent; parent indices always precede their children.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Tree:
    n: int
    groups: int
    parent: tuple          # [n] parent index or -1
    group: tuple           # [n] group id per node
    group_size: tuple      # [groups]
    group_offset: tuple    # [groups]
    leaf: tuple            # [n] 1 if leaf
    names: tuple           # [n]


def read_tree(path: str) -> Tree:
    """Parse a darknet .tree file (reference: read_tree, src/additionally.c:1895)."""
    parent, names, group = [], [], []
    group_size, group_offset = [], []
    last_parent = -1
    cur_size = 0
    groups = 0
    n = 0
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split()
            names.append(parts[0])
            p = int(parts[1]) if len(parts) > 1 else -1
            parent.append(p)
            if p != last_parent:
                groups += 1
                group_offset.append(n - cur_size)
                group_size.append(cur_size)
                cur_size = 0
                last_parent = p
            group.append(groups)
            n += 1
            cur_size += 1
    groups += 1
    group_offset.append(n - cur_size)
    group_size.append(cur_size)
    # the reference's first group entry is a 0-size artifact of its loop; the real
    # group list for softmax is sizes[1:] + the final flushed group — reproduce the
    # same arrays verbatim (softmax_tree iterates hier->groups entries)
    leaf = [1] * n
    for p in parent:
        if p >= 0:
            leaf[p] = 0
    return Tree(n=n, groups=groups, parent=tuple(parent), group=tuple(group),
                group_size=tuple(group_size), group_offset=tuple(group_offset),
                leaf=tuple(leaf), names=tuple(names))


def softmax_groups(tree: Tree) -> list:
    """(offset, size) spans over which the region head softmaxes
    (reference: softmax_tree, src/yolov2_forward_network.c:494-508 — iterates
    groups with running offset; 0-size groups are no-ops)."""
    out = []
    count = 0
    for gs in tree.group_size:
        if gs > 0:
            out.append((count, gs))
        count += gs
    return out


def hierarchy_predictions(pred: np.ndarray, tree: Tree,
                          only_leaves: bool = False) -> np.ndarray:
    """In index order, multiply each node's prob by its (already-updated) parent's —
    parents precede children, so this cascades into full path products
    (reference: hierarchy_predictions, src/additionally.c:1878-1893). ``pred``:
    [..., n]; modified copy returned."""
    out = np.array(pred, np.float32, copy=True)
    for j in range(tree.n):
        p = tree.parent[j]
        if p >= 0:
            out[..., j] *= out[..., p]
    if only_leaves:
        mask = np.asarray(tree.leaf, bool)
        out[..., ~mask] = 0.0
    return out


def read_map(path: str) -> list:
    """Class-index map file (reference: read_map, src/additionally.c:1649)."""
    with open(path) as f:
        return [int(l.strip()) for l in f if l.strip()]
