"""A reference package of the tests' own: the default reference with
darknet's ``relu`` beside its leaky and linear activations, for a
configuration that names it (``"reference": "tests.ref_relu"``). It reuses
every function of the default package, its forward through
``with_activations``."""

import torch

from portbench.reference import (conv_arith, conv_param_shapes,  # noqa: F401
                                 correct_boxes, count_params, decode,
                                 head_channels, ingest, nms,
                                 objectness_and_best, parse, prepare,
                                 with_activations)

forward = with_activations({"relu": torch.relu})
