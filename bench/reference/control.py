"""The control: the reference with one stated guarantee broken.

The configurations state bag semantics (a join result row is one edge,
duplicates kept).  The control keeps one row of each distinct edge, the
step a later change would be tempted by to shrink the output, so a sound
check has to call it not correct.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch

from reference import joins


def extract(arrays, model: Mapping, device
            ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    edges, vertices = joins.extract(arrays, model, device)
    return {k: torch.unique(v) for k, v in edges.items()}, vertices
