"""Device fence for timed regions.

Counterpart of ``dlaf_tpu/common/sync.py``: PyTorch returns before the card
finishes, so a timed region ends in ``torch.cuda.synchronize()`` on the
device of each tensor it produced. CPU tensors are already complete.
"""

from __future__ import annotations

import torch


def hard_fence(*tensors):
    """Block until the work producing every given tensor has run.
    ``None`` passes through. Returns the single argument (or the tuple)."""
    for x in tensors:
        if x is not None and x.is_cuda:
            torch.cuda.synchronize(x.device)
    return tensors[0] if len(tensors) == 1 else tensors
