"""Backend routing: the hand-written CUDA kernel for a tensor on the card,
the plain torch version for a tensor on the CPU. The tensor's device alone
decides; there is no switch that sends a CUDA tensor to the plain version.
"""

from __future__ import annotations

import torch


def use_kernels(t: torch.Tensor) -> bool:
    return t.is_cuda
