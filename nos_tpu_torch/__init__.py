"""PyTorch/CUDA port of the ``nos_tpu`` data plane, for NVIDIA Hopper.

The JAX package ``nos_tpu`` is the reference: every module here mirrors
its counterpart there (``ops/``, ``models/``, ``serve/``, ``util/``) and
is held against it by ``tests/test_torch_*.py``. This package imports
``torch`` and never ``jax``, and nothing of ``nos_tpu``: what it needs
from there (metrics, tracing) it keeps as its own trimmed copy.

Device rule: entry points run on ``cuda`` unless the caller passes
``device="cpu"``. With no GPU and no explicit device they raise; they
never fall back to the CPU quietly (``_resolve_device``).
"""
from __future__ import annotations

import torch

# Float32 parity with the reference is checked on the card too (the
# kernel's plain version, the dense model path): both TF32 switches are
# set off explicitly rather than trusting the defaults (cuDNN's is on).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default, the CPU
    only when the caller asks for it by name."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU explicitly"
        )
    return torch.device("cuda")
