"""Data layout over a ``('dp', 'sp')`` mesh.

Counterpart of the data half of ``nos_tpu/parallel/sharding.py``
(``llama_data_sharding``): tokens ``[B, S]`` lie batch over ``dp`` and
sequence over ``sp``, the block distribution ring attention consumes.
The reference returns a ``NamedSharding`` for ``jax.device_put``; a rank
here takes its own block of the global batch.

The parameter rules (``llama_param_sharding``,
``llama_quantized_sharding``: tensor parallelism over ``tp`` and FSDP
over ``dp``) wait for ROADMAP Queue 1 item 9; under a ``dp`` / ``sp``
mesh every rank holds the whole params tree.
"""
from __future__ import annotations

import torch

from nos_tpu_torch.parallel.mesh import axis_index, axis_size


def _block(x: torch.Tensor, dim: int, index: int, count: int) -> torch.Tensor:
    if x.shape[dim] % count:
        raise ValueError(
            f"dimension {dim} of {tuple(x.shape)} does not divide over {count} ranks"
        )
    size = x.shape[dim] // count
    return x.narrow(dim, index * size, size)


def sequence_block(mesh, tokens: torch.Tensor) -> torch.Tensor:
    """This rank's ``S / sp`` columns of ``tokens`` [rows, S]."""
    return _block(tokens, 1, axis_index(mesh, "sp"), axis_size(mesh, "sp"))


def llama_data_sharding(mesh, tokens: torch.Tensor) -> torch.Tensor:
    """This rank's ``[B / dp, S / sp]`` block of the global token batch
    ``tokens`` [B, S]: rows ``d·B/dp ...`` for dp index d, columns
    ``s·S/sp ...`` for sp index s (a view)."""
    rows = _block(tokens, 0, axis_index(mesh, "dp"), axis_size(mesh, "dp"))
    return sequence_block(mesh, rows)


def llama_param_sharding(mesh, config):
    raise NotImplementedError(
        "parameter sharding (tensor parallelism and FSDP) is not ported yet "
        "(ROADMAP Queue 1 item 9: multi-device)"
    )


def llama_quantized_sharding(mesh, config, bits: int = 8, group: int = 128):
    raise NotImplementedError(
        "quantized parameter sharding is not ported yet "
        "(ROADMAP Queue 1 item 9: multi-device)"
    )
