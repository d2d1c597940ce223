"""Tensor- and expert-parallel serving: one Engine spanning a mesh of ranks.

Counterpart of ``nos_tpu/serve/sharded.py``. A multi-device slice
serves one model replica larger or faster than one device allows. The
params shard Megatron-style (``parallel/sharding.py``) and the KV cache
shards its head axis over tp, so every head's cache rows live with the
rank that computes them; the model writes out the one all-reduce after
``wo`` and after ``w_down`` and gathers the logits, so every rank
samples the same token. Every rank runs the same host loop on the same
submissions (explicit SPMD: the reference's one program over a GSPMD
mesh).

Usage, on every rank of the group::

    mesh = mesh_from_devices((tp,), ("tp",))
    params = shard_for_serving(params, mesh, config)
    eng = Engine(params, config, mesh=mesh, ...)

A MoE model also spreads its experts over an ``ep`` axis (``(ep,)`` or
``(tp, ep)`` meshes): each rank holds ``E/ep`` experts of every layer,
routes every token itself and gathers the experts' outputs over ep
(``models/moe.py``); everything else is replicated over ep, the KV cache
included. A mesh's other axes (``dp``) replicate: each rank keeps its tp
/ ep shards and serves on its ``('tp', 'ep')`` plane. Works with dense
trees and with int8 / int4 trees (``quantize_params`` /
``quantize_params_int4``; expert stacks int8) alike.
"""
from __future__ import annotations

from typing import Any, Dict

from nos_tpu_torch.models.llama import LlamaConfig
from nos_tpu_torch.parallel.mesh import axis_size, sub_mesh
from nos_tpu_torch.parallel.sharding import shard_params

Spec = tuple


def kv_cache_sharding(mesh, config: LlamaConfig) -> Spec:
    """The spec of the KV cache rows [slots, max_len, Hkv, hd]: the head
    axis over tp (attention is head-local, so cache reads and writes
    never cross ranks). tp must divide the kv head count."""
    tp = axis_size(mesh, "tp")
    if config.n_kv_heads % tp:
        raise ValueError(
            f"tp={tp} must divide n_kv_heads={config.n_kv_heads} "
            f"(head-sharded KV cache)"
        )
    return (None, None, "tp" if tp > 1 else None, None)


def serving_mesh(mesh):
    """The mesh a serving replica runs on: its ``('tp', 'ep')`` plane
    (None without a tp or ep axis longer than 1); every other axis
    replicates."""
    return sub_mesh(mesh, ("tp", "ep"))


def shard_for_serving(params: Dict[str, Any], mesh, config: LlamaConfig) -> Dict[str, Any]:
    """This rank's serving shards of a whole params tree: dense trees by
    the Megatron rules, quantized trees by the scale-aware ones (the int4
    group read off the tree), expert stacks over ep, over the tp and ep
    axes only, replicated over the mesh's other axes."""
    kv_cache_sharding(mesh, config)
    return shard_params(params, serving_mesh(mesh), config)
