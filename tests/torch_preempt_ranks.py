"""The rank side of tests/test_torch_preempt_resume.py: the
preempt_resume example's three phases on every rank of a gloo group
(spawned by ``tests/torch_sp_ranks.spawn``), phase 1 on the examples'
(W/2, 2) mesh and phase 3 on the (W/4, 2) mesh of the first half.

This module imports no JAX: every spawned rank imports it afresh.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from tests.torch_sp_ranks import port_model, save


def preempt(rank, out, params_np, tokens, ckpt_dir) -> None:
    """``preempt_resume.run`` on the reference's params (f32): each rank's
    losses, node story and, on rank 0, the state saved at step 3 and the
    state restored from it, whole."""
    from nos_tpu_torch.examples import dp_tp_mesh, preempt_resume

    cfg, params = port_model(params_np, {})
    device = torch.device("cpu")
    outputs: dict = {}
    result = preempt_resume.run(cfg, params, tokens, ckpt_dir, device, dp_tp_mesh(device),
                                say=lambda *a, **k: None, outputs=outputs)
    steps = sorted(result["losses"])
    arrays = {"steps": np.array(steps),
              "losses": np.array([result["losses"][s] for s in steps]),
              "story": np.array(json.dumps({k: result[k] for k in (
                  "node", "recarve_chosen", "mesh_before", "mesh_after", "resumed_from",
                  "in_resumed_mesh")}, sort_keys=True))}
    if rank == 0:
        arrays.update({f"saved{i}": t.numpy() for i, t in enumerate(outputs["saved"])})
        arrays.update({f"restored{i}": t.numpy() for i, t in enumerate(outputs["restored"])})
    save(out, "preempt", rank, **arrays)
