"""Port Ulysses attention (nos_tpu_torch.parallel.ulysses) against JAX.

The reference's ``ulysses_attention`` runs in this process on a
``('dp', 'sp')`` mesh of the conftest's virtual CPU devices, with
``attention="flash"`` through its Pallas kernel in interpret mode; the
port runs on gloo ranks spawned once per test
(``tests/torch_sp_ranks.py``), each on its block of the same numpy
inputs, the flash path through ``flash_attention`` (the kernels' plain
versions on the CPU). Forward and q / k / v gradients are compared.

Tolerances, f32: outputs to 2e-5 and gradients to 1e-4 (the same
arithmetic in another summation order, observed about 1e-6).
"""
import itertools

import jax
import pytest

from nos_tpu.parallel import ulysses as jul
from nos_tpu.parallel.mesh import mesh_from_devices
from tests import torch_sp_ranks as ranks
from tests.test_torch_ring_attention import MASKS, assert_case, jax_case, qkv_do


@pytest.mark.parametrize("dims", [(2, 2), (1, 4)], ids=["dp2_sp2", "sp4"])
def test_ulysses_flash_and_dense_match_reference(dims, tmp_path):
    """Both attention backends, every mask, forward and gradients; 8 q
    heads and 4 kv heads split over sp 2 and 4 (whole GQA groups)."""
    dp, sp = dims
    arrays = qkv_do(10 + sp, b=2, s=16, hq=8, hkv=4)
    mesh = mesh_from_devices(dims, ("dp", "sp"), jax.devices()[:dp * sp])
    cases, wants = [], {}
    for (mask, causal, window), attention in itertools.product(MASKS, ("flash", "dense")):
        name = f"ulysses_{attention}_{mask}"

        def fn(q, k, v, mesh, attention=attention, **kw):
            return jul.ulysses_attention(q, k, v, mesh, attention=attention, **kw)

        wants[name] = jax_case(fn, arrays, mesh, causal, window)
        kind = "ulysses_flash" if attention == "flash" else "ulysses"
        cases.append((name, kind, causal, window))
    ranks.spawn(ranks.attention, dp * sp, tmp_path, tmp_path, dims, arrays, cases)
    for name, want in wants.items():
        assert_case(tmp_path, name, want, dp, sp)


def test_ulysses_raises_as_the_reference_does(tmp_path):
    """The reference's three raises (ValueError): heads that do not
    divide by sp, kv heads below the sp degree (Gemma-2B's single kv head
    at sp > 1; the ring serves it), no sp axis; the window contract; and
    a mesh with tp runs on the rank's own heads, as the reference's runs
    under a head axis."""
    ranks.spawn(ranks.attention_contracts, 4, tmp_path, tmp_path)
    for rank in range(4):
        errors = {k: str(v) for k, v in ranks.load(tmp_path, "contracts", rank).items()}
        for key in ("ulysses_indivisible_heads", "ulysses_kv_heads_below_sp"):
            assert errors[key].startswith("ValueError"), errors
            assert "use ring attention" in errors[key], errors
        assert "no sequence axis" in errors["ulysses_no_sp_axis"], errors
        assert "causal" in errors["ulysses_attention_window_noncausal"], errors
        assert ">= 1" in errors["ulysses_attention_window_zero"], errors
        assert errors["ulysses_tp"] == "no error", errors
