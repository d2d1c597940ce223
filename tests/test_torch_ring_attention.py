"""Port ring attention (nos_tpu_torch.parallel.ring_attention) against JAX.

The reference's ``ring_attention`` and ``ring_flash_attention`` (Pallas
kernels in interpret mode) run in this process on a ``('dp', 'sp')`` mesh
of the conftest's virtual CPU devices; the port runs on gloo ranks
spawned once per test (``tests/torch_sp_ranks.py``), each on its block
of the same numpy inputs, the flash ring through the kernels' plain
versions. Both forward and q / k / v gradients (the vjp of a random
cotangent) are compared.

Tolerances, f32: outputs to 2e-5 and gradients to 1e-4 (the same
arithmetic; the merge and key-tile summation orders differ, observed
about 1e-6). The block-coverage predicates must agree exactly.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nos_tpu.ops.flash_attention import _block_needed as jax_block_needed
from nos_tpu.parallel import ring_attention as jra
from nos_tpu.parallel.mesh import mesh_from_devices
from nos_tpu_torch.ops.flash_attention import _block_needed
from nos_tpu_torch.parallel import ring_attention as tra
from tests import torch_sp_ranks as ranks

OUT_ATOL = 2e-5
GRAD_ATOL = 1e-4

# (name, causal, window): full causal, bidirectional, and a band of 6
# that crosses block edges (blocks hold 8 or 16 positions)
MASKS = [("causal", True, None), ("noncausal", False, None), ("window6", True, 6)]


def qkv_do(seed, b=2, s=32, hq=4, hkv=2, hd=8):
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return {"q": normal(b, s, hq, hd), "k": normal(b, s, hkv, hd),
            "v": normal(b, s, hkv, hd), "do": normal(b, s, hq * hd)}


def jax_case(fn, arrays, mesh, causal, window):
    """(out, dq, dk, dv) of the reference on the global arrays."""
    q, k, v = (jnp.asarray(arrays[key]) for key in ("q", "k", "v"))
    out, vjp = jax.vjp(
        jax.jit(lambda q, k, v: fn(q, k, v, mesh, causal=causal, window=window)), q, k, v)
    return (np.asarray(out), *map(np.asarray, vjp(jnp.asarray(arrays["do"]))))


def assert_case(out_dir, name, want, dp, sp):
    for key, w, atol in zip(("out", "dq", "dk", "dv"), want,
                            (OUT_ATOL, GRAD_ATOL, GRAD_ATOL, GRAD_ATOL)):
        got = ranks.assemble(out_dir, name, key, dp, sp)
        assert got.shape == w.shape, (name, key, got.shape, w.shape)
        err = float(np.abs(got - w).max())
        assert err <= atol, (name, key, err)


@pytest.mark.parametrize("dims", [(2, 2), (1, 4)], ids=["dp2_sp2", "sp4"])
def test_ring_flash_and_dense_match_reference(dims, tmp_path):
    """Both rings, every mask, forward and gradients, at sp 2 (beside a
    dp axis: the batch splits over dp, the ring runs within each dp
    group) and at sp 4."""
    dp, sp = dims
    arrays = qkv_do(sp)
    mesh = mesh_from_devices(dims, ("dp", "sp"), jax.devices()[:dp * sp])
    cases, wants = [], {}
    for (mask, causal, window), kind in itertools.product(MASKS, ("ring_flash", "ring")):
        name = f"{kind}_{mask}"
        fn = jra.ring_flash_attention if kind == "ring_flash" else jra.ring_attention
        wants[name] = jax_case(fn, arrays, mesh, causal, window)
        cases.append((name, kind, causal, window))
    ranks.spawn(ranks.attention, dp * sp, tmp_path, tmp_path, dims, arrays, cases)
    for name, want in wants.items():
        assert_case(tmp_path, name, want, dp, sp)


def test_contracts_raise_as_the_reference_does(tmp_path):
    """Missing sp axis, heads not a multiple of kv heads, a window without
    causal or of width 0 (ValueError, as the reference); a mesh with tp
    runs (the heads are the rank's own), as the reference's ring runs
    under a head axis; Ulysses' three raises are held in
    tests/test_torch_ulysses.py."""
    ranks.spawn(ranks.attention_contracts, 4, tmp_path, tmp_path)
    for rank in range(4):
        errors = {k: str(v) for k, v in ranks.load(tmp_path, "contracts", rank).items()}
        for fn in ("ring", "ring_flash"):
            assert errors[f"{fn}_no_sp_axis"].startswith("ValueError"), errors
            assert "no sequence axis" in errors[f"{fn}_no_sp_axis"], errors
            assert "causal" in errors[f"{fn}_attention_window_noncausal"], errors
            assert ">= 1" in errors[f"{fn}_attention_window_zero"], errors
        assert "not a multiple of kv heads" in errors["ring_flash_gqa"], errors
        assert errors["ring_tp"] == "no error", errors


@pytest.mark.parametrize("causal,window", [
    (True, None), (True, 1), (True, 5), (True, 64), (False, None)])
def test_block_needed_matches_reference(causal, window):
    """The port's copy of the kernels' block-coverage predicate against
    the reference's, on a grid of block sizes and global starts."""
    for blk_q, blk_k, q_start, k_start in itertools.product(
            (1, 8, 64), (1, 8, 128), (0, 7, 64, 200), (0, 9, 64, 190)):
        want = bool(jax_block_needed(blk_q, blk_k, q_start, k_start, causal, window))
        assert _block_needed(blk_q, blk_k, q_start, k_start, causal, window) == want


@pytest.mark.parametrize("window", [None, 3, 8, 100])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_block_skippable_matches_reference(n, window):
    """Which hops skip their kernels, for every (rank, block) pair."""
    sq = 8
    for my_idx, kv_idx in itertools.product(range(n), range(n)):
        want = bool(jra._block_skippable(kv_idx, my_idx, sq, sq, True, window))
        assert tra._block_skippable(kv_idx, my_idx, sq, sq, True, window) == want
        assert not tra._block_skippable(kv_idx, my_idx, sq, sq, False, window)
    # causal: rank r runs blocks r, r - 1, ..., 0 (r + 1 of them) unbanded
    if window is None:
        for my_idx in range(n):
            runs = [j for j in range(n)
                    if not tra._block_skippable(j, my_idx, sq, sq, True, None)]
            assert runs == list(range(my_idx + 1))


@pytest.mark.parametrize("causal,window,q_offset,kv_offset", [
    (True, None, 8, 0), (True, None, 0, 8), (True, 5, 16, 8), (False, None, 8, 0),
])
def test_online_block_update_matches_reference(causal, window, q_offset, kv_offset):
    """One ring step's accumulator fold, from a state that already holds
    a block (finite m) and from the empty state."""
    rng = np.random.default_rng(3)
    b, sq, kv, g, hd = 1, 8, 2, 2, 8
    q = rng.standard_normal((b, sq, kv, g, hd)).astype(np.float32)
    k = rng.standard_normal((b, sq, kv, hd)).astype(np.float32)
    v = rng.standard_normal((b, sq, kv, hd)).astype(np.float32)
    for m0 in (np.full((b, kv, g, sq), -np.inf, np.float32),
               rng.standard_normal((b, kv, g, sq)).astype(np.float32)):
        l0 = np.abs(rng.standard_normal((b, kv, g, sq))).astype(np.float32)
        acc0 = rng.standard_normal((b, kv, g, sq, hd)).astype(np.float32)
        want = jra._online_block_update(*map(jnp.asarray, (q, k, v, m0, l0, acc0)),
                                        q_offset, kv_offset, causal, window)
        got = tra._online_block_update(*map(torch.from_numpy, (q, k, v, m0, l0, acc0)),
                                       q_offset, kv_offset, causal, window)
        for w, t in zip(want, got):
            w, t = np.asarray(w), t.numpy()
            assert np.array_equal(np.isinf(w), np.isinf(t))
            fin = np.isfinite(w)
            assert float(np.abs(w[fin] - t[fin]).max(initial=0.0)) <= 1e-5
