"""Port ResNet (nos_tpu_torch.models.resnet + bridge) against JAX.

Weights come from the reference's own init and cross through the bridge
as numpy arrays; images come from numpy with a fixed seed.

Tolerance: f32 logits within 1e-5 of the reference's largest logit
(relative): the same convolutions and elementwise ops, only the
summation order of each convolution differs. Both padding cases of
XLA's "SAME" run: at 32x32 every stride-2 window pads (0, 1) (and the
stem (2, 3)); at 33x33 they pad symmetrically ((1, 1), the stem (3, 3)).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nos_tpu.models import resnet as jr
from nos_tpu_torch.bridge import resnet_params_from_numpy
from nos_tpu_torch.models import resnet as tr
from nos_tpu_torch.models.llama import tree_leaves

REL_TOL = 1e-5

# the tiny config (two stages), and one whose middle stage is strided
# and two blocks deep
_CONFIGS = {
    "tiny": dict(num_classes=10, stage_sizes=(1, 1), width=8),
    "strided_stage": dict(num_classes=7, stage_sizes=(1, 2, 1), width=8),
}


def _bridged(name, seed=0):
    jc = jr.ResNetConfig(dtype=jnp.float32, **_CONFIGS[name])
    tc = tr.ResNetConfig(dtype=torch.float32, **_CONFIGS[name])
    jp = jr.init_resnet_params(jax.random.key(seed), jc)
    tree = jax.tree.map(np.asarray, jp)
    # init norms are constants; random ones exercise the folded norm
    rng = np.random.default_rng(seed + 100)

    def perturb(node):
        if isinstance(node, dict) and set(node) == {"scale", "bias"}:
            for key in node:
                node[key] = (1.0 if key == "scale" else 0.0) + 0.1 * rng.standard_normal(
                    node[key].shape).astype(np.float32)
        elif isinstance(node, dict):
            for value in node.values():
                perturb(value)
        elif isinstance(node, list):
            for value in node:
                perturb(value)

    perturb(tree)
    jp = jax.tree.map(jnp.asarray, tree)
    return jc, jp, tc, resnet_params_from_numpy(tree, tc, device="cpu")


def _images(size, batch=2, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (batch, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("name", sorted(_CONFIGS))
@pytest.mark.parametrize("size", [32, 33])
def test_logits_match_reference(name, size):
    jc, jp, tc, tp = _bridged(name)
    images = _images(size)
    want = np.asarray(jr.resnet_forward(jp, jnp.asarray(images), jc))
    got = tr.resnet_forward(tp, torch.from_numpy(images), tc)
    assert got.dtype == torch.float32 and got.shape == want.shape
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err <= REL_TOL, err


@pytest.mark.parametrize("n,k,s,pads", [
    (224, 7, 2, (2, 3)), (112, 3, 2, (0, 1)), (33, 3, 2, (1, 1)),
    (33, 7, 2, (3, 3)), (56, 1, 2, (0, 0)), (56, 3, 1, (1, 1)), (17, 1, 1, (0, 0)),
])
def test_same_pads_are_xla_s(n, k, s, pads):
    assert tr.same_pads(n, k, s) == pads
    # XLA's own rule, as the reference's convolutions apply it
    assert tuple(jax.lax.padtype_to_pads((n,), (k,), (s,), "SAME")[0]) == pads


def test_bridge_keeps_the_tree_and_channels_last():
    jc, jp, tc, tp = _bridged("strided_stage")
    assert [len(s) for s in tp["stages"]] == [len(s) for s in jp["stages"]]
    assert set(tp["stages"][1][0]) == set(jp["stages"][1][0])
    kernel = tp["stages"][1][0]["conv2"]
    hwio = np.asarray(jp["stages"][1][0]["conv2"])
    assert kernel.shape == (hwio.shape[3], hwio.shape[2], 3, 3)
    assert kernel.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(kernel.permute(2, 3, 1, 0).numpy(), hwio)
    assert len(tree_leaves(tp)) == len(jax.tree.leaves(jp))


def test_forward_stays_channels_last_through_the_pads():
    """Every conv input is channels_last, padded ones included (a pad
    that dropped the layout would cost a transpose on the card)."""
    tc = tr.ResNetConfig(dtype=torch.float32, **_CONFIGS["tiny"])
    params = tr.init_resnet_params(torch.Generator().manual_seed(0), tc, device="cpu")
    seen = []
    real = tr.F.conv2d

    def spy(x, w, *args, **kwargs):
        seen.append(x.is_contiguous(memory_format=torch.channels_last))
        return real(x, w, *args, **kwargs)

    tr.F.conv2d = spy
    try:
        tr.resnet_forward(params, torch.from_numpy(_images(32)), tc)
    finally:
        tr.F.conv2d = real
    assert len(seen) == 9 and all(seen), seen  # stem, 2 blocks x 4


def test_init_is_seeded_shaped_and_in_the_model_dtype():
    cfg = tr.ResNetConfig()
    a = tr.init_resnet_params(torch.Generator().manual_seed(3), tr.tiny_resnet_config(),
                             device="cpu")
    b = tr.init_resnet_params(torch.Generator().manual_seed(3), tr.tiny_resnet_config(),
                             device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))
    assert a["head"].dtype == torch.bfloat16
    # ResNet-50: the reference's tree, leaf for leaf (25.56 M parameters)
    full = tr.init_resnet_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    shapes = jax.eval_shape(lambda: jr.init_resnet_params(jax.random.key(0), jr.ResNetConfig()))
    want = sum(int(np.prod(leaf.shape)) for leaf in jax.tree.leaves(shapes))
    assert sum(t.numel() for t in tree_leaves(full)) == want == 25_556_032
    logits = tr.resnet_forward(a, torch.zeros((1, 33, 33, 3)), tr.tiny_resnet_config())
    assert logits.shape == (1, 10) and logits.dtype == torch.float32


def test_init_follows_the_device_rule():
    """The weights go to ``device`` (cuda unless the caller names the
    CPU), and a generator on another device is refused, not followed."""
    gen = torch.Generator().manual_seed(0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tr.init_resnet_params(gen, tr.tiny_resnet_config())
    with pytest.raises(ValueError, match="generator is on cpu"):
        tr.init_resnet_params(gen, tr.tiny_resnet_config(), device="meta")
