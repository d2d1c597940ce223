"""The preempt_resume example (nos_tpu_torch.examples.preempt_resume)
against examples/preempt_resume.py's training and the PR 13 geometry.

- One process at ``--device cpu``: the three phases run; the node after
  each is what the story says (one 7g.80gb acknowledged; two 3g.40gb
  advertised and acknowledged after the re-carve, the claimant and the
  trainer's new pod each on one); the simulator's instances after the
  re-carve are the geometry ``MigNode.update_geometry_for`` chooses for
  the two pending 3g.40gb pods on a GPU holding one free 7g.80gb (PR
  13's tests hold that choice against the reference's TpuNode); the
  resumed steps' losses equal, bit for bit, those of the same steps run
  on without the interruption.
- Four gloo ranks (``tests/torch_preempt_ranks.py``, one spawn): the
  weights are the reference's ``init_llama_params(key(0), tiny_config())``
  widened from bf16 to f32 (exact), the tokens the example's own [8, 16];
  phase 1 over the (2, 2) mesh, phase 3 over (1, 2) on ranks 0 and 1.
  Every loss, the resumed ones too, within 2e-5 of the reference's
  ``make_train_step`` (built-in momentum SGD) on one CPU device running
  the five steps without interruption: f32, since under tp each rank
  rounds its row-parallel partial to the model dtype (ROADMAP Queue 3,
  "tp sums in another order"). The state restored onto the smaller
  mesh equals the saved one bit for bit; ranks 2 and 3 leave after phase
  2 and every rank tells the same node story.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nos_tpu.models import llama as jl
from nos_tpu.parallel.mesh import mesh_from_devices
from nos_tpu.parallel.train import make_train_step as jax_make_train_step
from nos_tpu_torch.examples import preempt_resume
from nos_tpu_torch.gpu.known import GPU_PRODUCT_LABEL, H100_80GB
from nos_tpu_torch.gpu.node import MigNode, mig_resource
from nos_tpu_torch.gpu import annotations as annot
from nos_tpu_torch.models import llama as tl
from tests import torch_preempt_ranks as preempt_ranks
from tests import torch_sp_ranks as ranks

LOSS_ATOL = 2e-5
STEPS = preempt_resume.STEPS_BEFORE + preempt_resume.STEPS_AFTER


def _recarve_choice():
    """What MigNode.update_geometry_for chooses when a GPU holds one free
    7g.80gb and two 3g.40gb pods are pending."""
    node = MigNode("n", {GPU_PRODUCT_LABEL: H100_80GB}, {"nvidia.com/gpu": 1},
                   annot.status_from_devices(free={0: {"7g.80gb": 1}}, used={}))
    assert node.update_geometry_for({mig_resource("3g.40gb"): 2})
    return node.geometry()


def _plain(d):
    """JSON's string keys back to GPU indices."""
    return {int(k): v for k, v in d.items()}


def _story_holds(story):
    p1, p2, p3 = (story["node"][f"phase{i}"] for i in (1, 2, 3))
    assert _plain(p1["instances"]) == {0: {"7g.80gb": 1}}
    assert p1["status_plan"] == p1["spec_plan"] == "1"
    assert _plain(p1["used"]) == {0: {"7g.80gb": 1}}
    choice = _recarve_choice()
    assert choice == {0: {"3g.40gb": 2}}
    assert _plain(story["recarve_chosen"]) == choice
    assert _plain(p2["instances"]) == choice == _plain(p2["status"])
    assert p2["status_plan"] == p2["spec_plan"] == "2"
    assert p2["allocatable"] == {"nvidia.com/gpu": 0, mig_resource("3g.40gb"): 2}
    assert _plain(p2["used"]) == {0: {"3g.40gb": 1}}
    assert _plain(p3["used"]) == {0: {"3g.40gb": 2}} == _plain(p3["status"])
    assert p3["allocatable"] == p2["allocatable"]


def test_the_example_in_one_process(tmp_path):
    out = preempt_resume.main(["--device", "cpu", "--ckpt-dir", str(tmp_path / "run")])
    assert out["world"] == 1 and out["mesh_before"] is None and out["mesh_after"] is None
    assert out["config"]["attention"] == "dense" and out["config"]["head_dim"] == 8
    assert sorted(out["losses"]) == list(range(1, STEPS + 1))
    assert all(np.isfinite(v) for v in out["losses"].values())
    assert out["resumed_from"] == out["saved_step"] == preempt_resume.STEPS_BEFORE
    assert len(out["spec_to_ack_ms"]) == 2
    _story_holds(json.loads(json.dumps(out)))
    cfg = preempt_resume.trainer_config(torch.device("cpu"))
    straight = preempt_resume.uninterrupted_losses(
        cfg, tl.init_llama_params(cfg, seed=0, device="cpu"), preempt_resume.batch_tokens(cfg),
        "cpu")
    assert straight == out["losses"]  # bit for bit, the resumed steps too


def test_four_ranks_hold_the_reference_and_restore_bit_for_bit(tmp_path):
    jc = jl.tiny_config(dtype=jnp.float32)
    params_np = jax.tree.map(lambda x: np.asarray(x, dtype=np.float32),
                             jl.init_llama_params(jax.random.key(0), jl.tiny_config()))
    tokens = preempt_resume.batch_tokens(tl.tiny_config())
    step, shard = jax_make_train_step(mesh_from_devices((1, 1), ("dp", "tp"),
                                                        jax.devices()[:1]), jc)
    state = shard(jax.tree.map(jnp.asarray, params_np))
    want = []
    for _ in range(STEPS):
        state, loss = step(state, jnp.asarray(tokens))
        want.append(float(loss))

    ranks.spawn(preempt_ranks.preempt, 4, tmp_path, tmp_path, params_np, tokens,
                str(tmp_path / "ckpt"))
    results = [ranks.load(tmp_path, "preempt", r) for r in range(4)]
    stories = [json.loads(str(r["story"])) for r in results]
    for rank, (res, story) in enumerate(zip(results, stories)):
        resumed = rank < 2
        steps = list(range(1, STEPS + 1 if resumed else preempt_resume.STEPS_BEFORE + 1))
        assert res["steps"].tolist() == steps
        np.testing.assert_allclose(res["losses"], want[:len(steps)], rtol=0, atol=LOSS_ATOL)
        assert story["in_resumed_mesh"] == resumed
        assert story["resumed_from"] == (preempt_resume.STEPS_BEFORE if resumed else None)
        assert story["mesh_before"] == [2, 2] and story["mesh_after"] == [1, 2]
        assert story["node"] == stories[0]["node"]
        _story_holds(story)
    saved = [k for k in results[0] if k.startswith("saved")]
    assert len(saved) == 2 * len(tl.tree_leaves(tl.init_llama_params(
        tl.tiny_config(), device="cpu")))
    for key in saved:
        got = results[0][key.replace("saved", "restored")]
        assert got.dtype == results[0][key].dtype == np.float32
        assert np.array_equal(got, results[0][key])


def test_a_world_that_is_no_multiple_of_four_is_refused(monkeypatch):
    monkeypatch.setattr(preempt_resume.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(preempt_resume.dist, "get_world_size", lambda: 6)
    cfg = tl.tiny_config(dtype=torch.float32)
    with pytest.raises(ValueError, match="multiple of 4, not 6"):
        preempt_resume.run(cfg, None, None, "", torch.device("cpu"))


def test_several_ranks_on_the_card_are_refused(monkeypatch):
    monkeypatch.setattr(preempt_resume.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(preempt_resume.dist, "get_world_size", lambda: 4)
    cfg = tl.tiny_config(dtype=torch.float32)
    with pytest.raises(ValueError, match="on the CPU"):
        preempt_resume.run(cfg, None, None, "", torch.device("cuda"))
