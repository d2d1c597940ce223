"""Port LoRA (nos_tpu_torch.models.lora, the engine's per-request
adapters, the bridge's adapter trees) against JAX.

Base weights come from the reference's init through the bridge; adapter
trees from the reference's ``init_lora_params`` with ``b`` replaced by
numpy-seeded values (a zero ``b`` is the identity and would make every
comparison vacuous), handed to both sides as numpy arrays. f32 tiny
configs. Tolerances:

- logits within 1e-4 (as the dense model, tests/test_torch_llama.py);
- merged weights within 1e-6 (one f32 rank-r product, summation order);
- greedy tokens and Engine completions identical;
- three Adam steps: the loss within 1e-5 and the adapters within 1e-5
  (as the trainer's AdamW steps in tests/test_torch_train.py; an update
  of lr = 1e-2 moves them by about 1e-2, the gradient noise of 1e-6
  relative shrinks by that factor again).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nos_tpu.models import generate as jg
from nos_tpu.models import llama as jl
from nos_tpu.models import lora as jlora
from nos_tpu.models.quantize import quantize_params as jquantize
from nos_tpu.serve import Engine as JEngine, GenRequest as JRequest
from nos_tpu_torch.bridge import lora_from_numpy, lora_to_numpy
from nos_tpu_torch.models import generate as tg
from nos_tpu_torch.models import llama as tl
from nos_tpu_torch.models import lora as tlora
from nos_tpu_torch.models.quantize import quantize_params
from nos_tpu_torch.serve import Engine, GenRequest
from tests.test_torch_engine import prompts_np
from tests.test_torch_llama import bridged, tokens_np
from tests.test_torch_train import one_device_mesh

F32_ATOL = 1e-4


def t(x, dtype=torch.long):
    return torch.from_numpy(np.asarray(x)).to(dtype)


def adapters_both(jc, lora, seed):
    """The same adapter tree as the reference's (jnp) and the port's
    (tensors): ``a`` from the reference's init, ``b`` seeded numpy."""
    tree = jax.tree.map(np.asarray, jlora.init_lora_params(jax.random.key(seed), jc, lora))
    rng = np.random.default_rng(seed)
    for layer in tree["layers"]:
        for ab in layer.values():
            ab["b"] = (rng.standard_normal(ab["b"].shape) * 0.05).astype(np.float32)
    return jax.tree.map(jnp.asarray, tree), lora_from_numpy(tree, device="cpu")


@pytest.fixture(scope="module")
def setup():
    jc, jp, tc, tp = bridged(0)
    lora = jlora.LoraConfig(rank=4, alpha=8.0, targets=("wq", "wv", "w_down"))
    tlc = tlora.LoraConfig(rank=4, alpha=8.0, targets=("wq", "wv", "w_down"))
    ads = [adapters_both(jc, lora, 10 + i) for i in range(2)]
    return jc, jp, tc, tp, lora, tlc, ads


class TestAdapters:
    def test_zero_b_is_the_identity(self, setup):
        _, _, tc, tp, _, tlc, _ = setup
        ad = tlora.init_lora_params(tc, tlc, seed=3, device="cpu")
        assert all(ab["a"].dtype == torch.float32 and float(ab["b"].abs().max()) == 0
                   for layer in ad["layers"] for ab in layer.values())
        toks = t(tokens_np(1))
        assert torch.equal(tl.llama_forward(tlora.attach_lora(tp, ad, tlc), toks, tc),
                           tl.llama_forward(tp, toks, tc))

    def test_attach_and_merge_match_reference(self, setup):
        jc, jp, tc, tp, lora, tlc, ads = setup
        (jad, tad) = ads[0]
        toks = tokens_np(2)
        for jfn, tfn in ((jlora.attach_lora, tlora.attach_lora),
                         (jlora.merge_lora, tlora.merge_lora)):
            want = np.asarray(jl.llama_forward(jfn(jp, jad, lora), jnp.asarray(toks), jc))
            got = tl.llama_forward(tfn(tp, tad, tlc), t(toks), tc).numpy()
            assert np.abs(got - want).max() <= F32_ATOL
        merged_j = jlora.merge_lora(jp, jad, lora)["layers"][1]["w_down"]
        merged_t = tlora.merge_lora(tp, tad, tlc)["layers"][1]["w_down"]
        assert merged_t.dtype == tc.dtype
        assert float(np.abs(merged_t.numpy() - np.asarray(merged_j)).max()) <= 1e-6

    def test_attached_generation_token_identical(self, setup):
        jc, jp, tc, tp, lora, tlc, ads = setup
        jad, tad = ads[1]
        toks = tokens_np(3, s=7)
        want = np.asarray(jg.generate(jlora.attach_lora(jp, jad, lora), jnp.asarray(toks),
                                      jc, 8))
        got = tg.generate(tlora.attach_lora(tp, tad, tlc), t(toks), tc, 8)
        assert np.array_equal(got.numpy(), want)
        assert not np.array_equal(got.numpy(), tg.generate(tp, t(toks), tc, 8).numpy())

    def test_stack_and_with_adapter_rows(self, setup):
        jc, jp, tc, tp, lora, tlc, ads = setup
        stacked = tlora.stack_lora_adapters(tp, [ad for _, ad in ads], tlc, rows=3)
        assert tlora.n_adapters(stacked) == 3 and tlora.n_adapters(tp) == 0
        node = stacked["layers"][0]["wq"]
        assert isinstance(node, tlora.MultiLoraLinear)
        assert node.a.shape == (3, 64, 4) and float(node.a[0].abs().max()) == 0
        rows = tlora.with_adapter_rows(stacked, [2, 0, 1])
        moved = rows["layers"][0]["wq"]
        assert moved.w is node.w and moved.a is node.a  # no weight copied
        assert moved.idx.tolist() == [2, 0, 1] and node.idx.tolist() == [0, 0, 0]
        # per-row products equal each adapter's own LoraLinear
        x = torch.from_numpy(np.random.default_rng(4).standard_normal((3, 5, 64))
                             .astype(np.float32))
        got = moved.matmul(x)
        for r, a in enumerate([2, 0, 1]):
            want = x[r] @ node.w if a == 0 else tlora.LoraLinear(
                w=node.w, a=ads[a - 1][1]["layers"][0]["wq"]["a"],
                b=ads[a - 1][1]["layers"][0]["wq"]["b"], scale=tlc.scale).matmul(x[r])
            assert float((got[r] - want).abs().max()) <= 1e-5
        # the reference's stacked node crosses the bridge with its own dtypes
        from nos_tpu_torch.bridge import params_from_numpy

        jstacked = jlora.stack_lora_adapters(jp, [ad for ad, _ in ads], lora, rows=3)
        crossed = params_from_numpy(jax.tree.map(np.asarray, jstacked), tc, device="cpu")
        cnode = crossed["layers"][0]["wq"]
        assert isinstance(cnode, tlora.MultiLoraLinear) and cnode.scale == tlc.scale
        assert cnode.idx.dtype == torch.int32 and cnode.a.dtype == torch.float32
        assert torch.equal(cnode.a, node.a) and torch.equal(cnode.b, node.b)

    def test_adapter_trees_cross_both_ways(self, setup):
        jc, _, _, _, lora, _, ads = setup
        jad, tad = ads[0]
        back = lora_to_numpy(tad)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jax.tree.map(np.asarray, jad))):
            assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)

    def test_guards_raise_where_the_reference_raises(self, setup):
        jc, jp, tc, tp, lora, tlc, ads = setup
        jad, tad = ads[0]
        toks = tokens_np(5, s=4)
        # an adapter over a quantized base: merge, then quantize
        with pytest.raises(TypeError):
            jl.llama_forward(jlora.attach_lora(jquantize(jp), jad, lora), jnp.asarray(toks), jc)
        with pytest.raises(TypeError, match="merge_lora"):
            tl.llama_forward(tlora.attach_lora(quantize_params(tp), tad, tlc), t(toks), tc)
        with pytest.raises(ValueError, match="unknown LoRA target"):
            tlora.init_lora_params(tc, tlora.LoraConfig(targets=("embed",)), device="cpu")
        short = {"layers": tad["layers"][:1]}
        for fn in (tlora.attach_lora, tlora.merge_lora):
            with pytest.raises(ValueError, match="layers"):
                fn(tp, short, tlc)
        with pytest.raises(ValueError, match="at least one"):
            tlora.stack_lora_adapters(tp, [], tlc)
        node = tlora.stack_lora_adapters(tp, [tad], tlc)["layers"][0]["wq"]
        with pytest.raises(ValueError, match=r"\[B, S, d\]"):
            node.matmul(torch.zeros((1, 64)))
        with pytest.raises(TypeError, match="DeviceMesh"):
            tlora.make_lora_train_step(object(), tc, tlc, device="cpu")
        with pytest.raises(ValueError, match="optimizer"):
            tlora.make_lora_train_step(None, tc, tlc, learning_rate=0.1, device="cpu",
                                       optimizer=torch.optim.SGD)


class TestLoraTraining:
    def test_three_adam_steps_match_reference(self):
        """flash + remat, the card's path: only wq / wv adapted, so the
        flash backward sees k without a gradient in layer 0."""
        jc, jp, tc, tp = bridged(20, attention="flash", remat=True)
        lora = jlora.LoraConfig(rank=4)
        tlc = tlora.LoraConfig(rank=4)
        jad, tad = adapters_both(jc, lora, 21)
        toks = tokens_np(22)
        jstep, jshard = jlora.make_lora_train_step(one_device_mesh(), jc, lora,
                                                   learning_rate=1e-2)
        pstep, pshard = tlora.make_lora_train_step(None, tc, tlc, learning_rate=1e-2,
                                                   device="cpu")
        jstate, pstate = jshard(jad), pshard(tad)
        base_before = [x.clone() for x in tl.tree_leaves(tp)]
        jl_, pl_ = [], []
        for _ in range(3):
            jstate, loss = jstep(jstate, jp, jnp.asarray(toks))
            jl_.append(float(loss))
            pstate, loss = pstep(pstate, tp, t(toks))
            assert loss.dim() == 0
            pl_.append(float(loss))
        assert np.abs(np.array(jl_) - np.array(pl_)).max() <= 1e-5
        assert pl_[2] < pl_[0]
        want = jax.tree.leaves(jax.tree.map(np.asarray, jstate[0]))
        got = jax.tree.leaves(lora_to_numpy(pstate[0]))
        assert max(float(np.abs(g - w).max()) for g, w in zip(got, want)) <= 1e-5
        assert all(torch.equal(a, b) for a, b in zip(tl.tree_leaves(tp), base_before))
        moved = pstate[0]["layers"][0]["wq"]["b"].detach() - tad["layers"][0]["wq"]["b"]
        assert float(moved.abs().max()) > 0


def oracle_engine(params, config, prompt, n):
    eng = Engine(params, config, max_slots=1, max_len=64, ticks_per_sync=4)
    rid = eng.submit(GenRequest(prompt=prompt, max_new_tokens=n))
    return eng.run()[rid]


class TestMultiLoraEngine:
    """Mirrors tests/models/test_multi_lora.py: per request, the port's
    multi-LoRA engine and the reference's give the same tokens."""

    def _both(self, setup, rows, requests, **kw):
        jc, jp, tc, tp, lora, tlc, ads = setup
        out = []
        for E, R, cfg, stacked in (
            (JEngine, JRequest, jc,
             jlora.stack_lora_adapters(jp, [a for a, _ in ads], lora, rows=rows)),
            (Engine, GenRequest, tc,
             tlora.stack_lora_adapters(tp, [a for _, a in ads], tlc, rows=rows)),
        ):
            eng = E(stacked, cfg, max_slots=rows, max_len=64, ticks_per_sync=4, **kw)
            ids = [eng.submit(R(**r)) for r in requests]
            got = eng.run()
            out.append([got[i] for i in ids])
        return out

    def test_cotenants_each_get_their_own_adapter(self, setup):
        jc, jp, tc, tp, lora, tlc, ads = setup
        prompts = prompts_np(30, (5, 8, 11))
        reqs = [dict(prompt=p, max_new_tokens=7, adapter=a)
                for p, a in zip(prompts, (0, 1, 2))]
        want, got = self._both(setup, 3, reqs)
        assert got == want
        assert got[0] == oracle_engine(tp, tc, prompts[0], 7)  # adapter 0: the base
        assert got[1] == oracle_engine(tlora.merge_lora(tp, ads[0][1], tlc), tc,
                                       prompts[1], 7)
        assert got[1] != oracle_engine(tp, tc, prompts[1], 7)

    def test_slot_reuse_switches_adapters(self, setup):
        p = prompts_np(40, (6,))[0]
        reqs = [dict(prompt=p, max_new_tokens=5, adapter=a) for a in (1, 2, 0)]
        want, got = self._both(setup, 1, reqs)
        assert got == want and got[0] != got[1]

    def test_chunked_admission_applies_adapter(self, setup):
        p = prompts_np(41, (20,))[0]
        want, got = self._both(setup, 2, [dict(prompt=p, max_new_tokens=6, adapter=2)],
                               prefill_chunk=8)
        assert got == want

    def test_adapter_validation(self, setup):
        _, _, tc, tp, _, tlc, ads = setup
        eng = Engine(tlora.stack_lora_adapters(tp, [ads[0][1]], tlc), tc, max_slots=1,
                     max_len=64)
        with pytest.raises(ValueError, match="adapter"):
            eng.submit(GenRequest(prompt=[3], max_new_tokens=2, adapter=5))
        rid = eng.submit(GenRequest(prompt=[3], max_new_tokens=2, adapter=1))
        eng.run()
        assert eng._adapter_rows.tolist() == [0]  # reset at retire
        assert rid == 1
