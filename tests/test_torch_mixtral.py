"""Routed-MoE models through the port's entry points, against JAX.

``tiny_config(n_experts=4, dtype=float32)`` weights come from the
reference's init and cross the bridge; tokens and prompts come from
numpy seeds. Each entry point runs on both sides: the forward and loss
(aux included), the train step, prefill / decode_step / decode_chunk /
generate, the Engine, speculative decoding and SpecEngine, int8
weights, and conversion from a transformers Mixtral.

Tolerances, f32: logits within 1e-5 (summation order only; observed
about 2e-6); the loss within 1e-6 (observed 1e-6 at most, two ulps of a
loss near 6); gradients within 1e-4 of each leaf's largest gradient;
parameters after SGD steps within 1e-5 (tests/test_torch_train.py);
greedy tokens identical, with the capacity binding (factor 1.25 and
below) and not (2.0). HF logits within 3e-4 at capacity factor 8, where
no expert overflows (HF gathers densely), as the reference's own
Mixtral test holds them.
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nos_tpu.models import convert as jconv
from nos_tpu.models import generate as jg
from nos_tpu.models import llama as jl
from nos_tpu.models import quantize as jq
from nos_tpu.models.speculative import speculative_generate as j_spec_generate
from nos_tpu.serve import Engine as JEngine, GenRequest as JRequest
from nos_tpu.serve import SpecEngine as JSpecEngine
from nos_tpu_torch.bridge import params_from_numpy, params_to_numpy
from nos_tpu_torch.models import convert as tconv
from nos_tpu_torch.models import generate as tg
from nos_tpu_torch.models import llama as tl
from nos_tpu_torch.models import quantize as tq
from nos_tpu_torch.models.llama import tree_leaves
from nos_tpu_torch.models.speculative import speculative_generate
from nos_tpu_torch.serve import Engine, GenRequest, SpecEngine
from tests.test_torch_engine import prompts_np
from tests.test_torch_llama import bridged, tokens_np
from tests.test_torch_train import LOSS_ATOL, PARAM_ATOL, max_leaf_diff, run_both

LOGIT_ATOL = 1e-5
MOE_LOSS_ATOL = 1e-6
GRAD_REL = 1e-4
HF_ATOL = 3e-4


def moe(seed=0, factor=1.25, **kw):
    return bridged(seed, n_experts=4, moe_capacity_factor=factor, **kw)


def t(x):
    return torch.from_numpy(np.asarray(x)).long()


def close(got: torch.Tensor, want, atol=LOGIT_ATOL) -> bool:
    return float(np.abs(got.numpy() - np.asarray(want)).max()) <= atol


class TestModel:
    @pytest.mark.parametrize("attention", ["dense", "flash"])
    def test_forward_and_aux_match_reference(self, attention):
        """flash: the JAX side runs its Pallas kernel in interpret mode."""
        jc, jp, tc, tp = moe(1, attention=attention)
        toks = tokens_np(2)
        want, want_aux = jl.llama_forward(jp, jnp.asarray(toks), jc, with_aux=True)
        got, aux = tl.llama_forward(tp, t(toks), tc, with_aux=True)
        assert close(got, want)
        assert abs(float(aux) - float(want_aux)) <= MOE_LOSS_ATOL
        assert float(aux) > 0.5 * tc.n_layers  # a real balance term per layer

    @pytest.mark.parametrize("remat", [False, True])
    def test_loss_and_grads_match_reference(self, remat):
        jc, jp, tc, tp = moe(3, factor=1.0, remat=remat)
        toks = tokens_np(4)
        want_loss, want_grads = jax.value_and_grad(
            lambda p: jl.llama_loss(p, jnp.asarray(toks), jc))(jp)
        leaves = [p.requires_grad_(True) for p in tree_leaves(tp)]
        loss = tl.llama_loss(tp, t(toks), tc)
        grads = torch.autograd.grad(loss, leaves)
        assert abs(float(loss) - float(want_loss)) <= MOE_LOSS_ATOL
        want = tree_leaves(params_from_numpy(jax.tree.map(np.asarray, want_grads), tc,
                                             device="cpu"))
        assert len(grads) == len(want) and len(grads) > 2 * 10
        for g, w in zip(grads, want):
            assert float((g - w).abs().max()) <= GRAD_REL * float(w.abs().max())
        router = tp["layers"][0]["moe"]["router"]
        assert router.dtype == torch.float32
        assert any(x is router and float(g.abs().max()) > 0 for x, g in zip(leaves, grads))

    def test_remat_equals_no_remat(self):
        _, _, tc, tp = moe(5)
        toks = t(tokens_np(6))
        leaves = [p.requires_grad_(True) for p in tree_leaves(tp)]
        out = []
        for remat in (False, True):
            loss = tl.llama_loss(tp, toks, dataclasses.replace(tc, remat=remat))
            out.append((loss.detach(), torch.autograd.grad(loss, leaves)))
        (l0, g0), (l1, g1) = out
        assert torch.equal(l0, l1)
        assert all(torch.equal(a, b) for a, b in zip(g0, g1))

    def test_sgd_steps_match_reference(self):
        jl_, jp, pl_, pp = run_both(3, dict(learning_rate=0.05), dict(learning_rate=0.05),
                                    n_experts=4)
        assert np.abs(np.array(jl_) - np.array(pl_)).max() <= LOSS_ATOL
        assert max_leaf_diff(pp, jp) <= PARAM_ATOL
        assert pl_[2] < pl_[0]

    def test_init_and_bridge_round_trip(self):
        tc = tl.tiny_config(n_experts=4)
        params = tl.init_llama_params(tc, 0, device="cpu")
        node = params["layers"][1]["moe"]
        assert set(params["layers"][1]) == {"attn_norm", "wq", "wk", "wv", "wo",
                                            "mlp_norm", "moe"}
        assert node["router"].dtype == torch.float32
        assert node["w_up"].dtype == torch.bfloat16 and node["w_up"].shape == (4, 64, 128)
        back = params_from_numpy(params_to_numpy(params), tc, device="cpu")
        assert all(a.dtype == b.dtype and torch.equal(a, b)
                   for a, b in zip(tree_leaves(params), tree_leaves(back)))
        q = tq.quantize_params(params)
        back = params_from_numpy(params_to_numpy(q), tc, device="cpu")
        assert isinstance(back["layers"][0]["moe"]["w_down"], tq.QuantizedExpertStack)
        assert all(a.dtype == b.dtype and torch.equal(a, b)
                   for a, b in zip(tree_leaves(q), tree_leaves(back)))


class TestGenerate:
    @pytest.mark.parametrize("factor", [2.0, 1.25])
    @pytest.mark.parametrize("fmt", ["f32", "int8"])
    def test_greedy_token_identical(self, factor, fmt):
        jc, jp, tc, tp = moe(11, factor=factor)
        if fmt == "int8":
            jp, tp = jq.quantize_params(jp), tq.quantize_params(tp)
        prompt = tokens_np(12, s=8)
        want = np.asarray(jg.generate(jp, jnp.asarray(prompt), jc, 8))
        got = tg.generate(tp, t(prompt), tc, 8)
        assert np.array_equal(got.numpy(), want)

    def test_left_padded_prefill_keeps_pads_out_of_capacity(self):
        jc, jp, tc, tp = moe(13, factor=1.0)
        prompt = tokens_np(14, b=3, s=8)
        prompt[0, :3] = -1
        prompt[2, :6] = -1
        want_logits, _ = jg.prefill(jp, jnp.asarray(prompt), jc, 16, pad_id=-1)
        got_logits, _ = tg.prefill(tp, t(prompt), tc, 16, pad_id=-1)
        assert close(got_logits, want_logits)
        want = np.asarray(jg.generate(jp, jnp.asarray(prompt), jc, 6, pad_id=-1))
        assert np.array_equal(tg.generate(tp, t(prompt), tc, 6, pad_id=-1).numpy(), want)

    def test_decode_step_derives_row_valid_from_key_valid(self):
        """Row 0's key_valid is all false: it is dead, and claims no
        expert capacity. At factor 0.5 three rows share one slot per
        expert, and the race runs in row order, so counting the dead row
        would change the live rows."""
        jc, jp, tc, tp = moe(15, factor=0.5)
        prompt = tokens_np(16, b=3, s=6)
        _, jcache = jg.prefill(jp, jnp.asarray(prompt), jc, 12)
        _, tcache = tg.prefill(tp, t(prompt), tc, 12)
        pos = np.array([6, 6, 6], np.int32)
        token = np.array([5, 9, 7], np.int32)
        key_valid = np.ones((3, 12), bool)
        key_valid[0] = False
        want, _ = jg.decode_step(jp, jcache, jnp.asarray(pos), jnp.asarray(token), jc,
                                 key_valid=jnp.asarray(key_valid))
        got, _ = tg.decode_step(tp, tcache, t(pos), t(token), tc, key_valid=t(key_valid).bool())
        assert close(got, want)
        # the mask matters here: the dead row counted changes a live row
        _, tcache = tg.prefill(tp, t(prompt), tc, 12)
        alive = tg.decode_step(tp, tcache, t(pos), t(token), tc,
                               row_valid=torch.ones(3, dtype=torch.bool))[0]
        assert not torch.allclose(alive[1:], got[1:], atol=1e-3)

    def test_decode_chunk_with_write_mask_and_row_valid(self):
        """The reference's positional order: (..., write_mask, row_valid,
        rolling). Pads and the dead row 1 claim no capacity."""
        jc, jp, tc, tp = moe(17, factor=0.5)
        prompt = tokens_np(18, b=3, s=6)
        _, jcache = jg.prefill(jp, jnp.asarray(prompt), jc, 16)
        _, tcache = tg.prefill(tp, t(prompt), tc, 16)
        pos = np.array([6, 6, 6], np.int32)
        chunk = tokens_np(19, b=3, s=4)
        write_mask = np.ones((3, 4), bool)
        write_mask[0, 2:] = False
        row_valid = np.array([True, False, True])
        want, jcache = jg.decode_chunk(jp, jcache, jnp.asarray(pos), jnp.asarray(chunk), jc,
                                       jnp.asarray(write_mask), jnp.asarray(row_valid))
        got, tcache = tg.decode_chunk(tp, tcache, t(pos), t(chunk), tc,
                                      torch.from_numpy(write_mask), torch.from_numpy(row_valid))
        assert close(got, want)
        for layer_t, layer_j in zip(tcache, jcache):
            assert close(layer_t["k"], layer_j["k"])


def serve_both(setup, requests, **engine_kw):
    jc, jp, tc, tp = setup
    out = []
    for E, R, cfg, par in ((JEngine, JRequest, jc, jp), (Engine, GenRequest, tc, tp)):
        eng = E(par, cfg, **engine_kw)
        ids = [eng.submit(R(**r)) for r in requests]
        got = eng.run()
        out.append([got[i] for i in ids])
    return out


class TestEngine:
    def test_moe_params_match_solo_generation(self):
        """The reference engine test's contract (overflow-free, factor
        4), and the reference engine's tokens."""
        setup = moe(21, factor=4.0)
        _, _, tc, tp = setup
        p = prompts_np(22, (6,))[0]
        reqs = [dict(prompt=p, max_new_tokens=6), dict(prompt=p[:3], max_new_tokens=4)]
        want, got = serve_both(setup, reqs, max_slots=2, max_len=64, ticks_per_sync=4)
        assert got == want
        for r, toks in zip(reqs, got):
            assert toks == tg.generate(tp, t([r["prompt"]]), tc, r["max_new_tokens"])[0].tolist()

    def test_idle_slots_claim_no_expert_capacity(self):
        """Default factor, one request in a 4-slot engine: the three idle
        rows (all-false key_valid) must not compete for capacity."""
        setup = moe(23)
        _, _, tc, tp = setup
        p = prompts_np(24, (8,))[0]
        want, got = serve_both(setup, [dict(prompt=p, max_new_tokens=8)],
                               max_slots=4, max_len=64, ticks_per_sync=4)
        assert got == want
        assert got[0] == tg.generate(tp, t([p]), tc, 8)[0].tolist()

    def test_mixed_admission_int8(self):
        """Padded and chunked admission (pads and write_mask out of the
        race), int8 expert stacks, a binding capacity."""
        jc, jp, tc, tp = moe(25)
        setup = (jc, jq.quantize_params(jp), tc, tq.quantize_params(tp))
        reqs = [dict(prompt=p, max_new_tokens=n) for p, n in
                zip(prompts_np(26, (5, 30, 11)), (6, 4, 7))]
        want, got = serve_both(setup, reqs, max_slots=2, max_len=64, ticks_per_sync=4,
                               prefill_chunk=16)
        assert got == want


class TestSpeculative:
    @pytest.fixture(scope="class")
    def spec_setup(self):
        """Factor 0.5: a verify chunk's capacity binds, so a riding row
        counted in the race would displace the live rows after it."""
        jc, jp, tc, tp = moe(31, factor=0.5)
        jdc, jd, tdc, td = moe(32, factor=0.5, n_layers=1)
        return jc, jp, tc, tp, jdc, jd, tdc, td

    def test_speculative_generate_with_finished_rows(self, spec_setup):
        """Row 0 stops at its first EOS and rides on, out of the race."""
        jc, jp, tc, tp, jdc, jd, tdc, td = spec_setup
        prompt = tokens_np(33, b=3, s=8)
        free = np.asarray(jg.generate(jp, jnp.asarray(prompt), jc, 10))
        eos = int(free[0, 1])
        want, jstats = j_spec_generate(jp, jd, jnp.asarray(prompt), jc, jdc, 10, k=3,
                                       eos_id=eos)
        got, stats = speculative_generate(tp, td, t(prompt), tc, tdc, 10, k=3, eos_id=eos)
        assert np.array_equal(got.numpy(), np.asarray(want))
        assert stats == pytest.approx(jstats)

    def test_spec_engine_with_finished_rows(self, spec_setup):
        jc, jp, tc, tp, jdc, jd, tdc, td = spec_setup
        reqs = [dict(prompt=p, max_new_tokens=m) for p, m in
                zip(prompts_np(34, (5, 17, 8, 3)), (3, 12, 9, 5))]
        out = []
        for E, R, cfg, par, dcfg, dpar in ((JSpecEngine, JRequest, jc, jp, jdc, jd),
                                           (SpecEngine, GenRequest, tc, tp, tdc, td)):
            eng = E(par, cfg, dpar, dcfg, k=3, max_slots=3, max_len=64)
            ids = [eng.submit(R(**r)) for r in reqs]
            got = eng.run()
            out.append(([got[i] for i in ids], eng.stats()))
        (want, jstats), (got, stats) = out
        assert got == want
        assert stats == pytest.approx(jstats)


_FAMILIES = {
    "mixtral": ("MixtralConfig", "MixtralForCausalLM",
                dict(num_key_value_heads=4, num_local_experts=4, num_experts_per_tok=2,
                     intermediate_size=96, sliding_window=None)),
    "llama": ("LlamaConfig", "LlamaForCausalLM", dict(num_key_value_heads=4)),
    "mistral": ("MistralConfig", "MistralForCausalLM",
                dict(num_key_value_heads=4, sliding_window=8)),
    "gemma": ("GemmaConfig", "GemmaForCausalLM",
              dict(num_attention_heads=4, num_key_value_heads=1, head_dim=32,
                   hidden_act="gelu_pytorch_tanh",
                   hidden_activation="gelu_pytorch_tanh")),
}


def hf_model(family):
    transformers = pytest.importorskip("transformers")
    cfg_name, model_name, extra = _FAMILIES[family]
    kw = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
              num_attention_heads=8, max_position_embeddings=64, rope_theta=10000.0,
              attention_dropout=0.0)
    kw.update(extra)
    torch.manual_seed(0)
    model = getattr(transformers, model_name)(getattr(transformers, cfg_name)(**kw))
    return model.eval()


@pytest.fixture(scope="module")
def hf_mixtral():
    return hf_model("mixtral")


class TestConvert:
    @pytest.mark.parametrize("family", sorted(_FAMILIES))
    def test_config_and_params_equal_the_reference(self, family):
        model = hf_model(family)
        jp, jc = jconv.load_hf_llama(model, dtype=jnp.float32)
        tp, tc = tconv.load_hf_llama(model, dtype=torch.float32, device="cpu")
        want = dataclasses.asdict(jc)
        got = dataclasses.asdict(tc)
        assert want.pop("dtype") == jnp.float32 and got.pop("dtype") == torch.float32
        assert got == want
        want_leaves = tree_leaves(params_from_numpy(jax.tree.map(np.asarray, jp), tc,
                                                    device="cpu"))
        got_leaves = tree_leaves(tp)
        assert len(got_leaves) == len(want_leaves)
        assert all(g.dtype == w.dtype and torch.equal(g, w)
                   for g, w in zip(got_leaves, want_leaves))
        # a new tree: no leaf aliases the model's parameters
        storages = {p.untyped_storage().data_ptr() for p in model.parameters()}
        assert not any(x.untyped_storage().data_ptr() in storages for x in got_leaves)

    def test_mixtral_logits_match_hf(self, hf_mixtral):
        params, config = tconv.load_hf_llama(hf_mixtral, dtype=torch.float32, device="cpu")
        config = dataclasses.replace(config, moe_capacity_factor=8.0)
        assert config.n_experts == 4 and config.moe_top_k == 2
        assert params["layers"][0]["moe"]["router"].dtype == torch.float32
        toks = np.random.RandomState(0).randint(1, 128, (2, 12))
        got = tl.llama_forward(params, torch.from_numpy(toks), config)
        with torch.no_grad():
            want = hf_mixtral(torch.from_numpy(toks)).logits
        assert float((got - want).abs().max()) <= HF_ATOL

    def test_guards(self, hf_mixtral):
        sd = dict(hf_mixtral.state_dict())
        _, config = tconv.load_hf_llama(hf_mixtral, dtype=torch.float32, device="cpu")
        sd["model.layers.0.self_attn.q_proj.bias"] = torch.zeros(64)
        with pytest.raises(ValueError, match="unconverted"):
            tconv.params_from_hf_state_dict(sd, config, device="cpu")
        with pytest.raises(NotImplementedError, match="item 10"):
            tconv.load_hf_llama("some/checkpoint", device="cpu")
        bad = copy.deepcopy(hf_mixtral.config)
        bad.rope_scaling = {"rope_type": "yarn", "factor": 4.0}
        with pytest.raises(ValueError, match="rope_scaling"):
            tconv.config_from_hf(bad)
