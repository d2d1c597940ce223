"""Port speculative decoding (models/speculative.py, serve/spec_engine.py)
against JAX.

Same bridged f32 tiny weights (a 2-layer target, a 1-layer draft of its
own seed) and numpy-seeded prompts on both sides. Tokens must be
identical, and so must the acceptance statistics: both are functions of
the greedy draft and target tokens, which f32 keeps identical (the
chunk-vs-step drift sits far below every argmax gap here).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nos_tpu.models import generate as jg
from nos_tpu.models.speculative import speculative_generate as j_spec_generate
from nos_tpu.serve import GenRequest as JRequest, SpecEngine as JSpecEngine
from nos_tpu_torch.models import generate as tg
from nos_tpu_torch.models.lora import LoraConfig, init_lora_params, stack_lora_adapters
from nos_tpu_torch.models.speculative import speculative_generate
from nos_tpu_torch.serve import Engine, GenRequest, SpecEngine
from nos_tpu_torch.util import metrics
from tests.test_torch_engine import prompts_np
from tests.test_torch_llama import bridged, tokens_np


@pytest.fixture(scope="module")
def setup():
    jc, jp, tc, tp = bridged(0)
    jdc, jd, tdc, td = bridged(7, n_layers=1)
    return jc, jp, tc, tp, jdc, jd, tdc, td


def t(x):
    return torch.from_numpy(np.asarray(x)).long()


class TestSpeculativeGenerate:
    @pytest.mark.parametrize("k", [1, 3, 4])
    def test_token_identical_to_reference_and_to_generate(self, setup, k):
        jc, jp, tc, tp, jdc, jd, tdc, td = setup
        prompt = tokens_np(1, s=8)
        want, jstats = j_spec_generate(jp, jd, jnp.asarray(prompt), jc, jdc, 10, k=k)
        got, stats = speculative_generate(tp, td, t(prompt), tc, tdc, 10, k=k)
        assert np.array_equal(got.numpy(), np.asarray(want))
        assert stats == pytest.approx(jstats)
        assert torch.equal(got, tg.generate(tp, t(prompt), tc, 10))
        assert 0.0 <= stats["mean_accepted"] <= k

    def test_perfect_draft_accepts_everything(self, setup):
        jc, jp, tc, tp, *_ = setup
        prompt = tokens_np(2, s=8)
        got, stats = speculative_generate(tp, tp, t(prompt), tc, tc, 10, k=4)
        assert torch.equal(got, tg.generate(tp, t(prompt), tc, 10))
        assert stats["mean_accepted"] == pytest.approx(4.0)

    def test_eos_freezes_rows(self, setup):
        jc, jp, tc, tp, jdc, jd, tdc, td = setup
        prompt = tokens_np(3, s=8)
        free = np.asarray(jg.generate(jp, jnp.asarray(prompt), jc, 8))
        eos = int(free[0, 2])
        want, _ = j_spec_generate(jp, jd, jnp.asarray(prompt), jc, jdc, 8, k=3, eos_id=eos)
        got, _ = speculative_generate(tp, td, t(prompt), tc, tdc, 8, k=3, eos_id=eos)
        assert np.array_equal(got.numpy(), np.asarray(want))


def serve_both(setup, requests, steps_before=0, late=(), **kw):
    """Both SpecEngines over the same requests → (reference completions,
    port completions, port engine, reference stats)."""
    jc, jp, tc, tp, jdc, jd, tdc, td = setup
    out = []
    for E, R, cfg, par, dcfg, dpar in ((JSpecEngine, JRequest, jc, jp, jdc, jd),
                                       (SpecEngine, GenRequest, tc, tp, tdc, td)):
        eng = E(par, cfg, dpar, dcfg, **kw)
        ids = [eng.submit(R(**r)) for r in requests]
        for _ in range(steps_before):
            eng.step()
        ids += [eng.submit(R(**r)) for r in late]
        got = eng.run()
        out.append(([got[i] for i in ids], eng))
    (want, jeng), (got, teng) = out
    return want, got, teng, jeng.stats()


class TestSpecEngine:
    def test_mixed_workload_matches_reference(self, setup):
        reqs = [dict(prompt=p, max_new_tokens=m) for p, m in
                zip(prompts_np(4, (5, 17, 8, 3, 11)), (9, 4, 12, 7, 6))]
        want, got, eng, jstats = serve_both(setup, reqs, k=3, max_slots=2, max_len=64)
        assert got == want
        assert eng.stats() == pytest.approx(jstats)
        assert eng.stats()["rounds"] > 0 and 0.0 <= eng.stats()["mean_accepted"] <= 3.0
        # and the target's own greedy stream: the plain engine
        _, _, tc, tp, *_ = setup
        base = Engine(tp, tc, max_slots=2, max_len=64, ticks_per_sync=4)
        ids = [base.submit(GenRequest(**r)) for r in reqs]
        plain = base.run()
        assert got == [plain[i] for i in ids]

    def test_slot_reuse_staggered(self, setup):
        first = [dict(prompt=p, max_new_tokens=m)
                 for p, m in zip(prompts_np(5, (4, 9)), (3, 10))]
        late = [dict(prompt=prompts_np(6, (6,))[0], max_new_tokens=5)]
        want, got, _, _ = serve_both(setup, first, steps_before=1, late=late, k=2,
                                     max_slots=2, max_len=64)
        assert got == want

    def test_eos_mid_round_and_prefix_cache(self, setup):
        system = prompts_np(7, (20,))[0]
        reqs = [dict(prompt=system + tail, max_new_tokens=12)
                for tail in prompts_np(8, (3, 5))]
        want, got, _, _ = serve_both(setup, reqs, k=3, max_slots=1, max_len=64,
                                     prefill_chunk=8, prefix_cache_entries=2)
        assert got == want
        eos = got[0][next(i for i in range(2, 12) if got[0][i] not in got[0][:i])]
        reqs[0]["eos_id"] = eos
        want, got2, _, _ = serve_both(setup, reqs[:1], k=3, max_slots=1, max_len=64)
        assert got2 == want and got2[0] == got[0][:got[0].index(eos) + 1]

    def test_capacity_and_guards(self, setup):
        jc, jp, tc, tp, jdc, jd, tdc, td = setup
        spec = SpecEngine(tp, tc, td, tdc, k=4, max_slots=1, max_len=32)
        with pytest.raises(ValueError, match="cache slots"):
            spec.submit(GenRequest(prompt=[1] * 20, max_new_tokens=8))  # 33 > 32
        with pytest.raises(ValueError, match="argmax"):
            spec.submit(GenRequest(prompt=[3], max_new_tokens=4, temperature=0.5))
        rid = spec.submit(GenRequest(prompt=[1] * 18, max_new_tokens=8))  # 31 fits
        assert len(spec.run()[rid]) == 8
        with pytest.raises(ValueError, match="KV cache"):
            SpecEngine(tp, tc, td, tdc, max_len=64, kv_quant=True)
        with pytest.raises(ValueError, match="rolling"):
            SpecEngine(tp, tc, td, tdc, max_len=64, rolling=True)
        lora = LoraConfig(rank=2)
        stacked = stack_lora_adapters(
            tp, [init_lora_params(tc, lora, device="cpu")], lora)
        with pytest.raises(ValueError, match="LoRA"):
            SpecEngine(stacked, tc, td, tdc, max_len=64)

    def test_acceptance_counters(self, setup):
        _, _, tc, tp, _, _, tdc, td = setup
        before = [m.value for m in (metrics.SERVE_SPEC_ROUNDS, metrics.SERVE_SPEC_DRAFT_TOKENS,
                                    metrics.SERVE_SPEC_ACCEPTED_TOKENS, metrics.SERVE_TOKENS)]
        spec = SpecEngine(tp, tc, td, tdc, k=3, max_slots=2, max_len=64, model="spec-port")
        ids = [spec.submit(GenRequest(prompt=p, max_new_tokens=m))
               for p, m in zip(prompts_np(9, (5, 9, 4)), (8, 6, 10))]
        outs = spec.run()
        rounds, draft, accepted, tokens = (
            m.value - b for m, b in zip(
                (metrics.SERVE_SPEC_ROUNDS, metrics.SERVE_SPEC_DRAFT_TOKENS,
                 metrics.SERVE_SPEC_ACCEPTED_TOKENS, metrics.SERVE_TOKENS), before))
        assert tokens == sum(len(outs[i]) for i in ids) == 24
        assert rounds > 0 and draft == rounds * 3 and 0 <= accepted <= draft
        assert spec.stats()["mean_accepted"] == pytest.approx(accepted / rounds)
        assert 'model="spec-port"' in metrics.REGISTRY.render()
