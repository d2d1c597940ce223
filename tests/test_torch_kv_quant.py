"""Port int8 KV cache (generate.py ``quant`` / ``kv_quant``, the engine's
``kv_quant``) against JAX.

Same bridged f32 tiny weights and numpy-seeded tokens on both sides.
Tolerances:

- ``_quantize_kv`` on the same vectors: int8 values and scales
  bit-identical;
- cache contents after a model write: the K/V the two frameworks compute
  differ in their last f32 bits (summation order), so an int8 value on a
  rounding edge may round the other way: within 1, and scales within
  1e-5 relative;
- prefill logits within 1e-4 (as the unquantized cache, tests/
  test_torch_generate.py), and exactly equal to the unquantized
  prefill's (the prompt attends its exact fresh K/V); logits that read
  K/V written in the same call (decode_step, decode_chunk) within 1e-3:
  one int8 value rounding the other way moves the logits of the queries
  that read it by a part of one int8 step (observed: one value of 2048,
  1.8e-4 at one position of a decode_chunk);
- greedy tokens and Engine completions identical.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nos_tpu.models import generate as jg
from nos_tpu.serve import Engine as JEngine, GenRequest as JRequest
from nos_tpu_torch.models import generate as tg
from nos_tpu_torch.serve import Engine, GenRequest
from nos_tpu_torch.util import metrics
from tests.test_torch_engine import prompts_np
from tests.test_torch_generate import close
from tests.test_torch_llama import bridged, tokens_np


def t(x, dtype=torch.long):
    return torch.from_numpy(np.asarray(x)).to(dtype)


@pytest.fixture(scope="module")
def setup():
    return bridged(0)


QUANT_ATOL = 1e-3


def quant_cache_close(tcache, jcache, upto=None):
    for tl_, jl_ in zip(tcache, jcache):
        assert set(tl_) == {"k", "v", "k_scale", "v_scale"}
        for key in ("k", "v"):
            got = tl_[key][:, :upto].numpy().astype(np.int32)
            want = np.asarray(jl_[key][:, :upto]).astype(np.int32)
            assert tl_[key].dtype == torch.int8
            assert np.abs(got - want).max() <= 1
        for key in ("k_scale", "v_scale"):
            got = tl_[key][:, :upto].numpy()
            want = np.asarray(jl_[key][:, :upto])
            assert np.allclose(got, want, rtol=1e-5, atol=0)


class TestQuantizeKv:
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_values_and_scales_bit_identical(self, dtype):
        rng = np.random.default_rng(1)
        vec = (rng.standard_normal((3, 5, 2, 16)) * 3).astype(np.float32)
        vec[0, 0, 0] = 0.0  # an all-zero vector takes scale 1
        jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
        q8, scale = jg._quantize_kv(jnp.asarray(vec, jdt))
        got_q, got_s = tg._quantize_kv(torch.from_numpy(vec).to(dtype))
        assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
        assert np.array_equal(got_q.numpy(), np.asarray(q8))
        assert np.array_equal(got_s.numpy(), np.asarray(scale))
        assert float(got_s[0, 0, 0]) == 1.0

    def test_init_layout_and_bytes(self, setup):
        _, _, tc, _ = setup
        full = tg.init_kv_cache(tc, 4, 128, device="cpu")
        q8 = tg.init_kv_cache(tc, 4, 128, quant=True, device="cpu")
        assert q8[0]["k"].dtype == torch.int8 and q8[0]["k"].shape == (4, 128, 8, 8)
        assert q8[0]["k_scale"].dtype == torch.float32
        assert q8[0]["v_scale"].shape == (4, 128, 8)
        assert tg._kv_quantized(q8) and not tg._kv_quantized(full)

        def nbytes(cache):
            return sum(x.numel() * x.element_size() for layer in cache for x in layer.values())

        # f32 model: int8 quarters the values, scales add 4/hd of them
        assert nbytes(q8) / nbytes(full) == pytest.approx(0.25 + 1 / 8)


class TestQuantizedCachePaths:
    @pytest.mark.parametrize("attention", ["dense", "flash"])
    def test_prefill_logits_exact_and_cache_matches(self, attention):
        jc, jp, tc, tp = bridged(1, attention=attention)
        toks = tokens_np(1, s=12)
        jlog, jcache = jg.prefill(jp, jnp.asarray(toks), jc, 20, quant=True)
        tlog, tcache = tg.prefill(tp, t(toks), tc, 20, quant=True)
        plain, _ = tg.prefill(tp, t(toks), tc, 20)
        assert torch.equal(tlog, plain)  # the prompt attends its exact K/V
        close(tlog, jlog)
        quant_cache_close(tcache, jcache)

    def test_left_padded_prefill(self, setup):
        jc, jp, tc, tp = setup
        toks = tokens_np(2, s=10)
        toks[0, :3] = -1
        jlog, jcache = jg.prefill(jp, jnp.asarray(toks), jc, 16, pad_id=-1, quant=True)
        tlog, tcache = tg.prefill(tp, t(toks), tc, 16, pad_id=-1, quant=True)
        close(tlog, jlog)
        quant_cache_close(tcache, jcache)

    def _prefilled(self, setup, seed, s=8, max_len=24):
        jc, jp, tc, tp = setup
        toks = tokens_np(seed, s=s)
        _, jcache = jg.prefill(jp, jnp.asarray(toks), jc, max_len, quant=True)
        _, tcache = tg.prefill(tp, t(toks), tc, max_len, quant=True)
        return jc, jp, tc, tp, jcache, tcache

    def test_decode_step_scalar_pos(self, setup):
        jc, jp, tc, tp, jcache, tcache = self._prefilled(setup, 3)
        tok = np.array([5, 9], np.int32)
        jlog, jcache = jg.decode_step(jp, jcache, jnp.asarray(8), jnp.asarray(tok), jc)
        tlog, tcache = tg.decode_step(tp, tcache, 8, t(tok), tc)
        close(tlog, jlog, QUANT_ATOL)
        quant_cache_close(tcache, jcache)

    def test_decode_step_per_row_with_a_write_past_the_cache(self, setup):
        # row 1 rides far past T = 24: the reference's scatter drops the
        # write, the port masks it in the K/V AND the scale buffers
        jc, jp, tc, tp, jcache, tcache = self._prefilled(setup, 4)
        before = [{k: v.clone() for k, v in layer.items()} for layer in tcache]
        tok = np.array([5, 9], np.int32)
        pos = np.array([8, 30], np.int32)
        kv = np.ones((2, 24), bool)
        jlog, jcache = jg.decode_step(jp, jcache, jnp.asarray(pos), jnp.asarray(tok), jc,
                                      key_valid=jnp.asarray(kv))
        tlog, tcache = tg.decode_step(tp, tcache, t(pos), t(tok), tc,
                                      key_valid=t(kv, torch.bool))
        close(tlog, jlog, QUANT_ATOL)
        quant_cache_close(tcache, jcache)
        for layer, old in zip(tcache, before):
            for key in layer:
                assert torch.equal(layer[key][1], old[key][1]), key
            assert float(layer["k_scale"][0, 8].abs().min()) > 0  # row 0 wrote

    def test_decode_chunk_with_write_mask(self, setup):
        jc, jp, tc, tp = setup
        t_cache = 17
        jcache = jg.init_kv_cache(jc, 2, t_cache, quant=True)
        tcache = tg.init_kv_cache(tc, 2, t_cache, quant=True, device="cpu")
        toks = tokens_np(6, s=8)
        pos = np.array([0, 3], np.int32)
        mask = np.ones((2, 8), bool)
        mask[1, 5:] = False
        jlog, jcache = jg.decode_chunk(jp, jcache, jnp.asarray(pos), jnp.asarray(toks), jc,
                                       write_mask=jnp.asarray(mask))
        tlog, tcache = tg.decode_chunk(tp, tcache, t(pos), t(toks), tc,
                                       write_mask=t(mask, torch.bool))
        close(tlog, jlog, QUANT_ATOL)
        quant_cache_close(tcache, jcache, upto=t_cache - 1)

    def test_decode_logits_close_to_the_full_cache(self, setup):
        """Lossy by design: one decode step on an int8 cache stays within
        5% (relative to the largest logit) of the full-precision cache,
        the reference's own bound (tests/models/test_kv_quant.py)."""
        _, _, tc, tp = setup
        prompt = t(prompts_np(5, (24,)))
        _, cache_f = tg.prefill(tp, prompt, tc, 64)
        _, cache_q = tg.prefill(tp, prompt, tc, 64, quant=True)
        tok = torch.tensor([7])
        lf, _ = tg.decode_step(tp, cache_f, torch.tensor([24]), tok, tc)
        lq, _ = tg.decode_step(tp, cache_q, torch.tensor([24]), tok, tc)
        assert float((lf - lq).abs().max() / lf.abs().max()) < 0.05

    @pytest.mark.parametrize("attention", ["dense", "flash"])
    def test_generate_kv_quant_token_identical(self, attention):
        jc, jp, tc, tp = bridged(7, attention=attention)
        toks = tokens_np(7, s=12)
        want = np.asarray(jg.generate(jp, jnp.asarray(toks), jc, 10, kv_quant=True))
        got = tg.generate(tp, t(toks), tc, 10, kv_quant=True)
        assert np.array_equal(got.numpy(), want)


def serve_both(setup, requests, **engine_kw):
    jc, jp, tc, tp = setup
    out, engines = [], []
    for E, R, cfg, par in ((JEngine, JRequest, jc, jp), (Engine, GenRequest, tc, tp)):
        eng = E(par, cfg, kv_quant=True, **engine_kw)
        ids = [eng.submit(R(**dict(r))) for r in requests]
        got = eng.run()
        out.append([got[i] for i in ids])
        engines.append(eng)
    return out, engines[1]


class TestEngineKvQuant:
    def test_mixed_workload_with_a_prefix_hit(self, setup):
        hits0 = metrics.SERVE_PREFIX_HITS.value
        system = prompts_np(8, (40,))[0]
        reqs = [dict(prompt=p, max_new_tokens=6) for p in prompts_np(9, (5, 11, 3))]
        reqs += [dict(prompt=system + tail, max_new_tokens=5)
                 for tail in prompts_np(10, (5, 7))]
        (want, got), eng = serve_both(setup, reqs, max_slots=2, max_len=96,
                                      prefill_chunk=16, ticks_per_sync=2,
                                      prefix_cache_entries=4)
        assert got == want
        assert metrics.SERVE_PREFIX_HITS.value - hits0 >= 1
        # the prefix entry carries the scale buffers beside the int8 K/V
        (entry,) = eng._prefix_cache.values()
        for layer in entry:
            assert set(layer) == {"k", "v", "k_scale", "v_scale"}
            assert layer["k_scale"].shape == (1, 32, 8)
            assert float(layer["k_scale"].abs().min()) > 0

    def test_rolling_window(self):
        setup_w = bridged(2, sliding_window=16)
        reqs = [dict(prompt=p, max_new_tokens=m)
                for p, m in zip(prompts_np(11, (30, 9)), (60, 12))]
        (want, got), _ = serve_both(setup_w, reqs, max_slots=1, max_len=33,
                                    ticks_per_sync=4, prefill_chunk=8, rolling=True)
        assert got == want
        assert len(got[0]) == 60

    def test_splice_carries_the_scale_buffers(self, setup):
        """Admission copies every key of the row cache into the batch
        slot: the scales written at the row's prompt positions arrive."""
        _, _, tc, tp = setup
        eng = Engine(tp, tc, max_slots=2, max_len=64, prefill_chunk=8, kv_quant=True)
        prompt = prompts_np(12, (20,))[0]  # bucket 32 > chunk 8: chunked
        request = GenRequest(prompt=prompt, max_new_tokens=2, id=0)
        eng._admit(1, request)
        _, row = tg.prefill(tp, t([prompt]), tc, 64, quant=True)
        for layer in eng._cache:
            assert layer["k_scale"].dtype == torch.float32
            assert float(layer["v_scale"][1, :20].abs().min()) > 0
            assert float(layer["k_scale"][0].abs().max()) == 0  # slot 0 untouched
        # layer 0's keys see only the embeddings: the one-shot prefill
        # writes the same scales (later layers read quantized pieces)
        assert torch.allclose(eng._cache[0]["k_scale"][1, :20], row[0]["k_scale"][0, :20],
                              rtol=1e-5)
