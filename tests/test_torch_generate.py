"""Port KV-cache generation (nos_tpu_torch.models.generate) against JAX.

Same bridged weights and numpy-seeded tokens on both sides, f32 tiny
configs: logits and caches within 1e-4 (identical arithmetic, matmul
summation order differs), greedy tokens identical. Sampling is compared
through its deterministic parts (the top-k / nucleus filters on fixed
logits, top-k = 1 collapsing to greedy): torch generators and
jax.random keys draw different numbers by design.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nos_tpu.models import generate as jg
from nos_tpu_torch.models import generate as tg
from tests.test_torch_llama import bridged, tokens_np

ATOL = 1e-4


def close(got, want, atol=ATOL):
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= atol, err


def cache_close(tcache, jcache, upto=None):
    for tl_, jl_ in zip(tcache, jcache):
        for key in ("k", "v"):
            close(tl_[key][:, :upto], jl_[key][:, :upto])


def t(x, dtype=torch.long):
    return torch.from_numpy(np.asarray(x)).to(dtype)


class TestPrefill:
    @pytest.mark.parametrize("attention", ["dense", "flash"])
    def test_unpadded_logits_and_cache(self, attention):
        jc, jp, tc, tp = bridged(0, attention=attention)
        toks = tokens_np(1, s=12)
        jlog, jcache = jg.prefill(jp, jnp.asarray(toks), jc, 20)
        tlog, tcache = tg.prefill(tp, t(toks), tc, 20)
        close(tlog, jlog)
        cache_close(tcache, jcache)
        assert tcache[0]["k"].shape == (2, 20, 8, 8)

    def test_left_padded_logits_and_cache(self):
        jc, jp, tc, tp = bridged(1)
        toks = tokens_np(2, s=10)
        toks[0, :4] = -1  # row 0 left-padded by 4
        toks[1, :1] = -1
        jlog, jcache = jg.prefill(jp, jnp.asarray(toks), jc, 16, pad_id=-1)
        tlog, tcache = tg.prefill(tp, t(toks), tc, 16, pad_id=-1)
        close(tlog, jlog)
        cache_close(tcache, jcache)

    def test_contract_errors(self):
        jc, jp, tc, tp = bridged(2, sliding_window=4)
        with pytest.raises(ValueError, match="exceeds"):
            tg.prefill(tp, t(tokens_np(3, s=12)), tc, 8)
        with pytest.raises(ValueError, match="sliding_window"):
            tg.prefill(tp, t(tokens_np(3, s=8)), tc, 16, pad_id=-1)
        # the int8 cache keeps the same contract
        with pytest.raises(ValueError, match="sliding_window"):
            tg.prefill(tp, t(tokens_np(3, s=8)), tc, 16, pad_id=-1, quant=True)
        _, cache = tg.prefill(tp, t(tokens_np(3, s=8)), tc, 16, quant=True)
        with pytest.raises(ValueError, match="per-row"):
            tg.decode_step(tp, cache, 8, t([1, 2]), tc, rolling=True)


class TestDecode:
    def _prefilled(self, seed=3, s=8, max_len=24, **cfg):
        jc, jp, tc, tp = bridged(seed, **cfg)
        toks = tokens_np(seed, s=s)
        _, jcache = jg.prefill(jp, jnp.asarray(toks), jc, max_len)
        _, tcache = tg.prefill(tp, t(toks), tc, max_len)
        return jc, jp, tc, tp, jcache, tcache

    def test_scalar_pos(self):
        jc, jp, tc, tp, jcache, tcache = self._prefilled()
        tok = np.array([5, 9], np.int32)
        jlog, jcache = jg.decode_step(jp, jcache, jnp.asarray(8), jnp.asarray(tok), jc)
        tlog, tcache = tg.decode_step(tp, tcache, 8, t(tok), tc)
        close(tlog, jlog)
        cache_close(tcache, jcache)

    def test_per_row_pos_and_key_valid(self):
        jc, jp, tc, tp, jcache, tcache = self._prefilled(4)
        tok = np.array([5, 9], np.int32)
        pos = np.array([8, 5], np.int32)
        kv = np.ones((2, 24), bool)
        kv[1, 2] = False
        jlog, jcache = jg.decode_step(jp, jcache, jnp.asarray(pos), jnp.asarray(tok), jc,
                                      key_valid=jnp.asarray(kv))
        tlog, tcache = tg.decode_step(tp, tcache, t(pos), t(tok), tc, key_valid=t(kv, torch.bool))
        close(tlog, jlog)
        cache_close(tcache, jcache)

    def test_write_past_the_cache_is_dropped(self):
        # a slot riding past its frontier: the reference's scatter drops
        # the write, the port masks it; both leave the cache untouched
        jc, jp, tc, tp, jcache, tcache = self._prefilled(5)
        before = [layer["k"].clone() for layer in tcache]
        tok = np.array([5, 9], np.int32)
        pos = np.array([8, 30], np.int32)  # row 1 far past T = 24
        jlog, jcache = jg.decode_step(jp, jcache, jnp.asarray(pos), jnp.asarray(tok), jc)
        tlog, tcache = tg.decode_step(tp, tcache, t(pos), t(tok), tc)
        close(tlog, jlog)
        cache_close(tcache, jcache)
        for layer, old in zip(tcache, before):
            assert torch.equal(layer["k"][1], old[1])

    def test_chunk_with_write_mask(self):
        jc, jp, tc, tp = bridged(6)
        t_cache = 17  # 16 + the sacrificial pad slot
        jcache = jg.init_kv_cache(jc, 2, t_cache)
        tcache = tg.init_kv_cache(tc, 2, t_cache, device="cpu")
        toks = tokens_np(6, s=8)
        pos = np.array([0, 3], np.int32)
        mask = np.ones((2, 8), bool)
        mask[1, 5:] = False  # row 1: 5 real tokens, 3 right pads
        jlog, jcache = jg.decode_chunk(jp, jcache, jnp.asarray(pos), jnp.asarray(toks), jc,
                                       write_mask=jnp.asarray(mask))
        tlog, tcache = tg.decode_chunk(tp, tcache, t(pos), t(toks), tc,
                                       write_mask=t(mask, torch.bool))
        close(tlog, jlog)
        cache_close(tcache, jcache, upto=t_cache - 1)

    def test_rolling_chunk_and_step(self):
        jc, jp, tc, tp = bridged(7, sliding_window=4)
        jcache = jg.init_kv_cache(jc, 1, 9)  # C = 8 >= window + m
        tcache = tg.init_kv_cache(tc, 1, 9, device="cpu")
        for start in (0, 4, 8):  # wraps the 8-slot ring
            toks = tokens_np(start, b=1, s=4)
            pos = np.array([start], np.int32)
            jlog, jcache = jg.decode_chunk(jp, jcache, jnp.asarray(pos), jnp.asarray(toks),
                                           jc, rolling=True)
            tlog, tcache = tg.decode_chunk(tp, tcache, t(pos), t(toks), tc, rolling=True)
            close(tlog, jlog)
        pos = np.array([12], np.int32)
        tok = np.array([3], np.int32)
        jlog, jcache = jg.decode_step(jp, jcache, jnp.asarray(pos), jnp.asarray(tok), jc,
                                      rolling=True)
        tlog, tcache = tg.decode_step(tp, tcache, t(pos), t(tok), tc, rolling=True)
        close(tlog, jlog)
        cache_close(tcache, jcache, upto=8)


class TestGenerate:
    @pytest.mark.parametrize("attention", ["dense", "flash"])
    def test_greedy_token_identical(self, attention):
        jc, jp, tc, tp = bridged(8, attention=attention)
        toks = tokens_np(8, s=12)
        want = np.asarray(jg.generate(jp, jnp.asarray(toks), jc, 10))
        got = tg.generate(tp, t(toks), tc, 10)
        assert got.shape == (2, 10)
        assert np.array_equal(got.numpy(), want)
        # and the cache-free oracle agrees with the cached path
        assert torch.equal(tg.reference_generate(tp, t(toks), tc, 10), got)

    def test_left_padded_with_eos(self):
        jc, jp, tc, tp = bridged(9)
        toks = tokens_np(9, s=10)
        toks[toks == 0] = 1
        toks[0, :3] = 0  # pad_id 0, left padding
        free = np.asarray(jg.generate(jp, jnp.asarray(toks), jc, 8, pad_id=0))
        assert np.array_equal(tg.generate(tp, t(toks), tc, 8, pad_id=0).numpy(), free)
        eos = int(free[0, 3])
        want = np.asarray(jg.generate(jp, jnp.asarray(toks), jc, 8, pad_id=0, eos_id=eos))
        got = tg.generate(tp, t(toks), tc, 8, pad_id=0, eos_id=eos)
        assert np.array_equal(got.numpy(), want)

    def test_top_k_one_sampling_equals_greedy(self):
        jc, jp, tc, tp = bridged(10)
        toks = t(tokens_np(10, s=6))
        greedy = tg.generate(tp, toks, tc, 8)
        sampled = tg.generate(tp, toks, tc, 8, temperature=0.8, top_k=1)
        assert torch.equal(sampled, greedy)

    def test_sampling_reproducible_per_generator_seed(self):
        jc, jp, tc, tp = bridged(11)
        toks = t(tokens_np(11, s=6))

        def run(seed):
            gen = torch.Generator().manual_seed(seed)
            return tg.generate(tp, toks, tc, 12, temperature=1.0, top_p=0.95, rng=gen)

        assert torch.equal(run(1), run(1))
        assert not torch.equal(run(1), run(2))

    def test_kv_quant_raises(self):
        """kv_quant generation raises where the reference raises (a left-
        padded prompt on a sliding-window config) and otherwise runs:
        token parity is tests/test_torch_kv_quant.py's."""
        jc, jp, tc, tp = bridged(12, sliding_window=4)
        toks = tokens_np(12, s=6)
        toks[0, :2] = 0
        with pytest.raises(ValueError, match="sliding_window"):
            jg.generate(jp, jnp.asarray(toks), jc, 2, pad_id=0, kv_quant=True)
        with pytest.raises(ValueError, match="sliding_window"):
            tg.generate(tp, t(toks), tc, 2, pad_id=0, kv_quant=True)
        want = np.asarray(jg.generate(jp, jnp.asarray(toks), jc, 4, kv_quant=True))
        assert np.array_equal(tg.generate(tp, t(toks), tc, 4, kv_quant=True).numpy(), want)


class TestSamplingFilters:
    @pytest.mark.parametrize("top_k,top_p", [
        (0, 0.9), (5, 1.0), (5, 0.5), (0, 0.0), (50, 0.3), (1, 0.99),
    ])
    def test_filter_logits_matches(self, top_k, top_p):
        logits = np.random.default_rng(13).standard_normal((3, 50)).astype(np.float32) * 3
        want = np.asarray(jg._filter_logits(jnp.asarray(logits), top_k, top_p))
        got = tg._filter_logits(torch.from_numpy(logits), top_k, top_p).numpy()
        assert np.array_equal(np.isneginf(got), np.isneginf(want))
        kept = ~np.isneginf(want)
        assert np.array_equal(got[kept], want[kept])

    def test_nucleus_cutoff_matches(self):
        logits = np.sort(np.random.default_rng(14).standard_normal((4, 30)).astype(np.float32))[:, ::-1]
        top_p = np.array([[0.1], [0.5], [0.9], [0.0]], np.float32)
        want = np.asarray(jg._nucleus_cutoff(jnp.asarray(logits), jnp.asarray(top_p)))
        got = tg._nucleus_cutoff(torch.from_numpy(logits.copy()), torch.from_numpy(top_p))
        assert np.array_equal(got.numpy(), want)

    def test_pick_tokens_per_row(self):
        logits = torch.from_numpy(
            np.random.default_rng(15).standard_normal((4, 40)).astype(np.float32))
        gens = [None, torch.Generator().manual_seed(1), torch.Generator().manual_seed(2), None]
        temp = torch.tensor([0.0, 0.7, 1.3, 0.0])
        top_k = torch.tensor([0, 1, 1, 3])
        top_p = torch.tensor([1.0, 1.0, 0.9, 0.5])
        got = tg.pick_tokens_per_row(logits, temp, top_k, top_p, gens)
        # greedy rows and top_k = 1 rows all collapse to the argmax
        assert torch.equal(got, logits.argmax(-1))
