"""Port serving engine (nos_tpu_torch.serve) against the JAX engine.

Both engines serve the same requests on the same bridged f32 tiny
weights; greedy completions must be token-identical (the reference
engine's own contract with solo generation, carried across frameworks).
Port-only checks cover what cannot be compared bit for bit: sampled
streams (torch generators, not jax.random keys) and the port's own
metrics registry.
"""
import numpy as np
import pytest
import torch

from nos_tpu.serve import Engine as JEngine, GenRequest as JRequest
from nos_tpu_torch.serve import Engine, GenRequest
from nos_tpu_torch.util import metrics
from tests.test_torch_llama import bridged


@pytest.fixture(scope="module")
def setup():
    return bridged(0)


def prompts_np(seed, lengths, vocab=256):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, n).tolist() for n in lengths]


def serve_both(setup, requests, **engine_kw):
    """Run ``requests`` (GenRequest kwargs) through both engines → the
    two lists of completions, in submission order."""
    jc, jp, tc, tp = setup
    out = []
    for E, R, cfg, par in ((JEngine, JRequest, jc, jp), (Engine, GenRequest, tc, tp)):
        eng = E(par, cfg, **engine_kw)
        ids = [eng.submit(R(**dict(r))) for r in requests]
        got = eng.run()
        out.append([got[i] for i in ids])
    return out


class TestEngineParity:
    def test_mixed_lengths_padded_and_chunked(self, setup):
        reqs = [dict(prompt=p, max_new_tokens=6)
                for p in prompts_np(1, (5, 11, 3, 17, 8, 21, 40))]
        want, got = serve_both(setup, reqs, max_slots=3, max_len=64,
                               prefill_chunk=8, ticks_per_sync=2)
        assert got == want

    def test_prefix_cache_hits(self, setup):
        before = metrics.SERVE_PREFIX_HITS.value
        system = prompts_np(2, (40,))[0]
        reqs = [dict(prompt=system + tail, max_new_tokens=4)
                for tail in prompts_np(3, (5, 7, 3))]
        want, got = serve_both(setup, reqs, max_slots=2, max_len=128,
                               prefill_chunk=16, prefix_cache_entries=4)
        assert got == want
        assert metrics.SERVE_PREFIX_HITS.value - before >= 2

    def test_eos_mid_horizon(self, setup):
        p = prompts_np(4, (6,))[0]
        (free,), _ = serve_both(setup, [dict(prompt=p, max_new_tokens=12)],
                                max_slots=1, max_len=64, ticks_per_sync=2)
        cut = next(i for i in range(2, 12) if free[i] not in free[:i])
        want, got = serve_both(
            setup, [dict(prompt=p, max_new_tokens=12, eos_id=free[cut])],
            max_slots=1, max_len=64, ticks_per_sync=2,
        )
        assert got == want == [free[:cut + 1]]

    def test_slot_riding_past_its_frontier(self, setup):
        # a short-budget request shares the round with two long ones: the
        # horizon follows the long budgets, so the short slot rides ~32
        # ticks past its frontier and its writes fall outside the cache
        # (dropped by the reference's scatter, masked by the port)
        long_a, long_b = prompts_np(5, (3, 4))
        reqs = [
            dict(prompt=prompts_np(6, (17,))[0], max_new_tokens=5),
            dict(prompt=long_a, max_new_tokens=30),
            dict(prompt=long_b, max_new_tokens=30),
        ]
        want, got = serve_both(setup, reqs, max_slots=3, max_len=40,
                               ticks_per_sync=4)
        assert got == want
        assert [len(x) for x in got] == [5, 30, 30]

    def test_rolling_sliding_window(self):
        setup_w = bridged(1, sliding_window=16)
        reqs = [dict(prompt=p, max_new_tokens=m) for p, m in
                zip(prompts_np(7, (5, 20, 40)), (9, 6, 60))]
        want, got = serve_both(setup_w, reqs, max_slots=2, max_len=33,
                               ticks_per_sync=4, prefill_chunk=8, rolling=True)
        assert got == want
        assert len(got[2]) == 60  # 100 logical positions through 32 slots

    def test_on_token_streaming(self, setup):
        p = prompts_np(8, (6,))[0]
        streamed = {}

        def cb(rid, tok):
            streamed.setdefault(rid, []).append(tok)

        eng = Engine(setup[3], setup[2], max_slots=2, max_len=64, ticks_per_sync=4)
        r1 = eng.submit(GenRequest(prompt=p, max_new_tokens=9, on_token=cb))
        r2 = eng.submit(GenRequest(prompt=p[:3], max_new_tokens=5, on_token=cb))
        got = eng.run()
        assert streamed[r1] == got[r1] and len(got[r1]) == 9
        assert streamed[r2] == got[r2] and len(got[r2]) == 5
        want, _ = serve_both(setup, [dict(prompt=p, max_new_tokens=9),
                                     dict(prompt=p[:3], max_new_tokens=5)],
                             max_slots=2, max_len=64, ticks_per_sync=4)
        assert [got[r1], got[r2]] == want

    def test_virtual_clock_latencies_match(self, setup):
        # under the deterministic cost clock every latency is a function
        # of the scheduling decisions alone: both engines must agree
        from nos_tpu.serve import VirtualServeClock as JClock
        from nos_tpu_torch.serve import VirtualServeClock

        jc, jp, tc, tp = setup
        stamps = []
        for E, R, cfg, par, clock in ((JEngine, JRequest, jc, jp, JClock),
                                      (Engine, GenRequest, tc, tp, VirtualServeClock)):
            eng = E(par, cfg, max_slots=2, max_len=64, ticks_per_sync=2,
                    prefill_chunk=8, clock=clock())
            ids = [eng.submit(R(prompt=p, max_new_tokens=n)) for p, n in
                   zip(prompts_np(16, (5, 12, 7)), (4, 6, 3))]
            eng.run()
            recs = [eng.telemetry.record(i) for i in ids]
            stamps.append([(r.queue_wait_s, r.ttft_s, r.tpot_s, r.e2e_s) for r in recs])
        assert stamps[1] == stamps[0]
        assert all(ttft > 0 for _, ttft, _, _ in stamps[1])

    def test_top_k_one_sampled_rows_match_greedy(self, setup):
        p1, p2 = prompts_np(9, (6, 9))
        (want,), _ = serve_both(setup, [dict(prompt=p1, max_new_tokens=6)],
                                max_slots=2, max_len=64)
        eng = Engine(setup[3], setup[2], max_slots=2, max_len=64)
        r1 = eng.submit(GenRequest(prompt=p1, max_new_tokens=6, temperature=0.8, top_k=1))
        eng.submit(GenRequest(prompt=p2, max_new_tokens=6))
        assert eng.run()[r1] == want


class TestEnginePortOnly:
    def test_sampled_streams_reproducible_per_seed(self, setup):
        def run_once(seed):
            eng = Engine(setup[3], setup[2], max_slots=1, max_len=64, seed=seed)
            rid = eng.submit(GenRequest(prompt=[3, 5, 7, 9], max_new_tokens=8,
                                        temperature=1.0, top_p=0.9))
            return eng.run()[rid]

        assert run_once(1) == run_once(1)
        a, b = run_once(1), run_once(2)
        assert len(a) == len(b) == 8 and a != b

    def test_sampled_stream_independent_of_cotenants(self, setup):
        prompt = prompts_np(10, (6,))[0]

        def tokens_of(with_noise):
            eng = Engine(setup[3], setup[2], max_slots=2, max_len=64, seed=3)
            if with_noise:
                eng.submit(GenRequest(prompt=prompts_np(11, (9,))[0],
                                      max_new_tokens=9, temperature=1.3))
            else:
                eng.submit(GenRequest(prompt=[1], max_new_tokens=1))  # burn id 0
            rid = eng.submit(GenRequest(prompt=prompt, max_new_tokens=6,
                                        temperature=0.9, top_k=32))
            return eng.run()[rid]

        assert tokens_of(False) == tokens_of(True)

    def test_serve_counters_advance_in_the_port_registry(self, setup):
        from nos_tpu.util import metrics as jax_metrics

        assert metrics.REGISTRY is not jax_metrics.REGISTRY
        req0, tok0 = metrics.SERVE_REQUESTS.value, metrics.SERVE_TOKENS.value
        tick0 = metrics.SERVE_TICKS.value
        active0 = metrics.SERVE_SLOT_TICKS_ACTIVE.value
        jax_req0 = jax_metrics.SERVE_REQUESTS.value
        ttft = metrics.SERVE_TTFT.labels(model="default", adapter="0", bucket="8")
        ttft0 = ttft.count
        eng = Engine(setup[3], setup[2], max_slots=2, max_len=64)
        for p in prompts_np(12, (5, 5, 5)):
            eng.submit(GenRequest(prompt=p, max_new_tokens=4))
        eng.run()
        assert metrics.SERVE_REQUESTS.value - req0 == 3
        assert metrics.SERVE_TOKENS.value - tok0 == 12
        tick_delta = metrics.SERVE_TICKS.value - tick0
        assert 0 < metrics.SERVE_SLOT_TICKS_ACTIVE.value - active0 <= tick_delta * 2
        assert metrics.SERVE_SLOTS.value == 2
        assert ttft.count - ttft0 == 3  # five-token prompts: bucket 8
        assert 'nos_tpu_serve_ttft_seconds_count{adapter="0",bucket="8",model="default"}' \
            in metrics.REGISTRY.render()
        assert jax_metrics.SERVE_REQUESTS.value == jax_req0
        rec = eng.telemetry.completed[0]
        assert rec.tokens == 4 and rec.ttft_s is not None and rec.e2e_s >= rec.ttft_s

    def test_request_journey_is_traced(self, setup):
        from nos_tpu_torch.util.tracing import TRACER

        eng = Engine(setup[3], setup[2], max_slots=1, max_len=64)
        rid = eng.submit(GenRequest(prompt=prompts_np(15, (5,))[0], max_new_tokens=3))
        eng.run()
        roots = [tr for tr in TRACER.store.list()
                 if tr.root.name == "serve.request"
                 and tr.root.attributes.get("request") == rid]
        assert roots, "no finished serve.request journey"
        names = {span.name for span in roots[0].spans}
        assert {"serve.submit", "serve.queue", "serve.admit", "serve.prefill",
                "serve.decode", "serve.retire"} <= names
        assert roots[0].root.attributes["tokens"] == 3

    def test_rejections(self, setup):
        jc, jp, tc, tp = setup
        eng = Engine(tp, tc, max_slots=1, max_len=32)
        with pytest.raises(ValueError):
            eng.submit(GenRequest(prompt=[1] * 20, max_new_tokens=20))
        with pytest.raises(ValueError):
            eng.submit(GenRequest(prompt=[1] * 40, max_new_tokens=1))
        with pytest.raises(ValueError):
            eng.submit(GenRequest(prompt=[], max_new_tokens=4))
        with pytest.raises(ValueError):
            eng.submit(GenRequest(prompt=[1, 2], max_new_tokens=0))
        # a tree without stacked adapters serves adapter 0 only
        with pytest.raises(ValueError, match="adapter"):
            eng.submit(GenRequest(prompt=[1, 2], max_new_tokens=2, adapter=1))
        assert Engine(tp, tc, max_len=32, kv_quant=True)._cache[0]["k"].dtype == torch.int8
        with pytest.raises(TypeError, match="DeviceMesh"):
            Engine(tp, tc, mesh=object())
        with pytest.raises(ValueError, match="sliding_window"):
            Engine(tp, tc, max_len=64, rolling=True)

    def test_prefix_snapshot_is_a_copy(self, setup):
        # later in-place writes to the row cache must not reach the entry
        eng = Engine(setup[3], setup[2], max_slots=1, max_len=128,
                     prefill_chunk=16, prefix_cache_entries=2)
        eng.submit(GenRequest(prompt=prompts_np(13, (40,))[0], max_new_tokens=2))
        eng.run()
        (entry,) = eng._prefix_cache.values()
        for layer_entry, layer_cache in zip(entry, eng._cache):
            assert layer_entry["k"].data_ptr() != layer_cache["k"].data_ptr()
            assert layer_entry["k"].shape[1] == 32
        snap = [e["k"].clone() for e in entry]
        eng.submit(GenRequest(prompt=prompts_np(14, (40,))[0], max_new_tokens=2))
        eng.run()
        assert all(torch.equal(a["k"], b) for a, b in zip(entry, snap))
