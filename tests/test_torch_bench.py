"""The model bench (nos_tpu_torch.bench) against the reference's bench.py,
half 1 (``run_tpu_child``).

- The CPU line: ``bench.py --tpu-child`` with NOS_BENCH_PLATFORM=cpu in
  a subprocess beside the port's ``main(["--device", "cpu"])``: the same
  key set, the same model and train shape, positive times.
- The card's parameter count (from shapes, nothing materialized), the
  peak table, the train search's out-of-memory rule, the CLI's refusal
  without a card.
- Every section's outputs on a tiny f32 config, weights bridged from
  the reference's init, against the reference's own functions on the
  same inputs. Tolerances: greedy tokens identical (``generate`` in
  every weight format, the Engines, the prefix Engine and its hits, the
  rolling Engine); context-decode logits within 1e-4 on the f32 cache
  and 1e-3 on the int8 cache (an int8 value on a rounding edge can
  round the other way between the frameworks); forward logits within
  1e-4 (test_torch_llama's f32 bound); the attention op's output and
  gradients within 1e-5 (f32, one layer).
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from nos_tpu.models import generate as jg
from nos_tpu.models import llama as jl
from nos_tpu.models import quantize as jq
from nos_tpu.ops.flash_attention import flash_attention as jax_flash
from nos_tpu.serve import Engine as JEngine, GenRequest as JRequest
from nos_tpu.util import metrics as jmetrics
from nos_tpu_torch import bench
from nos_tpu_torch.models import llama as tl
from nos_tpu_torch.models import quantize as tq
from tests.test_torch_llama import bridged

ROOT = Path(__file__).resolve().parents[1]
F32_ATOL = 1e-4
ATTN_ATOL = 1e-5
CTX_ATOL = {False: 1e-4, True: 1e-3}
SIZES = bench.BenchSizes.tiny(dtype=torch.float32)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def setup():
    jc, jp, tc, tp = bridged(0)
    assert tc == SIZES.config
    return jc, jp, tc, tp


def _last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


# ------------------------------------------------------------- the CPU line


@pytest.fixture(scope="module")
def reference_cpu_line():
    env = dict(os.environ, NOS_BENCH_PLATFORM="cpu", JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "bench.py", "--tpu-child"], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return _last_json(proc.stdout)


def test_cpu_line_matches_the_reference_child(reference_cpu_line, capsys, tmp_path):
    out = tmp_path / "line.json"
    assert bench.main(["--device", "cpu", "--out", str(out)]) == 0
    mine = _last_json(capsys.readouterr().out)
    want = reference_cpu_line
    assert set(mine) == set(want)
    for key in ("backend", "device_kind", "model_params_b", "train_batch", "train_seq",
                "train_attention", "train_remat"):
        assert mine[key] == want[key], key
    for key in ("train_step_ms", "train_tokens_per_s", "fwd_step_ms"):
        assert mine[key] > 0 and want[key] > 0, key
    # no peak to hold a CPU against: the port's MFU is null
    assert mine["train_mfu_pct"] is None
    assert json.loads(out.read_text()) == mine


def test_cli_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main([]) == 2
    assert bench.main(["--quick"]) == 2
    assert capsys.readouterr().out == ""
    with pytest.raises(SystemExit):
        bench.main(["--device", "cpu", "--quick"])


def test_count_params_of_the_card_config_equals_the_reference():
    c = bench.BenchSizes.card().config
    jcfg = jl.LlamaConfig(vocab_size=c.vocab_size, d_model=c.d_model,
                          n_layers=c.n_layers, n_heads=c.n_heads,
                          n_kv_heads=c.n_kv_heads, d_ff=c.d_ff)
    shapes = jax.eval_shape(lambda: jl.init_llama_params(jax.random.key(0), jcfg))
    want = sum(x.size for x in jax.tree.leaves(shapes))
    with FakeTensorMode():
        params = tl.init_llama_params(c, device="cpu")
    assert bench._count_params(params) == want == 1_037_109_248


@pytest.mark.parametrize("name", ["NVIDIA H100 80GB HBM3", "NVIDIA H100 SXM5 80GB"])
def test_peak_of_the_h100(name):
    assert bench._peak_flops(name) == 989e12


@pytest.mark.parametrize("name", ["NVIDIA H100 PCIe", "NVIDIA A100-SXM4-80GB",
                                  "TPU v5 lite", "cpu"])
def test_peak_of_an_unknown_device_raises(name):
    with pytest.raises(ValueError, match="no bf16 peak"):
        bench._peak_flops(name)


# --------------------------------------------------------- the train search


def _failing_first_step(monkeypatch, error):
    """make_train_step whose first built step raises ``error``; returns
    the list of configs it was asked for."""
    real, built = bench.make_train_step, []

    def fake(mesh, cfg, **kw):
        step, shard = real(mesh, cfg, **kw)
        built.append(cfg)
        if len(built) == 1:
            def step(state, tokens):
                raise error
        return step, shard

    monkeypatch.setattr(bench, "make_train_step", fake)
    return built


CANDIDATES = ((4, 32, "flash", False), (2, 16, "dense", True))


def test_out_of_memory_moves_to_the_next_candidate(monkeypatch):
    built = _failing_first_step(monkeypatch, torch.cuda.OutOfMemoryError("injected"))
    logged = []
    got = bench.train_section(SIZES.config, CANDIDATES, 1, CPU, logged.append)
    assert [(c.attention, c.remat) for c in built] == [("flash", False), ("dense", True)]
    assert len(logged) == 1 and "4x32 attn=flash remat=False ran out of memory" in logged[0]
    assert (got["train_batch"], got["train_seq"], got["train_attention"],
            got["train_remat"]) == CANDIDATES[1]
    assert got["step_s"] > 0 and np.isfinite(got["losses"]).all()


def test_out_of_memory_on_every_candidate_gives_none(monkeypatch):
    def fake(mesh, cfg, **kw):
        def step(state, tokens):
            raise torch.cuda.OutOfMemoryError("injected")
        return step, lambda params, donate=False: (params, None)

    monkeypatch.setattr(bench, "make_train_step", fake)
    logged = []
    assert bench.train_section(SIZES.config, CANDIDATES, 1, CPU, logged.append) is None
    assert len(logged) == len(CANDIDATES)


def test_any_other_train_error_propagates_with_no_fallback(monkeypatch, capsys):
    built = _failing_first_step(monkeypatch, RuntimeError("injected"))
    sizes = dataclasses.replace(SIZES, train_candidates=CANDIDATES)
    with pytest.raises(RuntimeError, match="injected"):
        bench.run_model_bench("cpu", sizes)
    assert len(built) == 1
    # the result so far is printed before the error propagates
    last = _last_json(capsys.readouterr().out)
    assert last["model_params_b"] == 0.0001 and "train_batch" not in last


def test_expected_launches_at_the_card_sizes():
    card = bench.BenchSizes.card()
    got = bench.expected_launches(card, {"train_attention": "flash", "train_remat": False})
    assert got["train"] == [176, 176, 176]           # 11 steps x 16 layers
    assert got["forward_flash"] == [21 * 16, 0, 0]
    assert got["attention"] == [32, 11, 11]
    assert got["decode"] == [64, 0, 0]               # 4 prefills of 16 layers
    assert got["long_context"] == [2 * 9 * 16 * 2, 0, 0]
    assert got["engine"] == got["rolling"] == got["forward"] == [0, 0, 0]
    remat = bench.expected_launches(card, {"train_attention": "flash", "train_remat": True})
    assert remat["train"] == [352, 176, 176]


# ---------------------------------------------- every section, on the CPU

# bench.py's keys on the card (its sweep down to the one tile), at the
# tiny sizes' long-context length
CARD_KEYS = {
    "backend", "device_kind", "model_params_b", "train_batch", "train_seq",
    "train_attention", "train_remat", "train_step_ms", "train_tokens_per_s",
    "train_mfu_pct", "fwd_step_ms", "fwd_flash_step_ms", "flash_speedup",
    "attn_dense_ms", "attn_flash_128x128_ms", "attn_flash_best_blocks",
    "attn_flash_best_ms", "attn_flash_vs_dense", "attn_dense_bwd_ms",
    "attn_flash_bwd_ms", "attn_flash_bwd_vs_dense", "decode_tokens_per_s",
    "decode_int8_tokens_per_s", "int8_weight_bytes_ratio", "int8_decode_speedup",
    "decode_ctx4k_tokens_per_s", "decode_ctx4k_kvq_tokens_per_s",
    "kv_quant_decode_speedup", "decode_int4_tokens_per_s", "int4_weight_bytes_ratio",
    "int4_decode_speedup", "serve_slots", "serve_cold_start_s", "serve_tokens_per_s",
    "serve_vs_single_stream", "serve8_slots", "serve8_cold_start_s",
    "serve8_tokens_per_s", "serve8_vs_single_stream", "serve_prefix_tokens_per_s",
    "serve_prefix_hits", "fwd_dense_seq128_ms", "fwd_flash_seq128_ms",
    "flash_speedup_seq128", "fwd_flash_w1k_seq128_ms", "window_vs_full_seq128",
    "serve_window_tokens_per_s", "serve_rolling_tokens_per_s", "rolling_vs_physical",
}


def test_every_section_runs_under_the_reference_keys(capsys):
    outputs = {}
    result = bench.run_model_bench("cpu", SIZES, outputs=outputs)
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    assert set(result) == CARD_KEYS
    assert lines[-1] == result
    # a snapshot after the train, the forwards, the op, four decode
    # parts, three Engines, one length, rolling, and the end's
    assert len(lines) == 13
    assert result["serve_prefix_hits"] == SIZES.engines[0][1]
    assert set(outputs["launches"]) == set(bench.SECTIONS)
    # the plain versions launch no kernel on the CPU
    assert all(v == [0, 0, 0] for v in outputs["launches"].values())
    for key, value in result.items():
        if key.endswith(("_ms", "_per_s")):
            assert value > 0, key
    assert outputs["rolling"]["rolling"] == outputs["rolling"]["physical"]


@pytest.mark.parametrize("attention,window", [("dense", None), ("flash", None),
                                              ("flash", 16)])
def test_forward_logits_match_the_reference(setup, attention, window):
    jc, jp, tc, tp = setup
    toks = bench.draw_tokens((2, 64), tc.vocab_size, 11, CPU)
    _, got = bench.time_forward(
        tp, dataclasses.replace(tc, attention=attention, sliding_window=window), toks, 1)
    want = jl.llama_forward(jp, jnp.asarray(toks.numpy(), jnp.int32), dataclasses.replace(
        jc, attention=attention, sliding_window=window))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_ATOL, rtol=0)


def test_attention_op_matches_the_reference():
    rng = np.random.default_rng(3)
    # group 2, as the card's 16 / 8 heads
    shapes = {"q": (2, 64, 8, 16), "k": (2, 64, 4, 16), "v": (2, 64, 4, 16)}
    arrays = {n: rng.standard_normal(s).astype(np.float32) for n, s in shapes.items()}
    q, k, v = (torch.from_numpy(arrays[n]) for n in "qkv")
    got = bench.attention_section(q, k, v, 1, 1)["outputs"]

    def dense_ref(q, k, v):  # bench.py:299-310
        kr = jnp.repeat(k, 2, axis=2)
        vr = jnp.repeat(v, 2, axis=2)
        logits = jnp.einsum("bqhd,bkhd->bhqk", q, kr) / (16 ** 0.5)
        mask = jnp.tril(jnp.ones((64, 64), bool))
        probs = jax.nn.softmax(jnp.where(mask[None, None], logits, -jnp.inf), axis=-1)
        return jnp.einsum("bhqk,bkhd->bqhd", probs, vr)

    jargs = [jnp.asarray(arrays[n]) for n in "qkv"]
    def flash_ref(q, k, v):
        return jax_flash(q, k, v, interpret=True)

    for name, fn in (("dense", dense_ref), ("flash", flash_ref)):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(fn(*jargs)),
                                   atol=ATTN_ATOL, rtol=0)
        want = jax.grad(lambda q, k, v: jnp.sum(fn(q, k, v)), argnums=(0, 1, 2))(*jargs)
        for g, w in zip(got[f"{name}_grads"], want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATTN_ATOL, rtol=0)


@pytest.mark.parametrize("fmt", ["f32", "int8", "int4"])
def test_generate_tokens_match_the_reference(setup, fmt):
    jc, jp, tc, tp = setup
    if fmt == "int8":
        jp, tp = jq.quantize_params(jp), tq.quantize_params(tp)
    elif fmt == "int4":
        jp, tp = jq.quantize_params_int4(jp), tq.quantize_params_int4(tp)
    prompt = bench.draw_tokens((1, SIZES.decode_prompt), tc.vocab_size, 12, CPU)
    _, got = bench.time_generate(tp, tc, prompt, SIZES.decode_new, 1)
    want = jg.generate(jp, jnp.asarray(prompt.numpy(), jnp.int32), jc,
                       max_new_tokens=SIZES.decode_new)
    assert got.tolist() == np.asarray(want).tolist()


@pytest.mark.parametrize("quant", [False, True])
def test_context_decode_logits_match_a_reference_scan(setup, quant):
    jc, jp, tc, tp = setup
    toks = bench.draw_tokens(SIZES.ctx_shape, tc.vocab_size, 13, CPU)
    steps, ctx = SIZES.ctx_steps, SIZES.ctx_shape[1]
    _, got = bench.ctx_decode(tp, tc, toks, steps, quant)
    fcfg = dataclasses.replace(jc, attention="flash")

    def run(params, toks):  # bench.py:447-462, keeping every step's logits
        logits, cache = jg.prefill(params, toks, fcfg, ctx + steps, quant=quant)
        first = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)

        def tick(carry, i):
            cache, tok = carry
            lg, cache = jg.decode_step(params, cache, ctx + i, tok, fcfg)
            return (cache, jnp.argmax(lg, -1).astype(jnp.int32)), (tok, lg)

        _, (fed, steps_logits) = jax.lax.scan(tick, (cache, first), jnp.arange(steps))
        return fed.T, jnp.concatenate([logits[:, -1:], steps_logits.transpose(1, 0, 2)], 1)

    fed, want = jax.jit(run)(jp, jnp.asarray(toks.numpy(), jnp.int32))
    assert got["logits"].shape == (SIZES.ctx_shape[0], 1 + steps, tc.vocab_size)
    assert got["fed"].tolist() == np.asarray(fed).tolist()
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want), atol=CTX_ATOL[quant],
                               rtol=0)


def _reference_engine(jp, jc, requests, warm=None, **kw):
    eng = JEngine(jp, jc, ticks_per_sync=bench.TICKS_PER_SYNC, **kw)
    if warm is not None:
        eng.submit(JRequest(**warm))
        eng.run()
    ids = [eng.submit(JRequest(**r)) for r in requests]
    got = eng.run()
    return [got[i] for i in ids]


@pytest.mark.parametrize("slots,n_req", [(4, 8), (8, 16)])
def test_engine_tokens_match_the_reference_engine(setup, slots, n_req):
    jc, jp, tc, tp = setup
    new, max_len = SIZES.engine_new, SIZES.engine_max_len
    prompts = bench.draw_tokens((n_req + 1, SIZES.engine_prompt), tc.vocab_size, 20,
                                CPU).tolist()
    numbers, got = bench.bench_engine(tp, tc, slots, prompts[1:], new, max_len, prompts[0])
    want = _reference_engine(
        jp, jc, [dict(prompt=p, max_new_tokens=new) for p in prompts[1:]],
        warm=dict(prompt=prompts[0], max_new_tokens=new), max_slots=slots,
        max_len=max_len)
    assert got == want
    assert numbers["slots"] == slots and numbers["tokens_per_s"] > 0


def test_prefix_engine_tokens_and_hits_match_the_reference(setup):
    jc, jp, tc, tp = setup
    slots, n_req, _ = SIZES.engines[0]
    new = SIZES.engine_new
    shared = bench.draw_tokens((SIZES.prefix_shared,), tc.vocab_size, 30, CPU).tolist()
    _, hits, got = bench.bench_prefix_engine(
        tp, tc, shared, n_req, slots, SIZES.prefix_chunk, SIZES.prefix_max_len, new)
    before = jmetrics.SERVE_PREFIX_HITS.value
    want = _reference_engine(
        jp, jc, [dict(prompt=shared, max_new_tokens=new)] * n_req,
        warm=dict(prompt=shared, max_new_tokens=new), max_slots=slots,
        max_len=SIZES.prefix_max_len, prefill_chunk=SIZES.prefix_chunk,
        prefix_cache_entries=bench.PREFIX_CACHE_ENTRIES)
    assert got == want
    assert hits == jmetrics.SERVE_PREFIX_HITS.value - before == n_req


def test_rolling_and_physical_tokens_match_each_other_and_the_reference(setup):
    jc, jp, tc, tp = setup
    window, new = SIZES.window, SIZES.rolling_new
    prompt = bench.draw_tokens((SIZES.rolling_prompt,), tc.vocab_size, 50, CPU).tolist()
    times, got = bench.bench_rolling(tp, tc, window, prompt, new)
    assert got["rolling"] == got["physical"] and len(got["rolling"]) == new
    # the stream passes the rolling cache's slots: the modular writes ran
    assert len(prompt) + new > window + len(prompt)
    (want,) = _reference_engine(
        jp, dataclasses.replace(jc, sliding_window=window),
        [dict(prompt=prompt, max_new_tokens=new)], max_slots=1,
        max_len=window + len(prompt) + 1, prefill_chunk=len(prompt), rolling=True)
    assert got["rolling"] == want
    assert times["physical"] > 0 and times["rolling"] > 0
