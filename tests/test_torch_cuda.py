"""The port on the card: kernels against their plain versions, and the
serving paths' CUDA-only behaviour.

Every test here needs an NVIDIA GPU and nvcc; each skips, with a reason,
where ``torch.cuda.is_available()`` is false (decided inside a fixture,
never at import). This file imports no JAX, so it runs on a machine that
has only the port's dependencies:

    python -m pytest -m cuda tests/test_torch_cuda.py

Tolerance (bf16 inputs, f32 softmax in both versions): O within 2e-2
(about one bf16 ulp of values of order 1, accumulation order differs),
LSE within 1e-3, and rows with no visible key (-inf LSE, O = 0) exactly.
"""
import math

import pytest
import torch

import nos_tpu_torch.ops.flash_attention as fa


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,sq,skv,hq,hkv,hd,causal,window,q_off,kv_off",
    [
        (2, 128, 128, 4, 2, 128, True, None, 0, 0),
        (1, 100, 100, 8, 2, 128, True, None, 0, 0),    # ragged S
        (1, 200, 200, 4, 1, 64, True, 37, 0, 0),       # window, MQA, hd 64
        (2, 77, 77, 4, 4, 128, False, None, 0, 0),     # non-causal ragged
        (1, 64, 96, 4, 2, 128, True, None, 96, 0),     # offsets: all past
        (1, 64, 96, 4, 2, 128, True, 50, 40, 20),      # offsets + window
        (1, 64, 64, 4, 2, 128, True, None, 0, 1000),   # fully future
    ],
)
def test_kernel_matches_plain_on_card(cuda_device, b, sq, skv, hq, hkv, hd,
                                      causal, window, q_off, kv_off):
    gen = torch.Generator(device=cuda_device).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=cuda_device).to(torch.bfloat16)

    q, k, v = randn(b, sq, hq, hd), randn(b, skv, hkv, hd), randn(b, skv, hkv, hd)
    before = fa.LAUNCHES
    out, lse = fa.flash_attention_block(q, k, v, q_off, kv_off, causal=causal,
                                        window=window)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 1
    want, want_lse = fa.flash_attention_reference(
        q, k, v, q_off, kv_off, causal=causal, window=window
    )
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert float((out.float() - want.float()).abs().max()) <= 2e-2
    assert torch.equal(torch.isneginf(lse), torch.isneginf(want_lse))
    fin = torch.isfinite(want_lse)
    if fin.any():
        assert float((lse[fin] - want_lse[fin]).abs().max()) <= 1e-3
    assert torch.all(out[~torch.isfinite(lse).transpose(1, 2)[..., 0]] == 0)


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda_device):
    q = torch.zeros((1, 16, 2, 128), device=cuda_device)
    with pytest.raises(TypeError, match="bf16"):
        fa.flash_attention(q, q, q)  # f32
    q = q.to(torch.bfloat16)
    with pytest.raises(ValueError, match="tiles"):
        fa.flash_attention(q, q, q, blk_k=16)
    with pytest.raises(ValueError, match="head_dim"):
        z = torch.zeros((1, 16, 2, 96), device=cuda_device, dtype=torch.bfloat16)
        fa.flash_attention(z, z, z)
    assert math.isfinite(float(fa.flash_attention(q, q, q).float().sum()))


def _tiny_f32(device):
    from nos_tpu_torch.models.llama import init_llama_params, tiny_config

    cfg = tiny_config(dtype=torch.float32)
    return cfg, init_llama_params(cfg, 0, device=device)


@pytest.mark.cuda
def test_engine_matches_solo_generate_on_card(cuda_device):
    """The reference engine's contract, on CUDA tensors: every request's
    greedy tokens equal a solo generate() run. The short request rides
    ~32 ticks past its frontier, so its cache writes fall outside the
    cache (masked, not a device-side assert)."""
    from nos_tpu_torch.models.generate import generate
    from nos_tpu_torch.serve import Engine, GenRequest

    cfg, params = _tiny_f32(cuda_device)
    gen = torch.Generator().manual_seed(1)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in (17, 3, 4, 40)]
    budgets = (5, 30, 30, 6)
    eng = Engine(params, cfg, max_slots=3, max_len=64, ticks_per_sync=4,
                 prefill_chunk=16)
    ids = [eng.submit(GenRequest(prompt=p, max_new_tokens=n))
           for p, n in zip(prompts, budgets)]
    got = eng.run()
    for rid, p, n in zip(ids, prompts, budgets):
        solo = generate(params, torch.tensor([p], device=cuda_device), cfg, n)
        assert got[rid] == solo[0].tolist(), rid


@pytest.mark.cuda
def test_sampled_streams_on_card(cuda_device):
    from nos_tpu_torch.serve import Engine, GenRequest

    cfg, params = _tiny_f32(cuda_device)

    def run_once(seed):
        eng = Engine(params, cfg, max_slots=2, max_len=64, seed=seed)
        eng.submit(GenRequest(prompt=[9, 8, 7], max_new_tokens=5, temperature=1.2))
        rid = eng.submit(GenRequest(prompt=[3, 5, 7, 9], max_new_tokens=8,
                                    temperature=1.0, top_p=0.9))
        return eng.run()[rid]

    assert run_once(1) == run_once(1)
    assert run_once(1) != run_once(2)
