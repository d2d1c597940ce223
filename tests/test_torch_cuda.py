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
Backward (dQ, dK, dV against ``flash_attention_bwd_reference`` on the
same out / lse): |err| <= 1e-2 + 1e-2 * |want| elementwise. Both round p
and dS to bf16 at the same points, but on f32 values that differ in the
last bits (summation order, expf), so a value on a bf16 rounding edge
can round the other way, and the bf16 outputs round once more.
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


# The forward kernel's cases: its tiles are 128 query rows x 128 keys (64
# keys at head_dim 256), so the ragged lengths sit around one and two tiles; q_transposed hands q
# over as a [B, S, H, hd] view of [B, H, S, hd] storage, which the
# kernel's TMA maps read through its strides without a copy.
_FWD_CASES = [
    (2, 128, 128, 4, 2, 128, True, None, 0, 0, False),
    (1, 100, 100, 8, 2, 128, True, None, 0, 0, False),    # ragged S
    (1, 200, 200, 4, 1, 64, True, 37, 0, 0, False),       # window, MQA, hd 64
    (2, 77, 77, 4, 4, 128, False, None, 0, 0, False),     # non-causal ragged
    (1, 64, 96, 4, 2, 128, True, None, 96, 0, False),     # offsets: all past
    (1, 64, 96, 4, 2, 128, True, 50, 40, 20, False),      # offsets + window
    (1, 64, 64, 4, 2, 128, True, None, 0, 1000, False),   # fully future
    (1, 127, 127, 4, 2, 128, True, None, 0, 0, False),    # one key short of a tile
    (1, 129, 129, 4, 2, 128, True, None, 0, 0, False),    # one key past a tile
    (2, 255, 255, 4, 2, 128, True, None, 0, 0, False),    # one short of two tiles
    (1, 300, 400, 4, 2, 128, True, 200, 333, 45, False),  # window 200, offsets off-tile
    (2, 50, 1, 4, 2, 128, True, None, 0, 0, False),       # Skv = 1
    (1, 1024, 1024, 8, 2, 64, True, None, 0, 0, False),   # hd 64 at S 1024
    (2, 200, 200, 4, 2, 128, True, None, 0, 0, True),     # q a transposed view
    (1, 256, 256, 4, 4, 128, True, None, 0, 0, False),    # Hq = Hkv, no GQA
    # head_dim 256 (Gemma): 128 query rows x 64-key tiles
    (2, 128, 128, 8, 1, 256, True, None, 0, 0, False),    # MQA, as Gemma-2B
    (1, 63, 63, 4, 1, 256, True, None, 0, 0, False),      # one key short of a tile
    (1, 65, 65, 4, 1, 256, True, None, 0, 0, False),      # one key past a tile
    (1, 129, 129, 8, 2, 256, True, None, 0, 0, False),    # GQA, past a query tile
    (1, 300, 400, 4, 2, 256, True, 200, 333, 45, False),  # window 200, offsets off-tile
    (2, 50, 1, 4, 1, 256, True, None, 0, 0, False),       # Skv = 1
    (2, 77, 77, 4, 4, 256, False, None, 0, 0, False),     # non-causal, no GQA
    (2, 200, 200, 8, 1, 256, True, None, 0, 0, True),     # q a transposed view
]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,sq,skv,hq,hkv,hd,causal,window,q_off,kv_off,q_transposed", _FWD_CASES
)
def test_kernel_matches_plain_on_card(cuda_device, b, sq, skv, hq, hkv, hd,
                                      causal, window, q_off, kv_off,
                                      q_transposed):
    gen = torch.Generator(device=cuda_device).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=cuda_device).to(torch.bfloat16)

    if q_transposed:
        q = randn(b, hq, sq, hd).transpose(1, 2)
        assert not q.is_contiguous() and fa._tma_ready(q) is q  # read in place
    else:
        q = randn(b, sq, hq, hd)
    k, v = randn(b, skv, hkv, hd), randn(b, skv, hkv, hd)
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


# The backward kernels' cases. dK/dV blocks own 128 keys (64 per consumer
# warpgroup) and stream 64-row query tiles; dQ blocks own 128 query rows
# and stream 128-key tiles: the ragged lengths sit around those edges. At
# head_dim 256 dK/dV blocks own 64 keys and dQ streams 32-key tiles.
_BWD_CASES = [
    (2, 128, 128, 4, 2, 128, True, None, 0, 0),
    (1, 100, 100, 8, 2, 128, True, None, 0, 0),    # ragged S
    (1, 200, 200, 4, 1, 64, True, 37, 0, 0),       # window, MQA, hd 64
    (2, 77, 77, 4, 4, 128, False, None, 0, 0),     # non-causal ragged
    (1, 64, 96, 4, 2, 128, True, None, 96, 0),     # offsets: all past
    (1, 64, 96, 4, 2, 128, True, 50, 40, 20),      # offsets + window
    (1, 64, 64, 4, 2, 128, True, None, 0, 1000),   # fully future
    (1, 63, 63, 4, 2, 128, True, None, 0, 0),      # one short of a query tile
    (1, 65, 65, 4, 2, 128, True, None, 0, 0),      # one past a query tile
    (1, 127, 127, 4, 2, 128, True, None, 0, 0),    # one short of a key block
    (1, 129, 129, 4, 2, 128, True, None, 0, 0),    # one past a key block
    (2, 255, 255, 4, 2, 128, True, None, 0, 0),    # one short of two blocks
    (1, 300, 400, 4, 2, 128, True, 200, 333, 45),  # window 200, offsets off-tile
    (1, 1024, 1024, 8, 2, 64, True, None, 0, 0),   # hd 64 at S 1024
    (1, 256, 256, 4, 4, 128, True, None, 0, 0),    # Hq = Hkv, no GQA
    (2, 50, 1, 4, 2, 128, True, None, 0, 0),       # Skv = 1
    # head_dim 256 (Gemma): dK/dV blocks of 64 keys, dQ tiles of 32 keys
    (2, 128, 128, 8, 1, 256, True, None, 0, 0),    # MQA, as Gemma-2B
    (1, 63, 63, 4, 1, 256, True, None, 0, 0),      # one short of a query tile
    (1, 65, 65, 4, 1, 256, True, None, 0, 0),      # one past a key block
    (1, 129, 129, 8, 2, 256, True, None, 0, 0),    # GQA, past a dQ row block
    (1, 300, 400, 4, 2, 256, True, 200, 333, 45),  # window 200, offsets off-tile
    (1, 64, 96, 4, 1, 256, True, 50, 40, 20),      # offsets + window, MQA
    (2, 50, 1, 4, 1, 256, True, None, 0, 0),       # Skv = 1
    (2, 77, 77, 4, 4, 256, False, None, 0, 0),     # non-causal, no GQA
]


def _close(got, want):
    got, want = got.float(), want.float()
    return bool(((got - want).abs() <= 1e-2 + 1e-2 * want.abs()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("grad_dtype", [None, torch.float32])
@pytest.mark.parametrize("b,sq,skv,hq,hkv,hd,causal,window,q_off,kv_off", _BWD_CASES)
def test_backward_kernels_match_plain_on_card(cuda_device, b, sq, skv, hq, hkv,
                                              hd, causal, window, q_off, kv_off,
                                              grad_dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(1)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=cuda_device).to(torch.bfloat16)

    q, k, v = randn(b, sq, hq, hd), randn(b, skv, hkv, hd), randn(b, skv, hkv, hd)
    do = randn(b, sq, hq, hd)
    out, lse = fa.flash_attention_block(q, k, v, q_off, kv_off, causal=causal,
                                        window=window)
    # a non-contiguous dO, as autograd's reshapes hand it over
    do_t = do.transpose(1, 2).contiguous().transpose(1, 2)
    delta = fa.flash_delta(do, out)
    before = (fa.DQ_LAUNCHES, fa.DKV_LAUNCHES)
    got = fa.flash_block_grads(q, k, v, out, lse, do_t, q_off, kv_off,
                               causal=causal, window=window,
                               grad_dtype=grad_dtype, delta=delta)
    torch.cuda.synchronize()
    assert (fa.DQ_LAUNCHES, fa.DKV_LAUNCHES) == (before[0] + 1, before[1] + 1)
    want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, q_off, kv_off,
                                            causal=causal, window=window,
                                            grad_dtype=grad_dtype)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == (grad_dtype or torch.bfloat16), name
        assert g.shape == w.shape, name
        assert bool(torch.isfinite(g.float()).all()), name
        assert _close(g, w), (name, float((g.float() - w.float()).abs().max()))
    if bool(torch.isneginf(lse).all()):
        assert all(bool((g == 0).all()) for g in got)


def _bwd_inputs(device, seed, b, sq, skv, hq, hkv, hd=128):
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)

    return randn(b, sq, hq, hd), randn(b, skv, hkv, hd), randn(b, skv, hkv, hd)


@pytest.mark.cuda
def test_backward_reads_an_expanded_cotangent(cuda_device):
    """A 0-stride dO (autograd hands one over for ``out.sum()``) gives the
    same gradients, bit for bit, as its contiguous copy."""
    q, k, v = _bwd_inputs(cuda_device, 3, 2, 130, 130, 8, 2)
    out, lse = fa.flash_attention_block(q, k, v, 0, 0)
    row = torch.randn((2, 1, 8, 128), device=cuda_device).to(torch.bfloat16)
    do = row.expand(2, 130, 8, 128)
    assert do.stride(1) == 0
    got = fa.flash_block_grads(q, k, v, out, lse, do, 0, 0)
    want = fa.flash_block_grads(q, k, v, out, lse, do.contiguous(), 0, 0)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # through autograd: out.sum() makes the cotangent an expanded 1
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    fa.flash_attention(*leaves).sum().backward()
    ones = torch.ones_like(q)
    want = fa.flash_block_grads(q, k, v, *fa.flash_attention_block(q, k, v, 0, 0), ones,
                                0, 0)
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad, w)


@pytest.mark.cuda
@pytest.mark.parametrize("grad_dtype", [None, torch.float32])
def test_backward_kernels_are_bit_identical_run_to_run(cuda_device, grad_dtype):
    """Each dQ / dK / dV element has one owner and a fixed summation order
    (no atomics), so two launches on the same inputs agree bit for bit."""
    q, k, v = _bwd_inputs(cuda_device, 4, 2, 300, 300, 8, 2)
    do = torch.randn_like(q.float()).to(torch.bfloat16)
    out, lse = fa.flash_attention_block(q, k, v, 0, 0)
    first = fa.flash_block_grads(q, k, v, out, lse, do, 0, 0, grad_dtype=grad_dtype)
    second = fa.flash_block_grads(q, k, v, out, lse, do, 0, 0, grad_dtype=grad_dtype)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_sm90_header_forms_match_torch(cuda_device):
    """sm90.cuh's forms in isolation (csrc/sm90_check.cu, one warpgroup):
    the SS m64n64k16 product of two K-major [64 x 128] TMA tiles against
    a torch matmul, the RS m64n128k16 transpose-B product reading a
    64-row tile MN-major (its boxes 8 KB apart), and the 1-D f32 tensor
    map at an odd element offset, zeros past the end. Tolerances: f32
    sums in another order (1e-4 of the largest value); bf16 rounding of
    the first product's f32 values, which may differ in their last bits
    (1e-2 of the largest value); the copy exactly."""
    import ctypes

    from nos_tpu_torch.ops import _build

    fn = ctypes.CDLL(str(_build.build(["sm90_check"])["sm90_check"])).nos_sm90_forms_check
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_void_p] * 3
                   + [ctypes.c_int, ctypes.c_void_p])
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    a, b = (torch.randn((64, 128), generator=gen, device=cuda_device).to(torch.bfloat16)
            for _ in range(2))
    x = torch.randn(100, generator=gen, device=cuda_device)
    d1 = torch.empty((64, 64), device=cuda_device)
    d2 = torch.empty((64, 128), device=cuda_device)
    x_out = torch.empty(64, device=cuda_device)
    err = fn(a.data_ptr(), b.data_ptr(), x.data_ptr(), x.numel(), d1.data_ptr(),
             d2.data_ptr(), x_out.data_ptr(), 61, torch.cuda.current_stream().cuda_stream)
    assert err == 0
    torch.cuda.synchronize()
    want1 = a.float() @ b.float().T
    assert float((d1 - want1).abs().max()) <= 1e-4 * float(want1.abs().max())
    want2 = d1.to(torch.bfloat16).float() @ b.float()
    assert float((d2 - want2).abs().max()) <= 1e-2 * float(want2.abs().max())
    assert torch.equal(x_out, torch.cat([x[61:], x.new_zeros(25)]))


@pytest.mark.cuda
def test_autograd_launches_each_backward_kernel_once(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda_device)
               .to(torch.bfloat16).requires_grad_(True)
               for shape in ((2, 130, 8, 128), (2, 130, 2, 128), (2, 130, 2, 128)))
    counts = (fa.LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES)
    out = fa.flash_attention(q, k, v)
    out.float().square().sum().backward()
    torch.cuda.synchronize()
    assert (fa.LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES) == (
        counts[0] + 1, counts[1] + 1, counts[2] + 1)
    lse = fa.flash_attention_block(q.detach(), k.detach(), v.detach(), 0, 0)[1]
    want = fa.flash_attention_bwd_reference(
        q.detach(), k.detach(), v.detach(), out.detach(), lse,
        (2 * out.float()).to(torch.bfloat16))
    for g, w in zip((q.grad, k.grad, v.grad), want):
        assert _close(g, w)
    # only q asks for a gradient: the dK/dV kernel is not launched
    q2 = q.detach().requires_grad_(True)
    counts = (fa.DQ_LAUNCHES, fa.DKV_LAUNCHES)
    fa.flash_attention(q2, k.detach(), v.detach()).float().sum().backward()
    assert (fa.DQ_LAUNCHES, fa.DKV_LAUNCHES) == (counts[0] + 1, counts[1])
    with pytest.raises(NotImplementedError, match="flash_block_grads"):
        fa.flash_attention_block(q, k, v, 0, 0)


@pytest.mark.cuda
def test_backward_kernels_reject_what_they_do_not_take(cuda_device):
    q = torch.zeros((1, 16, 2, 128), device=cuda_device, dtype=torch.bfloat16)
    out, lse = fa.flash_attention_block(q, q, q, 0, 0)
    with pytest.raises(TypeError, match="bf16"):
        fa.flash_block_grads(q, q, q.float(), out, lse, q, 0, 0)
    with pytest.raises(TypeError, match="bf16 or f32"):
        fa.flash_block_grads(q, q, q, out, lse, q, 0, 0, grad_dtype=torch.float16)
    with pytest.raises(ValueError, match="lse"):
        fa.flash_block_grads(q, q, q, out, lse.cpu(), q, 0, 0)
    z = torch.zeros((1, 16, 2, 96), device=cuda_device, dtype=torch.bfloat16)
    z_out, z_lse = fa.flash_attention_reference(z, z, z)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_block_grads(z, z, z, z_out, z_lse, z, 0, 0)


@pytest.mark.cuda
def test_gemma_train_step_launches_the_hd256_kernels(cuda_device):
    """A tiny Gemma (head_dim 256, one kv head, 2 layers, bf16, flash +
    remat) takes one make_train_step step on the card: 4 forward
    launches (remat runs each layer's forward twice), 2 dQ and 2 dK/dV;
    the loss matches the dense path's within 2e-2 (chip_smoke.py's
    flash-vs-dense loss bar) and the weights move."""
    import dataclasses

    from nos_tpu_torch.models import llama as tl
    from nos_tpu_torch.parallel import make_train_step

    cfg = tl.tiny_config(d_model=256, n_heads=2, n_kv_heads=1, d_ff=512,
                         qk_head_dim=256, hidden_act="gelu", norm_offset=True,
                         scale_embeddings=True, tie_embeddings=True,
                         attention="flash", remat=True)
    params = tl.init_llama_params(cfg, 8, device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    tokens = torch.randint(0, cfg.vocab_size, (2, 300), generator=gen, device=cuda_device)
    dense_loss = tl.llama_loss(params, tokens, dataclasses.replace(cfg, attention="dense"))
    step, shard_state = make_train_step(None, cfg, learning_rate=1.0)
    state = shard_state(params)
    before = state[0]["layers"][0]["wq"].detach().clone()
    counts = (fa.LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES)
    state, loss = step(state, tokens)
    torch.cuda.synchronize()
    assert (fa.LAUNCHES - counts[0], fa.DQ_LAUNCHES - counts[1],
            fa.DKV_LAUNCHES - counts[2]) == (4, 2, 2)
    assert math.isfinite(float(loss))
    assert abs(float(loss) - float(dense_loss)) <= 2e-2
    assert not torch.equal(state[0]["layers"][0]["wq"], before)


# The ring's block calls at the card's shapes, in one process: rank r of
# sp holds queries [r·L, (r+1)·L); its forward runs the block kernel
# against every K/V block the mask does not hide (``_block_skippable``)
# at q_offset r·L, kv_offset j·L, own block first, and merges the f32
# partials; its backward runs the dQ and dK/dV kernels per block with f32
# outputs and the one delta, dK/dV summed per block over the ranks. Over
# all ranks that is the whole-sequence kernel path. Each block call is
# also held against its plain version on the same inputs (the merged out
# and lse, the one delta), so the kernels are checked against more than
# each other.
_RING_CASES = [
    (4, 2048, 32, 8, 128, None),  # Llama-3-8B's heads
    (4, 2048, 32, 8, 128, 512),   # a band: rank 3 skips blocks 0 and 1
    (2, 1024, 8, 1, 256, None),   # Gemma-2B's heads, MQA at head_dim 256
]


@pytest.mark.cuda
@pytest.mark.parametrize("sp,s,hq,hkv,hd,window", _RING_CASES)
def test_ring_block_calls_compose_to_the_whole_sequence_on_card(
        cuda_device, sp, s, hq, hkv, hd, window):
    from nos_tpu_torch.parallel.ring_attention import _block_skippable

    gen = torch.Generator(device=cuda_device).manual_seed(sp + hd)
    q, k, v, do = (torch.randn(shape, generator=gen, device=cuda_device).to(torch.bfloat16)
                   for shape in ((1, s, hq, hd), (1, s, hkv, hd), (1, s, hkv, hd),
                                 (1, s, hq, hd)))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    want = fa.flash_attention(*leaves, window=window)
    wdq, wdk, wdv = torch.autograd.grad(want, leaves, do)
    want = want.detach()
    n = s // sp
    dk = torch.zeros(k.shape, device=cuda_device)
    dv = torch.zeros(v.shape, device=cuda_device)
    counts = (fa.LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES)
    n_blocks = 0
    for r in range(sp):
        rows = slice(r * n, (r + 1) * n)
        blocks = [(r - i) % sp for i in range(sp)
                  if not _block_skippable((r - i) % sp, r, n, n, True, window)]
        n_blocks += len(blocks)
        out = lse = None
        for j in blocks:
            args = (q[:, rows], k[:, j * n:(j + 1) * n], v[:, j * n:(j + 1) * n],
                    r * n, j * n)
            o, l = fa.flash_attention_block(*args, window=window)
            o_ref, l_ref = fa.flash_attention_reference(*args, window=window)
            assert float((o.float() - o_ref.float()).abs().max()) <= 2e-2
            assert torch.equal(torch.isneginf(l), torch.isneginf(l_ref))
            fin = torch.isfinite(l_ref)
            assert float((l[fin] - l_ref[fin]).abs().max()) <= 1e-3
            out, lse = (o.float(), l) if out is None else fa.merge_flash_partials(
                out, lse, o, l)
        out = out.to(torch.bfloat16)
        assert float((out.float() - want[:, rows].float()).abs().max()) <= 2e-2
        delta = fa.flash_delta(do[:, rows], out)
        dq = torch.zeros(q[:, rows].shape, device=cuda_device)
        for j in blocks:
            cols = slice(j * n, (j + 1) * n)
            args = (q[:, rows], k[:, cols], v[:, cols], out, lse, do[:, rows],
                    r * n, j * n)
            kw = dict(window=window, grad_dtype=torch.float32, delta=delta)
            g = fa.flash_block_grads(*args, **kw)
            assert all(t.dtype == torch.float32 for t in g)
            assert all(_close(a, b) for a, b in
                       zip(g, fa.flash_attention_bwd_reference(*args, **kw)))
            dq += g[0]
            dk[:, cols] += g[1]
            dv[:, cols] += g[2]
        assert _close(dq.to(torch.bfloat16), wdq[:, rows])
    assert _close(dk.to(torch.bfloat16), wdk) and _close(dv.to(torch.bfloat16), wdv)
    torch.cuda.synchronize()
    # causal: rank r runs r + 1 blocks unbanded
    if window is None:
        assert n_blocks == sp * (sp + 1) // 2
    assert (fa.LAUNCHES - counts[0], fa.DQ_LAUNCHES - counts[1],
            fa.DKV_LAUNCHES - counts[2]) == (n_blocks,) * 3


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


def _to(tree, device):
    from nos_tpu_torch.models.llama import tree_map

    return tree_map(lambda x: x.to(device), tree)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["int8", "int4"])
@pytest.mark.parametrize("kv_quant", [False, True])
def test_quantized_generate_on_card_matches_cpu(cuda_device, fmt, kv_quant):
    """The same quantized f32 tiny model on the card and on the CPU: the
    prefill logits within 1e-4 (f32 products, TF32 off, other summation
    order) and greedy tokens identical."""
    from nos_tpu_torch.models import generate as tg
    from nos_tpu_torch.models import quantize as tq

    cfg, params = _tiny_f32("cpu")
    q = tq.quantize_params(params) if fmt == "int8" else tq.quantize_params_int4(params, 32)
    q_card = _to(q, cuda_device)
    assert isinstance(q_card["layers"][0]["wq"].q, torch.Tensor)
    assert q_card["embed"].q.device.type == "cuda"
    prompt = torch.randint(1, cfg.vocab_size, (2, 12), generator=torch.Generator().manual_seed(3))
    cpu_logits, _ = tg.prefill(q, prompt, cfg, 24, quant=kv_quant)
    card_logits, card_cache = tg.prefill(q_card, prompt, cfg, 24, quant=kv_quant)
    assert float((card_logits.cpu() - cpu_logits).abs().max()) <= 1e-4
    assert card_cache[0]["k"].dtype == (torch.int8 if kv_quant else torch.float32)
    want = tg.generate(q, prompt, cfg, 10, kv_quant=kv_quant)
    got = tg.generate(q_card, prompt, cfg, 10, kv_quant=kv_quant)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_lora_gradients_through_flash_match_dense_on_card(cuda_device):
    """LoRA on wq / wv over a frozen bf16 base, 2 layers at head_dim 128:
    the adapters' gradients through the flash kernels (forward, dQ,
    dK/dV) against autograd of the dense einsums, within 5e-2 of each
    gradient's largest value (the full-width flash-vs-dense bar of
    chip_smoke.py). In layer 0 k takes no gradient; dK/dV still runs for
    v. With remat the forward runs twice a layer."""
    import dataclasses

    from nos_tpu_torch.models import llama as tl
    from nos_tpu_torch.models import lora as tlora

    cfg = tl.tiny_config(d_model=256, n_heads=2, n_kv_heads=1, d_ff=512,
                         attention="flash", remat=True)
    params = tl.init_llama_params(cfg, 4, device=cuda_device)
    lora = tlora.LoraConfig(rank=8)
    adapters = tlora.init_lora_params(cfg, lora, seed=5, device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    for layer in adapters["layers"]:
        for ab in layer.values():
            ab["b"].normal_(0.0, 0.05, generator=gen)
    leaves = [x.requires_grad_(True) for x in tl.tree_leaves(adapters)]
    tokens = torch.randint(0, cfg.vocab_size, (2, 200), generator=gen, device=cuda_device)

    def grads(c):
        loss = tl.llama_loss(tlora.attach_lora(params, adapters, lora), tokens, c)
        return torch.autograd.grad(loss, leaves)

    counts = (fa.LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES)
    flash = grads(cfg)
    torch.cuda.synchronize()
    assert (fa.LAUNCHES - counts[0], fa.DQ_LAUNCHES - counts[1],
            fa.DKV_LAUNCHES - counts[2]) == (4, 2, 2)
    dense = grads(dataclasses.replace(cfg, attention="dense"))
    for g, w in zip(flash, dense):
        assert bool(torch.isfinite(g).all())
        assert float((g - w).abs().max()) <= 5e-2 * float(w.abs().max())


@pytest.mark.cuda
def test_write_rows_scale_buffers_at_out_of_range_slots_on_card(cuda_device):
    """A per-row decode_step write past the cache on an int8 cache: the
    row's K, V and both scale rows keep their old values (masked, no
    device-side assert), and the in-range row writes all four."""
    from nos_tpu_torch.models import generate as tg

    cfg, params = _tiny_f32(cuda_device)
    prompt = torch.randint(1, cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(7))
    _, cache = tg.prefill(params, prompt, cfg, 16, quant=True)
    before = [{k: v.clone() for k, v in layer.items()} for layer in cache]
    pos = torch.tensor([8, 40], device=cuda_device)
    logits, _ = tg.decode_step(params, cache, pos, torch.tensor([3, 4]), cfg)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(logits).all())
    for layer, old in zip(cache, before):
        for key in ("k", "v", "k_scale", "v_scale"):
            assert torch.equal(layer[key][1], old[key][1]), key
        assert float(layer["k_scale"][0, 8].abs().min()) > 0
    buf = torch.zeros((3, 4, 2), device=cuda_device)
    tg._write_rows(buf, torch.tensor([1, 3, 0], device=cuda_device),
                   torch.ones((3, 2), device=cuda_device),
                   torch.tensor([True, False, True], device=cuda_device))
    assert buf.sum().item() == 4 and buf[1].sum().item() == 0


def _moe_case(device, seed, factor=1.25, zero_router=False):
    """A tiny f32 MoE (d 64, d_ff 128, 8 experts, top-2) drawn on the CPU
    and copied to ``device``, and tokens x [2, 48, 64]."""
    from nos_tpu_torch.models import moe as tm

    cfg = tm.MoeConfig(d_model=64, d_ff=128, n_experts=8, top_k=2,
                       capacity_factor=factor, dtype=torch.float32)
    gen = torch.Generator().manual_seed(seed)
    params = tm.init_moe_params(gen, cfg)
    if zero_router:
        params["router"].zero_()
    x = torch.randn((2, 48, 64), generator=gen)
    return cfg, params, {k: v.to(device) for k, v in params.items()}, x


@pytest.mark.cuda
@pytest.mark.parametrize("zero_router", [False, True])
@pytest.mark.parametrize("factor", [1.0, 8.0])
def test_moe_routing_on_card_equals_cpu(cuda_device, zero_router, factor):
    """The same f32 MoE on the card and on the CPU: identical routing
    (experts, slots, kept pairs: the card's sort breaks a zero router's
    ties to experts [0, 1] as the CPU's and jax.lax.top_k do) and outputs
    and aux within 1e-5 (TF32 off, other summation order)."""
    from nos_tpu_torch.models import moe as tm

    cfg, cpu_p, card_p, x = _moe_case(cuda_device, 1, factor, zero_router)
    mask = torch.rand((2, 48), generator=torch.Generator().manual_seed(2)) < 0.8
    want = tm._route(x.reshape(96, 64), cpu_p["router"], cfg, mask.reshape(96))
    got = tm._route(x.reshape(96, 64).to(cuda_device), card_p["router"], cfg,
                    mask.reshape(96).to(cuda_device))
    for i, name in ((1, "top_e"), (3, "pos"), (4, "keep")):
        assert torch.equal(got[i].cpu(), want[i]), name
    if zero_router:
        assert got[1].cpu().tolist() == [[0, 1]] * 96
    out, aux = tm.moe_mlp(card_p, x.to(cuda_device), cfg, return_aux=True,
                          token_mask=mask.to(cuda_device))
    want_out, want_aux = tm.moe_mlp(cpu_p, x, cfg, return_aux=True, token_mask=mask)
    assert float((out.cpu() - want_out).abs().max()) <= 1e-5
    assert abs(float(aux) - float(want_aux)) <= 1e-5


@pytest.mark.cuda
def test_moe_dispatch_collisions_keep_the_kept_token_on_card(cuda_device):
    """Capacity 1, a zero router: every token picks experts 0 and 1, the
    first wins slot 0 of both, and every other pair is dropped onto that
    same slot with a zero contribution. On the card the scatter's order
    is unspecified; accumulating keeps the first token's row intact."""
    from nos_tpu_torch.models import moe as tm

    cfg, _, card_p, x = _moe_case(cuda_device, 3, factor=0.005, zero_router=True)
    x = x.to(cuda_device)
    assert tm.capacity_per_expert(96, cfg) == 1
    out = tm.moe_mlp(card_p, x, cfg)
    h = x[0, :1]
    solo = sum(0.5 * ((torch.nn.functional.silu(h @ card_p["w_gate"][e])
                      * (h @ card_p["w_up"][e])) @ card_p["w_down"][e]) for e in (0, 1))
    assert float((out[0, 0] - solo[0]).abs().max()) <= 1e-5
    assert bool((out.reshape(96, 64)[1:] == 0).all())


@pytest.mark.cuda
def test_int8_expert_product_matches_fake_quant_on_card(cuda_device):
    """QuantizedExpertStack.expert_matmul against the product with the
    dequantized stack, bf16 at a Mixtral-like aspect: relative Frobenius
    error within 1e-2 (the scale rounds to bf16 before it multiplies, the
    oracle's weight rounds once to bf16 instead)."""
    from nos_tpu_torch.models import quantize as tq

    gen = torch.Generator(device=cuda_device).manual_seed(4)
    w = torch.randn((8, 512, 1792), generator=gen, device=cuda_device) / 512 ** 0.5
    stack = tq.quantize_expert_stack(w.to(torch.bfloat16))
    x = torch.randn((8, 24, 512), generator=gen, device=cuda_device).to(torch.bfloat16)
    got = stack.expert_matmul(x).float()
    oracle = tq.dequantize_params({"s": stack}, torch.bfloat16)["s"]
    want = torch.bmm(x, oracle).float()
    assert got.shape == (8, 24, 1792)
    assert float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want)) <= 1e-2



def _tp_rank(rank, out) -> None:
    """One of two ranks on the card in a gloo group (NCCL refuses two
    ranks on one device), a tiny bf16 flash model over a tp 2 mesh: the
    forward kernel's launches and the q heads each launch saw, the
    vocab-parallel loss beside the mean NLL of the gathered logits, and
    the backward kernels' launches. Module-level so that spawn can pickle
    it (this file imports no JAX)."""
    import os

    import numpy as np
    import torch.distributed as dist

    from nos_tpu_torch.models import llama
    from nos_tpu_torch.parallel.mesh import mesh_from_devices
    from nos_tpu_torch.parallel.sharding import shard_params

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{out}/rendezvous", rank=rank,
                            world_size=2)
    forward = fa._flash_fwd_cuda
    heads = []

    def seen(q, *args):
        heads.append(q.shape[2])
        return forward(q, *args)

    try:
        cfg = llama.tiny_config(d_model=256, n_heads=4, n_kv_heads=2, d_ff=512,
                                vocab_size=512, attention="flash", dtype=torch.bfloat16)
        mesh = mesh_from_devices((2,), ("tp",), device="cuda")
        shards = shard_params(llama.init_llama_params(cfg, 5, device="cuda"), mesh, cfg)
        gen = torch.Generator(device="cuda").manual_seed(5)
        tokens = torch.randint(0, cfg.vocab_size, (2, 256), generator=gen, device="cuda")
        fa._flash_fwd_cuda = seen
        fa.LAUNCHES = fa.DQ_LAUNCHES = fa.DKV_LAUNCHES = 0
        with torch.no_grad():
            logits = llama.llama_forward(shards, tokens, cfg, mesh)
        forward_launches = fa.LAUNCHES
        leaves = [p.requires_grad_(True) for p in llama.tree_leaves(shards)]
        fa.LAUNCHES = fa.DQ_LAUNCHES = fa.DKV_LAUNCHES = 0
        loss = llama.llama_loss(shards, tokens, cfg, mesh)
        torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        np.savez(os.path.join(str(out), f"tp_r{rank}.npz"),
                 forward_launches=forward_launches, heads=np.array(heads),
                 train_launches=np.array([fa.LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES]),
                 loss=float(loss), gathered_loss=float(llama.next_token_nll(logits, tokens)),
                 logits_shape=np.array(logits.shape), n_layers=cfg.n_layers)
        dist.barrier()
    finally:
        fa._flash_fwd_cuda = forward
        dist.destroy_process_group()


@pytest.mark.cuda
def test_tp_ranks_launch_the_kernels_at_local_heads_on_card(cuda_device, tmp_path):
    """Two ranks on the card, a tiny bf16 flash model over a tp 2 mesh
    (``_tp_rank``): the forward kernel runs once a layer on each rank at
    the rank's 2 of 4 q heads; the vocab-parallel loss (max, sum of
    exponentials and target logit reduced over tp) equals the mean NLL of
    the gathered logits within 1e-5 relative (the same bf16 logits, two
    f32 reductions); one backward launches dQ and dK/dV once a layer."""
    import numpy as np
    import torch.multiprocessing as mp

    mp.spawn(_tp_rank, args=(tmp_path,), nprocs=2)
    for r in range(2):
        with np.load(tmp_path / f"tp_r{r}.npz") as got:
            layers = int(got["n_layers"])
            assert int(got["forward_launches"]) == layers
            assert list(got["heads"][:layers]) == [2] * layers
            assert list(got["logits_shape"]) == [2, 256, 512]
            assert list(got["train_launches"]) == [layers, layers, layers]
            loss, gathered = float(got["loss"]), float(got["gathered_loss"])
            assert abs(loss - gathered) <= 1e-5 * abs(gathered), (loss, gathered)


@pytest.fixture
def one_rank_group(tmp_path):
    """A gloo process group of this process alone (world size 1), torn
    down after the test: the mesh paths on one card with no peer."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rendezvous", rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_moe_mlp_on_a_one_rank_ep_mesh_on_card(cuda_device, one_rank_group):
    """moe_mlp over a one-rank ('ep',) mesh on the card (the mesh path:
    the rank's experts, its stacks through the FSDP gather on use, the
    copy and gather pieces with no peer) is the one-device call, bit for
    bit, forward and gradients, at a binding capacity."""
    from nos_tpu_torch.models import moe as tm
    from nos_tpu_torch.parallel.mesh import mesh_from_devices

    mc = tm.MoeConfig(d_model=256, d_ff=512, n_experts=4, top_k=2, capacity_factor=1.0)
    gen = torch.Generator(device="cuda").manual_seed(7)
    params = tm.init_moe_params(gen, mc)
    x = torch.randn((2, 64, 256), generator=gen, device="cuda").to(torch.bfloat16)
    mesh = mesh_from_devices((1,), ("ep",), device="cuda")
    results = []
    for m in (None, mesh):
        leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
        out, aux = tm.moe_mlp(leaves, x, mc, m, return_aux=True)
        grads = torch.autograd.grad(out.float().square().sum() + aux, list(leaves.values()))
        results.append((out, aux, grads))
    (o1, a1, g1), (o2, a2, g2) = results
    assert torch.equal(o1, o2) and torch.equal(a1, a2)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))
    keep = tm._route(x.reshape(-1, 256), params["router"], mc)[4]
    assert not bool(keep.all())  # capacity binds


@pytest.mark.cuda
def test_pipeline_one_rank_schedule_matches_llama_forward_on_card(cuda_device,
                                                                  one_rank_group):
    """The pipeline on a one-rank ('pp',) mesh on the card: its
    microbatches run the forward kernel M · L times and its logits agree
    with llama_forward's within 5% of the largest (bf16, other batch
    shapes in the products); pipeline_loss_and_grads launches each
    backward kernel M · L times and its loss is llama_loss's within
    2e-2 (the reference's pipeline bar)."""
    from nos_tpu_torch.models import llama
    from nos_tpu_torch.parallel import pipeline as pl
    from nos_tpu_torch.parallel.mesh import mesh_from_devices

    cfg = llama.tiny_config(d_model=256, n_heads=4, n_kv_heads=2, d_ff=512,
                            vocab_size=512, attention="flash", dtype=torch.bfloat16)
    params = llama.init_llama_params(cfg, 11, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(11)
    tokens = torch.randint(0, cfg.vocab_size, (4, 256), generator=gen, device="cuda")
    mesh = mesh_from_devices((1,), ("pp",), device="cuda")
    stacked = pl.stack_layer_params(params)
    m = 2
    with torch.no_grad():
        want = llama.llama_forward(params, tokens, cfg)
        fa.LAUNCHES = 0
        got = pl.pipeline_llama_forward(stacked, tokens, cfg, mesh, m)
        assert fa.LAUNCHES == m * cfg.n_layers
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= 5e-2, err
    fa.LAUNCHES = fa.DQ_LAUNCHES = fa.DKV_LAUNCHES = 0
    loss, grads = pl.pipeline_loss_and_grads(stacked, tokens, cfg, mesh, m)
    torch.cuda.synchronize()
    assert [fa.LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES] == [m * cfg.n_layers] * 3
    with torch.no_grad():
        one = llama.llama_loss(params, tokens, cfg)
    assert abs(float(loss) - float(one)) <= 2e-2
    assert all(bool(torch.isfinite(g).all()) for g in grads)


@pytest.mark.cuda
@pytest.mark.parametrize("size", [32, 33])
def test_resnet_on_card_matches_cpu_and_stays_channels_last(cuda_device, size):
    """A tiny f32 ResNet on the card against the same weights on the
    CPU (TF32 off), within 1e-4 of the largest logit: cuDNN may pick
    other f32 algorithms than the CPU's direct sums. Every conv input on
    the card is channels_last, the "SAME" pads' outputs included."""
    from nos_tpu_torch.models import resnet
    from nos_tpu_torch.models.llama import tree_map

    torch.backends.cudnn.allow_tf32 = False
    cfg = resnet.ResNetConfig(num_classes=10, stage_sizes=(1, 2, 1), width=8,
                              dtype=torch.float32)
    params = resnet.init_resnet_params(torch.Generator(device="cuda").manual_seed(3), cfg)

    images = torch.randn((4, size, size, 3), generator=torch.Generator().manual_seed(4))
    seen = []
    real = resnet.F.conv2d

    def spy(x, w, *args, **kwargs):
        seen.append(x.is_contiguous(memory_format=torch.channels_last))
        return real(x, w, *args, **kwargs)

    resnet.F.conv2d = spy
    try:
        with torch.no_grad():
            got = resnet.resnet_forward(params, images.to(cuda_device), cfg).cpu()
    finally:
        resnet.F.conv2d = real
    with torch.no_grad():
        want = resnet.resnet_forward(tree_map(torch.Tensor.cpu, params), images, cfg)
    assert all(seen) and len(seen) == 1 + 4 * 3 + 3  # stem, 4 blocks, 3 projections
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-4


@pytest.mark.cuda
def test_load_hf_llama_streams_a_directory_to_the_card(cuda_device, tmp_path):
    """A tiny Llama checkpoint directory (bf16 safetensors shards under an
    index, written by ``chip_smoke.write_hf_checkpoint``) loads onto the
    card bit-equal to its CPU load, and generate() on it launches the
    forward kernel once a layer."""
    import chip_smoke
    from nos_tpu_torch.models import convert, llama
    from nos_tpu_torch.models.generate import generate

    cfg = llama.tiny_config(d_model=256, n_heads=4, n_kv_heads=2, d_ff=512, vocab_size=512)
    params = llama.init_llama_params(cfg, 5, device="cpu")
    written = chip_smoke.write_hf_checkpoint(str(tmp_path), params, cfg, 2**20)
    assert written["shards"] >= 2
    on_card, got_cfg = convert.load_hf_llama(str(tmp_path), device=cuda_device)
    on_cpu, _ = convert.load_hf_llama(str(tmp_path), device="cpu")
    assert got_cfg == cfg
    for a, b, w in zip(llama.tree_leaves(on_card), llama.tree_leaves(on_cpu),
                       llama.tree_leaves(params)):
        assert a.device.type == "cuda" and torch.equal(a.cpu(), b) and torch.equal(b, w)
    fcfg = llama.tiny_config(d_model=256, n_heads=4, n_kv_heads=2, d_ff=512, vocab_size=512,
                             attention="flash")
    prompt = torch.randint(1, 512, (2, 64), generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        fa.LAUNCHES = 0
        out = generate(on_card, prompt.to(cuda_device), fcfg, 8)
    assert fa.LAUNCHES == cfg.n_layers and out.shape == (2, 8)


@pytest.mark.cuda
def test_model_bench_runs_every_section_at_tiny_sizes_on_card(cuda_device):
    """``nos_tpu_torch.bench`` at its tiny sizes on a head_dim-64 config
    (Hq 4, Hkv 2): every section once on the card, each section's kernel
    launches equal to the counts its shapes imply (none in the Engines
    and the rolling stream, whose attention is dense or over the cache),
    the rolling cache's stream as long as the physical one's."""
    from nos_tpu_torch import bench

    sizes = bench.BenchSizes.tiny(d_model=256, n_heads=4, n_kv_heads=2, d_ff=512)
    outputs = {}
    result = bench.run_model_bench(cuda_device, sizes, outputs=outputs)
    n = sizes.config.n_layers
    assert outputs["launches"] == outputs["expected_launches"] == result["flash_launches"]
    assert outputs["launches"]["train"] == [2 * n, 2 * n, 2 * n]
    assert outputs["launches"]["engine"] == outputs["launches"]["rolling"] == [0, 0, 0]
    assert result["train_attention"] == "flash" and result["train_mfu_pct"] > 0
    assert result["serve_prefix_hits"] == sizes.engines[0][1]
    rolling = outputs["rolling"]
    assert len(rolling["rolling"]) == len(rolling["physical"]) == sizes.rolling_new


@pytest.mark.cuda
def test_rolling_cache_on_card_matches_the_physical_one_and_the_cpu(cuda_device):
    """``bench.bench_rolling`` at the tiny sizes in f32 (window 16, an
    8-token prompt, 40 new tokens: the rolling cache's writes, modulo
    24, wrap for the last 24): the rolling stream equals the physical
    one on the card, and both equal the CPU's on the same weights."""
    from nos_tpu_torch import bench
    from nos_tpu_torch.models.llama import init_llama_params

    sizes = bench.BenchSizes.tiny(dtype=torch.float32)
    cfg = sizes.config
    params = init_llama_params(cfg, seed=0, device="cpu")
    prompt = bench.draw_tokens((sizes.rolling_prompt,), cfg.vocab_size, 50, "cpu").tolist()
    assert sizes.rolling_new > sizes.window
    _, on_card = bench.bench_rolling(_to(params, cuda_device), cfg, sizes.window, prompt,
                                     sizes.rolling_new)
    _, on_cpu = bench.bench_rolling(params, cfg, sizes.window, prompt, sizes.rolling_new)
    assert len(on_card["rolling"]) == sizes.rolling_new
    assert on_card["rolling"] == on_card["physical"] == on_cpu["rolling"] == on_cpu["physical"]


@pytest.mark.cuda
def test_nvml_sees_the_card_torch_sees(cuda_device):
    """nos_tpu_torch.device.nvml over NVIDIA's libnvidia-ml.so.1:
    the device count, name and UUID equal torch's, and the memory total
    is at least what torch reports as usable."""
    from nos_tpu_torch.device.nvml import Nvml

    props = torch.cuda.get_device_properties(cuda_device)
    with Nvml() as nvml:
        assert nvml.device_count() == torch.cuda.device_count()
        assert nvml.name(0) == torch.cuda.get_device_name(0)
        assert nvml.uuid(0) == f"GPU-{props.uuid}"
        assert nvml.memory_total(0) >= props.total_memory


@pytest.mark.cuda
def test_nvml_reads_the_mig_mode_and_its_table_agrees(cuda_device):
    """The MIG mode, current and pending, reads as disabled or enabled;
    with MIG enabled the H100 table agrees with NVML's profile info,
    with MIG disabled NVML refuses the profile info."""
    from nos_tpu_torch.device.nvml import (NVML_DEVICE_MIG_ENABLE, NVML_ERROR_NOT_SUPPORTED,
                                           Nvml, NvmlError)
    from nos_tpu_torch.gpu.known import MIG_PROFILES

    with Nvml() as nvml:
        current, pending = nvml.mig_mode(0)
        assert current in (0, 1) and pending in (0, 1)
        profile = MIG_PROFILES["1g.10gb"]
        if current == NVML_DEVICE_MIG_ENABLE:
            info = nvml.profile_info(0, profile.nvml_profile)
            assert info["slice_count"] == profile.compute_slices
            assert info["instance_count"] == profile.max_instances
            placements = nvml.possible_placements(0, info["id"])
            assert placements == [(s, profile.memory_slices) for s in profile.starts]
        else:
            with pytest.raises(NvmlError, match="Not Supported") as refused:
                nvml.profile_info(0, profile.nvml_profile)
            assert refused.value.code == NVML_ERROR_NOT_SUPPORTED
