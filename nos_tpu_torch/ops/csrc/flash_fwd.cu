// Flash-attention forward for Hopper (sm_90a), bf16 in, f32 softmax.
//
// Replaces nos_tpu/ops/flash_attention.py:_fwd_kernel (launched there by
// _fwd_pallas). Same function: O = softmax(Q K^T / sqrt(hd)) V per
// (batch, query head), with GQA (query head h reads kv head h / group,
// K/V never expanded), a causal mask and an optional sliding window
// (q - k < window) applied at GLOBAL positions q_off + i / kv_off + j, so
// the block-partials entry point uses the same kernel; the row
// log-sum-exp is returned beside O, and a row with no visible key gives
// O = 0 and LSE = -inf.
//
// What bounds it on an H100: at prefill and training lengths it is
// compute-bound. Causal attention does 4 * hd operations per visible
// (query, key) pair (QK^T and PV) against 989 TFLOP/s of dense bf16
// tensor-core peak; the bytes (Q, K, V, O once each) are a few MB, far
// below the 295 operations per byte where memory would bind.
//
// What the design does about it (the building blocks are in sm90.cuh):
// - One block per (query tile of 128 rows, query head, batch): three
//   warpgroups. Warpgroup 0 is the producer: it gives up registers
//   (setmaxnreg.dec) and one thread issues TMA loads of Q and of a ring
//   of K/V stages (3 at hd 128, 4 at hd 64) of 128 keys each, guarded by
//   a full and an empty mbarrier per stage; it runs up to the ring's depth
//   ahead. Warpgroups 1 and 2 are consumers (setmaxnreg.inc), 64 query
//   rows each.
// - hd 256 (Gemma) keeps the design on smaller key tiles: Q takes 64 KB
//   and a 128-key K+V stage 128 KB of the 227 KB, so the tiles hold 64
//   keys and the ring two stages (192 KB with Q). A consumer holds K_i
//   and V_{i-1} at once (the pipeline below), so on one K+V barrier pair
//   a two-stage ring could load nothing ahead; K and V get a full and an
//   empty barrier each instead: K_i is released as soon as S_i retires,
//   V_{i-1} once PV_{i-1} has, and the producer loads each a tile ahead.
//   PV is one m64n256k16 per 16 keys (the O accumulator, 128 floats a
//   thread, beside a 32-float score tile).
// - Both products are wgmma. S = Q K^T is the SS form with both operands
//   K-major in 128-byte-swizzled shared memory; O += P V is the RS form:
//   P comes from the S accumulator in registers (its layout is the A
//   fragment's), V's tile is read MN-major (transpose-B). A consumer
//   releases a stage only after the products reading it have retired.
// - Each consumer pipelines its own loop: it issues S of tile i and PV of
//   tile i - 1 together and runs tile i's softmax while PV is in flight.
//   The two consumers take turns to issue (ping-pong on named barriers),
//   so one's softmax runs under the other's products.
// - Online softmax in f32 with exp2: scale * log2(e) is folded into one
//   FMA per score; the LSE is returned in natural log.
// - Key tiles the causal / window band cannot reach are never loaded;
//   a tile wholly inside the band and below Skv takes no mask arithmetic.
// - Causal grids start the query tiles with the most visible keys first
//   (the heaviest blocks do not form the tail).
// - The epilogue stages O, normalised and rounded to bf16, in the
//   consumer's own rows of the Q tile and writes it with a TMA store that
//   clips the ragged edge; rows past Sq and keys past Skv arrive from TMA
//   as zeros and are masked.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_fwd.so flash_fwd.cu
// Bound from Python with ctypes (nos_tpu_torch/ops/flash_attention.py).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int BM = 128;  // query rows per block: 64 per consumer warpgroup
constexpr int WG_ROWS = 64;
constexpr int WG_THREADS = 128;
constexpr int THREADS = 3 * WG_THREADS;  // producer + two consumers
constexpr int CONSUMER_WARPS = 8;        // arrivals that release a stage
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;  // 24 * 128 + 240 * 256 = 168 * 384
constexpr int CHUNK = 64;           // bf16 in a 128-byte swizzled row (one TMA box)
constexpr int STORE_BAR = 1;        // + consumer: its 128 threads before the O store
constexpr int TURN_BAR = 3;         // + consumer: its turn to issue products
constexpr int ROW_BYTES = 128;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int HD>
struct Tiles {
  static constexpr int BN = HD == 256 ? 64 : 128;  // keys per K/V tile
  // K and V on barrier rings of their own (hd 256), else one pair a stage
  static constexpr bool SPLIT_KV = HD == 256;
  static constexpr int STAGES = HD == 256 ? 2 : HD == 128 ? 3 : 4;
  static constexpr int CHUNKS = HD / CHUNK;
  static constexpr int Q_BYTES = BM * HD * 2;
  static constexpr int KV_BYTES = BN * HD * 2;  // one K or one V tile
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int BARRIERS = (SPLIT_KV ? 4 : 2) * STAGES + 1;
  // 1024 bytes of slack to align the swizzle atoms, then the barriers
  static constexpr int SMEM_BYTES = 1024 + Q_BYTES + STAGES * STAGE_BYTES + BARRIERS * 8;
};

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void fence_regs_u32(uint32_t (&r)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// What a consumer thread needs to mask and normalise a tile of scores.
struct Band {
  int Skv, kv_off;
  int qpos0;   // global position of the warpgroup's first row
  int qpos_a;  // global position of this thread's first row (the other is 8 below)
  int t;       // thread within the fragment's row group
  int causal, window;
  float scale_log2;
};

// Issue S = Q K^T for one 64-row x BN-key block: hd / 16 k-steps of 32
// bytes, four per 64-wide chunk of head_dim, both operands K-major.
template <int HD, int BN>
__device__ __forceinline__ void issue_qk(float (&s)[BN / 2], uint32_t q_base,
                                         uint32_t k_base) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t koff = (kk / 4) * BN * ROW_BYTES + (kk % 4) * 32;
    const uint32_t qoff = (kk / 4) * BM * ROW_BYTES + (kk % 4) * 32;
    const uint64_t dq = sm90::make_desc_sw128(q_base + qoff, 16, 1024);
    const uint64_t dk = sm90::make_desc_sw128(k_base + koff, 16, 1024);
    if constexpr (BN == 128) {
      sm90::wgmma_ss_m64n128k16(s, dq, dk, kk > 0);
    } else {
      sm90::wgmma_ss_m64n64k16(s, dq, dk, kk > 0);
    }
  }
  sm90::wgmma_commit();
}

// Issue O += P V: BN / 16 k-steps of 16 keys (2048 bytes of the V tile
// each); V is MN-major, its 64-wide head_dim chunks BN * 128 bytes apart.
template <int HD, int BN>
__device__ __forceinline__ void issue_pv(float (&o)[HD / 2],
                                         const uint32_t (&pa)[BN / 16][4],
                                         uint32_t v_base) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    const uint64_t dv =
        sm90::make_desc_sw128(v_base + kk * 16 * ROW_BYTES, BN * ROW_BYTES, 1024);
    if constexpr (HD == 256) {
      sm90::wgmma_rs_m64n256k16_tb(o, pa[kk], dv, 1);
    } else if constexpr (HD == 128) {
      sm90::wgmma_rs_m64n128k16_tb(o, pa[kk], dv, 1);
    } else {
      sm90::wgmma_rs_m64n64k16_tb(o, pa[kk], dv, 1);
    }
  }
  sm90::wgmma_commit();
}

// Mask (only where the band or the ragged edge cuts the warpgroup's
// 64 x BN block), then the online-softmax step in log2 units:
// p = 2^(s * scale * log2e - m). Leaves p in s, updates the running max
// and this thread's share of the row sums, and returns the factor that
// rescales the rows' earlier output.
template <int BN>
__device__ __forceinline__ void softmax_tile(float (&s)[BN / 2], int n0, const Band& bd,
                                             float (&m_run)[2], float (&l_run)[2],
                                             float (&corr)[2]) {
  const bool inside =
      n0 + BN <= bd.Skv &&
      (!bd.causal ||
       (bd.kv_off + n0 + BN - 1 <= bd.qpos0 &&
        (bd.window <= 0 || bd.qpos0 + WG_ROWS - 1 - bd.kv_off - n0 < bd.window)));
  if (!inside) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n0 + j * 8 + bd.t * 2 + (e & 1);
        const int qpos = bd.qpos_a + ((e < 2) ? 0 : 8);
        const int kpos = bd.kv_off + col;
        bool ok = col < bd.Skv;
        if (bd.causal) {
          ok = ok && kpos <= qpos;
          if (bd.window > 0) ok = ok && (qpos - kpos) < bd.window;
        }
        if (!ok) s[4 * j + e] = -INFINITY;
      }
    }
  }
  float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) mt[e >> 1] = fmaxf(mt[e >> 1], s[4 * j + e]);
  }
  float neg_m[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
    mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
    const float m_new = fmaxf(m_run[r], mt[r] * bd.scale_log2);
    const float safe_m = (m_new == -INFINITY) ? 0.f : m_new;
    corr[r] = fast_exp2(m_run[r] - safe_m);  // 0 while the row saw no key
    neg_m[r] = -safe_m;
    m_run[r] = m_new;
    l_run[r] *= corr[r];
  }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = fast_exp2(fmaf(s[4 * j + e], bd.scale_log2, neg_m[e >> 1]));
      s[4 * j + e] = p;
      l_run[e >> 1] += p;
    }
  }
}

template <int N>
__device__ __forceinline__ void rescale(float (&o)[N], const float (&corr)[2]) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    o[4 * j + 0] *= corr[0];
    o[4 * j + 1] *= corr[0];
    o[4 * j + 2] *= corr[1];
    o[4 * j + 3] *= corr[1];
  }
}

// P as the A operand: the S accumulator of keys 16kk .. 16kk + 15 is the
// m16n8k16 A fragment, rounded to bf16.
template <int BN>
__device__ __forceinline__ void pack_p(const float (&s)[BN / 2], uint32_t (&pa)[BN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    fence_regs_u32(pa[kk]);
  }
}

// A consumer warp is done with a stage once its products have retired.
__device__ __forceinline__ void release(uint64_t* empty_bar, int lane) {
  __syncwarp();
  if (lane == 0) sm90::mbar_arrive(empty_bar);
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const __grid_constant__ CUtensorMap tm_o, float* __restrict__ lse,
                 int Sq, int Skv, int Hq, int group, int q_off, int kv_off,
                 int causal, int window, float scale_log2) {
  using T = Tiles<HD>;
  constexpr int BN = T::BN;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s =
      smem_raw + ((1024u - (sm90::smem_addr(smem_raw) & 1023u)) & 1023u);
  uint8_t* kv_s = q_s + T::Q_BYTES;  // stage s: K at s * STAGE_BYTES, V after it
  // full / empty guard a stage's K and V, or only its K under SPLIT_KV,
  // where v_full / v_empty guard its V
  uint64_t* full = reinterpret_cast<uint64_t*>(kv_s + T::STAGES * T::STAGE_BYTES);
  uint64_t* empty = full + T::STAGES;
  uint64_t* q_full = empty + T::STAGES;
  uint64_t* v_full = q_full + 1;
  uint64_t* v_empty = v_full + T::STAGES;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q_tile = causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int q0 = q_tile * BM;
  const int hk = h / group;

  // Key range [n_lo, n_hi) any row of this tile can see: the causal
  // frontier of its last real row and the window edge of its first.
  const int q_last = min(q0 + BM, Sq) - 1;
  int n_lo = 0;
  int n_hi = Skv;
  if (causal) {
    n_hi = min(Skv, q_off + q_last - kv_off + 1);
    if (window > 0) n_lo = max(0, q_off + q0 - window + 1 - kv_off);
  }
  n_lo = (n_lo / BN) * BN;
  const int n_tiles = n_hi > n_lo ? (n_hi - n_lo + BN - 1) / BN : 0;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < T::STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], CONSUMER_WARPS);
      if constexpr (T::SPLIT_KV) {
        sm90::mbar_init(&v_full[s], 1);
        sm90::mbar_init(&v_empty[s], CONSUMER_WARPS);
      }
    }
    sm90::mbar_init(q_full, 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / WG_THREADS;
  if (wg == 0) {
    // ------------------------------------------------------- producer
    sm90::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      sm90::prefetch_tensormap(&tm_q);
      sm90::prefetch_tensormap(&tm_k);
      sm90::prefetch_tensormap(&tm_v);
      sm90::mbar_arrive_expect_tx(q_full, T::Q_BYTES);
#pragma unroll
      for (int c = 0; c < T::CHUNKS; ++c) {
        sm90::tma_load_4d(q_s + c * BM * ROW_BYTES, &tm_q, q_full, c * CHUNK, h, q0, b);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % T::STAGES;
        if (i >= T::STAGES) sm90::mbar_wait(&empty[st], ((i / T::STAGES) - 1) & 1);
        uint8_t* k_dst = kv_s + st * T::STAGE_BYTES;
        uint8_t* v_dst = k_dst + T::KV_BYTES;
        const int n0 = n_lo + i * BN;
        uint64_t* v_bar = &full[st];
        if constexpr (T::SPLIT_KV) {
          sm90::mbar_arrive_expect_tx(&full[st], T::KV_BYTES);
        } else {
          sm90::mbar_arrive_expect_tx(&full[st], T::STAGE_BYTES);
        }
#pragma unroll
        for (int c = 0; c < T::CHUNKS; ++c) {
          sm90::tma_load_4d(k_dst + c * BN * ROW_BYTES, &tm_k, &full[st], c * CHUNK, hk,
                            n0, b);
        }
        if constexpr (T::SPLIT_KV) {
          if (i >= T::STAGES) sm90::mbar_wait(&v_empty[st], ((i / T::STAGES) - 1) & 1);
          v_bar = &v_full[st];
          sm90::mbar_arrive_expect_tx(v_bar, T::KV_BYTES);
        }
#pragma unroll
        for (int c = 0; c < T::CHUNKS; ++c) {
          sm90::tma_load_4d(v_dst + c * BN * ROW_BYTES, &tm_v, v_bar, c * CHUNK, hk,
                            n0, b);
        }
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    sm90::setmaxnreg_inc<CONSUMER_REGS>();
    const int cw = wg - 1;  // owns rows cw * 64 .. cw * 64 + 63 of the tile
    const int tid = threadIdx.x % WG_THREADS;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane / 4;  // fragment row group
    const int t = lane % 4;  // thread within the group
    const int row0 = q0 + cw * WG_ROWS;  // first query row of this warpgroup
    const int r_a = warp * 16 + g;       // this thread's rows: r_a and r_a + 8
    const int qpos_a = q_off + row0 + r_a;
    const uint32_t q_base = sm90::smem_addr(q_s) + cw * WG_ROWS * ROW_BYTES;
    const uint32_t kv_base = sm90::smem_addr(kv_s);
    const Band band{Skv, kv_off, q_off + row0, qpos_a, t, causal, window, scale_log2};

    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY};  // row max of scaled scores, log2 units
    float l_run[2] = {0.f, 0.f};              // this thread's share of the row sums

    float s[BN / 2];           // scores, then probabilities, of the newest tile
    uint32_t pa[BN / 16][4];   // the previous tile's probabilities as A fragments
    float corr[2];

    // Software pipeline: iteration i issues S_i = Q K_i^T and then
    // O += P_{i-1} V_{i-1}, and runs tile i's softmax while the PV
    // product is in flight; O is rescaled once that product retires.
    // The two consumers take turns to issue their products (ping-pong
    // on named barriers), so one's softmax runs under the other's
    // products. Consumer 1 hands consumer 0 the first turn; consumer 0
    // takes one turn more at the end, so every barrier phase completes.
    const uint32_t my_turn = TURN_BAR + cw;
    const uint32_t their_turn = TURN_BAR + 1 - cw;
    if (cw == 1) sm90::named_barrier_arrive(their_turn, 2 * WG_THREADS);
    sm90::mbar_wait(q_full, 0);
    if (n_tiles > 0) {
      sm90::mbar_wait(&full[0], 0);
      sm90::named_barrier_sync(my_turn, 2 * WG_THREADS);
      sm90::fence_regs(s);
      sm90::wgmma_fence();
      issue_qk<HD, BN>(s, q_base, kv_base);
      sm90::named_barrier_arrive(their_turn, 2 * WG_THREADS);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(s);
      if constexpr (T::SPLIT_KV) release(&empty[0], lane);  // K_0 is read
      softmax_tile<BN>(s, n_lo, band, m_run, l_run, corr);  // corr unused: O is 0
      pack_p<BN>(s, pa);
    }
    for (int i = 1; i < n_tiles; ++i) {
      const int st = i % T::STAGES;
      const int prev = (i - 1) % T::STAGES;
      sm90::mbar_wait(&full[st], (i / T::STAGES) & 1);
      if constexpr (T::SPLIT_KV) sm90::mbar_wait(&v_full[prev], ((i - 1) / T::STAGES) & 1);
      sm90::named_barrier_sync(my_turn, 2 * WG_THREADS);
      sm90::fence_regs(s);
      sm90::fence_regs(o);
      sm90::wgmma_fence();
      issue_qk<HD, BN>(s, q_base, kv_base + st * T::STAGE_BYTES);
      issue_pv<HD, BN>(o, pa, kv_base + prev * T::STAGE_BYTES + T::KV_BYTES);
      sm90::named_barrier_arrive(their_turn, 2 * WG_THREADS);
      sm90::wgmma_wait<1>();  // S_i has retired; PV_{i-1} may still run
      sm90::fence_regs(s);
      if constexpr (T::SPLIT_KV) release(&empty[st], lane);  // K_i is read
      softmax_tile<BN>(s, n_lo + i * BN, band, m_run, l_run, corr);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(o);
      release(T::SPLIT_KV ? &v_empty[prev] : &empty[prev], lane);
      rescale(o, corr);
      pack_p<BN>(s, pa);
    }
    if (n_tiles > 0) {
      const int last = (n_tiles - 1) % T::STAGES;
      if constexpr (T::SPLIT_KV) {
        sm90::mbar_wait(&v_full[last], ((n_tiles - 1) / T::STAGES) & 1);
      }
      sm90::named_barrier_sync(my_turn, 2 * WG_THREADS);
      sm90::fence_regs(o);
      sm90::wgmma_fence();
      issue_pv<HD, BN>(o, pa, kv_base + last * T::STAGE_BYTES + T::KV_BYTES);
      sm90::named_barrier_arrive(their_turn, 2 * WG_THREADS);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(o);
      release(T::SPLIT_KV ? &v_empty[last] : &empty[last], lane);
    }
    if (cw == 0) sm90::named_barrier_sync(my_turn, 2 * WG_THREADS);

    // Normalise and stage O as bf16 in this warpgroup's rows of the Q
    // tile (its last reader, this warpgroup's QK^T, has retired), in the
    // swizzled layout the O tensor map expects; rows with no visible key:
    // O = 0, LSE = -inf.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
      const bool has_mass = l_run[r] > 0.f;
      const float inv = has_mass ? 1.f / l_run[r] : 0.f;
      const int lr = r_a + 8 * r;  // warpgroup-local row; lr % 8 == g
      uint8_t* row_s = q_s + cw * WG_ROWS * ROW_BYTES + lr * ROW_BYTES + t * 4;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        const float x0 = has_mass ? o[4 * j + 2 * r] * inv : 0.f;
        const float x1 = has_mass ? o[4 * j + 2 * r + 1] * inv : 0.f;
        *reinterpret_cast<uint32_t*>(row_s + (j / 8) * BM * ROW_BYTES +
                                     (((j % 8) ^ g) * 16)) = pack_bf16(x0, x1);
      }
      const int row = row0 + lr;
      if (t == 0 && row < Sq) {
        lse[(static_cast<long long>(b) * Hq + h) * Sq + row] =
            has_mass ? (m_run[r] + log2f(l_run[r])) * LN2 : -INFINITY;
      }
    }
    sm90::fence_async_smem();
    sm90::named_barrier_sync(STORE_BAR + cw, WG_THREADS);
    if (tid == 0) {
#pragma unroll
      for (int c = 0; c < T::CHUNKS; ++c) {
        sm90::tma_store_4d(&tm_o, q_s + c * BM * ROW_BYTES + cw * WG_ROWS * ROW_BYTES,
                           c * CHUNK, h, row0, b);
      }
      sm90::tma_store_commit_and_wait();
    }
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse,
                   int B, int Sq, int Skv, int Hq, int Hkv, const long long* st,
                   int q_off, int kv_off, int causal, int window, float scale,
                   cudaStream_t stream) {
  constexpr int BN = Tiles<HD>::BN;
  const int n_qtiles = (Sq + BM - 1) / BM;
  if (n_qtiles > 65535 || B > 65535) return cudaErrorInvalidValue;
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  // strides: (b, s, h) of q, k, v, o in that order
  if (!sm90::make_tmap_bf16_4d(&tm_q, q, HD, Hq, Sq, B, st[2], st[1], st[0], BM) ||
      !sm90::make_tmap_bf16_4d(&tm_k, k, HD, Hkv, Skv, B, st[5], st[4], st[3], BN) ||
      !sm90::make_tmap_bf16_4d(&tm_v, v, HD, Hkv, Skv, B, st[8], st[7], st[6], BN) ||
      !sm90::make_tmap_bf16_4d(&tm_o, o, HD, Hq, Sq, B, st[11], st[10], st[9],
                               WG_ROWS)) {
    return cudaErrorInvalidValue;
  }
  const int smem = Tiles<HD>::SMEM_BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(Hq, B, n_qtiles);
  flash_fwd_kernel<HD><<<grid, THREADS, smem, stream>>>(
      tm_q, tm_k, tm_v, tm_o, static_cast<float*>(lse), Sq, Skv, Hq, Hq / Hkv, q_off,
      kv_off, causal, window, scale * LOG2E);
  return cudaGetLastError();
}

}  // namespace

// q [B, Sq, Hq, HD], k/v [B, Skv, Hkv, HD] bf16 with unit stride on the
// last dim, 16-byte aligned bases and (b, s, h) strides in multiples of 8
// elements (the TMA maps read them as they are); o like q; lse
// [B, Hq, Sq] f32 contiguous. `strides` holds (b, s, h) element strides
// of q, k, v, o in that order. window <= 0 means no window. Returns a
// cudaError_t.
extern "C" int nos_flash_fwd_bf16(const void* q, const void* k, const void* v,
                                  void* o, void* lse, int B, int Sq, int Skv,
                                  int Hq, int Hkv, int head_dim,
                                  const long long* strides, int q_off,
                                  int kv_off, int causal, int window,
                                  float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || Hq % Hkv != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return static_cast<int>(launch<64>(q, k, v, o, lse, B, Sq, Skv, Hq, Hkv, strides,
                                         q_off, kv_off, causal, window, scale, s));
    case 128:
      return static_cast<int>(launch<128>(q, k, v, o, lse, B, Sq, Skv, Hq, Hkv, strides,
                                          q_off, kv_off, causal, window, scale, s));
    case 256:
      return static_cast<int>(launch<256>(q, k, v, o, lse, B, Sq, Skv, Hq, Hkv, strides,
                                          q_off, kv_off, causal, window, scale, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
