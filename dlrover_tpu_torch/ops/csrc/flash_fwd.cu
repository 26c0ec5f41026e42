// Flash-attention forward for Hopper (sm_90a), bf16 in, f32 accumulate.
//
// Replaces: dlrover_tpu/ops/flash_attention.py `_fwd_kernel` (:98), the
// TPU kernel that `_fwd` launches through pl.pallas_call (:181) for the
// public `flash_attention` (:457). It computes what that kernel computes:
//   o   = softmax(scale * q k^T + mask) v      (B, H, Sq, D), q's dtype
//   lse = m + log(l) per query row             (B, H, Sq), f32
// with the mask `col < Sk` and, when causal, `col <= row` (top-left
// alignment: row is the absolute query index, so Sq != Sk keeps the TPU
// kernel's meaning, not FlashAttention-2's bottom-right one). A row with no
// visible key gives o = 0 and lse = -1e30 (the TPU kernel's masked score);
// Sk = 0 is such a case for every row and takes a small fill kernel.
//
// What bounds it on this card: operations. The two products are 4*D FLOP
// per visible (query, key) pair against 2*D*2 bytes of q and o per query
// row and 2*D*2 bytes of k and v per key row; at the serving prefill's and
// the training step's lengths (S >= 1024) that is far above the H100's ~295
// FLOP/byte ridge, so the tensor cores (989 TFLOP/s bf16) bound it.
//
// Design, for that bound. Only wgmma reaches the tensor cores' full rate,
// and only if the operands are already in shared memory when it issues:
//   - One CTA owns 128 query rows of one (b, h): two consumer warpgroups of
//     64 rows each, and a producer warpgroup that gives its registers to the
//     consumers (setmaxnreg 24 / 240). The roles split once and never
//     reconverge.
//   - The producer's one thread loads Q once and then K and V tiles of 128
//     keys by TMA into a ring of kStages stages (128-byte swizzle; 4-D
//     tensor maps over (D, S, H, B) with the caller's strides, so a
//     transposed q needs no copy and rows past S arrive as zeros without
//     touching the next head). Each stage has full and empty barriers for
//     K and for V apart: Q K^T starts before V lands, and all 256 consumer
//     threads release a K tile as soon as Q K^T has read it, so the next
//     K tile loads while this tile's P V still runs.
//   - S = Q K^T is wgmma m64n128k16 with Q and K both K-major in shared
//     memory. P is the S accumulator rounded to bf16 in registers: for a
//     16-bit type the accumulator layout of one product is the A-register
//     fragment of the next, so O += P V is wgmma with P in registers and V
//     read MN-major (the transpose bit), with no transposed copy of V.
//   - Softmax in registers with ex2.approx and scale*log2(e) folded into one FMA;
//     row max and sum across the 4 lanes of a row; masked scores are -inf
//     inside the kernel, with the row max taken as 0 while a row has seen no
//     visible key, so no inf - inf arises. Only tiles that cross the causal
//     diagonal or the Sk edge compute the mask.
//   - Under causal masking, K tiles wholly in the future are never loaded,
//     and the Q tiles of a group of heads launch heaviest first, so the
//     longest CTAs do not form the tail while the CTAs in flight share
//     those heads' K and V in L2 (ordering the whole grid heaviest first
//     spreads them over every head and sends each K/V tile to HBM again).
//   - Within a consumer warpgroup, tile n's Q K^T is issued before tile
//     n-1's P V, and tile n's softmax runs while that P V is still on the
//     tensor cores. The two consumer warpgroups take turns to issue their
//     products (named barriers), so one's softmax also runs while the
//     other's products run.
// o is stored straight from registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBlockM = 128;  // query rows per CTA, 64 per consumer warpgroup
constexpr int kBlockN = 128;  // keys per K/V tile
constexpr int kStages = 2;    // K/V ring depth
constexpr int kConsumers = 2;  // consumer warpgroups
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr int kHeadGroup = 8;  // heads whose Q tiles are scheduled together
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kColBlockBytes = 128 * 128;  // one 64-wide column block of a 128-row tile
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// Dynamic shared memory: Q, then the K stages, then the V stages, each tile
// D / 64 column blocks of 128 rows x 128 bytes; then the barriers.
template <int D>
struct Smem {
  static constexpr int kTileBytes = kBlockN * D * 2;
  static constexpr int kQ = 0;
  static constexpr int kK = kBlockM * D * 2;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBars = kV + kStages * kTileBytes;
  static constexpr int kBytes = kBars + (1 + 4 * kStages) * 8;
  static constexpr int kAlloc = kBytes + 1024;  // room to align the base to 1024
};

// S = Q K^T for one tile (64 rows x 128 keys), Q and K K-major: issued and
// committed as one group, not waited for. A 16-wide k step moves 32 bytes
// inside a 64-wide column block.
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[kBlockN / 2], const uint8_t* q_s,
                                         const uint8_t* k_s) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int off = (kk / 4) * kColBlockBytes + (kk % 4) * 32;
    wgmma_m64n128k16_ss<0, 0>(sc, wgmma_desc_sw128(q_s + off, 16, 1024),
                              wgmma_desc_sw128(k_s + off, 16, 1024), kk > 0);
  }
  wgmma_commit();
}

// O += P V for one tile, P in registers, V MN-major (16 keys, 2 KB of rows,
// per k step; column blocks kColBlockBytes apart): issued and committed.
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2],
                                         const uint32_t (&pa)[kBlockN / 16][4],
                                         const uint8_t* v_s) {
#pragma unroll
  for (int kk = 0; kk < kBlockN / 16; ++kk) {
    const uint64_t dv = wgmma_desc_sw128(v_s + kk * 16 * 128, kColBlockBytes, 1024);
    if constexpr (D == 128)
      wgmma_m64n128k16_rs<1>(acc, pa[kk], dv, 1);
    else
      wgmma_m64n64k16_rs<1>(acc, pa[kk], dv, 1);
  }
  wgmma_commit();
}

// Online softmax of one tile in the log2 domain. The accumulator element i
// of this lane sits in row row0 + 8 * ((i >> 1) & 1) and column
// k0 + 8 * (i / 4) + col_lane + (i & 1). Masks when asked (-inf inside the
// kernel), turns sc into p, folds the tile into the running max m_i and sum
// l_i, and leaves in alpha the factor that rescales each row's output.
__device__ __forceinline__ void softmax_tile(float (&sc)[kBlockN / 2], float (&m_i)[2],
                                             float (&l_i)[2], float (&alpha)[2],
                                             bool mask, int k0, int row0, int col_lane,
                                             int Sk, int causal, float scale_log2) {
  if (mask) {
#pragma unroll
    for (int i = 0; i < kBlockN / 2; ++i) {
      const int col = k0 + (i / 4) * 8 + col_lane + (i & 1);
      const int row = row0 + ((i >> 1) & 1) * 8;
      if (col >= Sk || (causal && col > row)) sc[i] = -INFINITY;
    }
  }
  float mx[2] = {m_i[0], m_i[1]};
#pragma unroll
  for (int i = 0; i < kBlockN / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
  float m_scaled[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    // a row that has seen no visible key keeps max 0, so p = exp2(-inf) = 0
    m_scaled[r] = mx[r] == -INFINITY ? 0.f : mx[r] * scale_log2;
    alpha[r] = exp2_approx(m_i[r] * scale_log2 - m_scaled[r]);
    m_i[r] = mx[r];
    l_i[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < kBlockN / 2; ++i) {
    const int r = (i >> 1) & 1;
    sc[i] = exp2_approx(fmaf(sc[i], scale_log2, -m_scaled[r]));
    l_i[r] += sc[i];
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int H,
                 int Sq, int Sk, float scale, int causal) {
  using L = Smem<D>;
  constexpr int kColBlocks = D / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full_q = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full_k = full_q + 1;
  uint64_t* full_v = full_k + kStages;
  uint64_t* empty_k = full_v + kStages;
  uint64_t* empty_v = empty_k + kStages;

  // CTA order: heads in groups of kHeadGroup; inside a group, Q tiles from
  // the last (heaviest under causal masking) to the first, the group's heads
  // side by side. The CTAs in flight then share a few heads' K and V in L2.
  const int n_m = (Sq + kBlockM - 1) / kBlockM;
  const int BH = gridDim.x / n_m;
  const int group = blockIdx.x / (kHeadGroup * n_m);
  const int in_group = blockIdx.x - group * kHeadGroup * n_m;
  const int g_heads = min(kHeadGroup, BH - group * kHeadGroup);
  const int bh = group * kHeadGroup + in_group % g_heads;
  const int b = bh / H;
  const int h = bh - b * H;
  const int m0 = (n_m - 1 - in_group / g_heads) * kBlockM;
  int n_tiles = (Sk + kBlockN - 1) / kBlockN;
  if (causal) n_tiles = min(n_tiles, (m0 + kBlockM - 1) / kBlockN + 1);

  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_k[s], kConsumers * 128);
      mbar_init(&empty_v[s], kConsumers * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= kConsumers * 4) {
    // ---- producer warpgroup: one thread issues every TMA load ----
    warpgroup_reg_dealloc<kProducerRegs>();
    if (warp == kConsumers * 4 && lane == 0) {
      prefetch_tensor_map(&tq);
      prefetch_tensor_map(&tk);
      prefetch_tensor_map(&tv);
      mbar_arrive_expect_tx(full_q, kBlockM * D * 2);
      for (int cb = 0; cb < kColBlocks; ++cb)
        tma_load_4d(smem + L::kQ + cb * kColBlockBytes, &tq, full_q, cb * 64, m0, h, b);
      for (int n = 0; n < n_tiles; ++n) {
        const int s = n % kStages;
        const uint32_t parity = ((n / kStages) & 1) ^ 1;
        uint8_t* k_s = smem + L::kK + s * L::kTileBytes;
        uint8_t* v_s = smem + L::kV + s * L::kTileBytes;
        mbar_wait(&empty_k[s], parity);
        mbar_arrive_expect_tx(&full_k[s], L::kTileBytes);
        for (int cb = 0; cb < kColBlocks; ++cb)
          tma_load_4d(k_s + cb * kColBlockBytes, &tk, &full_k[s], cb * 64, n * kBlockN,
                      h, b);
        mbar_wait(&empty_v[s], parity);
        mbar_arrive_expect_tx(&full_v[s], L::kTileBytes);
        for (int cb = 0; cb < kColBlocks; ++cb)
          tma_load_4d(v_s + cb * kColBlockBytes, &tv, &full_v[s], cb * 64, n * kBlockN,
                      h, b);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    warpgroup_reg_alloc<kConsumerRegs>();
    const int wg = warp / 4;
    const int row0 = m0 + wg * 64 + (warp % 4) * 16 + lane / 4;  // and row0 + 8
    const int col_lane = 2 * (lane % 4);
    const float scale_log2 = scale * kLog2e;
    const uint8_t* q_s = smem + L::kQ + wg * 64 * 128;  // this warpgroup's rows

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m_i[2] = {-INFINITY, -INFINITY};
    float l_i[2] = {0.f, 0.f};  // this lane's share of the row sums
    float sc[kBlockN / 2];        // S, then P, of the current tile
    uint32_t pa[kBlockN / 16][4];  // P of the previous tile as bf16 A fragments
    float alpha[2];
    // a tile takes the mask when it crosses the Sk edge or, under causal
    // masking, this warpgroup's diagonal
    auto masked = [&](int n) {
      const int k0 = n * kBlockN;
      return k0 + kBlockN > Sk || (causal && k0 + kBlockN - 1 > m0 + wg * 64);
    };

    // The two warpgroups take turns to issue their products (named barriers
    // 1 and 2), so one's softmax runs while the other's products run;
    // warpgroup 0 goes first, and warpgroup 1 does not pass its last turn
    // on, so every barrier sees as many arrivals as waits.
    auto take_turn = [&] { named_barrier_sync(1 + wg, kConsumers * 128); };
    auto pass_turn = [&](bool more) {
      if (more) named_barrier_arrive(2 - wg, kConsumers * 128);
    };
    if (wg == 1) pass_turn(true);

    // Tile n's S = Q K^T is issued before tile n-1's O += P V, and its
    // softmax runs while that product is still on the tensor cores. There
    // is at least one tile: Sk > 0 here, and every Q tile sees key 0.
    mbar_wait(full_q, 0);
    mbar_wait(&full_k[0], 0);
    wgmma_fence();
    take_turn();
    issue_qk<D>(sc, q_s, smem + L::kK);
    pass_turn(true);
    wgmma_wait<0>();
    fence_operands(sc);
    mbar_arrive(&empty_k[0]);
    softmax_tile(sc, m_i, l_i, alpha, masked(0), 0, row0, col_lane, Sk, causal,
                 scale_log2);
    to_bf16_fragments(sc, pa);
    for (int n = 1; n < n_tiles; ++n) {
      const int s = n % kStages;
      const int sp = (n - 1) % kStages;
      mbar_wait(&full_k[s], (n / kStages) & 1);
      mbar_wait(&full_v[sp], ((n - 1) / kStages) & 1);
      fence_operands(sc);
      fence_operands(pa);
      fence_operands(acc);
      wgmma_fence();
      take_turn();
      issue_qk<D>(sc, q_s, smem + L::kK + s * L::kTileBytes);
      issue_pv<D>(acc, pa, smem + L::kV + sp * L::kTileBytes);
      pass_turn(true);
      wgmma_wait<1>();  // S of tile n is ready; P V of tile n-1 may still run
      fence_operands(sc);
      mbar_arrive(&empty_k[s]);
      softmax_tile(sc, m_i, l_i, alpha, masked(n), n * kBlockN, row0, col_lane, Sk,
                   causal, scale_log2);
      wgmma_wait<0>();
      fence_operands(acc);
      fence_operands(pa);
      mbar_arrive(&empty_v[sp]);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
      to_bf16_fragments(sc, pa);
    }
    const int sl = (n_tiles - 1) % kStages;
    mbar_wait(&full_v[sl], ((n_tiles - 1) / kStages) & 1);
    fence_operands(pa);
    fence_operands(acc);
    wgmma_fence();
    take_turn();
    issue_pv<D>(acc, pa, smem + L::kV + sl * L::kTileBytes);
    pass_turn(wg == 0);
    wgmma_wait<0>();
    fence_operands(acc);
    mbar_arrive(&empty_v[sl]);

    // epilogue: o = acc / l in bf16, lse = m * scale + log(l)
    const long long row_base = static_cast<long long>(bh) * Sq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_i[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int row = row0 + 8 * r;
      if (row >= Sq) continue;
      const float inv = l == 0.f ? 0.f : 1.f / l;
      __nv_bfloat16* orow = o + (row_base + row) * D + col_lane;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j) =
            pack_bf16(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
      if (lane % 4 == 0)
        lse[row_base + row] = l == 0.f ? kNegInf : m_i[r] * scale + logf(l);
    }
  }
}

// Sk = 0: no row sees a key, so o = 0 and lse = -1e30 everywhere.
__global__ void flash_fwd_no_keys(__nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                                  long long rows, int D) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = blockIdx.x * blockDim.x + threadIdx.x; i < rows * D; i += stride) {
    o[i] = __float2bfloat16(0.f);
    if (i < rows) lse[i] = kNegInf;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int B,
           int H, int Sq, int Sk, const long long (&qs)[3], const long long (&ks)[3],
           const long long (&vs)[3], float scale, int causal, cudaStream_t st) {
  CUtensorMap tq, tk, tv;
  const uint64_t qdims[4] = {D, static_cast<uint64_t>(Sq), static_cast<uint64_t>(H),
                             static_cast<uint64_t>(B)};
  const uint64_t kdims[4] = {D, static_cast<uint64_t>(Sk), static_cast<uint64_t>(H),
                             static_cast<uint64_t>(B)};
  if (!make_tensor_map_4d_bf16(&tq, q, qdims, qs, 64, kBlockM) ||
      !make_tensor_map_4d_bf16(&tk, k, kdims, ks, 64, kBlockN) ||
      !make_tensor_map_4d_bf16(&tv, v, kdims, vs, 64, kBlockN))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<D>::kAlloc);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = B * H * ((Sq + kBlockM - 1) / kBlockM);
  flash_fwd_kernel<D><<<grid, kThreads, Smem<D>::kAlloc, st>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), H, Sq, Sk,
      scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q/k/v: bf16 with the head dim contiguous and the given element strides
// over (batch, head, sequence), each a multiple of 8 (16 bytes, as TMA
// needs), 16-byte aligned bases; o: contiguous (B, H, Sq, D) bf16; lse:
// contiguous (B, H, Sq) f32. Returns cudaGetLastError() after the launch,
// or cudaErrorInvalidValue when D is not 64 or 128 or a tensor map is
// refused.
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              void* o, void* lse, int B, int H, int Sq, int Sk,
                              int D, long long q_sb, long long q_sh,
                              long long q_ss, long long k_sb, long long k_sh,
                              long long k_ss, long long v_sb, long long v_sh,
                              long long v_ss, float scale, int causal,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D != 64 && D != 128) return static_cast<int>(cudaErrorInvalidValue);
  if (Sk == 0) {
    const long long rows = static_cast<long long>(B) * H * Sq;
    const int blocks = static_cast<int>(std::min((rows * D + 255) / 256, 4096LL));
    flash_fwd_no_keys<<<blocks, 256, 0, st>>>(static_cast<__nv_bfloat16*>(o),
                                              static_cast<float*>(lse), rows, D);
    return static_cast<int>(cudaGetLastError());
  }
  // tensor-map strides of dims (S, H, B), innermost first
  const long long qs[3] = {q_ss, q_sh, q_sb};
  const long long ks[3] = {k_ss, k_sh, k_sb};
  const long long vs[3] = {v_ss, v_sh, v_sb};
  if (D == 128)
    return launch<128>(q, k, v, o, lse, B, H, Sq, Sk, qs, ks, vs, scale, causal, st);
  return launch<64>(q, k, v, o, lse, B, H, Sq, Sk, qs, ks, vs, scale, causal, st);
}
