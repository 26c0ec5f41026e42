// Flash-attention backward for Hopper (sm_90a), bf16 in, f32 accumulate.
//
// Replaces: dlrover_tpu/ops/flash_attention.py `_bwd_dq_kernel` (:212) and
// `_bwd_dkv_kernel` (:266), the two TPU kernels that `_bwd` launches through
// pl.pallas_call (:366, :386) for the custom VJP of `flash_attention`. Two
// kernels here too, computing what those compute from the forward's lse:
//   p     = exp(scale * q k^T - lse)    masked to 0 (after the exp)
//   ds    = p * (do v^T - delta)        delta = rowsum(do * o) - dlse, given
//   dq    = scale * ds k                 flash_bwd_dq_bf16   (K2)
//   dk    = scale * ds^T q               flash_bwd_dkv_bf16  (K3)
//   dv    = p^T do                       flash_bwd_dkv_bf16  (K3)
// with the forward's masks: `col < Sk`, `row < Sq` (the reference's q_len
// mask in K3), and, when causal, `col <= row` with top-left alignment (row is
// the absolute query index). Keeping dq in a kernel of its own keeps it
// deterministic: fusing it into K3 needs f32 atomics across key tiles.
//
// What bounds them on this card: operations. K2 does 6*D FLOP per visible
// (query, key) pair (s, dp, dq) and K3 8*D (s, dp, dv, dk), against 2*D*2
// bytes per row of each of q, k, v, do and the outputs. At training lengths
// (S = 2048) that is far above the H100's ~295 FLOP/byte ridge: the tensor
// cores (989 TFLOP/s bf16) bound both.
//
// Design, for that bound: K1's (flash_fwd.cu). Only wgmma reaches the tensor
// cores' full rate, and only with its operands already in shared memory.
//   - Each CTA has two consumer warpgroups of 64 rows and a producer
//     warpgroup that gives its registers to them (setmaxnreg 24 / 240). The
//     producer's one thread loads the CTA's own tiles once and streams the
//     others by TMA through a ring with full and empty barriers per operand
//     (128-byte swizzle; 4-D tensor maps over (D, S, H, B) with the caller's
//     strides, so the models' transposed q and do are read in place, and
//     rows past S arrive as zeros).
//   - K2: one CTA per (b, h, 128 query rows); Q and dO loaded once, K and V
//     streamed in 64-key tiles. S = Q K^T and dP = dO V^T are wgmma with
//     every operand K-major; dS = P (dP - delta) is rounded to bf16 in
//     registers, where the accumulator layout is the A-fragment layout, and
//     dQ += dS K reads the same K tile MN-major (the transpose bit). lse
//     and delta are per row: registers for the whole CTA. Tile n's S and dP
//     are issued before tile n-1's dS K, and tile n's dS is computed while
//     that product runs; the two warpgroups take turns to issue (named
//     barriers), as in K1.
//   - K3: one CTA per (b, h, 128 keys); K and V loaded once, Q and dO
//     streamed in 64-row tiles. The keys are the M dimension: S^T = K Q^T
//     and dP^T = V dO^T (all K-major), so P^T and dS^T come out as A
//     fragments of dV += P^T dO and dK += dS^T Q, which read the same Q and
//     dO tiles MN-major. lse and delta are per column here: a second
//     producer warp copies each Q tile's 64 values into the stage (ordinary
//     loads: a row of them is Sq * 4 bytes, not the 16-byte multiple TMA
//     needs) and arrives on the tile's full barrier.
//   - The mask selects 0 after the exponential (a masked row's lse of -1e30
//     overflows it) and is computed only on tiles that cross the causal
//     diagonal or an Sq/Sk edge. Under causal masking K2 never loads key
//     tiles wholly in its rows' future and K3 starts at the first Q tile
//     that sees its keys; a K3 warpgroup skips the products of a Q tile
//     that sees none of its keys. CTAs launch heaviest first within groups
//     of 8 heads (K2: the last Q tile; K3: key tile 0), so the CTAs in
//     flight share a few heads' operands in L2.
//   - Sk = 0 (K2) and Sq = 0 (K3) write zeros: a tensor map cannot have a
//     zero dimension.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kConsumers = 2;  // consumer warpgroups, 64 rows each
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr int kHeadGroup = 8;  // heads whose CTAs are scheduled together
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr float kLog2e = 1.4426950408889634f;

// K2: 128 query rows a CTA, K/V streamed in 64-key tiles
constexpr int kDqRows = 128;
constexpr int kDqKeys = 64;
constexpr int kDqStages = 4;
// K3: 128 keys a CTA, Q/dO streamed in 64-row tiles. Ring depths are powers
// of two: the stage and phase are then a mask and a shift, which the
// producer's 24 registers need (a 3-stage ring spilled there).
constexpr int kDkvKeys = 128;
constexpr int kDkvRows = 64;
constexpr int kDkvStages = 4;

// Bytes of one 64-wide column block (128-byte rows) of a tile of `rows`.
__host__ __device__ constexpr int col_block(int rows) { return rows * 128; }

// K2's dynamic shared memory: Q, dO, the K stages, the V stages, each tile
// D / 64 column blocks; then the barriers.
template <int D>
struct DqSmem {
  static constexpr int kTileBytes = kDqKeys * D * 2;
  static constexpr int kQ = 0;
  static constexpr int kDo = kDqRows * D * 2;
  static constexpr int kK = 2 * kDqRows * D * 2;
  static constexpr int kV = kK + kDqStages * kTileBytes;
  static constexpr int kBars = kV + kDqStages * kTileBytes;
  static constexpr int kBytes = kBars + (1 + 4 * kDqStages) * 8;
  static constexpr int kAlloc = kBytes + 1024;  // room to align the base to 1024
};

// K3's: K, V, the Q stages, the dO stages, then per stage 64 lse * log2(e)
// and 64 delta, then the barriers.
template <int D>
struct DkvSmem {
  static constexpr int kKVBytes = kDkvKeys * D * 2;
  static constexpr int kTileBytes = kDkvRows * D * 2;
  static constexpr int kK = 0;
  static constexpr int kV = kKVBytes;
  static constexpr int kQ = 2 * kKVBytes;
  static constexpr int kDo = kQ + kDkvStages * kTileBytes;
  static constexpr int kRowVals = kDo + kDkvStages * kTileBytes;
  static constexpr int kBars = kRowVals + kDkvStages * 2 * kDkvRows * 4;
  static constexpr int kBytes = kBars + (1 + 4 * kDkvStages) * 8;
  static constexpr int kAlloc = kBytes + 1024;
};

__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  return raw + ((1024 - (smem_addr(raw) & 1023)) & 1023);
}

// X Y^T for one 64 x 64 tile with both operands K-major: X is a warpgroup's
// 64 rows of a CTA's own 128-row tile, Y a streamed tile of 64 rows; a
// 16-wide k step moves 32 bytes inside a 64-wide column block. Issued, not
// committed.
template <int D>
__device__ __forceinline__ void issue_xyt(float (&d)[32], const uint8_t* x_s,
                                          const uint8_t* y_s) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int k_off = (kk % 4) * 32;
    wgmma_m64n64k16_ss<0, 0>(
        d, wgmma_desc_sw128(x_s + (kk / 4) * col_block(128) + k_off, 16, 1024),
        wgmma_desc_sw128(y_s + (kk / 4) * col_block(64) + k_off, 16, 1024), kk > 0);
  }
}

// acc += A Y for 64 rows, A (64 x 64) as bf16 fragments in registers, Y a
// tile of 64 rows read MN-major (16 rows, 2 KB, per k step; its column
// blocks col_block(64) apart). Issued and committed.
template <int D>
__device__ __forceinline__ void issue_ay(float (&acc)[D / 2], const uint32_t (&a)[4][4],
                                         const uint8_t* y_s) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t desc = wgmma_desc_sw128(y_s + kk * 16 * 128, col_block(64), 1024);
    if constexpr (D == 128)
      wgmma_m64n128k16_rs<1>(acc, a[kk], desc, 1);
    else
      wgmma_m64n64k16_rs<1>(acc, a[kk], desc, 1);
  }
  wgmma_commit();
}

// ---------------------------------------------------------------------------
// K2: dq
// ---------------------------------------------------------------------------

// dS = P (dP - delta) of one K2 tile, in place in s, with P = exp2(S *
// scale * log2(e) - lse * log2(e)). Element i of this lane sits in row row0 +
// 8 * ((i >> 1) & 1) and column k0 + 8 * (i / 4) + col_lane + (i & 1).
// When asked, masked elements select P = 0 after the exponential.
__device__ __forceinline__ void dq_tile_ds(float (&s)[32], const float (&dp)[32],
                                           const float (&lse2)[2], const float (&dlt)[2],
                                           bool mask, int k0, int row0, int col_lane,
                                           int Sk, int causal, float scale_log2) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i >> 1) & 1;
    float p = exp2_approx(fmaf(s[i], scale_log2, -lse2[r]));
    if (mask) {
      const int col = k0 + (i / 4) * 8 + col_lane + (i & 1);
      if (col >= Sk || (causal && col > row0 + 8 * r)) p = 0.f;
    }
    s[i] = p * (dp[i] - dlt[r]);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, int H, int Sq, int Sk, float scale,
                    int causal) {
  using L = DqSmem<D>;
  constexpr int kColBlocks = D / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  uint64_t* full_q = reinterpret_cast<uint64_t*>(smem + L::kBars);  // Q and dO
  uint64_t* full_k = full_q + 1;
  uint64_t* full_v = full_k + kDqStages;
  uint64_t* empty_k = full_v + kDqStages;
  uint64_t* empty_v = empty_k + kDqStages;

  // CTA order: heads in groups of kHeadGroup; inside a group, Q tiles from
  // the last (heaviest under causal masking) to the first, the group's heads
  // side by side.
  const int n_m = (Sq + kDqRows - 1) / kDqRows;
  const int BH = gridDim.x / n_m;
  const int group = blockIdx.x / (kHeadGroup * n_m);
  const int in_group = blockIdx.x - group * kHeadGroup * n_m;
  const int g_heads = min(kHeadGroup, BH - group * kHeadGroup);
  const int bh = group * kHeadGroup + in_group % g_heads;
  const int b = bh / H;
  const int h = bh - b * H;
  const int m0 = (n_m - 1 - in_group / g_heads) * kDqRows;
  int n_tiles = (Sk + kDqKeys - 1) / kDqKeys;
  if (causal) n_tiles = min(n_tiles, (min(m0 + kDqRows, Sq) - 1) / kDqKeys + 1);

  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < kDqStages; ++s) {
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
      prefetch_tensor_map(&tdo);
      prefetch_tensor_map(&tk);
      prefetch_tensor_map(&tv);
      mbar_arrive_expect_tx(full_q, 2 * kDqRows * D * 2);
      for (int cb = 0; cb < kColBlocks; ++cb) {
        tma_load_4d(smem + L::kQ + cb * col_block(kDqRows), &tq, full_q, cb * 64, m0, h, b);
        tma_load_4d(smem + L::kDo + cb * col_block(kDqRows), &tdo, full_q, cb * 64, m0, h,
                    b);
      }
      for (int n = 0; n < n_tiles; ++n) {
        const int s = n % kDqStages;
        const uint32_t parity = ((n / kDqStages) & 1) ^ 1;
        uint8_t* k_s = smem + L::kK + s * L::kTileBytes;
        uint8_t* v_s = smem + L::kV + s * L::kTileBytes;
        mbar_wait(&empty_k[s], parity);
        mbar_arrive_expect_tx(&full_k[s], L::kTileBytes);
        for (int cb = 0; cb < kColBlocks; ++cb)
          tma_load_4d(k_s + cb * col_block(kDqKeys), &tk, &full_k[s], cb * 64,
                      n * kDqKeys, h, b);
        mbar_wait(&empty_v[s], parity);
        mbar_arrive_expect_tx(&full_v[s], L::kTileBytes);
        for (int cb = 0; cb < kColBlocks; ++cb)
          tma_load_4d(v_s + cb * col_block(kDqKeys), &tv, &full_v[s], cb * 64,
                      n * kDqKeys, h, b);
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
    const uint8_t* do_s = smem + L::kDo + wg * 64 * 128;
    const long long row_base = static_cast<long long>(bh) * Sq;
    float lse2[2], dlt[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      lse2[r] = row < Sq ? lse[row_base + row] * kLog2e : 0.f;
      dlt[r] = row < Sq ? delta[row_base + row] : 0.f;
    }

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float s[32], dp[32];  // S then dS, and dP, of the current tile
    uint32_t dsa[4][4];   // dS of the previous tile as bf16 A fragments
    auto masked = [&](int n) {
      const int k0 = n * kDqKeys;
      return k0 + kDqKeys > Sk || (causal && k0 + kDqKeys - 1 > m0 + wg * 64);
    };
    auto k_stage = [&](int n) { return smem + L::kK + (n % kDqStages) * L::kTileBytes; };
    auto v_stage = [&](int n) { return smem + L::kV + (n % kDqStages) * L::kTileBytes; };

    // The warpgroups take turns to issue their products (named barriers 1
    // and 2), warpgroup 0 first; warpgroup 1 does not pass its last turn on,
    // so every barrier sees as many arrivals as waits.
    auto take_turn = [&] { named_barrier_sync(1 + wg, kConsumers * 128); };
    auto pass_turn = [&](bool more) {
      if (more) named_barrier_arrive(2 - wg, kConsumers * 128);
    };
    if (wg == 1) pass_turn(true);

    // Tile n's S and dP are issued before tile n-1's dS K, and tile n's dS
    // is computed while that product runs. There is at least one tile: Sk >
    // 0 here, and every Q tile sees key 0.
    mbar_wait(full_q, 0);
    mbar_wait(&full_k[0], 0);
    mbar_wait(&full_v[0], 0);
    wgmma_fence();
    take_turn();
    issue_xyt<D>(s, q_s, k_stage(0));
    issue_xyt<D>(dp, do_s, v_stage(0));
    wgmma_commit();
    pass_turn(true);
    wgmma_wait<0>();
    fence_operands(s);
    fence_operands(dp);
    mbar_arrive(&empty_v[0]);
    dq_tile_ds(s, dp, lse2, dlt, masked(0), 0, row0, col_lane, Sk, causal, scale_log2);
    to_bf16_fragments(s, dsa);
    for (int n = 1; n < n_tiles; ++n) {
      const uint32_t parity = (n / kDqStages) & 1;
      mbar_wait(&full_k[n % kDqStages], parity);
      mbar_wait(&full_v[n % kDqStages], parity);
      fence_operands(s);
      fence_operands(dp);
      fence_operands(dsa);
      fence_operands(acc);
      wgmma_fence();
      take_turn();
      issue_xyt<D>(s, q_s, k_stage(n));
      issue_xyt<D>(dp, do_s, v_stage(n));
      wgmma_commit();
      issue_ay<D>(acc, dsa, k_stage(n - 1));
      pass_turn(true);
      wgmma_wait<1>();  // S and dP of tile n are ready; dS K of tile n-1 may still run
      fence_operands(s);
      fence_operands(dp);
      mbar_arrive(&empty_v[n % kDqStages]);
      dq_tile_ds(s, dp, lse2, dlt, masked(n), n * kDqKeys, row0, col_lane, Sk, causal,
                 scale_log2);
      wgmma_wait<0>();
      fence_operands(acc);
      fence_operands(dsa);
      mbar_arrive(&empty_k[(n - 1) % kDqStages]);
      to_bf16_fragments(s, dsa);
    }
    fence_operands(dsa);
    fence_operands(acc);
    wgmma_fence();
    take_turn();
    issue_ay<D>(acc, dsa, k_stage(n_tiles - 1));
    pass_turn(wg == 0);
    wgmma_wait<0>();
    fence_operands(acc);
    fence_operands(dsa);
    mbar_arrive(&empty_k[(n_tiles - 1) % kDqStages]);

    // epilogue: dq = scale * acc in bf16, straight from registers
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= Sq) continue;
      __nv_bfloat16* drow = dq + (row_base + row) * D + col_lane;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(drow + 8 * j) =
            pack_bf16(acc[4 * j + 2 * r] * scale, acc[4 * j + 2 * r + 1] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// K3: dk, dv
// ---------------------------------------------------------------------------

// P^T of one K3 tile in place in s: P = exp2(S * scale * log2(e) - lse *
// log2(e)), lse per column (query) from the stage. Element i of this lane
// sits in row (key) key0 + 8 * ((i >> 1) & 1) and column (query) q0 + 8 *
// (i / 4) + col_lane + (i & 1). When asked, masked elements select 0 after
// the exponential.
__device__ __forceinline__ void dkv_tile_p(float (&s)[32], const float* lse2_s, bool mask,
                                           int q0, int key0, int col_lane, int Sq, int Sk,
                                           int causal, float scale_log2) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 l = *reinterpret_cast<const float2*>(lse2_s + 8 * j + col_lane);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e;
      float p = exp2_approx(fmaf(s[i], scale_log2, -((e & 1) ? l.y : l.x)));
      if (mask) {
        const int query = q0 + 8 * j + col_lane + (e & 1);
        const int key = key0 + 8 * (e >> 1);
        if (key >= Sk || query >= Sq || (causal && key > query)) p = 0.f;
      }
      s[i] = p;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                     int H, int Sq, int Sk, float scale, int causal) {
  using L = DkvSmem<D>;
  constexpr int kColBlocks = D / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  uint64_t* full_kv = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full_q = full_kv + 1;  // Q and its lse / delta
  uint64_t* full_do = full_q + kDkvStages;
  uint64_t* empty_q = full_do + kDkvStages;
  uint64_t* empty_do = empty_q + kDkvStages;
  auto row_vals = [&](int t) {  // lse * log2(e), then delta, of stage t's rows
    return reinterpret_cast<float*>(smem + L::kRowVals) + (t % kDkvStages) * 2 * kDkvRows;
  };

  // CTA order: heads in groups of kHeadGroup; inside a group, key tiles from
  // the first (heaviest under causal masking) to the last.
  const int n_k = (Sk + kDkvKeys - 1) / kDkvKeys;
  const int BH = gridDim.x / n_k;
  const int group = blockIdx.x / (kHeadGroup * n_k);
  const int in_group = blockIdx.x - group * kHeadGroup * n_k;
  const int g_heads = min(kHeadGroup, BH - group * kHeadGroup);
  const int bh = group * kHeadGroup + in_group % g_heads;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = (in_group / g_heads) * kDkvKeys;
  // Q tiles t0 .. t0 + n_t - 1; earlier ones see none of these keys
  const int t0 = causal ? k0 / kDkvRows : 0;
  const int n_t = max(0, (Sq + kDkvRows - 1) / kDkvRows - t0);

  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(full_kv, 1);
    for (int s = 0; s < kDkvStages; ++s) {
      mbar_init(&full_q[s], 1 + 32);  // the TMA thread and the row-value warp
      mbar_init(&full_do[s], 1);
      mbar_init(&empty_q[s], kConsumers * 128);
      mbar_init(&empty_do[s], kConsumers * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= kConsumers * 4) {
    // ---- producer warpgroup: one thread issues every TMA load, one warp
    // copies lse and delta ----
    warpgroup_reg_dealloc<kProducerRegs>();
    if (warp == kConsumers * 4 && lane == 0 && n_t > 0) {
      prefetch_tensor_map(&tq);
      prefetch_tensor_map(&tdo);
      prefetch_tensor_map(&tk);
      prefetch_tensor_map(&tv);
      mbar_arrive_expect_tx(full_kv, 2 * L::kKVBytes);
      for (int cb = 0; cb < kColBlocks; ++cb) {
        tma_load_4d(smem + L::kK + cb * col_block(kDkvKeys), &tk, full_kv, cb * 64, k0, h,
                    b);
        tma_load_4d(smem + L::kV + cb * col_block(kDkvKeys), &tv, full_kv, cb * 64, k0, h,
                    b);
      }
      for (int t = 0; t < n_t; ++t) {
        const int s = t % kDkvStages;
        const uint32_t parity = ((t / kDkvStages) & 1) ^ 1;
        const int q0 = (t0 + t) * kDkvRows;
        uint8_t* q_s = smem + L::kQ + s * L::kTileBytes;
        uint8_t* do_s = smem + L::kDo + s * L::kTileBytes;
        mbar_wait(&empty_q[s], parity);
        mbar_arrive_expect_tx(&full_q[s], L::kTileBytes);
        for (int cb = 0; cb < kColBlocks; ++cb)
          tma_load_4d(q_s + cb * col_block(kDkvRows), &tq, &full_q[s], cb * 64, q0, h, b);
        mbar_wait(&empty_do[s], parity);
        mbar_arrive_expect_tx(&full_do[s], L::kTileBytes);
        for (int cb = 0; cb < kColBlocks; ++cb)
          tma_load_4d(do_s + cb * col_block(kDkvRows), &tdo, &full_do[s], cb * 64, q0, h,
                      b);
      }
    } else if (warp == kConsumers * 4 + 1) {
      const long long row_base = static_cast<long long>(bh) * Sq;
      for (int t = 0; t < n_t; ++t) {
        const int q0 = (t0 + t) * kDkvRows;
        float* vals = row_vals(t);
        mbar_wait(&empty_q[t % kDkvStages], ((t / kDkvStages) & 1) ^ 1);
        for (int j = lane; j < kDkvRows; j += 32) {
          const int row = q0 + j;
          vals[j] = row < Sq ? lse[row_base + row] * kLog2e : 0.f;
          vals[kDkvRows + j] = row < Sq ? delta[row_base + row] : 0.f;
        }
        mbar_arrive(&full_q[t % kDkvStages]);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 keys each ----
    warpgroup_reg_alloc<kConsumerRegs>();
    const int wg = warp / 4;
    const int kw0 = k0 + wg * 64;                       // this warpgroup's keys
    const int key0 = kw0 + (warp % 4) * 16 + lane / 4;  // and key0 + 8
    const int col_lane = 2 * (lane % 4);
    const float scale_log2 = scale * kLog2e;
    const uint8_t* k_s = smem + L::kK + wg * 64 * 128;
    const uint8_t* v_s = smem + L::kV + wg * 64 * 128;

    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    float s[32], dp[32];           // S^T then P^T, and dP^T then dS^T
    uint32_t pa[4][4], dsa[4][4];  // P^T and dS^T as bf16 A fragments

    if (n_t > 0) mbar_wait(full_kv, 0);
    for (int t = 0; t < n_t; ++t) {
      const int st = t % kDkvStages;
      const uint32_t parity = (t / kDkvStages) & 1;
      const int q0 = (t0 + t) * kDkvRows;
      const uint8_t* q_s = smem + L::kQ + st * L::kTileBytes;
      const uint8_t* do_s = smem + L::kDo + st * L::kTileBytes;
      mbar_wait(&full_q[st], parity);
      mbar_wait(&full_do[st], parity);
      // a Q tile wholly before these keys (or keys all past Sk) adds nothing
      if (kw0 < Sk && !(causal && kw0 > q0 + kDkvRows - 1)) {
        const bool mask = q0 + kDkvRows > Sq || kw0 + 64 > Sk ||
                          (causal && kw0 + 63 > q0);
        const float* vals = row_vals(t);
        fence_operands(s);
        fence_operands(dp);
        wgmma_fence();
        issue_xyt<D>(s, k_s, q_s);
        wgmma_commit();
        issue_xyt<D>(dp, v_s, do_s);
        wgmma_commit();
        wgmma_wait<1>();  // S^T is ready; dP^T may still run
        fence_operands(s);
        dkv_tile_p(s, vals, mask, q0, key0, col_lane, Sq, Sk, causal, scale_log2);
        wgmma_wait<0>();
        fence_operands(dp);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 d = *reinterpret_cast<const float2*>(vals + kDkvRows + 8 * j + col_lane);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - ((e & 1) ? d.y : d.x));
        }
        // packed only now, so that P^T is not held both as floats and as
        // fragments while dS^T is computed (registers)
        to_bf16_fragments(s, pa);
        to_bf16_fragments(dp, dsa);
        fence_operands(dk_acc);
        fence_operands(dv_acc);
        wgmma_fence();
        issue_ay<D>(dv_acc, pa, do_s);
        issue_ay<D>(dk_acc, dsa, q_s);
        wgmma_wait<1>();  // dV is done with dO; dK may still read Q
        fence_operands(dv_acc);
        fence_operands(pa);
        mbar_arrive(&empty_do[st]);
        wgmma_wait<0>();
        fence_operands(dk_acc);
        fence_operands(dsa);
        mbar_arrive(&empty_q[st]);
      } else {
        mbar_arrive(&empty_do[st]);
        mbar_arrive(&empty_q[st]);
      }
    }

    // epilogue: dk = scale * dk_acc and dv in bf16, straight from registers;
    // keys no query sees get zeros
    const long long key_base = static_cast<long long>(bh) * Sk;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key0 + 8 * r;
      if (key >= Sk) continue;
      __nv_bfloat16* dkrow = dk + (key_base + key) * D + col_lane;
      __nv_bfloat16* dvrow = dv + (key_base + key) * D + col_lane;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(dkrow + 8 * j) =
            pack_bf16(dk_acc[4 * j + 2 * r] * scale, dk_acc[4 * j + 2 * r + 1] * scale);
        *reinterpret_cast<uint32_t*>(dvrow + 8 * j) =
            pack_bf16(dv_acc[4 * j + 2 * r], dv_acc[4 * j + 2 * r + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

struct Maps {
  CUtensorMap q, k, v, o;
};

// Tensor maps of q, k, v, do over (D, S, H, B) with the caller's strides
// (s: q, k, v, do, each batch, head, sequence), boxes of 64 columns x
// q_rows (q, do) or k_rows (k, v) rows. False when cuTensorMapEncodeTiled
// refuses one.
bool make_maps(Maps& m, const void* q, const void* k, const void* v, const void* dout,
               int B, int H, int Sq, int Sk, int D, const long long (&s)[12], int q_rows,
               int k_rows) {
  const uint64_t qdims[4] = {static_cast<uint64_t>(D), static_cast<uint64_t>(Sq),
                             static_cast<uint64_t>(H), static_cast<uint64_t>(B)};
  const uint64_t kdims[4] = {static_cast<uint64_t>(D), static_cast<uint64_t>(Sk),
                             static_cast<uint64_t>(H), static_cast<uint64_t>(B)};
  // tensor-map strides of dims (S, H, B), innermost first
  const long long qs[3] = {s[2], s[1], s[0]};
  const long long ks[3] = {s[5], s[4], s[3]};
  const long long vs[3] = {s[8], s[7], s[6]};
  const long long os[3] = {s[11], s[10], s[9]};
  return make_tensor_map_4d_bf16(&m.q, q, qdims, qs, 64, q_rows) &&
         make_tensor_map_4d_bf16(&m.k, k, kdims, ks, 64, k_rows) &&
         make_tensor_map_4d_bf16(&m.v, v, kdims, vs, 64, k_rows) &&
         make_tensor_map_4d_bf16(&m.o, dout, qdims, os, 64, q_rows);
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, __nv_bfloat16* dq, int B, int H,
              int Sq, int Sk, const long long (&s)[12], float scale, int causal,
              cudaStream_t st) {
  Maps m;
  if (!make_maps(m, q, k, v, dout, B, H, Sq, Sk, D, s, kDqRows, kDqKeys))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, DqSmem<D>::kAlloc);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = B * H * ((Sq + kDqRows - 1) / kDqRows);
  flash_bwd_dq_kernel<D><<<grid, kThreads, DqSmem<D>::kAlloc, st>>>(
      m.q, m.k, m.v, m.o, lse, delta, dq, H, Sq, Sk, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, __nv_bfloat16* dk,
               __nv_bfloat16* dv, int B, int H, int Sq, int Sk, const long long (&s)[12],
               float scale, int causal, cudaStream_t st) {
  Maps m;
  if (!make_maps(m, q, k, v, dout, B, H, Sq, Sk, D, s, kDkvRows, kDkvKeys))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err =
      cudaFuncSetAttribute(flash_bwd_dkv_kernel<D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, DkvSmem<D>::kAlloc);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = B * H * ((Sk + kDkvKeys - 1) / kDkvKeys);
  flash_bwd_dkv_kernel<D><<<grid, kThreads, DkvSmem<D>::kAlloc, st>>>(
      m.q, m.k, m.v, m.o, lse, delta, dk, dv, H, Sq, Sk, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q/k/v/do: bf16 with the head dim contiguous and the given element strides
// over (batch, head, sequence), each a multiple of 8 (16 bytes, as TMA
// needs), 16-byte aligned bases; lse, delta: contiguous (B, H, Sq) f32; dq:
// contiguous (B, H, Sq, D) bf16. Returns cudaGetLastError() after the launch,
// or cudaErrorInvalidValue when D is not 64 or 128 or a tensor map is
// refused.
extern "C" int flash_bwd_dq_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int B, int H, int Sq,
    int Sk, int D, long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, long long o_sb, long long o_sh,
    long long o_ss, float scale, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D != 64 && D != 128) return static_cast<int>(cudaErrorInvalidValue);
  if (Sk == 0)  // no key: dq = 0
    return static_cast<int>(
        cudaMemsetAsync(dq, 0, static_cast<size_t>(B) * H * Sq * D * 2, st));
  const long long s[12] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                           v_sb, v_sh, v_ss, o_sb, o_sh, o_ss};
  const auto* lp = static_cast<const float*>(lse);
  const auto* dp = static_cast<const float*>(delta);
  auto* out = static_cast<__nv_bfloat16*>(dq);
  if (D == 128)
    return launch_dq<128>(q, k, v, dout, lp, dp, out, B, H, Sq, Sk, s, scale, causal, st);
  return launch_dq<64>(q, k, v, dout, lp, dp, out, B, H, Sq, Sk, s, scale, causal, st);
}

// As flash_bwd_dq_bf16; dk, dv: contiguous (B, H, Sk, D) bf16.
extern "C" int flash_bwd_dkv_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int H,
    int Sq, int Sk, int D, long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, long long o_sb, long long o_sh,
    long long o_ss, float scale, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D != 64 && D != 128) return static_cast<int>(cudaErrorInvalidValue);
  if (Sq == 0) {  // no query: dk = dv = 0
    const size_t bytes = static_cast<size_t>(B) * H * Sk * D * 2;
    cudaError_t err = cudaMemsetAsync(dk, 0, bytes, st);
    if (err == cudaSuccess) err = cudaMemsetAsync(dv, 0, bytes, st);
    return static_cast<int>(err);
  }
  const long long s[12] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                           v_sb, v_sh, v_ss, o_sb, o_sh, o_ss};
  const auto* lp = static_cast<const float*>(lse);
  const auto* dp = static_cast<const float*>(delta);
  auto* dkp = static_cast<__nv_bfloat16*>(dk);
  auto* dvp = static_cast<__nv_bfloat16*>(dv);
  if (D == 128)
    return launch_dkv<128>(q, k, v, dout, lp, dp, dkp, dvp, B, H, Sq, Sk, s, scale, causal,
                           st);
  return launch_dkv<64>(q, k, v, dout, lp, dp, dkp, dvp, B, H, Sq, Sk, s, scale, causal,
                        st);
}
