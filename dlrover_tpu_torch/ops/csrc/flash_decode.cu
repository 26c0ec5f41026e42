// Single-token (decode) GQA attention over a head-major KV cache, for
// Hopper (sm_90a). One template, two instantiations: a bf16 cache, and an
// int8 cache with one f32 scale per cached vector.
//
// Replaces: dlrover_tpu/ops/flash_attention.py `_decode_kernel` (:494),
// launched through pl.pallas_call in `flash_decode_attention` (:692). For
// each batch row b and KV head, the G query heads of the group attend the
// cache positions [0, pos[b]]:
//   s   = scale * q k^T               (int8: times ks[t], per key column)
//   p   = exp(s - m), masked past pos[b]
//   out = (p v) / sum(p)              (int8: p times vs[t] before the AV sum)
// The int8 blocks are never dequantized: the scales are folded into the
// score columns and into p exactly as the TPU kernel folds them (:538-557).
// Unlike the TPU kernel, `pos` is one value PER BATCH ROW, so a batch of
// serving slots at ragged positions takes one launch; a scalar broadcasts.
// The cache length T need not divide any block: the last tile is masked.
//
// What bounds it on this card: bytes. Each visible cached vector is read
// once (2*Dh bytes bf16, Dh + 4 bytes int8 with its scale) for 4*G*Dh
// FLOP, about G FLOP per byte, far under the H100's ~295 FLOP/byte ridge:
// HBM's 3.35 TB/s sets the floor. What the kernel must keep small is its
// own work per key in shared memory, or that, and not HBM, bounds it.
//
// Design (split-KV, as in FlashDecoding). The TPU kernel walks cache blocks
// on a sequential grid axis with the online-softmax state in VMEM scratch.
// Here the cache is cut into splits of kSplit = 256 keys (the TPU kernel's
// block_k) and the grid is (B * KV, ceil(T / kSplit)): it depends on T
// only, never on the values of pos, so nothing is read back to the host. A
// CTA whose split starts past min(pos[b], T - 1) exits at once, so ragged
// rows get CTAs in proportion to their positions and nothing past pos is
// read. A live CTA:
//   - holds its G query rows in registers as the B operand of mma.sync
//     (m16n8k16, bf16; rows past G are zero);
//   - walks its split's 64-key tiles with 2 (bf16) or 3 (int8) of them in
//     flight: the K and V rows (and the int8 scales) are copied with
//     cp.async into a ring of shared-memory stages, tile n + 1's copy
//     issued before tile n is scored (K rows padded by 16 bytes, so
//     ldmatrix hits distinct banks);
//   - scores a tile on the tensor cores, s = K q^T with warp w on keys
//     [16w, 16w + 16): ldmatrix feeds bf16 keys, int8 keys are widened to
//     bf16 pairs (exact), and the products are exact in the f32 sums, so
//     the scores are those of an f32 dot product up to summation order;
//   - takes the tile max and sum with one warp per query row (online
//     softmax in f32) and leaves p (times vs for int8) in shared memory;
//   - accumulates p v in f32 on CUDA cores, each thread on 4 bytes of a V
//     row (2 bf16 or 4 int8 columns) and the threads cut into key groups,
//     whose sums are added in a fixed order at the end of the split;
//   - writes its UNNORMALISED partial o (G x Dh) and its m, l (G each) in
//     f32 to a workspace the caller allocates.
// A second kernel, launched from the same entry point on the same stream,
// combines them: one CTA per (b, kv-head, g) reads the live splits 0 ..
// last / kSplit in that fixed order and writes
//   out = sum_s e^(m_s - M) o_s / sum_s e^(m_s - M) l_s,  M = max_s m_s
// in bf16 (l == 0 → 1). No atomics: the result is bitwise deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kTile = 64;      // keys per tile
constexpr int kSplit = 256;    // keys per split (one CTA), 4 tiles
// Tiles in flight per CTA: 2 for a bf16 cache (3 would leave room for two
// CTAs an SM, not three), 3 for int8 (half the bytes a stage).
template <typename Elem>
constexpr int stages() {
  return sizeof(Elem) == 1 ? 3 : 2;
}
constexpr int kThreads = 128;  // 4 warps
constexpr int kMaxG = 8;       // query heads per KV head the kernel takes
constexpr int kCombineThreads = 128;  // one per column, Dh <= 128
constexpr float kNegInf = -1e30f;

static_assert(kSplit % kTile == 0, "a split is whole tiles");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// d += a b on the tensor cores: a 16 x 16 (row-major), b 16 x 8, bf16 in,
// f32 sums. Fragments as in the PTX ISA's m16n8k16 layouts.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A fragment of 16 keys x 16 dims of a bf16 tile: ldmatrix, lane l giving
// row (l & 7) + 8 * ((l >> 3) & 1) at column 8 * (l >> 4)
__device__ __forceinline__ void a_fragment(uint32_t (&a)[4],
                                           const unsigned char* rows,
                                           int row_bytes, int lane,
                                           const __nv_bfloat16*) {
  const unsigned char* p =
      rows + ((lane & 7) + 8 * ((lane >> 3) & 1)) * row_bytes +
      (lane >> 4) * 16;
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(smem_u32(p)));
}

// the same from an int8 tile, each pair of int8 widened to bf16 (exact)
__device__ __forceinline__ void a_fragment(uint32_t (&a)[4],
                                           const unsigned char* rows,
                                           int row_bytes, int lane,
                                           const int8_t*) {
  const unsigned char* p = rows + (lane >> 2) * row_bytes + (lane & 3) * 2;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // a0: (row, col), a1: (row + 8, col), a2: (row, col + 8), a3: both
    const uint16_t raw = *reinterpret_cast<const uint16_t*>(
        p + (i & 1) * 8 * row_bytes + (i >> 1) * 8);
    const __nv_bfloat162 h = __floats2bfloat162_rn(
        static_cast<float>(static_cast<int8_t>(raw & 0xff)),
        static_cast<float>(static_cast<int8_t>(raw >> 8)));
    a[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
}

// 4 bytes of cache elements → floats (2 for bf16, 4 for int8)
__device__ __forceinline__ void word_to_float(uint32_t raw, float* out,
                                              const __nv_bfloat16*) {
  const float2 f =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw));
  out[0] = f.x;
  out[1] = f.y;
}

__device__ __forceinline__ void word_to_float(uint32_t raw, float* out,
                                              const int8_t*) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    out[i] = static_cast<float>(static_cast<int8_t>(raw >> (8 * i)));
}

template <typename Elem, bool kQuant, int D>
struct Layout {
  static constexpr int kStages = stages<Elem>();
  // K rows padded by 16 bytes (ldmatrix and the int8 fragment loads read
  // 8 rows at once); V rows are read whole by a warp, so need none
  static constexpr int kRowBytes = D * sizeof(Elem) + 16;
  static constexpr int kVRowBytes = D * sizeof(Elem);
  static constexpr int kKBytes = kTile * kRowBytes;
  static constexpr int kVBytes = kTile * kVRowBytes;
  static constexpr int kScaleBytes = kQuant ? kTile * 4 : 0;
  static constexpr int kStageBytes = kKBytes + kVBytes + 2 * kScaleBytes;
  static constexpr int kCols = 4 / sizeof(Elem);   // V columns per thread
  static constexpr int kColThreads = D / kCols;    // threads across a row
  static constexpr int kGroups = kThreads / kColThreads;  // key groups
  // the key groups' partial sums are added through the stages' memory
  static constexpr int kRedBytes = kGroups * kMaxG * D * 4;
  // stages, then p (kTile x kMaxG f32), then m, l, alpha
  static constexpr int kPOff = kStages * kStageBytes > kRedBytes
                                   ? kStages * kStageBytes
                                   : kRedBytes;
  static constexpr int kStatOff = kPOff + kTile * kMaxG * 4;
  static constexpr int kBytes = kStatOff + 3 * kMaxG * 4;
  static_assert(kThreads % kColThreads == 0, "whole key groups");
  static_assert(kStageBytes % 16 == 0 && kKBytes % 16 == 0 &&
                    kVBytes % 16 == 0,
                "alignment");
};

// One split of one (b, kv-head): partial o, m, l into the workspace.
template <typename Elem, bool kQuant, int D>
__global__ void __launch_bounds__(kThreads)
flash_decode_split_kernel(const __nv_bfloat16* __restrict__ q,
                          const Elem* __restrict__ k,
                          const Elem* __restrict__ v,
                          const float* __restrict__ ks,
                          const float* __restrict__ vs,
                          const int* __restrict__ pos,
                          float* __restrict__ o_ws, float* __restrict__ m_ws,
                          float* __restrict__ l_ws, int KV, int G, int T,
                          float scale) {
  using L = Layout<Elem, kQuant, D>;
  constexpr int kChunks = D * sizeof(Elem) / 16;  // 16-byte chunks per row
  constexpr int kSteps = D / 16;                   // mma k steps over Dh
  constexpr int kCols = L::kCols;
  constexpr int kStages = L::kStages;
  extern __shared__ __align__(16) unsigned char smem[];
  float* p_s = reinterpret_cast<float*>(smem + L::kPOff);  // [key][g]
  float* m_s = reinterpret_cast<float*>(smem + L::kStatOff);
  float* l_s = m_s + kMaxG;
  float* alpha_s = l_s + kMaxG;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const long long bkv = blockIdx.x;  // (b, kv-head) fused
  const int split = blockIdx.y;
  const int b = blockIdx.x / KV;
  const int last = min(pos[b], T - 1);  // keys [0, last] attend
  const int begin = split * kSplit;
  if (begin > last) return;  // a split wholly past pos: nothing to do
  const int end = min(begin + kSplit, last + 1);
  const int n_tiles = (end - begin + kTile - 1) / kTile;

  const unsigned char* kb =
      reinterpret_cast<const unsigned char*>(k + bkv * T * D);
  const unsigned char* vb =
      reinterpret_cast<const unsigned char*>(v + bkv * T * D);
  const float* ksb = kQuant ? ks + bkv * T : nullptr;
  const float* vsb = kQuant ? vs + bkv * T : nullptr;

  // copy tile i (its visible rows only) into its stage
  auto issue = [&](int i) {
    const int t0 = begin + i * kTile;
    const int n = min(kTile, end - t0);
    unsigned char* st = smem + (i % kStages) * L::kStageBytes;
    for (int idx = tid; idx < n * kChunks; idx += kThreads) {
      const int r = idx / kChunks;
      const int c = idx % kChunks;
      const long long off = (long long)(t0 + r) * D * sizeof(Elem) + c * 16;
      cp_async16(st + r * L::kRowBytes + c * 16, kb + off);
      cp_async16(st + L::kKBytes + r * L::kVRowBytes + c * 16, vb + off);
    }
    if (kQuant) {
      float* sc = reinterpret_cast<float*>(st + L::kKBytes + L::kVBytes);
      for (int r = tid; r < n; r += kThreads) {
        cp_async4(sc + r, ksb + t0 + r);
        cp_async4(sc + kTile + r, vsb + t0 + r);
      }
    }
  };

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_tiles) issue(i);
    cp_async_commit();
  }

  // q as the mma's B operand, held in registers for the whole split:
  // column n = lane / 4 is query row g (zero past G), rows are dims
  uint32_t qf[kSteps][2];
  {
    const int g = lane >> 2;
    const __nv_bfloat16* qr = q + (bkv * G + g) * D + (lane & 3) * 2;
#pragma unroll
    for (int t = 0; t < kSteps; ++t) {
      qf[t][0] = g < G ? *reinterpret_cast<const uint32_t*>(qr + t * 16) : 0u;
      qf[t][1] =
          g < G ? *reinterpret_cast<const uint32_t*>(qr + t * 16 + 8) : 0u;
    }
  }
  if (tid < kMaxG) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  // this thread's V columns [cg * kCols, +kCols) and key group kg
  const int cg = tid % L::kColThreads;
  const int kg = tid / L::kColThreads;
  float acc[kMaxG][kCols];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[g][c] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    // the stage tile i + kStages - 1 lands in was read in iteration i - 1,
    // which every thread has left (the barrier at the end of the loop)
    if (i + kStages - 1 < n_tiles) issue(i + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // tile i has landed (this thread's part)
    __syncthreads();               // ... and everyone's

    const int t0 = begin + i * kTile;
    const int n = min(kTile, end - t0);  // visible keys in this tile
    const unsigned char* k_t = smem + (i % kStages) * L::kStageBytes;
    const unsigned char* v_t = k_t + L::kKBytes;
    const float* ks_t = reinterpret_cast<const float*>(v_t + L::kVBytes);
    const float* vs_t = ks_t + kTile;

    // scores on the tensor cores: warp w takes keys [16w, 16w + 16) of the
    // tile as the rows of s = K q^T; bf16 products are exact in the f32
    // sums. Keys past n are left out of the softmax below.
    if (warp * 16 < n) {
      float sc[4] = {0.f, 0.f, 0.f, 0.f};
      const unsigned char* rows = k_t + warp * 16 * L::kRowBytes;
#pragma unroll
      for (int t = 0; t < kSteps; ++t) {
        uint32_t a[4];
        a_fragment(a, rows + t * 16 * sizeof(Elem), L::kRowBytes, lane,
                   static_cast<const Elem*>(nullptr));
        mma_16816(sc, a, qf[t]);
      }
      // sc[r]: key 16w + lane / 4 (+ 8 for r >= 2), row g = 2 (lane % 4)
      // (+ 1 for odd r)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int key = warp * 16 + (lane >> 2) + (r >> 1) * 8;
        const int g = (lane & 3) * 2 + (r & 1);
        if (g < G && key < n)
          p_s[key * kMaxG + g] = kQuant ? sc[r] * scale * ks_t[key]
                                        : sc[r] * scale;
      }
    }
    __syncthreads();

    // online softmax over the tile, one warp per query row
    for (int g = warp; g < G; g += kThreads / 32) {
      const float a = lane < n ? p_s[lane * kMaxG + g] : kNegInf;
      const float c = lane + 32 < n ? p_s[(lane + 32) * kMaxG + g] : kNegInf;
      float mx = fmaxf(a, c);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      const float pa = lane < n ? expf(a - m_new) : 0.f;
      const float pc = lane + 32 < n ? expf(c - m_new) : 0.f;
      // l sums p; the AV product takes p times the key's v scale
      p_s[lane * kMaxG + g] = kQuant && lane < n ? pa * vs_t[lane] : pa;
      p_s[(lane + 32) * kMaxG + g] =
          kQuant && lane + 32 < n ? pc * vs_t[lane + 32] : pc;
      float sum = pa + pc;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
        alpha_s[g] = alpha;
      }
    }
    __syncthreads();

    // acc += p v over this key group's keys kg, kg + kGroups, ...
    float alpha[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) alpha[g] = g < G ? alpha_s[g] : 0.f;
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[g][c] *= alpha[g];
    for (int jj = kg; jj < n; jj += L::kGroups) {
      const uint32_t raw = *reinterpret_cast<const uint32_t*>(
          v_t + jj * L::kVRowBytes + cg * 4);
      float vf[kCols];
      word_to_float(raw, vf, static_cast<const Elem*>(nullptr));
      const float4 p0 = *reinterpret_cast<const float4*>(p_s + jj * kMaxG);
      const float4 p1 =
          G > 4 ? *reinterpret_cast<const float4*>(p_s + jj * kMaxG + 4)
                : make_float4(0.f, 0.f, 0.f, 0.f);
      const float p[kMaxG] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G)
#pragma unroll
          for (int c = 0; c < kCols; ++c) acc[g][c] += p[g] * vf[c];
    }
    __syncthreads();  // the next issue overwrites this tile's stage
  }
  cp_async_wait<0>();  // no copy outstanding (the last groups are empty)

  // add the key groups' sums in a fixed order, through the stages' memory
  float* red = reinterpret_cast<float*>(smem);  // [kg][g][D]
#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
    if (g < G)
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        red[(kg * kMaxG + g) * D + cg * kCols + c] = acc[g][c];
  __syncthreads();
  const long long ws_row = bkv * gridDim.y + split;  // [b, kv, split]
  float* ob = o_ws + ws_row * G * D;
  for (int idx = tid; idx < G * D; idx += kThreads) {
    float o = 0.f;
#pragma unroll
    for (int gr = 0; gr < L::kGroups; ++gr) o += red[gr * kMaxG * D + idx];
    ob[idx] = o;
  }
  if (tid < G) {
    m_ws[ws_row * G + tid] = m_s[tid];
    l_ws[ws_row * G + tid] = l_s[tid];
  }
}

// One CTA per (b, kv-head, g), one thread per column d: the live splits'
// partials, in split order.
__global__ void __launch_bounds__(kCombineThreads)
flash_decode_combine_kernel(const float* __restrict__ o_ws,
                            const float* __restrict__ m_ws,
                            const float* __restrict__ l_ws,
                            const int* __restrict__ pos,
                            __nv_bfloat16* __restrict__ out, int KV, int G,
                            int T, int D, int n_split) {
  const long long row = blockIdx.x;  // (b, kv-head, g) fused
  const long long bkv = row / G;
  const int g = static_cast<int>(row % G);
  const int b = static_cast<int>(bkv / KV);
  const int d = threadIdx.x;
  // launched early (programmatic dependent launch): wait until the kernel
  // before it on the stream has finished and its writes are visible
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  if (d >= D) return;
  const int last = min(pos[b], T - 1);
  const int live = last < 0 ? 0 : last / kSplit + 1;
  const float* mb = m_ws + bkv * n_split * G + g;  // split s at s * G
  const float* lb = l_ws + bkv * n_split * G + g;
  const float* ob = o_ws + (bkv * n_split * G + g) * D + d;  // s at s * G * D
  float m = kNegInf;
  for (int s = 0; s < live; ++s) m = fmaxf(m, mb[s * G]);
  float o = 0.f, l = 0.f;
#pragma unroll 4
  for (int s = 0; s < live; ++s) {
    const float w = expf(mb[s * G] - m);
    l += w * lb[s * G];
    o += w * ob[(long long)s * G * D];
  }
  out[row * D + d] = __float2bfloat16(o / (l == 0.f ? 1.f : l));
}

template <typename Elem, bool kQuant, int D>
int launch_split(const void* q, const void* k, const void* v, const void* ks,
                 const void* vs, const void* pos, float* o_ws, float* m_ws,
                 float* l_ws, int B, int KV, int G, int T, int n_split,
                 float scale, cudaStream_t st) {
  using L = Layout<Elem, kQuant, D>;
  auto kernel = flash_decode_split_kernel<Elem, kQuant, D>;
  // the shared-memory limit stays set on the function in each device's
  // context: set it once a device (bit `dev`), not on every decode step
  static std::atomic<unsigned long long> set_on{0};
  int dev = 0;
  const cudaError_t got = cudaGetDevice(&dev);
  if (got != cudaSuccess) return static_cast<int>(got);
  const unsigned long long bit = dev < 64 ? 1ULL << dev : 0ULL;
  if (!(set_on.load(std::memory_order_acquire) & bit)) {
    const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    set_on.fetch_or(bit, std::memory_order_release);
  }
  const dim3 grid(B * KV, n_split);
  kernel<<<grid, kThreads, L::kBytes, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const Elem*>(k),
      static_cast<const Elem*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(pos), o_ws, m_ws,
      l_ws, KV, G, T, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename Elem, bool kQuant>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* pos, void* ws, void* out, int B,
           int KV, int G, int T, int D, float scale, void* stream) {
  if (G < 1 || G > kMaxG || B < 1 || KV < 1 || T < 0 ||
      (long long)B * KV * G > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_split = (T + kSplit - 1) / kSplit;
  if (n_split > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // workspace: o (B, KV, n_split, G, D), then m and l (B, KV, n_split, G)
  float* o_ws = static_cast<float*>(ws);
  float* m_ws = o_ws + (size_t)B * KV * n_split * G * D;
  float* l_ws = m_ws + (size_t)B * KV * n_split * G;
  if (n_split > 0) {
    int rc;
    if (D == 128) {
      rc = launch_split<Elem, kQuant, 128>(q, k, v, ks, vs, pos, o_ws, m_ws,
                                           l_ws, B, KV, G, T, n_split, scale,
                                           st);
    } else if (D == 64) {
      rc = launch_split<Elem, kQuant, 64>(q, k, v, ks, vs, pos, o_ws, m_ws,
                                          l_ws, B, KV, G, T, n_split, scale,
                                          st);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (rc != 0) return rc;
  } else if (D != 128 && D != 64) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the combine may be launched while the split kernel's last CTAs run; it
  // waits for them (griddepcontrol.wait) before it reads the workspace
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(B * KV * G);
  config.blockDim = dim3(kCombineThreads);
  config.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t rc = cudaLaunchKernelEx(
      &config, flash_decode_combine_kernel, static_cast<const float*>(o_ws),
      static_cast<const float*>(m_ws), static_cast<const float*>(l_ws),
      static_cast<const int*>(pos), static_cast<__nv_bfloat16*>(out), KV, G,
      T, D, n_split);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: contiguous (B, KV, G, D) bf16; k/v: contiguous (B, KV, T, D); pos:
// (B,) int32; ws: f32 workspace of B * KV * ceil(T / 256) * G * (D + 2)
// floats; out: contiguous (B, KV, G, D) bf16. Launches the split kernel
// and then the combine kernel on `stream`; returns cudaGetLastError()
// after the second launch (or the first failure).
extern "C" int flash_decode_bf16(const void* q, const void* k, const void* v,
                                 const void* pos, void* ws, void* out, int B,
                                 int KV, int G, int T, int D, float scale,
                                 void* stream) {
  return launch<__nv_bfloat16, false>(q, k, v, nullptr, nullptr, pos, ws, out,
                                      B, KV, G, T, D, scale, stream);
}

// As above with int8 k/v and their per-vector f32 scales ks/vs, contiguous
// (B, KV, T).
extern "C" int flash_decode_int8(const void* q, const void* k, const void* v,
                                 const void* ks, const void* vs,
                                 const void* pos, void* ws, void* out, int B,
                                 int KV, int G, int T, int D, float scale,
                                 void* stream) {
  return launch<int8_t, true>(q, k, v, ks, vs, pos, ws, out, B, KV, G, T, D,
                              scale, stream);
}
