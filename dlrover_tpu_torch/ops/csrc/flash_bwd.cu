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
// What bounds them on this card: K2 does 6*D FLOP per visible (query, key)
// pair (s, dp, dq) and K3 8*D (s, dp, dv, dk), against 2*D*2 bytes per row of
// each of q, k, v, do and the outputs. At training lengths (S = 2048) that is
// far above the ~295 FLOP/byte ridge: the tensor cores bound both.
//
// Design. The TPU kernels walk the reduction axis on a sequential grid axis
// and carry dq (K2) or dk/dv (K3) in VMEM scratch across grid steps. GPU
// blocks carry nothing over, so one block owns one output tile and loops over
// the reduction axis itself, with the sums in registers:
//   - K2: one block per (b, h, 64-row Q tile); 4 warps of 16 rows. The warp's
//     q and do rows live in registers as mma.sync A fragments; each 64-key
//     tile of K and V is staged row-major in shared memory. S = Q K^T and
//     dP = dO V^T come out in accumulator layout, which is the A-fragment
//     layout of dS K (dS rounded to bf16), as P feeds P V in flash_fwd.cu.
//     The B operand of dS K needs two keys of one column: read as a column
//     pair of the row-major K tile (rows padded so the pairs hit distinct
//     banks), no transposed copy.
//   - K3: one block per (b, h, 64-key tile); 4 warps of 16 keys. The block
//     computes S^T = K Q^T and dP^T = V dO^T with the keys as the M
//     dimension, so P^T and dS^T come out in accumulator layout and feed
//     dV += P^T dO and dK += dS^T Q as A fragments directly; lse and delta
//     become per-column values. K and V stay in shared memory (their A
//     fragments are reread there, so the dk/dv sums, 2*D/8*4 floats a
//     thread, fit in registers); each 64-row tile of Q and dO is staged
//     row-major beside them (70 KB at D=128: dynamic shared memory).
//   - Work is taken in chunks of 16 columns so that only 16 floats of S and
//     dP are live at once.
//   - Causal skips: K2 never loads K tiles wholly in the future of its Q
//     tile; K3 starts at the first Q tile that can see its keys.
// Simple first: one tile in flight, no cp.async/TMA pipelining, no wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;  // rows of the owned tile, and of each streamed tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two bf16 of one column of a row-major tile: p[0] in the low half, p[stride]
// in the high half (the B-fragment order of consecutive k).
__device__ __forceinline__ uint32_t ld_col2(const __nv_bfloat16* p, int stride) {
  __nv_bfloat162 v;
  v.x = p[0];
  v.y = p[stride];
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a * b for one 16x8x16 tile: a row-major 16x16, b column-major 16x8.
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage rows [row0, row0 + 64) of a (rows, D) bf16 matrix with the given row
// stride into shared memory, row stride D + 8; rows at or past `limit` are 0.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long row_stride, int row0,
                                          int limit, int tid) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  constexpr int kStride = D + 8;
  for (int idx = tid; idx < kTile * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < limit)
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * row_stride + c);
    *reinterpret_cast<uint4*>(&dst[r * kStride + c]) = val;
  }
}

// K2: dq for one (b, h, 64-row Q tile).
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, int H, int Sq, int Sk,
                    long long q_sb, long long q_sh, long long q_ss,
                    long long k_sb, long long k_sh, long long k_ss,
                    long long v_sb, long long v_sh, long long v_ss,
                    long long o_sb, long long o_sh, long long o_ss,
                    float scale, int causal) {
  constexpr int kStride = D + 8;
  __shared__ __align__(16) __nv_bfloat16 k_s[kTile * kStride];
  __shared__ __align__(16) __nv_bfloat16 v_s[kTile * kStride];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment row within the warp's 16
  const int t4 = lane & 3;  // fragment column pair
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kTile;
  const long long bh = (long long)b * H + h;

  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + h * v_sh;
  const __nv_bfloat16* ob = dout + b * o_sb + h * o_sh;
  const int row0 = q0 + warp * 16 + g;  // this lane's rows: row0, row0 + 8
  const int row1 = row0 + 8;

  uint32_t qa[D / 16][4], da[D / 16][4];
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    const int c = kc * 16 + 2 * t4;
    qa[kc][0] = row0 < Sq ? ld32(qb + row0 * q_ss + c) : 0u;
    qa[kc][1] = row1 < Sq ? ld32(qb + row1 * q_ss + c) : 0u;
    qa[kc][2] = row0 < Sq ? ld32(qb + row0 * q_ss + c + 8) : 0u;
    qa[kc][3] = row1 < Sq ? ld32(qb + row1 * q_ss + c + 8) : 0u;
    da[kc][0] = row0 < Sq ? ld32(ob + row0 * o_ss + c) : 0u;
    da[kc][1] = row1 < Sq ? ld32(ob + row1 * o_ss + c) : 0u;
    da[kc][2] = row0 < Sq ? ld32(ob + row0 * o_ss + c + 8) : 0u;
    da[kc][3] = row1 < Sq ? ld32(ob + row1 * o_ss + c + 8) : 0u;
  }
  float lse_r[2], delta_r[2];
  lse_r[0] = row0 < Sq ? lse[bh * Sq + row0] : 0.f;
  lse_r[1] = row1 < Sq ? lse[bh * Sq + row1] : 0.f;
  delta_r[0] = row0 < Sq ? delta[bh * Sq + row0] : 0.f;
  delta_r[1] = row1 < Sq ? delta[bh * Sq + row1] : 0.f;

  float acc[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
    acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;

  int n_tiles = (Sk + kTile - 1) / kTile;
  if (causal) n_tiles = min(n_tiles, (q0 + kTile - 1) / kTile + 1);

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kTile;
    __syncthreads();  // every warp is done with the previous tile
    load_tile<D>(k_s, kb, k_ss, k0, Sk, tid);
    load_tile<D>(v_s, vb, v_ss, k0, Sk, tid);
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {  // 16 keys at a time
      float s[2][4], dp[2][4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = 2 * kk + jj;  // 8-key column tile
        s[jj][0] = s[jj][1] = s[jj][2] = s[jj][3] = 0.f;
        dp[jj][0] = dp[jj][1] = dp[jj][2] = dp[jj][3] = 0.f;
#pragma unroll
        for (int kc = 0; kc < D / 16; ++kc) {
          const int off = (j * 8 + g) * kStride + kc * 16 + 2 * t4;
          mma16816(s[jj], qa[kc], ld32(&k_s[off]), ld32(&k_s[off + 8]));
          mma16816(dp[jj], da[kc], ld32(&v_s[off]), ld32(&v_s[off + 8]));
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + j * 8 + 2 * t4 + (e & 1);
          const int r = e >> 1;
          const int row = r ? row1 : row0;
          const bool ok = col < Sk && (!causal || col <= row);
          const float p = ok ? expf(s[jj][e] * scale - lse_r[r]) : 0.f;
          s[jj][e] = p * (dp[jj][e] - delta_r[r]);  // ds
        }
      }
      // dS (16 rows x 16 keys) in accumulator layout = its A fragment
      const uint32_t a[4] = {pack_bf16(s[0][0], s[0][1]),
                             pack_bf16(s[0][2], s[0][3]),
                             pack_bf16(s[1][0], s[1][1]),
                             pack_bf16(s[1][2], s[1][3])};
      // dq += dS K: B[key][d] is a column pair of the row-major K tile
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        const __nv_bfloat16* kp = &k_s[(kk * 16 + 2 * t4) * kStride + nd * 8 + g];
        mma16816(acc[nd], a, ld_col2(kp, kStride),
                 ld_col2(kp + 8 * kStride, kStride));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? row1 : row0;
    if (row >= Sq) continue;
    __nv_bfloat16* drow = dq + (bh * Sq + row) * D;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      *reinterpret_cast<uint32_t*>(drow + nd * 8 + 2 * t4) =
          pack_bf16(acc[nd][2 * r] * scale, acc[nd][2 * r + 1] * scale);
    }
  }
}

template <int D>
constexpr int dkv_smem_bytes() {
  return 4 * kTile * (D + 8) * 2 + 2 * kTile * 4;
}

// K3: dk and dv for one (b, h, 64-key tile).
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int H, int Sq, int Sk,
                     long long q_sb, long long q_sh, long long q_ss,
                     long long k_sb, long long k_sh, long long k_ss,
                     long long v_sb, long long v_sh, long long v_ss,
                     long long o_sb, long long o_sh, long long o_ss,
                     float scale, int causal) {
  constexpr int kStride = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* v_s = k_s + kTile * kStride;
  __nv_bfloat16* q_s = v_s + kTile * kStride;
  __nv_bfloat16* o_s = q_s + kTile * kStride;  // the do tile
  float* lse_s = reinterpret_cast<float*>(o_s + kTile * kStride);
  float* delta_s = lse_s + kTile;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int k0 = blockIdx.x * kTile;
  const long long bh = (long long)b * H + h;

  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + h * v_sh;
  const __nv_bfloat16* ob = dout + b * o_sb + h * o_sh;
  const int wrow = warp * 16 + g;  // this lane's keys: k0 + wrow, + 8
  const int key0 = k0 + wrow;
  const int key1 = key0 + 8;

  load_tile<D>(k_s, kb, k_ss, k0, Sk, tid);
  load_tile<D>(v_s, vb, v_ss, k0, Sk, tid);

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    dk_acc[nd][0] = dk_acc[nd][1] = dk_acc[nd][2] = dk_acc[nd][3] = 0.f;
    dv_acc[nd][0] = dv_acc[nd][1] = dv_acc[nd][2] = dv_acc[nd][3] = 0.f;
  }

  const int n_q = (Sq + kTile - 1) / kTile;
  const int it0 = causal ? k0 / kTile : 0;  // earlier Q tiles see no key here

  for (int it = it0; it < n_q; ++it) {
    const int q0 = it * kTile;
    __syncthreads();  // every warp is done with the previous Q tile
    load_tile<D>(q_s, qb, q_ss, q0, Sq, tid);
    load_tile<D>(o_s, ob, o_ss, q0, Sq, tid);
    if (tid < kTile) {
      const int r = q0 + tid;
      lse_s[tid] = r < Sq ? lse[bh * Sq + r] : 0.f;
      delta_s[tid] = r < Sq ? delta[bh * Sq + r] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {  // 16 queries at a time
      float s[2][4], ds[2][4];  // S^T and dP^T: 16 keys x 16 queries
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        s[jj][0] = s[jj][1] = s[jj][2] = s[jj][3] = 0.f;
        ds[jj][0] = ds[jj][1] = ds[jj][2] = ds[jj][3] = 0.f;
      }
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        const int aoff = wrow * kStride + kc * 16 + 2 * t4;
        const uint32_t ka[4] = {ld32(&k_s[aoff]), ld32(&k_s[aoff + 8 * kStride]),
                                ld32(&k_s[aoff + 8]),
                                ld32(&k_s[aoff + 8 * kStride + 8])};
        const uint32_t va[4] = {ld32(&v_s[aoff]), ld32(&v_s[aoff + 8 * kStride]),
                                ld32(&v_s[aoff + 8]),
                                ld32(&v_s[aoff + 8 * kStride + 8])};
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int boff = ((2 * kk + jj) * 8 + g) * kStride + kc * 16 + 2 * t4;
          mma16816(s[jj], ka, ld32(&q_s[boff]), ld32(&q_s[boff + 8]));
          mma16816(ds[jj], va, ld32(&o_s[boff]), ld32(&o_s[boff + 8]));
        }
      }
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = (2 * kk + jj) * 8 + 2 * t4 + (e & 1);  // in tile
          const int qrow = q0 + col;
          const int key = (e < 2) ? key0 : key1;
          const bool ok = key < Sk && qrow < Sq && (!causal || key <= qrow);
          const float p = ok ? expf(s[jj][e] * scale - lse_s[col]) : 0.f;
          s[jj][e] = p;
          ds[jj][e] = p * (ds[jj][e] - delta_s[col]);
        }
      }
      // P^T and dS^T in accumulator layout = their A fragments
      const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]),
                              pack_bf16(s[0][2], s[0][3]),
                              pack_bf16(s[1][0], s[1][1]),
                              pack_bf16(s[1][2], s[1][3])};
      const uint32_t dsa[4] = {pack_bf16(ds[0][0], ds[0][1]),
                               pack_bf16(ds[0][2], ds[0][3]),
                               pack_bf16(ds[1][0], ds[1][1]),
                               pack_bf16(ds[1][2], ds[1][3])};
      // dv += P^T dO, dk += dS^T Q: B[query][d] is a column pair of the
      // row-major dO / Q tile
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        const int off = (kk * 16 + 2 * t4) * kStride + nd * 8 + g;
        mma16816(dv_acc[nd], pa, ld_col2(&o_s[off], kStride),
                 ld_col2(&o_s[off + 8 * kStride], kStride));
        mma16816(dk_acc[nd], dsa, ld_col2(&q_s[off], kStride),
                 ld_col2(&q_s[off + 8 * kStride], kStride));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = r ? key1 : key0;
    if (key >= Sk) continue;
    __nv_bfloat16* dkrow = dk + (bh * Sk + key) * D;
    __nv_bfloat16* dvrow = dv + (bh * Sk + key) * D;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      *reinterpret_cast<uint32_t*>(dkrow + nd * 8 + 2 * t4) =
          pack_bf16(dk_acc[nd][2 * r] * scale, dk_acc[nd][2 * r + 1] * scale);
      *reinterpret_cast<uint32_t*>(dvrow + nd * 8 + 2 * t4) =
          pack_bf16(dv_acc[nd][2 * r], dv_acc[nd][2 * r + 1]);
    }
  }
}

template <int D>
int launch_dkv(const dim3& grid, cudaStream_t st, const __nv_bfloat16* q,
               const __nv_bfloat16* k, const __nv_bfloat16* v,
               const __nv_bfloat16* dout, const float* lse,
               const float* delta, __nv_bfloat16* dk, __nv_bfloat16* dv,
               int H, int Sq, int Sk, const long long* s, float scale,
               int causal) {
  constexpr int bytes = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkv_kernel<D><<<grid, kThreads, bytes, st>>>(
      q, k, v, dout, lse, delta, dk, dv, H, Sq, Sk, s[0], s[1], s[2], s[3],
      s[4], s[5], s[6], s[7], s[8], s[9], s[10], s[11], scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q/k/v/do: bf16 with the head dim contiguous and the given element strides
// over (batch, head, sequence); lse, delta: contiguous (B, H, Sq) f32; dq:
// contiguous (B, H, Sq, D) bf16. Returns cudaGetLastError() after the launch.
extern "C" int flash_bwd_dq_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int B, int H, int Sq,
    int Sk, int D, long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, long long o_sb, long long o_sh,
    long long o_ss, float scale, int causal, void* stream) {
  const dim3 grid((Sq + kTile - 1) / kTile, H, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const auto* op = static_cast<const __nv_bfloat16*>(dout);
  const auto* lp = static_cast<const float*>(lse);
  const auto* dp = static_cast<const float*>(delta);
  auto* out = static_cast<__nv_bfloat16*>(dq);
  if (D == 128) {
    flash_bwd_dq_kernel<128><<<grid, kThreads, 0, st>>>(
        qp, kp, vp, op, lp, dp, out, H, Sq, Sk, q_sb, q_sh, q_ss, k_sb, k_sh,
        k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss, scale, causal);
  } else if (D == 64) {
    flash_bwd_dq_kernel<64><<<grid, kThreads, 0, st>>>(
        qp, kp, vp, op, lp, dp, out, H, Sq, Sk, q_sb, q_sh, q_ss, k_sb, k_sh,
        k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss, scale, causal);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// As flash_bwd_dq_bf16; dk, dv: contiguous (B, H, Sk, D) bf16.
extern "C" int flash_bwd_dkv_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int H,
    int Sq, int Sk, int D, long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, long long o_sb, long long o_sh,
    long long o_ss, float scale, int causal, void* stream) {
  const dim3 grid((Sk + kTile - 1) / kTile, H, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long s[12] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                           v_sb, v_sh, v_ss, o_sb, o_sh, o_ss};
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const auto* op = static_cast<const __nv_bfloat16*>(dout);
  const auto* lp = static_cast<const float*>(lse);
  const auto* dp = static_cast<const float*>(delta);
  auto* dkp = static_cast<__nv_bfloat16*>(dk);
  auto* dvp = static_cast<__nv_bfloat16*>(dv);
  if (D == 128)
    return launch_dkv<128>(grid, st, qp, kp, vp, op, lp, dp, dkp, dvp, H, Sq,
                           Sk, s, scale, causal);
  if (D == 64)
    return launch_dkv<64>(grid, st, qp, kp, vp, op, lp, dp, dkp, dvp, H, Sq,
                          Sk, s, scale, causal);
  return static_cast<int>(cudaErrorInvalidValue);
}
