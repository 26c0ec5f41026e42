// Flash-attention forward for Hopper (sm_90a), bf16 in, f32 accumulate.
//
// Replaces: dlrover_tpu/ops/flash_attention.py `_fwd_kernel` (:98), the
// TPU kernel that `_fwd` launches through pl.pallas_call (:181) for the
// public `flash_attention` (:457). It computes what that kernel computes:
//   o   = softmax(scale * q k^T + mask) v      (B, H, Sq, D), q's dtype
//   lse = m + log(l) per query row             (B, H, Sq), f32
// with the mask `col < Sk` and, when causal, `col <= row` (top-left
// alignment: row is the absolute query index, so Sq != Sk keeps the TPU
// kernel's meaning, not FlashAttention-2's bottom-right one). Masked scores
// are -1e30, never -inf; a row with no visible key gives o = 0 and
// lse = -1e30.
//
// What bounds it on this card: the two products are 4*D FLOP per visible
// (query, key) pair, against 2*D*2 bytes of q and o and 2*D*2 bytes of k and
// v per row; at the serving prefill's lengths (S >= 1024) that is far above
// the H100's ~295 FLOP/byte ridge, so the tensor cores (989 TFLOP/s bf16)
// bound it, not the 3.35 TB/s of HBM.
//
// Design. The TPU kernel walks K blocks on a sequential grid axis and carries
// the online-softmax state (m, l, acc) in VMEM scratch from one grid step to
// the next. GPU blocks run in parallel and carry nothing over, so here one
// block owns one (b, h, 64-row Q tile) and loops over the K tiles itself,
// with the state in registers:
//   - 4 warps, 16 query rows each. A warp's Q rows are loaded once into
//     mma.sync A fragments (registers) and reused for every K tile.
//   - Each 64-key tile of K is staged row-major and V transposed in shared
//     memory (rows padded by 16 bytes so the fragment reads hit distinct
//     banks). S = Q K^T and O += P V are mma.sync.m16n8k16 bf16 products
//     with f32 accumulators; P goes from the S accumulators straight into
//     the A fragments of the PV product (rounded to bf16), never through
//     shared memory.
//   - Row max and row sum live with the 4 lanes that share a row (quad
//     shuffles); the running sum stays per lane and is reduced once at the
//     end, since every lane of a row scales it by the same factor.
//   - Under causal masking, K tiles wholly in the future of the Q tile are
//     never loaded (the TPU kernel's `pl.when` skip).
// Simple first: one tile in flight, no cp.async/TMA pipelining, no wgmma or
// warp specialisation. Those are later work; see PERF.md for its times.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 64;  // query rows per block (16 per warp)
constexpr int kBlockN = 64;  // keys per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
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

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int H, int Sq, int Sk,
                 long long q_sb, long long q_sh, long long q_ss,
                 long long k_sb, long long k_sh, long long k_ss,
                 long long v_sb, long long v_sh, long long v_ss,
                 float scale, int causal) {
  constexpr int kKStride = D + 8;        // K tile row stride (elements)
  constexpr int kVStride = kBlockN + 8;  // transposed V tile row stride
  constexpr int kChunks = D / 8;         // 16-byte chunks per K/V row
  __shared__ __align__(16) __nv_bfloat16 k_s[kBlockN * kKStride];
  __shared__ __align__(16) __nv_bfloat16 vt_s[D * kVStride];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;   // fragment row within the warp's 16
  const int t4 = lane & 3;   // fragment column pair
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kBlockM;

  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + h * v_sh;
  const int row0 = q0 + warp * 16 + g;  // this lane's rows: row0, row0 + 8
  const int row1 = row0 + 8;

  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    const int c = kc * 16 + 2 * t4;
    qa[kc][0] = row0 < Sq ? ld32(qb + row0 * q_ss + c) : 0u;
    qa[kc][1] = row1 < Sq ? ld32(qb + row1 * q_ss + c) : 0u;
    qa[kc][2] = row0 < Sq ? ld32(qb + row0 * q_ss + c + 8) : 0u;
    qa[kc][3] = row1 < Sq ? ld32(qb + row1 * q_ss + c + 8) : 0u;
  }

  float m_i[2] = {kNegInf, kNegInf};
  float l_i[2] = {0.f, 0.f};  // this lane's share of the row sums
  float acc[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
    acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;

  int n_tiles = (Sk + kBlockN - 1) / kBlockN;
  if (causal) n_tiles = min(n_tiles, (q0 + kBlockM - 1) / kBlockN + 1);

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kBlockN;
    __syncthreads();  // every warp is done with the previous tile
    for (int idx = tid; idx < kBlockN * kChunks; idx += kThreads) {
      const int r = idx / kChunks;
      const int c = (idx % kChunks) * 8;
      uint4 kv4 = make_uint4(0u, 0u, 0u, 0u);
      uint4 vv4 = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < Sk) {
        kv4 = *reinterpret_cast<const uint4*>(kb + (k0 + r) * k_ss + c);
        vv4 = *reinterpret_cast<const uint4*>(vb + (k0 + r) * v_ss + c);
      }
      *reinterpret_cast<uint4*>(&k_s[r * kKStride + c]) = kv4;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv4);
#pragma unroll
      for (int e = 0; e < 8; ++e) vt_s[(c + e) * kVStride + r] = ve[e];
    }
    __syncthreads();

    // S = Q K^T: this warp's 16 rows x 64 keys, 8 column tiles of 8 keys
    float s[kBlockN / 8][4];
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        const __nv_bfloat16* kp = &k_s[(j * 8 + g) * kKStride + kc * 16 + 2 * t4];
        mma16816(s[j], qa[kc], ld32(kp), ld32(kp + 8));
      }
    }

    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + 2 * t4 + (e & 1);
        const int row = (e < 2) ? row0 : row1;
        const bool ok = col < Sk && (!causal || col <= row);
        s[j][e] = ok ? s[j][e] * scale : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_i[r], mx[r]);
      alpha[r] = expf(m_i[r] - m_new);
      m_i[r] = m_new;
      l_i[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + 2 * t4 + (e & 1);
        const int row = (e < 2) ? row0 : row1;
        const bool ok = col < Sk && (!causal || col <= row);
        const float p = ok ? expf(s[j][e] - m_i[e >> 1]) : 0.f;
        s[j][e] = p;
        l_i[e >> 1] += p;
      }
    }
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      acc[nd][0] *= alpha[0];
      acc[nd][1] *= alpha[0];
      acc[nd][2] *= alpha[1];
      acc[nd][3] *= alpha[1];
    }

    // O += P V: P's accumulator layout is the A-fragment layout of the
    // next product, 16 keys (two S column tiles) per k step
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        const __nv_bfloat16* vp = &vt_s[(nd * 8 + g) * kVStride + kk * 16 + 2 * t4];
        mma16816(acc[nd], pa, ld32(vp), ld32(vp + 8));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 1);
    l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 2);
  }
  const long long bh = (long long)b * H + h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? row1 : row0;
    if (row >= Sq) continue;
    const float l = l_i[r];
    const float safe = (l == 0.f) ? 1.f : l;
    const float inv = 1.f / safe;
    __nv_bfloat16* orow = o + (bh * Sq + row) * D;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      *reinterpret_cast<uint32_t*>(orow + nd * 8 + 2 * t4) =
          pack_bf16(acc[nd][2 * r] * inv, acc[nd][2 * r + 1] * inv);
    }
    if (t4 == 0) lse[bh * Sq + row] = (l == 0.f) ? kNegInf : m_i[r] + logf(safe);
  }
}

}  // namespace

// q/k/v: bf16 with the head dim contiguous and the given element strides
// over (batch, head, sequence); o: contiguous (B, H, Sq, D) bf16; lse:
// contiguous (B, H, Sq) f32. Returns cudaGetLastError() after the launch.
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              void* o, void* lse, int B, int H, int Sq, int Sk,
                              int D, long long q_sb, long long q_sh,
                              long long q_ss, long long k_sb, long long k_sh,
                              long long k_ss, long long v_sb, long long v_sh,
                              long long v_ss, float scale, int causal,
                              void* stream) {
  const dim3 grid((Sq + kBlockM - 1) / kBlockM, H, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* op = static_cast<__nv_bfloat16*>(o);
  auto* lp = static_cast<float*>(lse);
  if (D == 128) {
    flash_fwd_kernel<128><<<grid, kThreads, 0, st>>>(
        qp, kp, vp, op, lp, H, Sq, Sk, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
        v_sb, v_sh, v_ss, scale, causal);
  } else if (D == 64) {
    flash_fwd_kernel<64><<<grid, kThreads, 0, st>>>(
        qp, kp, vp, op, lp, H, Sq, Sk, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
        v_sb, v_sh, v_ss, scale, causal);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
