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
// HBM's 3.35 TB/s sets the floor.
//
// Design. The TPU kernel walks cache blocks on a sequential grid axis with
// the online-softmax state in VMEM scratch, and skips blocks past pos via a
// clamped index map. Here one block owns one (b, kv-head): it loads its G
// query rows once (f32, shared memory), then loops over 64-key tiles only
// up to pos[b], so nothing past pos is read at all. Per tile:
//   - the K and V rows are copied to shared memory in 16-byte loads
//     (rows padded by 16 bytes, so the per-key 16-byte reads below hit
//     distinct banks);
//   - 128 threads score the tile: thread t takes key t % 64 and half of
//     the G query rows;
//   - one warp per query row takes the tile max and sum (online softmax);
//   - thread d accumulates column d of the G outputs over the tile's keys.
// At batch 8 with 8 KV heads that is 64 blocks, under half of the 132 SMs,
// and each block streams its head's cache alone with one tile in flight.
// Splitting T across blocks with a combine pass (split-K), and keeping
// several tiles in flight, are left to a later performance change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;      // keys per tile
constexpr int kThreads = 128;  // 4 warps
constexpr int kMaxG = 8;       // query heads per KV head the kernel takes
constexpr float kNegInf = -1e30f;

// 16 bytes of cache elements → floats (8 for bf16, 16 for int8)
__device__ __forceinline__ void to_float(const uint4& raw, float* out,
                                         const __nv_bfloat16*) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void to_float(const uint4& raw, float* out,
                                         const int8_t*) {
  const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 16; ++i) out[i] = static_cast<float>(e[i]);
}

__device__ __forceinline__ float elem_to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float elem_to_float(int8_t x) {
  return static_cast<float>(x);
}

template <typename Elem, bool kQuant, int D>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const Elem* __restrict__ k, const Elem* __restrict__ v,
                    const float* __restrict__ ks, const float* __restrict__ vs,
                    const int* __restrict__ pos,
                    __nv_bfloat16* __restrict__ out, int KV, int G, int T,
                    float scale) {
  constexpr int kPerChunk = 16 / sizeof(Elem);       // elements per 16 bytes
  constexpr int kChunks = D / kPerChunk;             // 16-byte chunks per row
  constexpr int kRowBytes = D * sizeof(Elem) + 16;   // padded tile row
  __shared__ __align__(16) unsigned char k_s[kTile * kRowBytes];
  __shared__ __align__(16) unsigned char v_s[kTile * kRowBytes];
  __shared__ __align__(16) float q_s[kMaxG * D];
  __shared__ float p_s[kMaxG * kTile];
  __shared__ float ks_s[kTile];
  __shared__ float vs_s[kTile];
  __shared__ float m_s[kMaxG];
  __shared__ float l_s[kMaxG];
  __shared__ float alpha_s[kMaxG];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int b = blockIdx.x / KV;
  const long long bkv = blockIdx.x;  // (b, kv-head) fused
  const int last = min(pos[b], T - 1);  // keys [0, last] attend

  const __nv_bfloat16* qb = q + bkv * G * D;
  for (int i = tid; i < G * D; i += kThreads) q_s[i] = __bfloat162float(qb[i]);
  if (tid < kMaxG) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  const Elem* kb = k + bkv * T * D;
  const Elem* vb = v + bkv * T * D;
  float acc[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) acc[g] = 0.f;
  __syncthreads();

  const int j = tid % kTile;   // this thread's key within a tile
  const int gh = tid / kTile;  // and its query rows: gh, gh + 2, ...
  for (int t0 = 0; t0 <= last; t0 += kTile) {
    const int n = min(kTile, last - t0 + 1);  // visible keys in this tile
    for (int idx = tid; idx < n * kChunks; idx += kThreads) {
      const int r = idx / kChunks;
      const int c = idx % kChunks;
      const long long off = (long long)(t0 + r) * D * sizeof(Elem) + c * 16;
      *reinterpret_cast<uint4*>(k_s + r * kRowBytes + c * 16) =
          *reinterpret_cast<const uint4*>(
              reinterpret_cast<const unsigned char*>(kb) + off);
      *reinterpret_cast<uint4*>(v_s + r * kRowBytes + c * 16) =
          *reinterpret_cast<const uint4*>(
              reinterpret_cast<const unsigned char*>(vb) + off);
    }
    if (kQuant) {
      for (int i = tid; i < n; i += kThreads) {
        ks_s[i] = ks[bkv * T + t0 + i];
        vs_s[i] = vs[bkv * T + t0 + i];
      }
    }
    __syncthreads();

    // scores: key j against query rows gh, gh + 2, gh + 4, gh + 6
    float sc[kMaxG / 2];
#pragma unroll
    for (int gi = 0; gi < kMaxG / 2; ++gi) sc[gi] = 0.f;
    if (j < n) {
#pragma unroll 4
      for (int c = 0; c < kChunks; ++c) {
        const uint4 raw =
            *reinterpret_cast<const uint4*>(k_s + j * kRowBytes + c * 16);
        float kf[kPerChunk];
        to_float(raw, kf, static_cast<const Elem*>(nullptr));
#pragma unroll
        for (int gi = 0; gi < kMaxG / 2; ++gi) {
          const int g = gh + 2 * gi;
          if (g < G) {
            const float* qr = q_s + g * D + c * kPerChunk;
#pragma unroll
            for (int e = 0; e < kPerChunk; e += 4) {
              const float4 qv = *reinterpret_cast<const float4*>(qr + e);
              sc[gi] += qv.x * kf[e] + qv.y * kf[e + 1] + qv.z * kf[e + 2] +
                        qv.w * kf[e + 3];
            }
          }
        }
      }
    }
#pragma unroll
    for (int gi = 0; gi < kMaxG / 2; ++gi) {
      const int g = gh + 2 * gi;
      if (g < G) {
        float s = kNegInf;
        if (j < n) {
          s = sc[gi] * scale;
          if (kQuant) s *= ks_s[j];
        }
        p_s[g * kTile + j] = s;
      }
    }
    __syncthreads();

    // online softmax over the tile, one warp per query row
    for (int g = warp; g < G; g += kThreads / 32) {
      const float a = p_s[g * kTile + lane];
      const float c = p_s[g * kTile + lane + 32];
      float mx = fmaxf(a, c);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      const float pa = lane < n ? expf(a - m_new) : 0.f;
      const float pc = lane + 32 < n ? expf(c - m_new) : 0.f;
      p_s[g * kTile + lane] = pa;
      p_s[g * kTile + lane + 32] = pc;
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

    // out column d = tid, over the tile's visible keys
    if (tid < D) {
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G) acc[g] *= alpha_s[g];
      for (int jj = 0; jj < n; ++jj) {
        const float vf = elem_to_float(
            reinterpret_cast<const Elem*>(v_s + jj * kRowBytes)[tid]);
        const float w = kQuant ? vs_s[jj] : 1.f;
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          if (g < G) acc[g] += (p_s[g * kTile + jj] * w) * vf;
      }
    }
    __syncthreads();  // the next tile overwrites shared memory
  }

  if (tid < D) {
    __nv_bfloat16* ob = out + bkv * G * D;
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G) {
        const float l = l_s[g];
        ob[g * D + tid] = __float2bfloat16(acc[g] / (l == 0.f ? 1.f : l));
      }
    }
  }
}

template <typename Elem, bool kQuant>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* pos, void* out, int B, int KV, int G,
           int T, int D, float scale, void* stream) {
  if (G < 1 || G > kMaxG) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(B * KV);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const Elem*>(k);
  const auto* vp = static_cast<const Elem*>(v);
  const auto* ksp = static_cast<const float*>(ks);
  const auto* vsp = static_cast<const float*>(vs);
  const auto* pp = static_cast<const int*>(pos);
  auto* op = static_cast<__nv_bfloat16*>(out);
  if (D == 128) {
    flash_decode_kernel<Elem, kQuant, 128><<<grid, kThreads, 0, st>>>(
        qp, kp, vp, ksp, vsp, pp, op, KV, G, T, scale);
  } else if (D == 64) {
    flash_decode_kernel<Elem, kQuant, 64><<<grid, kThreads, 0, st>>>(
        qp, kp, vp, ksp, vsp, pp, op, KV, G, T, scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: contiguous (B, KV, G, D) bf16; k/v: contiguous (B, KV, T, D); pos:
// (B,) int32; out: contiguous (B, KV, G, D) bf16. Returns
// cudaGetLastError() after the launch.
extern "C" int flash_decode_bf16(const void* q, const void* k, const void* v,
                                 const void* pos, void* out, int B, int KV,
                                 int G, int T, int D, float scale,
                                 void* stream) {
  return launch<__nv_bfloat16, false>(q, k, v, nullptr, nullptr, pos, out, B,
                                      KV, G, T, D, scale, stream);
}

// As above with int8 k/v and their per-vector f32 scales ks/vs, contiguous
// (B, KV, T).
extern "C" int flash_decode_int8(const void* q, const void* k, const void* v,
                                 const void* ks, const void* vs,
                                 const void* pos, void* out, int B, int KV,
                                 int G, int T, int D, float scale,
                                 void* stream) {
  return launch<int8_t, true>(q, k, v, ks, vs, pos, out, B, KV, G, T, D,
                              scale, stream);
}
