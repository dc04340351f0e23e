// GAT's edge softmax for Hopper (sm_90a): the attention logits and the
// self-inclusive softmax over each target's incoming edges, and their
// backward. Over the target-grouped COO (dst nondecreasing on [0, cnt),
// cnt = min(max(count, 0), E)), with the real edges those below cnt whose
// dst is below T (a prefix [0, n) of the edges), per head h:
//
//     z_e      = leaky_relu(a_src[src_e, h] + a_dst[dst_e, h])
//     z_self_t = leaky_relu(a_src[t, h] + a_dst[t, h])
//     m_t      = max(z_self_t, max over t's edges of z_e)     (a shift only)
//     D_t      = max(exp(z_self_t - m_t) + sum_e exp(z_e - m_t), 1e-16)
//     att_e    = exp(z_e - m_t) / D_t,   self_att_t = exp(z_self_t - m_t) / D_t
//
// The sums take the stored values (bf16 or f32) in f32. Dropped edges get
// att 0 and their src is never read; a target with no edges gets self_att
// 1. The backward, for g = d_att [E, H] and g_self = d_self_att [T, H]:
//
//     s_t        = sum_e att_e g_e + self_att_t g_self_t
//     dz_e       = att_e (g_e - s_t) lrelu'(a_src[src_e] + a_dst[t])
//     dz_self_t  = self_att_t (g_self_t - s_t) lrelu'(a_src[t] + a_dst[t])
//     d_a_dst[t] = sum_e dz_e + dz_self_t
//     d_a_src[src_e] += dz_e,  d_a_src[t] += dz_self_t
//
// Replaces no TPU kernel: the JAX package takes the softmax as segmented
// scans (salient_plusplus_tpu/ops/segment.py::segment_softmax_self). The
// port took it as plain torch (ops/segment.py::segment_softmax_self): two
// [E, H] gathers for the logits, scatter_reduce amax, two index_add_, the
// gathers of each edge's target statistics and some twenty elementwise
// kernels over [E, H], and in the backward as many again, with the gather
// c_pad[safe] differentiated as a sort plus index_put_ over int64 ids.
//
// Bound: memory, and the latency of the gathers. Forward, per real edge: 4
// bytes of src, the gathered a_src row (H values; its 32-byte sector), 4H
// of att; per target its a_src and a_dst rows and 4H of self_att; the
// binary searches' dst reads, mostly cache hits. Backward, per real edge:
// src, att, g and the a_src row again, and a 4H-byte f32 atomic add into
// d_a_src; per target its rows, self_att, g_self and d_a_dst. The f32
// operations, some ten an edge and head, are far under the card's rate.
//
// Design. A warp owns 32 consecutive targets. Its lanes find the 33 bounds
// of their segments in the sorted dst by binary searches taken in lockstep
// (segment_common's lower_bounds), so no rowptr is built and no edge is
// scattered. The warp then walks its targets 32 / G at a time, G lanes a
// target: G is the power of two at or above the average segment capacity
// E / T (16 for fanout 10, 32 for 20 or whole neighbourhoods), so a sampled
// segment takes one pass of its lanes and a longer one (a hub in layerwise
// inference) loops over it. Each lane holds HC heads (HC the power of two
// at or above H, at most 8; more heads take more blocks along y), loaded as
// one vector where the row is exactly HC values (16 bytes at 4 f32 heads, 8
// at 4 bf16). The forward takes an online max and sum on each lane, seeded
// with the self logit, merges them over the G lanes with xor shuffles, and
// writes att from the first G edges' logits kept in registers (a longer
// segment gathers its later edges again). The backward keeps the first G
// edges' att, g, src and a_src rows in registers across its two passes,
// reduces s_t and d_a_dst over the G lanes with xor shuffles (no atomics:
// the owning lanes write the row), and adds into d_a_src with f32 vector
// atomics (float4 and float2 on sm_90), so d_a_src's bits depend on the
// order of the adds. Blocks after the targets' in the forward's grid zero
// att over the dropped edges [n, E).
//
// Plain C interface, bound with ctypes (salient_plusplus_tpu_torch/ops/
// edge_softmax.py); each entry point launches one kernel on the caller's
// stream and returns cudaGetLastError().

#include <climits>
#include <type_traits>

#include "segment_common.cuh"

namespace sptpu_esm {

using sptpu_seg::clamped_count;
using sptpu_seg::kFull;
using sptpu_seg::lower_bounds;
using sptpu_seg::warp_lower_bound;

constexpr int kWarps = 8;                // warps a block
constexpr int kTile = 32;                // targets a warp owns
constexpr int64_t kZeroEdges = 512;      // dropped edges a zeroing warp owns

template <int Bytes> struct Raw;
template <> struct Raw<2> { using type = unsigned short; };
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<16> { using type = uint4; };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Heads [h0, h0 + HC) of row r of a [*, H] table of T, as f32 (heads at or
// past H read 0). kVec: H == HC and the row is one aligned vector, or two
// 16-byte ones.
template <typename T, int HC, bool kVec>
__device__ __forceinline__ void load_heads(const T* __restrict__ base,
                                           int64_t r, int64_t H, int64_t h0,
                                           float* out) {
  if constexpr (kVec) {
    constexpr int kBytes = HC * static_cast<int>(sizeof(T));
    constexpr int kChunk = kBytes < 16 ? kBytes : 16;
    constexpr int kPer = kChunk / static_cast<int>(sizeof(T));
    using R = typename Raw<kChunk>::type;
    const R* __restrict__ p = reinterpret_cast<const R*>(base + r * HC);
#pragma unroll
    for (int c = 0; c < kBytes / kChunk; ++c) {
      const R v = __ldg(p + c);
      const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
      for (int i = 0; i < kPer; ++i) out[c * kPer + i] = to_f32(e[i]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < HC; ++i) {
      out[i] = h0 + i < H ? to_f32(__ldg(base + r * H + h0 + i)) : 0.f;
    }
  }
}

// Store HC f32 values as T at heads [h0, h0 + HC) of row r (kVec as above).
template <typename T, int HC, bool kVec>
__device__ __forceinline__ void store_heads(T* __restrict__ base, int64_t r,
                                            int64_t H, int64_t h0,
                                            const float* v) {
  if constexpr (kVec) {
    constexpr int kBytes = HC * static_cast<int>(sizeof(T));
    constexpr int kChunk = kBytes < 16 ? kBytes : 16;
    constexpr int kPer = kChunk / static_cast<int>(sizeof(T));
    using R = typename Raw<kChunk>::type;
    R* __restrict__ p = reinterpret_cast<R*>(base + r * HC);
#pragma unroll
    for (int c = 0; c < kBytes / kChunk; ++c) {
      R w;
      T* e = reinterpret_cast<T*>(&w);
#pragma unroll
      for (int i = 0; i < kPer; ++i) e[i] = from_f32<T>(v[c * kPer + i]);
      p[c] = w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < HC; ++i) {
      if (h0 + i < H) base[r * H + h0 + i] = from_f32<T>(v[i]);
    }
  }
}

// base[r, h0 + i] += v[i] for the heads below H: 16- or 8-byte vector
// atomics where the row is one vector (sm_90), else one float at a time.
template <int HC, bool kVec>
__device__ __forceinline__ void atomic_add_heads(float* __restrict__ base,
                                                 int64_t r, int64_t H,
                                                 int64_t h0, const float* v) {
  if constexpr (kVec && HC >= 4) {
    auto* p = reinterpret_cast<float4*>(base + r * HC);
#pragma unroll
    for (int c = 0; c < HC / 4; ++c) {
      atomicAdd(p + c, make_float4(v[4 * c], v[4 * c + 1], v[4 * c + 2],
                                   v[4 * c + 3]));
    }
  } else if constexpr (kVec && HC == 2) {
    atomicAdd(reinterpret_cast<float2*>(base) + r, make_float2(v[0], v[1]));
  } else {
#pragma unroll
    for (int i = 0; i < HC; ++i) {
      if (h0 + i < H) atomicAdd(base + r * H + h0 + i, v[i]);
    }
  }
}

__device__ __forceinline__ float leaky(float x, float ns) {
  return x > 0.f ? x : x * ns;
}
__device__ __forceinline__ float leaky_grad(float x, float ns) {
  return x > 0.f ? 1.f : ns;
}

// The warp's 32 targets from t0: lane l gets lo = the first edge of target
// t0 + l, and every lane hi = the first edge past target t0 + 31 (targets
// at or past T have empty ranges at n).
__device__ __forceinline__ void tile_bounds(const int32_t* __restrict__ dst,
                                            int64_t cnt, int64_t T,
                                            int64_t t0, int64_t* lo,
                                            int64_t* hi) {
  const int lane = threadIdx.x & 31;
  int64_t key[2] = {t0 + lane < T ? t0 + lane : T,
                    t0 + kTile < T ? t0 + kTile : T};
  int64_t pos[2];
  lower_bounds<2>(dst, cnt, key, pos);
  *lo = pos[0];
  *hi = pos[1];
}

// Round j0 of a tile: this lane's target t0 + j, j = j0 + lane / G, and its
// edge range [s0, s1). Every lane of the warp calls it.
__device__ __forceinline__ int tile_target(int64_t lo, int64_t hi, int j0,
                                           int G, int64_t* s0, int64_t* s1) {
  const int lane = threadIdx.x & 31;
  const int j = j0 + lane / G;
  *s0 = __shfl_sync(kFull, lo, j);
  const int64_t next = __shfl_sync(kFull, lo, (j + 1) & 31);
  *s1 = j + 1 < kTile ? next : hi;
  return j;
}

// Zeros of att over the dropped edges of warp w's kZeroEdges: the first
// dropped edge is found by the whole warp (the real edges are a prefix).
__device__ __forceinline__ void zero_dropped(const int32_t* __restrict__ dst,
                                             int64_t cnt, int64_t E,
                                             int64_t T, int64_t H,
                                             float* __restrict__ att,
                                             int64_t w) {
  const int lane = threadIdx.x & 31;
  const int64_t a = w * kZeroEdges;
  if (a >= E) return;
  const int64_t b = a + kZeroEdges < E ? a + kZeroEdges : E;
  int64_t z = a;
  if (a < cnt && __ldg(dst + a) < T) {
    const int64_t c = b < cnt ? b : cnt;
    z = __ldg(dst + c - 1) < T ? c
                               : a + warp_lower_bound(dst + a, c - a, T);
  }
  for (int64_t x = z * H + lane; x < b * H; x += 32) att[x] = 0.f;
}

template <typename T, int HC, bool kVec>
__global__ void __launch_bounds__(kWarps * 32)
edge_softmax_fwd_kernel(const T* __restrict__ a_src,
                        const T* __restrict__ a_dst,
                        const int32_t* __restrict__ src,
                        const int32_t* __restrict__ dst,
                        const int32_t* __restrict__ count, int64_t E,
                        int64_t num_targets, int64_t H, float ns, int G,
                        int64_t tile_blocks, float* __restrict__ att,
                        float* __restrict__ self_att) {
  const int64_t T_ = num_targets;
  const int lane = threadIdx.x & 31;
  const int64_t warp = threadIdx.x >> 5;
  const int64_t cnt = clamped_count(count, E);
  if (blockIdx.x >= tile_blocks) {
    if (blockIdx.y == 0) {
      zero_dropped(dst, cnt, E, T_, H, att,
                   (blockIdx.x - tile_blocks) * kWarps + warp);
    }
    return;
  }
  const int64_t t0 = (blockIdx.x * kWarps + warp) * kTile;
  if (t0 >= T_) return;  // uniform over the warp
  const int64_t h0 = static_cast<int64_t>(blockIdx.y) * HC;
  const int lane_g = lane & (G - 1);
  const unsigned gmask =
      G == 32 ? kFull : (((1u << G) - 1) << (lane & ~(G - 1)));
  int64_t lo, hi;
  tile_bounds(dst, cnt, T_, t0, &lo, &hi);
  for (int j0 = 0; j0 < kTile; j0 += 32 / G) {
    int64_t s0, s1;
    const int64_t t = t0 + tile_target(lo, hi, j0, G, &s0, &s1);
    if (t >= T_) continue;  // uniform over the G lanes
    float ad[HC], zs[HC], m[HC], s[HC], z0[HC];
    load_heads<T, HC, kVec>(a_dst, t, H, h0, ad);
    load_heads<T, HC, kVec>(a_src, t, H, h0, zs);
#pragma unroll
    for (int i = 0; i < HC; ++i) {
      zs[i] = leaky(zs[i] + ad[i], ns);
      m[i] = zs[i];  // the self logit seeds every lane's max
      s[i] = 0.f;
      z0[i] = 0.f;
    }
    for (int64_t e = s0 + lane_g; e < s1; e += G) {
      float z[HC];
      load_heads<T, HC, kVec>(a_src, __ldg(src + e), H, h0, z);
#pragma unroll
      for (int i = 0; i < HC; ++i) {
        z[i] = leaky(z[i] + ad[i], ns);
        if (z[i] > m[i]) {
          s[i] = s[i] * expf(m[i] - z[i]) + 1.f;
          m[i] = z[i];
        } else {
          s[i] += expf(z[i] - m[i]);
        }
      }
      if (e < s0 + G) {
#pragma unroll
        for (int i = 0; i < HC; ++i) z0[i] = z[i];
      }
    }
    // merge the lanes' (max, sum): the same bits on every lane
    for (int off = G >> 1; off > 0; off >>= 1) {
#pragma unroll
      for (int i = 0; i < HC; ++i) {
        const float mo = __shfl_xor_sync(gmask, m[i], off, G);
        const float so = __shfl_xor_sync(gmask, s[i], off, G);
        const float mm = fmaxf(m[i], mo);
        s[i] = s[i] * expf(m[i] - mm) + so * expf(mo - mm);
        m[i] = mm;
      }
    }
    float den[HC], sa[HC];
#pragma unroll
    for (int i = 0; i < HC; ++i) {
      const float es = expf(zs[i] - m[i]);
      den[i] = fmaxf(s[i] + es, 1e-16f);
      sa[i] = es / den[i];
    }
    if (lane_g == 0) store_heads<float, HC, kVec>(self_att, t, H, h0, sa);
    for (int64_t e = s0 + lane_g; e < s1; e += G) {
      float z[HC];
      if (e < s0 + G) {
#pragma unroll
        for (int i = 0; i < HC; ++i) z[i] = z0[i];
      } else {
        load_heads<T, HC, kVec>(a_src, __ldg(src + e), H, h0, z);
#pragma unroll
        for (int i = 0; i < HC; ++i) z[i] = leaky(z[i] + ad[i], ns);
      }
      float a[HC];
#pragma unroll
      for (int i = 0; i < HC; ++i) a[i] = expf(z[i] - m[i]) / den[i];
      store_heads<float, HC, kVec>(att, e, H, h0, a);
    }
  }
}

template <typename T, int HC, bool kVec>
__global__ void __launch_bounds__(kWarps * 32)
edge_softmax_bwd_kernel(const T* __restrict__ a_src,
                        const T* __restrict__ a_dst,
                        const int32_t* __restrict__ src,
                        const int32_t* __restrict__ dst,
                        const int32_t* __restrict__ count,
                        const float* __restrict__ att,
                        const float* __restrict__ self_att,
                        const float* __restrict__ g,
                        const float* __restrict__ g_self, int64_t E,
                        int64_t num_targets, int64_t H, float ns, int G,
                        float* __restrict__ d_a_src, T* __restrict__ d_a_dst) {
  const int64_t T_ = num_targets;
  const int lane = threadIdx.x & 31;
  const int64_t warp = threadIdx.x >> 5;
  const int64_t t0 = (blockIdx.x * kWarps + warp) * kTile;
  if (t0 >= T_) return;  // uniform over the warp
  const int64_t cnt = clamped_count(count, E);
  const int64_t h0 = static_cast<int64_t>(blockIdx.y) * HC;
  const int lane_g = lane & (G - 1);
  const unsigned gmask =
      G == 32 ? kFull : (((1u << G) - 1) << (lane & ~(G - 1)));
  int64_t lo, hi;
  tile_bounds(dst, cnt, T_, t0, &lo, &hi);
  for (int j0 = 0; j0 < kTile; j0 += 32 / G) {
    int64_t s0, s1;
    const int64_t t = t0 + tile_target(lo, hi, j0, G, &s0, &s1);
    if (t >= T_) continue;  // uniform over the G lanes
    float ad[HC], ps[HC], sa[HC], gs[HC];
    load_heads<T, HC, kVec>(a_dst, t, H, h0, ad);
    load_heads<T, HC, kVec>(a_src, t, H, h0, ps);
    load_heads<float, HC, kVec>(self_att, t, H, h0, sa);
    load_heads<float, HC, kVec>(g_self, t, H, h0, gs);
    // pass 1: s_t; the first G edges' inputs stay in registers
    float acc[HC], a0[HC], g0[HC], p0[HC];
    int64_t r0 = 0;
#pragma unroll
    for (int i = 0; i < HC; ++i) acc[i] = a0[i] = g0[i] = p0[i] = 0.f;
    for (int64_t e = s0 + lane_g; e < s1; e += G) {
      float a[HC], gv[HC];
      load_heads<float, HC, kVec>(att, e, H, h0, a);
      load_heads<float, HC, kVec>(g, e, H, h0, gv);
      if (e < s0 + G) {
        r0 = __ldg(src + e);
        load_heads<T, HC, kVec>(a_src, r0, H, h0, p0);
#pragma unroll
        for (int i = 0; i < HC; ++i) {
          a0[i] = a[i];
          g0[i] = gv[i];
        }
      }
#pragma unroll
      for (int i = 0; i < HC; ++i) acc[i] = fmaf(a[i], gv[i], acc[i]);
    }
    float sum[HC];
#pragma unroll
    for (int i = 0; i < HC; ++i) {
      float v = acc[i];
      for (int off = G >> 1; off > 0; off >>= 1) {
        v += __shfl_xor_sync(gmask, v, off, G);
      }
      sum[i] = fmaf(sa[i], gs[i], v);
    }
    // pass 2: dz of each edge into d_a_src, and their sum for d_a_dst
    float dd[HC];
#pragma unroll
    for (int i = 0; i < HC; ++i) dd[i] = 0.f;
    for (int64_t e = s0 + lane_g; e < s1; e += G) {
      float a[HC], gv[HC], p[HC];
      int64_t r;
      if (e < s0 + G) {
        r = r0;
#pragma unroll
        for (int i = 0; i < HC; ++i) {
          a[i] = a0[i];
          gv[i] = g0[i];
          p[i] = p0[i];
        }
      } else {
        r = __ldg(src + e);
        load_heads<float, HC, kVec>(att, e, H, h0, a);
        load_heads<float, HC, kVec>(g, e, H, h0, gv);
        load_heads<T, HC, kVec>(a_src, r, H, h0, p);
      }
      float dz[HC];
#pragma unroll
      for (int i = 0; i < HC; ++i) {
        dz[i] = a[i] * (gv[i] - sum[i]) * leaky_grad(p[i] + ad[i], ns);
        dd[i] += dz[i];
      }
      atomic_add_heads<HC, kVec>(d_a_src, r, H, h0, dz);
    }
    float dzs[HC], out[HC];
#pragma unroll
    for (int i = 0; i < HC; ++i) {
      float v = dd[i];
      for (int off = G >> 1; off > 0; off >>= 1) {
        v += __shfl_xor_sync(gmask, v, off, G);
      }
      dzs[i] = sa[i] * (gs[i] - sum[i]) * leaky_grad(ps[i] + ad[i], ns);
      out[i] = v + dzs[i];
    }
    if (lane_g == 0) {
      store_heads<T, HC, kVec>(d_a_dst, t, H, h0, out);
      atomic_add_heads<HC, kVec>(d_a_src, t, H, h0, dzs);
    }
  }
}

// Lanes a target: the power of two at or above E / T, at most a warp.
inline int lanes_per_target(int64_t E, int64_t T) {
  const int64_t per = T > 0 ? (E + T - 1) / T : 1;
  int G = 1;
  while (G < 32 && G < per) G *= 2;
  return G;
}

// Calls launch(hc, vec) with HC (heads a lane: the power of two at or above
// H, at most 8) and kVec (H == HC and every pointer in `bits` aligned to
// the row's f32 vector) as std::integral_constant.
template <typename Launch>
cudaError_t by_heads(int64_t H, uintptr_t bits, Launch&& launch) {
  const int HC = H <= 1 ? 1 : (H <= 2 ? 2 : (H <= 4 ? 4 : 8));
  auto go = [&](auto hc) -> cudaError_t {
    constexpr int kHC = decltype(hc)::value;
    constexpr uintptr_t kAlign = kHC * 4 < 16 ? kHC * 4 : 16;
    if (H == kHC && (bits & (kAlign - 1)) == 0) {
      return launch(hc, std::true_type{});
    }
    return launch(hc, std::false_type{});
  };
  if (HC == 1) return go(std::integral_constant<int, 1>{});
  if (HC == 2) return go(std::integral_constant<int, 2>{});
  if (HC == 4) return go(std::integral_constant<int, 4>{});
  return go(std::integral_constant<int, 8>{});
}

inline uintptr_t ptr_bits(std::initializer_list<const void*> ps) {
  uintptr_t b = 0;
  for (const void* p : ps) b |= reinterpret_cast<uintptr_t>(p);
  return b;
}

template <typename T>
cudaError_t forward(const T* a_src, const T* a_dst, const int32_t* src,
                    const int32_t* dst, const int32_t* count, int64_t E,
                    int64_t T_, int64_t H, float ns, float* att,
                    float* self_att, cudaStream_t stream) {
  const int64_t per_block = kWarps * kTile;
  const int64_t tile_blocks = (T_ + per_block - 1) / per_block;
  const int64_t zero_blocks =
      (E + kWarps * kZeroEdges - 1) / (kWarps * kZeroEdges);
  const int64_t heads_y = (H + 7) / 8;
  if (tile_blocks + zero_blocks == 0) return cudaSuccess;
  const int G = lanes_per_target(E, T_);
  return by_heads(H, ptr_bits({a_src, a_dst, att, self_att}),
                  [&](auto hc, auto vec) {
    constexpr int kHC = decltype(hc)::value;
    const dim3 grid(static_cast<unsigned>(tile_blocks + zero_blocks),
                    static_cast<unsigned>(kHC == 8 ? heads_y : 1));
    edge_softmax_fwd_kernel<T, kHC, decltype(vec)::value>
        <<<grid, kWarps * 32, 0, stream>>>(a_src, a_dst, src, dst, count, E,
                                           T_, H, ns, G, tile_blocks, att,
                                           self_att);
    return cudaGetLastError();
  });
}

template <typename T>
cudaError_t backward(const T* a_src, const T* a_dst, const int32_t* src,
                     const int32_t* dst, const int32_t* count,
                     const float* att, const float* self_att, const float* g,
                     const float* g_self, int64_t E, int64_t T_, int64_t H,
                     float ns, float* d_a_src, T* d_a_dst,
                     cudaStream_t stream) {
  const int64_t per_block = kWarps * kTile;
  const int64_t tile_blocks = (T_ + per_block - 1) / per_block;
  const int64_t heads_y = (H + 7) / 8;
  if (tile_blocks == 0) return cudaSuccess;
  const int G = lanes_per_target(E, T_);
  return by_heads(
      H, ptr_bits({a_src, a_dst, att, self_att, g, g_self, d_a_src, d_a_dst}),
      [&](auto hc, auto vec) {
        constexpr int kHC = decltype(hc)::value;
        const dim3 grid(static_cast<unsigned>(tile_blocks),
                        static_cast<unsigned>(kHC == 8 ? heads_y : 1));
        edge_softmax_bwd_kernel<T, kHC, decltype(vec)::value>
            <<<grid, kWarps * 32, 0, stream>>>(a_src, a_dst, src, dst, count,
                                               att, self_att, g, g_self, E,
                                               T_, H, ns, G, d_a_src,
                                               d_a_dst);
        return cudaGetLastError();
      });
}

inline bool bad_sizes(int64_t E, int64_t T, int64_t N, int64_t H) {
  return E < 0 || E > INT32_MAX || T < 0 || N < T || H <= 0 ||
         (H + 7) / 8 > 65535;
}

}  // namespace sptpu_esm

extern "C" {

// dtype: 0 = float32 a_src and a_dst, 1 = bfloat16. All pointers are
// device pointers to contiguous tensors: a_src [N, H], a_dst [T, H], src
// and dst [E] int32 (dst nondecreasing over the first count edges), count
// one int32; att [E, H] and self_att [T, H] float32 out; E below 2^31 and
// N at least T; stream is a cudaStream_t.
int sptpu_edge_softmax(const void* a_src, const void* a_dst, int dtype,
                       const void* src, const void* dst, const void* count,
                       int64_t E, int64_t T, int64_t N, int64_t H,
                       float negative_slope, void* att, void* self_att,
                       void* stream) {
  using namespace sptpu_esm;
  if (bad_sizes(E, T, N, H)) return static_cast<int>(cudaErrorInvalidValue);
  const auto* s = static_cast<const int32_t*>(src);
  const auto* d = static_cast<const int32_t*>(dst);
  const auto* c = static_cast<const int32_t*>(count);
  auto* at = static_cast<float*>(att);
  auto* sa = static_cast<float*>(self_att);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return static_cast<int>(forward<float>(
        static_cast<const float*>(a_src), static_cast<const float*>(a_dst),
        s, d, c, E, T, H, negative_slope, at, sa, st));
  }
  if (dtype == 1) {
    return static_cast<int>(forward<__nv_bfloat16>(
        static_cast<const __nv_bfloat16*>(a_src),
        static_cast<const __nv_bfloat16*>(a_dst), s, d, c, E, T, H,
        negative_slope, at, sa, st));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The backward: the forward's inputs, its outputs att and self_att, and
// their gradients g [E, H] and g_self [T, H] float32; d_a_src [N, H]
// float32, zeroed by the caller, takes atomic adds; d_a_dst [T, H] of
// a_dst's type is written whole.
int sptpu_edge_softmax_backward(const void* a_src, const void* a_dst,
                                int dtype, const void* src, const void* dst,
                                const void* count, const void* att,
                                const void* self_att, const void* g,
                                const void* g_self, int64_t E, int64_t T,
                                int64_t N, int64_t H, float negative_slope,
                                void* d_a_src, void* d_a_dst, void* stream) {
  using namespace sptpu_esm;
  if (bad_sizes(E, T, N, H)) return static_cast<int>(cudaErrorInvalidValue);
  const auto* s = static_cast<const int32_t*>(src);
  const auto* d = static_cast<const int32_t*>(dst);
  const auto* c = static_cast<const int32_t*>(count);
  const auto* at = static_cast<const float*>(att);
  const auto* sa = static_cast<const float*>(self_att);
  const auto* gp = static_cast<const float*>(g);
  const auto* gs = static_cast<const float*>(g_self);
  auto* das = static_cast<float*>(d_a_src);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return static_cast<int>(backward<float>(
        static_cast<const float*>(a_src), static_cast<const float*>(a_dst),
        s, d, c, at, sa, gp, gs, E, T, H, negative_slope, das,
        static_cast<float*>(d_a_dst), st));
  }
  if (dtype == 1) {
    return static_cast<int>(backward<__nv_bfloat16>(
        static_cast<const __nv_bfloat16*>(a_src),
        static_cast<const __nv_bfloat16*>(a_dst), s, d, c, at, sa, gp, gs, E,
        T, H, negative_slope, das, static_cast<__nv_bfloat16*>(d_a_dst),
        st));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
