// The gradients of GAT's attention-weighted message sum
// (weighted_segment_sum.cu) for Hopper (sm_90a). With g the output gradient
// [T, H * C] in xs's type, over the real edges only (e < count, dst[e] < T):
//
//     d_att[e, h]        = sum over c of g[dst[e], h * C + c] *
//                                        xs[src[e], h * C + c]
//     d_xs[s, h * C + c] = sum over e with src[e] == s of
//                          att[e, h] * g[dst[e], h * C + c]
//
// d_att f32 [E, H], 0 on the dropped edges; d_xs [N, H * C] in xs's type,
// 0 on the rows no real edge reaches. Products and sums in f32; each d_xs
// row is rounded to xs's type once, where it is written. Row offsets are
// 64-bit.
//
// Replaces no TPU kernel: the JAX package differentiates the gather,
// broadcast multiply and K1 with autodiff, and the port did the same with
// torch ops, writing four [E, H * C] tensors (g gathered by dst, xs
// gathered by src, their product, the weighted g that a bf16 index_add_
// summed into d_xs). Here nothing [E, H * C]-wide is written.
//
// Bound: memory. The d_att pass reads each real edge's xs row (a row that
// repeats comes from L2 where it fits), each target's g row once, 8 bytes
// of ids an edge, and writes 4 * H bytes an edge; the d_xs pass reads each
// real edge's g row, 16 bytes of ids and 4 * H of weight, and writes d_xs
// once (2 * N * H * C bytes in bf16). Their f32 operations, 2 an element of
// a real row, are far under the card's f32 rate.
//
// Design, two passes over K2's edge slices (segment_common.cuh):
//
// - weighted_att_grad_pass, in the forward's dst order: a worker of G lanes
//   walks its kSlice edges as the forward's slice pass does (ids and src
//   ids G at a time, broadcast with __shfl_sync; each lane loads 16 bytes
//   of a row, kUnroll / (2 KV) rows in flight). When the target changes,
//   the new target's g row is loaded with the edges' xs rows and kept in
//   f32 registers. Each lane sums the products of each vector it holds.
//   Where a head's vectors fill aligned blocks of a power of two lanes (4
//   heads of 128 in bf16: 16 lanes), each block reduces its head with xor
//   shuffles inside it; otherwise each head's sum is reduced over the G
//   lanes in turn, and a row wider than one pass of G * KV vectors adds its
//   later passes onto the first, in pass order. One fixed lane writes each
//   head's sum. Dropped edges of the slice get 0.
// - weighted_scatter_pass, in src order: the forward's weighted slice pass
//   with the roles swapped, under its own name so that a profiler tells
//   the forward and the backward apart. The caller sorts the keys src (N
//   for a dropped edge) stably; the sorted keys are the segment ids, so the
//   dropped edges are the pads at the end, and each sorted edge's position
//   e = perm[i] gives the g row it reads (dst[e]) and its weights (att[e]),
//   loaded with the ids a group of G edges ahead; a vector's elements take
//   its head's weight. A segment inside a slice is written once, in xs's
//   type; one that crosses a slice edge leaves f32 partial rows in scratch,
//   which weighted_scatter_combine (segment_common's combine_pass, writing
//   xs's type) sums in a fixed order; empty rows are written as zeros.
//
// Both passes take the forward's parameters from H, C, the row width and
// the alignment they observe (16-byte vectors where rows and pointers
// allow and no head straddles a vector, else one element a load; G lanes
// a row, KV vectors a lane a pass). No atomics: the same inputs give the
// same bits.
//
// Plain C interface, bound with ctypes (salient_plusplus_tpu_torch/ops/
// weighted_segment.py); launches every pass on the caller's stream and
// returns cudaGetLastError().

#include <climits>
#include <type_traits>

#include "segment_common.cuh"

namespace sptpu_seg {

// The VE elements of one loaded vector as f32 (the loads of Vec<T, kVec>).
__device__ __forceinline__ void to_f32(const float4& r, float* f) {
  f[0] = r.x; f[1] = r.y; f[2] = r.z; f[3] = r.w;
}
__device__ __forceinline__ void to_f32(const int4& r, float* f) {
  const auto* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}
__device__ __forceinline__ void to_f32(const float& r, float* f) { f[0] = r; }
__device__ __forceinline__ void to_f32(const unsigned short& r, float* f) {
  f[0] = __bfloat162float(__ushort_as_bfloat16(r));
}

// The sum of s over the G lanes of a worker, in the same bits on each.
__device__ __forceinline__ float group_sum(float s, unsigned gmask, int G) {
  for (int off = G >> 1; off > 0; off >>= 1) {
    s += __shfl_xor_sync(gmask, s, off, G);
  }
  return s;
}

__device__ __forceinline__ float from_f32(float x, float*) { return x; }
__device__ __forceinline__ __nv_bfloat16 from_f32(float x, __nv_bfloat16*) {
  return __float2bfloat16(x);
}

// Store VE f32 sums as T at element v * VE of a row of T (16 bytes when
// VE > 1, rounded to nearest even as a cast would).
template <int VE>
__device__ __forceinline__ void store_as(float* __restrict__ row, int64_t v,
                                         const float* acc) {
  store<VE>(row, v, acc);
}
template <int VE>
__device__ __forceinline__ void store_as(__nv_bfloat16* __restrict__ row,
                                         int64_t v, const float* acc) {
  if constexpr (VE == 1) {
    row[v] = __float2bfloat16(acc[0]);
  } else {
    static_assert(VE == 8, "a 16-byte vector of bf16");
    int4 r;
    auto* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      h[i] = __floats2bfloat162_rn(acc[2 * i], acc[2 * i + 1]);
    }
    reinterpret_cast<int4*>(row)[v] = r;
  }
}

// segment_common's zero_empty_rows for rows of T: zeros of the rows whose
// edge range is empty.
template <typename T>
__device__ __forceinline__ void zero_rows(const int32_t* __restrict__ ids,
                                          int64_t cnt, int64_t num_segments,
                                          int64_t F, T* __restrict__ out,
                                          int64_t warp_index) {
  const int lane = threadIdx.x & 31;
  const int64_t base = warp_index * 32 * kRowGroups;
  int64_t key[kRowGroups + 1], pos[kRowGroups + 1];
#pragma unroll
  for (int k = 0; k <= kRowGroups; ++k) {
    const int64_t t = base + 32 * k + lane;
    key[k] = t < num_segments ? t : num_segments;
  }
  lower_bounds<kRowGroups + 1>(ids, cnt, key, pos);
  const int64_t n16 = (F * static_cast<int64_t>(sizeof(T))) % 16 == 0
                          ? F * static_cast<int64_t>(sizeof(T)) / 16
                          : 0;
#pragma unroll
  for (int k = 0; k < kRowGroups; ++k) {
    // the range of row t ends where row t + 1's begins
    const int64_t down = __shfl_down_sync(kFull, pos[k], 1);
    const int64_t wrap = __shfl_sync(kFull, pos[k + 1], 0);
    const int64_t t = base + 32 * k + lane;
    unsigned empty = __ballot_sync(
        kFull, t < num_segments && pos[k] == (lane < 31 ? down : wrap));
    while (empty) {
      const int r = __ffs(empty) - 1;
      empty &= empty - 1;
      T* __restrict__ row = out + (base + 32 * k + r) * F;
      if (n16 > 0) {
        for (int64_t v = lane; v < n16; v += 32) {
          reinterpret_cast<int4*>(row)[v] = make_int4(0, 0, 0, 0);
        }
      } else {
        for (int64_t c = lane; c < F; c += 32) row[c] = from_f32(0.f, row);
      }
    }
  }
}

// The real edges of the slice [a, a + kSlice): [a, b), b = a if none.
__device__ __forceinline__ int64_t real_end(const int32_t* __restrict__ ids,
                                            int64_t a, int64_t cnt,
                                            int64_t num_segments) {
  if (a >= cnt || __ldg(ids + a) >= num_segments) return a;
  int64_t b = a + kSlice < cnt ? a + kSlice : cnt;
  if (__ldg(ids + b - 1) >= num_segments) {  // the slice where pads begin
    int64_t pos;
    lower_bounds<1>(ids + a, b - a, &num_segments, &pos);
    b = a + pos;
  }
  return b;
}

// d_att, in dst order; kMultiHead: each element sums into its head
// (column / C).
template <typename T, bool kVec, int KV, bool kMultiHead>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
weighted_att_grad_pass(const T* __restrict__ xs, const T* __restrict__ grad,
                       const int32_t* __restrict__ src,
                       const int32_t* __restrict__ ids,
                       const int32_t* __restrict__ count, int64_t E,
                       int64_t num_segments, int64_t F, int64_t H, int64_t C,
                       int G, float* __restrict__ d_att) {
  using V = Vec<T, kVec>;
  constexpr int VE = V::VE;
  // edges in flight: half the forward's, as each may also load a g row
  constexpr int U = KV < kUnroll / 2 ? kUnroll / (2 * KV) : 1;
  const int lane = threadIdx.x & 31;
  const int lane_g = lane & (G - 1);
  const unsigned gmask =
      G == 32 ? kFull : (((1u << G) - 1) << (lane & ~(G - 1)));
  const int64_t w = static_cast<int64_t>(blockIdx.x) * (kWarps * (32 / G)) +
                    (threadIdx.x / G);
  const int64_t a = w * kSlice;
  if (a >= E) return;  // uniform over the worker's G lanes
  const int64_t end = a + kSlice < E ? a + kSlice : E;
  const int64_t b = real_end(ids, a, clamped_count(count, E), num_segments);
  for (int64_t x = (b - a) * H + lane_g; x < (end - a) * H; x += G) {
    d_att[a * H + x] = 0.f;
  }
  if (b == a) return;
  const int64_t NV = F / VE;  // vectors a row, each inside one head
  // a head's vectors fill aligned blocks of L lanes (L a power of two up to
  // G): each block reduces its own head, and a head lies in one pass
  const int64_t L = C / VE;
  const bool blocks = kMultiHead && L <= G && (L & (L - 1)) == 0;

  for (int64_t c0 = 0; c0 < NV; c0 += static_cast<int64_t>(G) * KV) {
    const bool first = c0 == 0;
    int32_t hk[KV];  // kMultiHead: the head of each vector
#pragma unroll
    for (int k = 0; k < KV; ++k) {
      const int64_t col = (c0 + k * G + lane_g) * VE;
      hk[k] = static_cast<int32_t>(kMultiHead && col < F ? col / C : 0);
    }
    float gv[KV][VE];  // the current target's g elements of this lane
    int32_t cur = -1;

    int32_t next_id = 0, next_src = 0;
    auto fetch = [&](int64_t eb) {
      if (eb + lane_g < b) {
        next_id = __ldg(ids + eb + lane_g);
        next_src = __ldg(src + eb + lane_g);
      }
    };
    fetch(a);
    for (int64_t eb = a; eb < b; eb += G) {
      const int m = b - eb < G ? static_cast<int>(b - eb) : G;
      const int32_t my_id = next_id, my_src = next_src;
      fetch(eb + G);
      for (int j = 0; j < m; j += U) {
        typename V::Raw raw[U][KV], graw[U][KV];
        int32_t d[U];
        bool fresh[U];
        int32_t prev = cur;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          d[u] = __shfl_sync(gmask, my_id, j + u, G);
          const int64_t r = __shfl_sync(gmask, my_src, j + u, G);
          fresh[u] = j + u < m && d[u] != prev;
          prev = d[u];
          if (j + u < m) {
            const T* __restrict__ row = xs + r * F;
            const T* __restrict__ grow = grad + static_cast<int64_t>(d[u]) * F;
#pragma unroll
            for (int k = 0; k < KV; ++k) {
              const int64_t v = c0 + k * G + lane_g;
              if (v < NV) {
                raw[u][k] = V::load(row, v);
                if (fresh[u]) graw[u][k] = V::load(grow, v);
              }
            }
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (j + u >= m) continue;
          float vs[KV];  // this lane's part of the dot, a vector at a time
#pragma unroll
          for (int k = 0; k < KV; ++k) {
            vs[k] = 0.f;
            if (c0 + k * G + lane_g < NV) {
              if (fresh[u]) to_f32(graw[u][k], gv[k]);
              float f[VE];
              to_f32(raw[u][k], f);
#pragma unroll
              for (int i = 0; i < VE; ++i) vs[k] = fmaf(f[i], gv[k][i], vs[k]);
            }
          }
          cur = d[u];
          float* __restrict__ out = d_att + (eb + j + u) * H;
          if constexpr (!kMultiHead) {
            float s = 0.f;
#pragma unroll
            for (int k = 0; k < KV; ++k) s += vs[k];
            s = group_sum(s, gmask, G);
            if (lane_g == 0) out[0] = first ? s : out[0] + s;
          } else if (blocks) {
#pragma unroll
            for (int k = 0; k < KV; ++k) {
              float s = vs[k];
              for (int off = static_cast<int>(L) >> 1; off > 0; off >>= 1) {
                s += __shfl_xor_sync(gmask, s, off, G);
              }
              if ((lane_g & (L - 1)) == 0 && c0 + k * G + lane_g < NV) {
                out[hk[k]] = s;
              }
            }
          } else {
            for (int h = 0; h < H; ++h) {
              float s = 0.f;
#pragma unroll
              for (int k = 0; k < KV; ++k) s += hk[k] == h ? vs[k] : 0.f;
              s = group_sum(s, gmask, G);
              if (lane_g == (h & (G - 1))) out[h] = first ? s : out[h] + s;
            }
          }
        }
      }
    }
  }
}

// d_xs, in src order: weighted_segment_sum.cu's weighted_slice_pass over
// the sorted edges (vals: g; ids: the sorted keys; the row of sorted edge i
// is rows[perm[i]], its weights att[perm[i]]).
template <typename T, bool kVec, int KV, bool kMultiHead>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
weighted_scatter_pass(const T* __restrict__ vals,
                      const float* __restrict__ att,
                      const int32_t* __restrict__ rows,
                      const int64_t* __restrict__ perm,
                      const int32_t* __restrict__ ids,
                      const int32_t* __restrict__ count, int64_t E,
                      int64_t num_segments, int64_t F, int64_t H, int64_t C,
                      int G, int64_t slice_blocks, T* __restrict__ out,
                      float* __restrict__ scratch) {
  using V = Vec<T, kVec>;
  constexpr int VE = V::VE;
  constexpr int U = kUnroll / KV;  // rows in flight: U * KV loads a lane
  const int64_t cnt = clamped_count(count, E);
  if (blockIdx.x >= slice_blocks) {
    zero_rows(ids, cnt, num_segments, F, out,
              (blockIdx.x - slice_blocks) * kWarps + (threadIdx.x >> 5));
    return;
  }
  const int lane = threadIdx.x & 31;
  const int lane_g = lane & (G - 1);
  const unsigned gmask =
      G == 32 ? kFull : (((1u << G) - 1) << (lane & ~(G - 1)));
  const int64_t w = static_cast<int64_t>(blockIdx.x) * (kWarps * (32 / G)) +
                    (threadIdx.x / G);
  const int64_t a = w * kSlice;
  const int64_t b = real_end(ids, a, cnt, num_segments);
  if (b == a) return;  // uniform over the worker's G lanes
  const int64_t NV = F / VE;                  // vectors a row
  const int64_t Fs = (F + 3) & ~int64_t{3};   // scratch row stride
  const int32_t head = __ldg(ids + a);
  const int32_t tail = __ldg(ids + b - 1);
  const bool head_open = a > 0 && __ldg(ids + a - 1) == head;
  const bool tail_open = b < cnt && __ldg(ids + b) == tail;

  for (int64_t c0 = 0; c0 < NV; c0 += static_cast<int64_t>(G) * KV) {
    float acc[KV][VE];
#pragma unroll
    for (int k = 0; k < KV; ++k)
#pragma unroll
      for (int i = 0; i < VE; ++i) acc[k][i] = 0.f;
    int32_t hk[KV];  // kMultiHead: the head of each vector
#pragma unroll
    for (int k = 0; k < KV; ++k) {
      const int64_t col = (c0 + k * G + lane_g) * VE;
      hk[k] = static_cast<int32_t>(kMultiHead && col < F ? col / C : 0);
    }

    // write the sums of segment cur (ended: it ends inside this slice): a
    // whole segment's as T to out, a part's in f32 to scratch
    auto flush = [&](int32_t cur, bool ended) {
      const bool started = !(cur == head && head_open);
      T* __restrict__ orow = out + static_cast<int64_t>(cur) * F;
      float* __restrict__ srow =
          scratch + (2 * w + (cur == head ? 0 : 1)) * Fs;
#pragma unroll
      for (int k = 0; k < KV; ++k) {
        const int64_t v = c0 + k * G + lane_g;
        if (v < NV) {
          if (started && ended) {
            store_as<VE>(orow, v, acc[k]);
          } else {
            store<VE>(srow, v, acc[k]);
          }
        }
#pragma unroll
        for (int i = 0; i < VE; ++i) acc[k][i] = 0.f;
      }
    };

    // the ids, edges, rows (and weights) of the next G sorted edges load
    // while this G's rows do
    int32_t next_id = 0, next_src = 0;
    long long next_e = 0;
    float next_w = 0.f;
    auto fetch = [&](int64_t eb) {
      if (eb + lane_g < b) {
        next_id = __ldg(ids + eb + lane_g);
        next_e = __ldg(reinterpret_cast<const long long*>(perm) + eb + lane_g);
        next_src = __ldg(rows + next_e);
        if constexpr (!kMultiHead) next_w = __ldg(att + next_e);
      }
    };
    fetch(a);
    int32_t cur = head;
    for (int64_t eb = a; eb < b; eb += G) {
      const int m = b - eb < G ? static_cast<int>(b - eb) : G;
      const int32_t my_id = next_id, my_src = next_src;
      const long long my_e = next_e;
      const float my_w = next_w;
      fetch(eb + G);
      for (int j = 0; j < m; j += U) {
        typename V::Raw raw[U][KV];
        int32_t d[U];
        float wt[U];
        int32_t ed[kMultiHead ? U : 1];  // E < 2^31
#pragma unroll
        for (int u = 0; u < U; ++u) {
          d[u] = __shfl_sync(gmask, my_id, j + u, G);
          const int64_t r = __shfl_sync(gmask, my_src, j + u, G);
          wt[u] = __shfl_sync(gmask, my_w, j + u, G);
          if constexpr (kMultiHead) {
            ed[u] = __shfl_sync(gmask, static_cast<int32_t>(my_e), j + u, G);
          }
          if (j + u < m) {
            const T* __restrict__ row = vals + r * F;
#pragma unroll
            for (int k = 0; k < KV; ++k) {
              const int64_t v = c0 + k * G + lane_g;
              if (v < NV) raw[u][k] = V::load(row, v);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (j + u < m) {
            if (d[u] != cur) {
              flush(cur, true);
              cur = d[u];
            }
            const float* __restrict__ we = att;
            if constexpr (kMultiHead) we += static_cast<int64_t>(ed[u]) * H;
#pragma unroll
            for (int k = 0; k < KV; ++k) {
              if (c0 + k * G + lane_g < NV) {
                float f[VE];
                to_f32(raw[u][k], f);
                float wi = wt[u];
                if constexpr (kMultiHead) wi = __ldg(we + hk[k]);
#pragma unroll
                for (int i = 0; i < VE; ++i) acc[k][i] = fmaf(wi, f[i], acc[k][i]);
              }
            }
          }
        }
      }
    }
    flush(cur, !tail_open);
  }
}

// segment_common's combine_pass with rows of T out: block w sums the
// partials of the segment that crosses the end of slice w and starts inside
// it, if there is one, in the same order, and writes the sum as T.
template <typename T>
__global__ void __launch_bounds__(kCombineWarps * 32)
weighted_scatter_combine(const int32_t* __restrict__ ids,
                         const int32_t* __restrict__ count, int64_t E,
                         int64_t num_segments, int64_t F,
                         const float* __restrict__ scratch,
                         T* __restrict__ out) {
  __shared__ float4 part[kCombineWarps][32 * kCombineVec];
  __shared__ int64_t seg[3];  // target (-1: none), partials, first slot
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t w = blockIdx.x;
  const int64_t a = w * kSlice;
  if (warp == 0) {
    const int64_t cnt = clamped_count(count, E);
    const int64_t b = a + kSlice;
    int64_t t = -1, m = 0, first = 0;
    if (b < cnt) {
      const int32_t tb = __ldg(ids + b - 1), after = __ldg(ids + b);
      const int32_t before = a > 0 ? __ldg(ids + a - 1) : -1;
      const int32_t head = __ldg(ids + a);
      // a real segment continues past b and starts in this slice
      if (tb < num_segments && after == tb && before != tb) {
        const int64_t key = static_cast<int64_t>(tb) + 1;
        const bool lt = b + lane < cnt && __ldg(ids + b + lane) < key;
        int64_t e1 = b + __popc(__ballot_sync(kFull, lt));
        if (e1 == b + 32) {
          e1 += warp_lower_bound(ids + e1, cnt - e1, key);
        }
        t = tb;
        m = (e1 - 1) / kSlice - w + 1;
        first = 2 * w + (head == tb ? 0 : 1);
      }
    }
    if (lane == 0) {
      seg[0] = t;
      seg[1] = m;
      seg[2] = first;
    }
  }
  __syncthreads();
  const int64_t t = seg[0], m = seg[1], first = seg[2];
  if (t < 0) return;  // uniform over the block
  const int64_t Fs = (F + 3) & ~int64_t{3};
  const int64_t NV = Fs / 4;
  constexpr int R = kCombineDepth;
  for (int64_t c0 = 0; c0 < NV; c0 += 32 * kCombineVec) {
    float4 acc[kCombineVec];
#pragma unroll
    for (int k = 0; k < kCombineVec; ++k) acc[k] = make_float4(0, 0, 0, 0);
    for (int64_t j = warp; j < m; j += kCombineWarps * R) {
      float4 r[R][kCombineVec];
#pragma unroll
      for (int u = 0; u < R; ++u) {
        const int64_t jj = j + u * kCombineWarps;
        if (jj < m) {
          const int64_t slot = jj == 0 ? first : 2 * (w + jj);
          const float4* __restrict__ row =
              reinterpret_cast<const float4*>(scratch + slot * Fs);
#pragma unroll
          for (int k = 0; k < kCombineVec; ++k) {
            const int64_t v = c0 + k * 32 + lane;
            if (v < NV) r[u][k] = row[v];
          }
        }
      }
#pragma unroll
      for (int u = 0; u < R; ++u) {
        if (j + u * kCombineWarps < m) {
#pragma unroll
          for (int k = 0; k < kCombineVec; ++k) {
            acc[k].x += r[u][k].x;
            acc[k].y += r[u][k].y;
            acc[k].z += r[u][k].z;
            acc[k].w += r[u][k].w;
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kCombineVec; ++k) part[warp][k * 32 + lane] = acc[k];
    __syncthreads();
    for (int x = threadIdx.x; x < 32 * kCombineVec; x += blockDim.x) {
      const int64_t v = c0 + x;
      if (v < NV) {
        float4 s = part[0][x];
        for (int q = 1; q < kCombineWarps; ++q) {
          s.x += part[q][x].x;
          s.y += part[q][x].y;
          s.z += part[q][x].z;
          s.w += part[q][x].w;
        }
        T* __restrict__ orow = out + t * F + 4 * v;
        const float sv[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (4 * v + i < F) orow[i] = from_f32(sv[i], orow);
        }
      }
    }
    __syncthreads();
  }
}

// The forward's launch parameters (weighted_launch_dtype) for rows of H
// heads of C elements of T at the pointers in `bits` (or-ed): 16-byte
// vectors where they allow and no head straddles a vector, G lanes a row
// (a power of two up to 32), KV vectors a lane a pass. Calls launch(kVec,
// KV, kMultiHead, G) with the first three as std::integral_constant.
template <typename T, typename Launch>
cudaError_t with_params(uintptr_t bits, int64_t H, int64_t C,
                        Launch&& launch) {
  const int64_t F = H * C;
  constexpr int64_t kVE = 16 / sizeof(T);
  const bool vec =
      ((bits | static_cast<uintptr_t>(F * sizeof(T))) & 15) == 0 &&
      (H == 1 || C % kVE == 0);
  const int64_t VE = vec ? kVE : 1;
  const int64_t NV = F / VE;
  int G = 1;
  while (G < 32 && G < NV) G *= 2;
  const int64_t per_lane = (NV + G - 1) / G;
  const int KV = per_lane <= 1 ? 1 : (per_lane <= 2 ? 2 : 4);
  auto by_kv = [&](auto v, auto mh) -> cudaError_t {
    if (KV == 1) return launch(v, std::integral_constant<int, 1>{}, mh, G);
    if (KV == 2) return launch(v, std::integral_constant<int, 2>{}, mh, G);
    return launch(v, std::integral_constant<int, 4>{}, mh, G);
  };
  auto by_heads = [&](auto v) -> cudaError_t {
    return H > 1 ? by_kv(v, std::true_type{}) : by_kv(v, std::false_type{});
  };
  return vec ? by_heads(std::true_type{}) : by_heads(std::false_type{});
}

template <typename T>
cudaError_t grad_dtype(const T* xs, const T* grad, const int32_t* src,
                       const int32_t* dst, const int32_t* count,
                       const float* att, const int32_t* keys_s,
                       const int64_t* perm, int64_t E, int64_t T_,
                       int64_t N, int64_t H, int64_t C, float* d_att,
                       T* d_xs, float* scratch, cudaStream_t stream) {
  const int64_t F = H * C;
  const int64_t slices = (E + kSlice - 1) / kSlice;
  if (d_att != nullptr && slices > 0) {
    const uintptr_t bits = reinterpret_cast<uintptr_t>(xs) |
                           reinterpret_cast<uintptr_t>(grad);
    const cudaError_t err = with_params<T>(
        bits, H, C, [&](auto vec, auto kv, auto mh, int G) {
          const int64_t per_block = kWarps * (32 / G);
          weighted_att_grad_pass<T, decltype(vec)::value, decltype(kv)::value,
                                 decltype(mh)::value>
              <<<static_cast<unsigned>((slices + per_block - 1) / per_block),
                 kWarps * 32, 0, stream>>>(xs, grad, src, dst, count, E, T_,
                                           F, H, C, G, d_att);
          return cudaGetLastError();
        });
    if (err != cudaSuccess) return err;
  }
  if (d_xs == nullptr || N <= 0) return cudaSuccess;
  const uintptr_t bits = reinterpret_cast<uintptr_t>(grad) |
                         reinterpret_cast<uintptr_t>(d_xs);
  const cudaError_t err = with_params<T>(
      bits, H, C, [&](auto vec, auto kv, auto mh, int G) {
        const int64_t rows_per_block = kWarps * 32 * kRowGroups;
        const int64_t empty_blocks = (N + rows_per_block - 1) / rows_per_block;
        const int64_t per_block = kWarps * (32 / G);
        const int64_t slice_blocks = (slices + per_block - 1) / per_block;
        weighted_scatter_pass<T, decltype(vec)::value, decltype(kv)::value,
                              decltype(mh)::value>
            <<<static_cast<unsigned>(slice_blocks + empty_blocks),
               kWarps * 32, 0, stream>>>(grad, att, dst, perm, keys_s,
                                         count, E, N, F, H, C, G,
                                         slice_blocks, d_xs, scratch);
        return cudaGetLastError();
      });
  if (err != cudaSuccess || slices == 0) return err;
  weighted_scatter_combine<T>
      <<<static_cast<unsigned>(slices), kCombineWarps * 32, 0, stream>>>(
          keys_s, count, E, N, F, scratch, d_xs);
  return cudaGetLastError();
}

}  // namespace sptpu_seg

extern "C" {

// dtype: 0 = float32 xs and grad, 1 = bfloat16; E below 2^31. All
// pointers are device pointers to contiguous tensors: xs [N, H * C], grad
// [T, H * C], src and dst [E] int32 (dst nondecreasing over the real
// edges), count one int32, att [E, H] float32; keys_s [E] int32 the stably
// sorted keys (src of a real edge, N for a dropped one) and perm [E] int64
// the edge of each. d_att [E, H] float32 or null (the d_att pass is
// skipped); d_xs [N, H * C] of xs's type or null (the d_xs pass is
// skipped, and keys_s, perm and scratch may be null); scratch holds
// scratch_len f32 (at least 2 * ceil(E / 64) * round_up(H * C, 4) for
// d_xs); stream is a cudaStream_t.
int sptpu_weighted_segment_grad(const void* xs, const void* grad, int dtype,
                                const void* src, const void* dst,
                                const void* count, const void* att,
                                const void* keys_s, const void* perm,
                                int64_t E, int64_t num_segments, int64_t N,
                                int64_t H, int64_t C, void* d_att,
                                void* d_xs, void* scratch,
                                int64_t scratch_len, void* stream) {
  using namespace sptpu_seg;
  const int64_t F = H * C;
  if (E < 0 || E > INT32_MAX || H <= 0 || C < 0 || num_segments < 0 ||
      N < 0 || (d_xs != nullptr && scratch_len < scratch_floats(E, F))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (F == 0) return 0;
  const auto* src_p = static_cast<const int32_t*>(src);
  const auto* dst_p = static_cast<const int32_t*>(dst);
  const auto* count_p = static_cast<const int32_t*>(count);
  const auto* att_p = static_cast<const float*>(att);
  const auto* keys_p = static_cast<const int32_t*>(keys_s);
  const auto* perm_p = static_cast<const int64_t*>(perm);
  auto* d_att_p = static_cast<float*>(d_att);
  auto* scratch_p = static_cast<float*>(scratch);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return static_cast<int>(grad_dtype<float>(
        static_cast<const float*>(xs), static_cast<const float*>(grad), src_p,
        dst_p, count_p, att_p, keys_p, perm_p, E, num_segments, N, H, C,
        d_att_p, static_cast<float*>(d_xs), scratch_p, s));
  }
  if (dtype == 1) {
    return static_cast<int>(grad_dtype<__nv_bfloat16>(
        static_cast<const __nv_bfloat16*>(xs),
        static_cast<const __nv_bfloat16*>(grad), src_p, dst_p, count_p,
        att_p, keys_p, perm_p, E, num_segments, N, H, C, d_att_p,
        static_cast<__nv_bfloat16*>(d_xs), scratch_p, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
