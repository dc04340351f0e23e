// The edge-split sorted segment sum shared by K1 (sorted_segment_sum.cu)
// and K2 (fused_gather_segment_sum.cu):
//
//     out[t, :] = sum over e < n with ids[e] == t of vals[row(e), :]
//
// with row(e) = e for K1 and row(e) = src[e] for K2, over ids nondecreasing
// on [0, n). n is the number of real edges: those below min(count, E)
// (count read on the device; K1 has none) whose id is below T. Edges at or
// past n are never read, nor their rows or src ids. f32 [T, F] out.
//
// Design (for Hopper; nothing of the TPU's tiles is carried over). The
// work is cut by edges, not by targets, so no worker's time depends on the
// longest segment:
//
// 1. Pass 1, one launch, two kinds of block:
//    - slice workers. A worker (G lanes: G = the lanes one row needs, up to
//      a warp; 32 / G workers per warp) owns kSlice consecutive edges and
//      walks them in order. It loads G segment ids (and for K2 G src ids)
//      at a time, one per lane, and broadcasts them with __shfl_sync; for
//      each edge every lane loads 16 bytes of the row (8 bf16 or 4 f32),
//      kUnroll rows are in flight before the first is added. A segment
//      that starts and ends inside the slice is summed in f32 registers
//      and written to out once. A segment that crosses an edge of the
//      slice (at most two per slice: the one holding its first edge and
//      the one holding its last) is written as an f32 partial row to
//      scratch slot 2 * slice (first) or 2 * slice + 1 (last);
//    - empty-row blocks, after the slices in the grid: each lane finds
//      lower_bound(t) for kRowGroups rows by binary searches taken in
//      lockstep, gets lower_bound(t + 1) from its neighbour, and the warp
//      writes zeros to every row whose range is empty. So out may come from
//      torch.empty.
// 2. Pass 2, one block per slice: the slice in which a crossing segment
//    starts owns it and sums its partials (one per slice it touches) with
//    8 warps, warp w taking partials w, w + 8, ..., then adds the warps'
//    sums in warp order in shared memory and writes the row. A hub that
//    spans thousands of slices is summed by one block, not walked by one
//    lane group.
//
// Deterministic: no atomics; each segment is summed in an order fixed by
// the positions of its edges (edge order inside a slice, then the partials
// in a fixed order), so the same inputs give the same bits.
//
// 16-byte loads need the row width in bytes and the vals base pointer to be
// multiples of 16 (and out's, which the wrappers allocate); otherwise the
// same kernel runs with one element a load (for example F = 12 or 100 in
// bf16, or a view that starts at an odd row). Row offsets are 64-bit.
//
// Scratch: 2 * ceil(E / kSlice) rows of round_up(F, 4) f32, from the
// wrapper (torch.empty); the kernels allocate nothing. Both passes launch
// on the caller's stream; the entry points return cudaGetLastError().

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace sptpu_seg {

constexpr int64_t kSlice = 64;    // edges a worker owns
constexpr int kUnroll = 8;        // 16-byte row loads in flight a lane
constexpr int kMinBlocks = 2;     // pass-1 blocks an SM must hold
constexpr int kWarps = 8;         // warps of a pass-1 block
constexpr int kRowGroups = 4;     // 32-row groups an empty-row warp covers
constexpr int kCombineWarps = 8;  // warps of a pass-2 block
constexpr int kCombineDepth = 8;  // partial rows in flight a pass-2 warp
constexpr int kCombineVec = 2;    // float4 columns a lane per pass 2 round
constexpr unsigned kFull = 0xffffffffu;

// Loads of one "vector": VE consecutive elements of a row, as f32.
template <typename T, bool kVec> struct Vec;
template <> struct Vec<float, true> {
  static constexpr int VE = 4;
  using Raw = float4;
  static __device__ __forceinline__ Raw load(const float* row, int64_t v) {
    return __ldg(reinterpret_cast<const float4*>(row) + v);
  }
  static __device__ __forceinline__ void add(float* acc, const Raw& r) {
    acc[0] += r.x; acc[1] += r.y; acc[2] += r.z; acc[3] += r.w;
  }
};
template <> struct Vec<__nv_bfloat16, true> {
  static constexpr int VE = 8;
  using Raw = int4;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* row,
                                             int64_t v) {
    return __ldg(reinterpret_cast<const int4*>(row) + v);
  }
  static __device__ __forceinline__ void add(float* acc, const Raw& r) {
    const auto* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      acc[2 * i] += f.x;
      acc[2 * i + 1] += f.y;
    }
  }
};
template <> struct Vec<float, false> {
  static constexpr int VE = 1;
  using Raw = float;
  static __device__ __forceinline__ Raw load(const float* row, int64_t v) {
    return __ldg(row + v);
  }
  static __device__ __forceinline__ void add(float* acc, const Raw& r) {
    acc[0] += r;
  }
};
template <> struct Vec<__nv_bfloat16, false> {
  static constexpr int VE = 1;
  using Raw = unsigned short;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* row,
                                             int64_t v) {
    return __ldg(reinterpret_cast<const unsigned short*>(row) + v);
  }
  static __device__ __forceinline__ void add(float* acc, const Raw& r) {
    acc[0] += __bfloat162float(__ushort_as_bfloat16(r));
  }
};

// First index in [0, len) with ids[i] >= key (len if none), by the whole
// warp: 32 probes a round, so ~log32(len) dependent loads. All 32 lanes
// must call it together.
__device__ __forceinline__ int64_t warp_lower_bound(
    const int32_t* __restrict__ ids, int64_t len, int64_t key) {
  const int lane = threadIdx.x & 31;
  int64_t lo = 0, hi = len;
  while (hi - lo > 32) {
    const int64_t step = (hi - lo + 31) / 32;
    const int64_t p = lo + lane * step;
    const bool lt = p < hi && static_cast<int64_t>(__ldg(ids + p)) < key;
    const int c = __popc(__ballot_sync(kFull, lt));
    if (c == 0) return lo;
    const int64_t nlo = lo + (c - 1) * step + 1;
    hi = hi < lo + c * step ? hi : lo + c * step;
    lo = nlo;
  }
  const int64_t p = lo + lane;
  const bool lt = p < hi && static_cast<int64_t>(__ldg(ids + p)) < key;
  return lo + __popc(__ballot_sync(kFull, lt));
}

// The edges below min(count, E) (count may be null: E). ids are sorted on
// [0, cnt), so the real edges (id < T) are its prefix [0, n): an edge e <
// cnt is real iff ids[e] < T, and no search for n is needed.
__device__ __forceinline__ int64_t clamped_count(
    const int32_t* __restrict__ count, int64_t E) {
  if (count == nullptr) return E;
  const int64_t c = __ldg(count);
  return c < 0 ? 0 : (c < E ? c : E);
}

// Store VE f32 sums at element v * VE of a row (16-byte aligned when VE > 1).
template <int VE>
__device__ __forceinline__ void store(float* __restrict__ row, int64_t v,
                                      const float* acc) {
  if constexpr (VE == 1) {
    row[v] = acc[0];
  } else {
    auto* p = reinterpret_cast<float4*>(row + v * VE);
#pragma unroll
    for (int i = 0; i < VE / 4; ++i) {
      p[i] = make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2],
                         acc[4 * i + 3]);
    }
  }
}

// lower_bound of K keys over the same [0, len) in lockstep: the searches
// take the same steps (branch-free form), so their K loads are in flight
// together.
template <int K>
__device__ __forceinline__ void lower_bounds(const int32_t* __restrict__ ids,
                                             int64_t len, const int64_t* key,
                                             int64_t* pos) {
#pragma unroll
  for (int k = 0; k < K; ++k) pos[k] = 0;
  if (len == 0) return;
  for (int64_t n = len; n > 1; n -= n >> 1) {
    const int64_t half = n >> 1;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (__ldg(ids + pos[k] + half) < key[k]) pos[k] += half;
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) pos[k] += __ldg(ids + pos[k]) < key[k];
}

// Zeros of the rows whose edge range is empty: warp q covers rows
// [q * 32 * kRowGroups, ...), lane l row base + 32 k + l of group k. The
// ranges come from lower bounds over [0, cnt): for t <= T they equal those
// over the real prefix.
__device__ __forceinline__ void zero_empty_rows(
    const int32_t* __restrict__ ids, int64_t cnt, int64_t T, int64_t F,
    float* __restrict__ out, int64_t warp_index) {
  const int lane = threadIdx.x & 31;
  const int64_t base = warp_index * 32 * kRowGroups;
  int64_t key[kRowGroups + 1], pos[kRowGroups + 1];
#pragma unroll
  for (int k = 0; k <= kRowGroups; ++k) {
    const int64_t t = base + 32 * k + lane;
    key[k] = t < T ? t : T;
  }
  lower_bounds<kRowGroups + 1>(ids, cnt, key, pos);
  const bool vec = (F & 3) == 0;
#pragma unroll
  for (int k = 0; k < kRowGroups; ++k) {
    // the range of row t ends where row t + 1's begins
    const int64_t down = __shfl_down_sync(kFull, pos[k], 1);
    const int64_t wrap = __shfl_sync(kFull, pos[k + 1], 0);
    const int64_t t = base + 32 * k + lane;
    unsigned empty = __ballot_sync(
        kFull, t < T && pos[k] == (lane < 31 ? down : wrap));
    while (empty) {
      const int r = __ffs(empty) - 1;
      empty &= empty - 1;
      float* __restrict__ row = out + (base + 32 * k + r) * F;
      if (vec) {
        for (int64_t v = lane; v < F / 4; v += 32) {
          reinterpret_cast<float4*>(row)[v] =
              make_float4(0.f, 0.f, 0.f, 0.f);
        }
      } else {
        for (int64_t c = lane; c < F; c += 32) row[c] = 0.f;
      }
    }
  }
}

// Pass 1. Blocks [0, slice_blocks) hold the slice workers, 32 / G a warp,
// each with KV vectors of VE columns a lane per column pass; the blocks
// after them zero the empty rows, so that the slices start first.
template <typename T, bool kVec, int KV, bool kGather>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
slice_pass(const T* __restrict__ vals, const int32_t* __restrict__ src,
           const int32_t* __restrict__ ids, const int32_t* __restrict__ count,
           int64_t E, int64_t num_segments, int64_t F, int G,
           int64_t slice_blocks, float* __restrict__ out,
           float* __restrict__ scratch) {
  using V = Vec<T, kVec>;
  constexpr int VE = V::VE;
  constexpr int U = kUnroll / KV;  // rows in flight: U * KV loads a lane
  const int64_t cnt = clamped_count(count, E);
  if (blockIdx.x >= slice_blocks) {
    zero_empty_rows(ids, cnt, num_segments, F, out,
                    (blockIdx.x - slice_blocks) * kWarps +
                        (threadIdx.x >> 5));
    return;
  }
  const int lane = threadIdx.x & 31;
  const int lane_g = lane & (G - 1);
  const unsigned gmask =
      G == 32 ? kFull : (((1u << G) - 1) << (lane & ~(G - 1)));
  const int64_t w = static_cast<int64_t>(blockIdx.x) * (kWarps * (32 / G)) +
                    (threadIdx.x / G);
  const int64_t a = w * kSlice;
  // uniform over the worker's G lanes: the slice holds no real edge
  if (a >= cnt || __ldg(ids + a) >= num_segments) return;
  int64_t b = a + kSlice < cnt ? a + kSlice : cnt;
  if (__ldg(ids + b - 1) >= num_segments) {  // the slice where pads begin
    int64_t pos;
    lower_bounds<1>(ids + a, b - a, &num_segments, &pos);
    b = a + pos;
  }
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

    // write the sums of segment cur (ended: it ends inside this slice)
    auto flush = [&](int32_t cur, bool ended) {
      const bool started = !(cur == head && head_open);
      float* __restrict__ row =
          started && ended
              ? out + static_cast<int64_t>(cur) * F
              : scratch + (2 * w + (cur == head ? 0 : 1)) * Fs;
#pragma unroll
      for (int k = 0; k < KV; ++k) {
        const int64_t v = c0 + k * G + lane_g;
        if (v < NV) store<VE>(row, v, acc[k]);
#pragma unroll
        for (int i = 0; i < VE; ++i) acc[k][i] = 0.f;
      }
    };

    // the ids (and src ids) of the next G edges load while this G's rows do
    int32_t next_id = 0, next_src = 0;
    auto fetch = [&](int64_t eb) {
      if (eb + lane_g < b) {
        next_id = __ldg(ids + eb + lane_g);
        if constexpr (kGather) next_src = __ldg(src + eb + lane_g);
      }
    };
    fetch(a);
    int32_t cur = head;
    for (int64_t eb = a; eb < b; eb += G) {
      const int m = b - eb < G ? static_cast<int>(b - eb) : G;
      const int32_t my_id = next_id, my_src = next_src;
      fetch(eb + G);
      for (int j = 0; j < m; j += U) {
        typename V::Raw raw[U][KV];
        int32_t d[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          d[u] = __shfl_sync(gmask, my_id, j + u, G);
          int64_t r;
          if constexpr (kGather) {
            r = __shfl_sync(gmask, my_src, j + u, G);
          } else {
            r = eb + j + u;
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
#pragma unroll
            for (int k = 0; k < KV; ++k) {
              if (c0 + k * G + lane_g < NV) V::add(acc[k], raw[u][k]);
            }
          }
        }
      }
    }
    flush(cur, !tail_open);
  }
}

// Pass 2: block w sums the partials of the segment that crosses the end of
// slice w and starts inside it, if there is one.
__global__ void __launch_bounds__(kCombineWarps * 32)
combine_pass(const int32_t* __restrict__ ids,
             const int32_t* __restrict__ count, int64_t E,
             int64_t num_segments, int64_t F,
             const float* __restrict__ scratch, float* __restrict__ out) {
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
        // its end: most segments end within 32 edges past b
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
        float* __restrict__ orow = out + t * F + 4 * v;
        const float sv[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (4 * v + i < F) orow[i] = sv[i];
        }
      }
    }
    __syncthreads();
  }
}

template <typename T, bool kVec, int KV, bool kGather>
cudaError_t launch_typed(const void* vals, const int32_t* src,
                         const int32_t* ids, const int32_t* count, int64_t E,
                         int64_t T_, int64_t F, int G, float* out,
                         float* scratch, cudaStream_t stream) {
  const int64_t slices = (E + kSlice - 1) / kSlice;
  const int64_t rows_per_block = kWarps * 32 * kRowGroups;
  const int64_t empty_blocks = (T_ + rows_per_block - 1) / rows_per_block;
  const int64_t per_block = kWarps * (32 / G);
  const int64_t slice_blocks = (slices + per_block - 1) / per_block;
  slice_pass<T, kVec, KV, kGather>
      <<<static_cast<unsigned>(slice_blocks + empty_blocks), kWarps * 32, 0,
         stream>>>(static_cast<const T*>(vals), src, ids, count, E, T_, F, G,
                   slice_blocks, out, scratch);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || slices == 0) return err;
  combine_pass<<<static_cast<unsigned>(slices), kCombineWarps * 32, 0,
                 stream>>>(ids, count, E, T_, F, scratch, out);
  return cudaGetLastError();
}

template <typename T, bool kVec, bool kGather>
cudaError_t launch_kv(int KV, const void* vals, const int32_t* src,
                      const int32_t* ids, const int32_t* count, int64_t E,
                      int64_t T_, int64_t F, int G, float* out,
                      float* scratch, cudaStream_t stream) {
  if (KV == 1) {
    return launch_typed<T, kVec, 1, kGather>(vals, src, ids, count, E, T_, F,
                                             G, out, scratch, stream);
  }
  if (KV == 2) {
    return launch_typed<T, kVec, 2, kGather>(vals, src, ids, count, E, T_, F,
                                             G, out, scratch, stream);
  }
  return launch_typed<T, kVec, 4, kGather>(vals, src, ids, count, E, T_, F, G,
                                           out, scratch, stream);
}

template <typename T, bool kGather>
cudaError_t launch_dtype(const void* vals, const int32_t* src,
                         const int32_t* ids, const int32_t* count, int64_t E,
                         int64_t T_, int64_t F, float* out, float* scratch,
                         cudaStream_t stream) {
  const bool vec = ((reinterpret_cast<uintptr_t>(vals) |
                     reinterpret_cast<uintptr_t>(out) |
                     static_cast<uintptr_t>(F * sizeof(T))) & 15) == 0;
  const int64_t VE = vec ? 16 / static_cast<int64_t>(sizeof(T)) : 1;
  const int64_t NV = F / VE;
  int G = 1;
  while (G < 32 && G < NV) G *= 2;
  const int64_t per_lane = (NV + G - 1) / G;
  const int KV = per_lane <= 1 ? 1 : (per_lane <= 2 ? 2 : 4);
  if (vec) {
    return launch_kv<T, true, kGather>(KV, vals, src, ids, count, E, T_, F, G,
                                       out, scratch, stream);
  }
  return launch_kv<T, false, kGather>(KV, vals, src, ids, count, E, T_, F, G,
                                      out, scratch, stream);
}

// dtype: 0 = float32 vals, 1 = bfloat16 vals. scratch must hold
// scratch_floats() floats.
inline int64_t scratch_floats(int64_t E, int64_t F) {
  return 2 * ((E + kSlice - 1) / kSlice) * ((F + 3) & ~int64_t{3});
}

template <bool kGather>
int segment_sum(const void* vals, int dtype, const void* src, const void* ids,
                const void* count, int64_t E, int64_t num_segments, int64_t F,
                void* out, void* scratch, int64_t scratch_len, void* stream) {
  if (num_segments <= 0 || F <= 0) return 0;
  if (E < 0 || scratch_len < scratch_floats(E, F)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* src_p = static_cast<const int32_t*>(src);
  const auto* ids_p = static_cast<const int32_t*>(ids);
  const auto* count_p = static_cast<const int32_t*>(count);
  auto* out_p = static_cast<float*>(out);
  auto* scratch_p = static_cast<float*>(scratch);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return static_cast<int>(launch_dtype<float, kGather>(
        vals, src_p, ids_p, count_p, E, num_segments, F, out_p, scratch_p,
        s));
  }
  if (dtype == 1) {
    return static_cast<int>(launch_dtype<__nv_bfloat16, kGather>(
        vals, src_p, ids_p, count_p, E, num_segments, F, out_p, scratch_p,
        s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace sptpu_seg
