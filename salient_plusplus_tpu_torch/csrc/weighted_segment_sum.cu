// Weighted fused gather + sorted segment sum for Hopper (sm_90a), GAT's
// attention-weighted message sum:
//
//     out[t, h * C + c] = sum over e < count with dst[e] == t of
//                         att[e, h] * xs[src[e], h * C + c]       (t < T)
//
// xs [N, H * C] (bf16 or f32), att [E, H] f32, over dst nondecreasing on
// [0, count); edges at or past count, and ids >= T (padding), are dropped,
// and neither their src nor their weight is read. The f32 weight multiplies
// the row converted to f32 and the products are summed in f32; f32 [T,
// H * C] out. Row offsets are 64-bit.
//
// Replaces no TPU kernel: the JAX package (and the port before it) gathers
// the [E, H * C] messages xs[src], scales them by the broadcast attention
// into a second [E, H * C] tensor, and sums that by target with the sorted
// segment sum (K1). Here nothing [E, H * C]-wide is written: each row is
// read straight from xs, scaled in registers and summed.
//
// Bound: memory. The call reads each real edge's xs row (a row of a hub's
// repeated src comes from L2 where it fits), 12 bytes of ids and weight a
// real edge, and writes 4 * T * H * C bytes; its 2 f32 operations an
// element of a real row are far under the card's f32 rate.
//
// Design: K2's (segment_common.cuh), with a weight. The edges are cut into
// slices of kSlice = 64, one per worker of G lanes (32 lanes for a 512-byte
// bf16 row of 256 columns). A worker loads G dst ids, src ids and, with one
// head, f32 weights at a time, one per lane, and broadcasts them with
// __shfl_sync; each lane loads 16 bytes of a row with 8 rows in flight and
// adds weight * row into f32 registers. With H > 1 heads each element takes
// the weight of its head (column / C), read per edge from att. Segments that
// cross a slice edge leave f32 partial rows in scratch that segment_common's
// combine_pass sums in a fixed order; empty rows are written as zeros. No
// atomics: the same inputs give the same bits.
//
// The single-head slice pass is weighted_slice_pass<T, kVec, KV, false>.
//
// Plain C interface, bound with ctypes (salient_plusplus_tpu_torch/ops/
// weighted_segment.py); launches both passes on the caller's stream and
// returns cudaGetLastError().

#include "segment_common.cuh"

namespace sptpu_seg {

// The VE elements of one loaded vector as f32 (the loads of Vec<T, kVec>).
__device__ __forceinline__ void unpack(const float4& r, float* f) {
  f[0] = r.x; f[1] = r.y; f[2] = r.z; f[3] = r.w;
}
__device__ __forceinline__ void unpack(const int4& r, float* f) {
  const auto* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}
__device__ __forceinline__ void unpack(const float& r, float* f) { f[0] = r; }
__device__ __forceinline__ void unpack(const unsigned short& r, float* f) {
  f[0] = __bfloat162float(__ushort_as_bfloat16(r));
}

// Pass 1, as segment_common's slice_pass with kGather, each row scaled by
// its edge's weight (kMultiHead: each element by its head's weight).
template <typename T, bool kVec, int KV, bool kMultiHead>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
weighted_slice_pass(const T* __restrict__ vals, const float* __restrict__ att,
                    const int32_t* __restrict__ src,
                    const int32_t* __restrict__ ids,
                    const int32_t* __restrict__ count, int64_t E,
                    int64_t num_segments, int64_t F, int64_t H, int64_t C,
                    int G, int64_t slice_blocks, float* __restrict__ out,
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
    // kMultiHead: the head of each element this lane sums in this pass
    int32_t hd[kMultiHead ? KV : 1][kMultiHead ? VE : 1];
    if constexpr (kMultiHead) {
#pragma unroll
      for (int k = 0; k < KV; ++k)
#pragma unroll
        for (int i = 0; i < VE; ++i) {
          const int64_t col = (c0 + k * G + lane_g) * VE + i;
          hd[k][i] = static_cast<int32_t>(col < F ? col / C : 0);
        }
    }

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

    // the ids, src ids (and weights) of the next G edges load while this
    // G's rows do
    int32_t next_id = 0, next_src = 0;
    float next_w = 0.f;
    auto fetch = [&](int64_t eb) {
      if (eb + lane_g < b) {
        next_id = __ldg(ids + eb + lane_g);
        next_src = __ldg(src + eb + lane_g);
        if constexpr (!kMultiHead) next_w = __ldg(att + eb + lane_g);
      }
    };
    fetch(a);
    int32_t cur = head;
    for (int64_t eb = a; eb < b; eb += G) {
      const int m = b - eb < G ? static_cast<int>(b - eb) : G;
      const int32_t my_id = next_id, my_src = next_src;
      const float my_w = next_w;
      fetch(eb + G);
      for (int j = 0; j < m; j += U) {
        typename V::Raw raw[U][KV];
        int32_t d[U];
        float wt[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          d[u] = __shfl_sync(gmask, my_id, j + u, G);
          const int64_t r = __shfl_sync(gmask, my_src, j + u, G);
          wt[u] = __shfl_sync(gmask, my_w, j + u, G);
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
            const float* __restrict__ we = att + (eb + j + u) * H;
#pragma unroll
            for (int k = 0; k < KV; ++k) {
              if (c0 + k * G + lane_g < NV) {
                float f[VE];
                unpack(raw[u][k], f);
#pragma unroll
                for (int i = 0; i < VE; ++i) {
                  float wi = wt[u];
                  if constexpr (kMultiHead) wi = __ldg(we + hd[k][i]);
                  acc[k][i] = fmaf(wi, f[i], acc[k][i]);
                }
              }
            }
          }
        }
      }
    }
    flush(cur, !tail_open);
  }
}

template <typename T, bool kVec, int KV, bool kMultiHead>
cudaError_t weighted_launch_typed(const void* vals, const float* att,
                                  const int32_t* src, const int32_t* ids,
                                  const int32_t* count, int64_t E,
                                  int64_t T_, int64_t H, int64_t C, int G,
                                  float* out, float* scratch,
                                  cudaStream_t stream) {
  const int64_t F = H * C;
  const int64_t slices = (E + kSlice - 1) / kSlice;
  const int64_t rows_per_block = kWarps * 32 * kRowGroups;
  const int64_t empty_blocks = (T_ + rows_per_block - 1) / rows_per_block;
  const int64_t per_block = kWarps * (32 / G);
  const int64_t slice_blocks = (slices + per_block - 1) / per_block;
  weighted_slice_pass<T, kVec, KV, kMultiHead>
      <<<static_cast<unsigned>(slice_blocks + empty_blocks), kWarps * 32, 0,
         stream>>>(static_cast<const T*>(vals), att, src, ids, count, E, T_,
                   F, H, C, G, slice_blocks, out, scratch);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || slices == 0) return err;
  combine_pass<<<static_cast<unsigned>(slices), kCombineWarps * 32, 0,
                 stream>>>(ids, count, E, T_, F, scratch, out);
  return cudaGetLastError();
}

template <typename T, bool kVec, bool kMultiHead>
cudaError_t weighted_launch_kv(int KV, const void* vals, const float* att,
                               const int32_t* src, const int32_t* ids,
                               const int32_t* count, int64_t E, int64_t T_,
                               int64_t H, int64_t C, int G, float* out,
                               float* scratch, cudaStream_t stream) {
  if (KV == 1) {
    return weighted_launch_typed<T, kVec, 1, kMultiHead>(
        vals, att, src, ids, count, E, T_, H, C, G, out, scratch, stream);
  }
  if (KV == 2) {
    return weighted_launch_typed<T, kVec, 2, kMultiHead>(
        vals, att, src, ids, count, E, T_, H, C, G, out, scratch, stream);
  }
  return weighted_launch_typed<T, kVec, 4, kMultiHead>(
      vals, att, src, ids, count, E, T_, H, C, G, out, scratch, stream);
}

// The vector width and lane count as segment_common's launch_dtype picks
// them; one head or several from H.
template <typename T>
cudaError_t weighted_launch_dtype(const void* vals, const float* att,
                                  const int32_t* src, const int32_t* ids,
                                  const int32_t* count, int64_t E,
                                  int64_t T_, int64_t H, int64_t C,
                                  float* out, float* scratch,
                                  cudaStream_t stream) {
  const int64_t F = H * C;
  const bool vec = ((reinterpret_cast<uintptr_t>(vals) |
                     reinterpret_cast<uintptr_t>(out) |
                     static_cast<uintptr_t>(F * sizeof(T))) & 15) == 0;
  const int64_t VE = vec ? 16 / static_cast<int64_t>(sizeof(T)) : 1;
  const int64_t NV = F / VE;
  int G = 1;
  while (G < 32 && G < NV) G *= 2;
  const int64_t per_lane = (NV + G - 1) / G;
  const int KV = per_lane <= 1 ? 1 : (per_lane <= 2 ? 2 : 4);
  if (H == 1) {
    if (vec) {
      return weighted_launch_kv<T, true, false>(KV, vals, att, src, ids,
                                                count, E, T_, H, C, G, out,
                                                scratch, stream);
    }
    return weighted_launch_kv<T, false, false>(KV, vals, att, src, ids,
                                               count, E, T_, H, C, G, out,
                                               scratch, stream);
  }
  if (vec) {
    return weighted_launch_kv<T, true, true>(KV, vals, att, src, ids, count,
                                             E, T_, H, C, G, out, scratch,
                                             stream);
  }
  return weighted_launch_kv<T, false, true>(KV, vals, att, src, ids, count,
                                            E, T_, H, C, G, out, scratch,
                                            stream);
}

}  // namespace sptpu_seg

extern "C" {

// dtype: 0 = float32 xs, 1 = bfloat16 xs. All pointers are device pointers
// to contiguous tensors (xs [N, H * C], att [E, H] float32, src and dst [E]
// int32, count one int32); scratch holds scratch_len f32 (at least
// 2 * ceil(E / 64) * round_up(H * C, 4)); stream is a cudaStream_t.
int sptpu_weighted_segment_sum(const void* xs, int dtype, const void* att,
                               const void* src, const void* dst,
                               const void* count, int64_t E,
                               int64_t num_segments, int64_t H, int64_t C,
                               void* out, void* scratch, int64_t scratch_len,
                               void* stream) {
  using namespace sptpu_seg;
  const int64_t F = H * C;
  if (num_segments <= 0 || F <= 0) return 0;
  if (E < 0 || H <= 0 || scratch_len < scratch_floats(E, F)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* att_p = static_cast<const float*>(att);
  const auto* src_p = static_cast<const int32_t*>(src);
  const auto* ids_p = static_cast<const int32_t*>(dst);
  const auto* count_p = static_cast<const int32_t*>(count);
  auto* out_p = static_cast<float*>(out);
  auto* scratch_p = static_cast<float*>(scratch);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return static_cast<int>(weighted_launch_dtype<float>(
        xs, att_p, src_p, ids_p, count_p, E, num_segments, H, C, out_p,
        scratch_p, s));
  }
  if (dtype == 1) {
    return static_cast<int>(weighted_launch_dtype<__nv_bfloat16>(
        xs, att_p, src_p, ids_p, count_p, E, num_segments, H, C, out_p,
        scratch_p, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
