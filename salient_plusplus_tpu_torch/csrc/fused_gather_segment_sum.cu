// Fused gather + sorted segment sum for Hopper (sm_90a):
//
//     out[t, :] = sum over e < count with dst[e] == t of emb[src[e], :]
//                                                              (t < T)
//
// over dst nondecreasing on [0, count); edges at or past count, and ids
// >= T (padding), are dropped, and their src is never read, whatever it
// holds (in gsrc mode a pad src need not be a row of emb). count is read
// on the device. Accumulates in f32 and returns f32 [T, F].
//
// Replaces the TPU kernel salient_plusplus_tpu/ops/pallas_aggregate.py::
// _kernel (per 64-target tile: 1024-edge index chunks DMA'd to SMEM, a ring
// of 8 row DMAs from HBM, a loop-carried row accumulator flushed into the
// VMEM tile with a masked add when the target changes; tile_starts from a
// searchsorted over dst). The tiles, chunks and the ring are TPU devices;
// they are not carried over. Here, as in sorted_segment_sum.cu:
//
// - one warp owns one target row t. Its edge range [e0, e1) is found by
//   two binary searches over dst[0, count) (lower_bound(t),
//   lower_bound(t + 1)), so pads and everything past count drop out;
// - the warp loads 32 src ids of its range at a time, one per lane, and
//   broadcasts them with __shfl_sync; for each, lanes on neighbouring
//   columns read emb[src] straight from the table (coalesced), into CH f32
//   accumulators per lane; columns beyond 32 * CH take further passes;
// - it writes the row once. Empty rows write zeros, so the output may come
//   from torch.empty. No atomics: the result is deterministic;
// - row offsets are 64-bit (global src ids index a table of up to 12M rows).
//
// Bound: memory. The work reads each real edge's emb row once
// (E_real * F * sizeof(emb)), its src and dst ids (8 * E_real) and writes
// 4 * T * F bytes; the f32 adds are E_real * F, far under the card's f32
// rate. Against gather + sorted segment sum it saves writing and reading
// back the [E, F] message tensor. Later work: 16-byte vector loads,
// splitting hub rows across warps, async copies of the next rows.
//
// Plain C interface, bound with ctypes (salient_plusplus_tpu_torch/ops/
// pallas_aggregate.py); launches on the caller's stream and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kCH = 8;  // columns per lane per pass: 256 columns a pass

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ int64_t lower_bound(const int32_t* __restrict__ ids,
                                               int64_t n, int64_t key) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (static_cast<int64_t>(__ldg(ids + mid)) < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
fused_gather_segment_sum_kernel(const T* __restrict__ emb,
                                const int32_t* __restrict__ src,
                                const int32_t* __restrict__ dst,
                                const int32_t* __restrict__ count, int64_t E,
                                int64_t num_segments, int64_t F,
                                float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t t =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (t >= num_segments) return;  // uniform over the warp
  const int64_t cnt = __ldg(count);
  const int64_t n = cnt < 0 ? 0 : (cnt < E ? cnt : E);
  // every lane searches the same addresses: broadcast loads
  const int64_t e0 = lower_bound(dst, n, t);
  const int64_t e1 = lower_bound(dst, n, t + 1);
  float* __restrict__ orow = out + t * F;
  for (int64_t c0 = 0; c0 < F; c0 += 32 * kCH) {
    float acc[kCH];
#pragma unroll
    for (int k = 0; k < kCH; ++k) acc[k] = 0.f;
    for (int64_t eb = e0; eb < e1; eb += 32) {
      const int32_t mine = eb + lane < e1 ? __ldg(src + eb + lane) : 0;
      const int m = e1 - eb < 32 ? static_cast<int>(e1 - eb) : 32;
      for (int j = 0; j < m; ++j) {
        const int64_t s = __shfl_sync(0xffffffffu, mine, j);
        const T* __restrict__ row = emb + s * F + c0 + lane;
#pragma unroll
        for (int k = 0; k < kCH; ++k) {
          if (c0 + lane + 32 * k < F) acc[k] += to_f32(row[32 * k]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kCH; ++k) {
      const int64_t c = c0 + lane + 32 * k;
      if (c < F) orow[c] = acc[k];
    }
  }
}

template <typename T>
cudaError_t launch(const void* emb, const int32_t* src, const int32_t* dst,
                   const int32_t* count, int64_t E, int64_t num_segments,
                   int64_t F, float* out, cudaStream_t stream) {
  const int64_t blocks = (num_segments + kWarpsPerBlock - 1) / kWarpsPerBlock;
  fused_gather_segment_sum_kernel<T><<<static_cast<unsigned>(blocks),
                                        kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(emb), src, dst, count, E, num_segments, F, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32 emb, 1 = bfloat16 emb. All pointers are device
// pointers to contiguous tensors (count: one int32); stream is a
// cudaStream_t.
int sptpu_fused_gather_segment_sum(const void* emb, int dtype,
                                   const void* src, const void* dst,
                                   const void* count, int64_t E,
                                   int64_t num_segments, int64_t F, void* out,
                                   void* stream) {
  if (num_segments <= 0 || F <= 0) return 0;
  const auto* src_p = static_cast<const int32_t*>(src);
  const auto* dst_p = static_cast<const int32_t*>(dst);
  const auto* count_p = static_cast<const int32_t*>(count);
  auto* out_p = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return static_cast<int>(launch<float>(emb, src_p, dst_p, count_p, E,
                                          num_segments, F, out_p, s));
  }
  if (dtype == 1) {
    return static_cast<int>(launch<__nv_bfloat16>(
        emb, src_p, dst_p, count_p, E, num_segments, F, out_p, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
