// Row gather for Hopper (sm_90a):
//
//     out[i, :] = table[idx[i], :]      (i < n)
//
// for a 2-d table of any dtype: each row is copied as row_bytes bytes.
//
// Replaces the TPU kernel salient_plusplus_tpu/ops/pallas_gather.py::
// _gather_kernel (one program per 256-row block, double-buffered row DMAs
// from HBM into VMEM, addresses from scalar-prefetched indices). The block,
// the padding of idx to it and the DMA ring are TPU devices; they are not
// carried over. Here:
//
// - one warp owns one output row: it reads its index once (all lanes the
//   same address, a broadcast) and copies the row, lanes on neighbouring
//   16-byte words, so each row is one coalesced read and one coalesced
//   write. Many warps in flight keep many rows' reads outstanding, which
//   is what the TPU kernel's DMA ring did;
// - 16-byte vector loads and stores where row_bytes and both base pointers
//   are multiples of 16 (then every row is aligned); a byte loop otherwise.
//   Both paths are in the kernel; the test is uniform over the launch;
// - row offsets are 64-bit (idx * row_bytes overflows 32 bits at 12M rows
//   of 256 bytes).
//
// Bound: memory. The work reads n rows and n int32 ids and writes n rows:
// 2 * n * row_bytes + 4 * n bytes, no arithmetic. Later work: several rows
// per warp for narrow rows (a 256-byte bf16 row keeps 16 of 32 lanes busy).
//
// idx must lie in [0, N): callers clamp or pass real ids. Plain C
// interface, bound with ctypes (salient_plusplus_tpu_torch/ops/
// pallas_gather.py); launches on the caller's stream and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gather_rows_kernel(const char* __restrict__ table,
                   const int32_t* __restrict__ idx, int64_t n,
                   int64_t row_bytes, char* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (i >= n) return;
  const int64_t r = __ldg(idx + i);
  const char* __restrict__ src = table + r * row_bytes;
  char* __restrict__ dst = out + i * row_bytes;
  const bool vec16 = ((reinterpret_cast<uintptr_t>(table) |
                       reinterpret_cast<uintptr_t>(out) |
                       static_cast<uintptr_t>(row_bytes)) & 15) == 0;
  if (vec16) {
    const int4* __restrict__ s = reinterpret_cast<const int4*>(src);
    int4* __restrict__ d = reinterpret_cast<int4*>(dst);
    const int64_t words = row_bytes >> 4;
    for (int64_t k = lane; k < words; k += 32) d[k] = __ldg(s + k);
  } else {
    for (int64_t k = lane; k < row_bytes; k += 32) dst[k] = src[k];
  }
}

}  // namespace

extern "C" {

// All pointers are device pointers to contiguous tensors: table [N, *] of
// row_bytes bytes a row, idx int32 [n], out [n, *]; stream is a
// cudaStream_t.
int sptpu_gather_rows(const void* table, const void* idx, int64_t n,
                      int64_t row_bytes, void* out, void* stream) {
  if (n <= 0 || row_bytes <= 0) return 0;
  const int64_t blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  gather_rows_kernel<<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char*>(table), static_cast<const int32_t*>(idx), n,
      row_bytes, static_cast<char*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
