// Sorted segment sum for Hopper (sm_90a), K1:
//
//     out[t, :] = sum over e with ids[e] == t of vals[e, :]     (t < T)
//
// over a nondecreasing ids[E]; every id >= T (padding, which may lie far
// above T) is dropped, and rows of vals past the last real id are never
// read, whatever they hold. Accumulates in f32 and returns f32 [T, F].
//
// Replaces the TPU kernel salient_plusplus_tpu/ops/mxu_segment.py::
// _segment_kernel (a one-hot MXU matmul over 512-edge DMA chunks and
// 128-target tiles). That design answers the TPU's lack of a fast
// scatter; it is not carried over.
//
// Bound: memory. The function reads each real edge's vals row once and its
// id (E_real * F * sizeof(vals) + 4 * E_real bytes) and writes 4 * T * F
// bytes; its E_real * F f32 adds are far under the card's f32 rate.
//
// Design: segment_common.cuh, shared with K2 (here row(e) = e). The edges
// are cut into slices of kSlice = 64, one per worker of G lanes, so the
// time does not follow the longest segment (the mirrored backward's hubs
// reach thousands of edges); each lane loads 16 bytes of a row at a time
// with 8 rows in flight; segments that cross a slice edge leave f32
// partial rows in scratch (2 * ceil(E / 64) rows of round_up(F, 4) f32,
// 2 KB per slice at F = 256) that a second pass sums in a fixed order;
// empty rows are written as zeros. No atomics: the same inputs give the
// same bits. Against the bound it adds the partial rows' write and read
// (two f32 rows per 64 edges at most) and the id searches.
//
// Plain C interface, bound with ctypes (salient_plusplus_tpu_torch/ops/
// sorted_segment.py); launches both passes on the caller's stream and
// returns cudaGetLastError().

#include "segment_common.cuh"

extern "C" {

// dtype: 0 = float32 vals, 1 = bfloat16 vals. All pointers are device
// pointers to contiguous tensors; scratch holds scratch_len f32 (at least
// 2 * ceil(E / 64) * round_up(F, 4)); stream is a cudaStream_t.
int sptpu_sorted_segment_sum(const void* vals, int dtype, const void* ids,
                             int64_t E, int64_t num_segments, int64_t F,
                             void* out, void* scratch, int64_t scratch_len,
                             void* stream) {
  return sptpu_seg::segment_sum<false>(vals, dtype, nullptr, ids, nullptr, E,
                                       num_segments, F, out, scratch,
                                       scratch_len, stream);
}

}  // extern "C"
