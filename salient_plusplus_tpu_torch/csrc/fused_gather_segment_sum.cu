// Fused gather + sorted segment sum for Hopper (sm_90a), K2:
//
//     out[t, :] = sum over e < count with dst[e] == t of emb[src[e], :]
//                                                              (t < T)
//
// over dst nondecreasing on [0, count); edges at or past count, and ids
// >= T (padding), are dropped, and their src is never read, whatever it
// holds (in gsrc mode a pad src need not be a row of emb). count is read
// on the device and clamped to [0, E]. Accumulates in f32 and returns f32
// [T, F]. Row offsets are 64-bit (global src ids index a table of up to
// 12M rows).
//
// Replaces the TPU kernel salient_plusplus_tpu/ops/pallas_aggregate.py::
// _kernel (per 64-target tile: 1024-edge index chunks DMA'd to SMEM, a ring
// of 8 row DMAs from HBM, a loop-carried row accumulator flushed into the
// VMEM tile with a masked add when the target changes; tile_starts from a
// searchsorted over dst). The tiles, chunks and the ring are TPU devices;
// they are not carried over.
//
// Bound: memory. The function reads each distinct emb row of a real edge
// once (hub ids repeat), 8 bytes of ids per real edge, and writes 4 * T * F
// bytes; its E_real * F f32 adds are far under the card's f32 rate.
// Against gather + sorted segment sum it saves writing and reading back
// the [E, F] message tensor.
//
// Design: segment_common.cuh, shared with K1 (here row(e) = src[e]). The
// edges are cut into slices of kSlice = 64, one per worker of G lanes
// (16 lanes for a 256-byte bf16 row, two workers a warp), so the time does
// not follow the longest segment (a hub of layerwise inference holds
// 527,530 edges on the 1M-node bench graph); a worker loads G src and dst
// ids at a time and broadcasts them with __shfl_sync, each lane loads 16
// bytes of a row with 8 rows in flight; segments that cross a slice edge
// leave f32 partial rows in scratch (2 * ceil(E / 64) rows of
// round_up(F, 4) f32: 45 MB for the 2.8M-edge hub chunk at F = 128) that a
// second pass sums in a fixed order, a hub's thousands of partials over
// the 8 warps of one block; empty rows are written as zeros. No atomics:
// the same inputs give the same bits. A row is read once per edge, not
// once per distinct row: a hub's repeated rows come from L2 where they
// fit.
//
// Plain C interface, bound with ctypes (salient_plusplus_tpu_torch/ops/
// pallas_aggregate.py); launches both passes on the caller's stream and
// returns cudaGetLastError().

#include "segment_common.cuh"

extern "C" {

// dtype: 0 = float32 emb, 1 = bfloat16 emb. All pointers are device
// pointers to contiguous tensors (count: one int32); scratch holds
// scratch_len f32 (at least 2 * ceil(E / 64) * round_up(F, 4)); stream is
// a cudaStream_t.
int sptpu_fused_gather_segment_sum(const void* emb, int dtype,
                                   const void* src, const void* dst,
                                   const void* count, int64_t E,
                                   int64_t num_segments, int64_t F, void* out,
                                   void* scratch, int64_t scratch_len,
                                   void* stream) {
  return sptpu_seg::segment_sum<true>(emb, dtype, src, dst, count, E,
                                      num_segments, F, out, scratch,
                                      scratch_len, stream);
}

}  // extern "C"
