// Interp (type-2 step 3) for NVIDIA Hopper: per-tile halo-padded blocks
// [num_tiles, B2, *ext] -> slot-order values [num_chunks, B2, chunk]
// (float32, rank 1, 2 or 3).
//
// Replaces four Pallas TPU kernels:
//   tensorflow_nufft_tpu/kernels/pallas_interp.py:_interp_kernel_resident_mats
//   and :_interp_kernel_mats (the rank-3 per-tile grid): precomputed
//     kernel windows (tnt_interp, planned);
//   tensorflow_nufft_tpu/kernels/pallas_interp.py:_interp_kernel
//     (unplanned, ranks 1-3: in-kernel Horner or exp/sqrt on the
//     two-float coordinates, es_window from the extended-tile origin).
//     Its deriv_axis flag, the backward kernel of the spread-only ops, is
//     the runtime EsKernel::deriv_axis: that axis's window holds phi'
//     (direct exp/sqrt, es_eval_deriv) and the other axes keep phi.
//     Planned windows never carry phi', as in the TPU path.
//   tensorflow_nufft_tpu/kernels/pallas_interp.py:_interp_kernel_banded
//     (the planned rank-3 binned level: z-ordered binning on a coarse
//     axis-0 geometry, sub-chunk j reading only the axis-0 rows
//     [zorigins[j], + band)); here kBanded (tnt_interp_banded, in
//     interp_banded.cu). The kernel itself is interp_rows.cuh's
//     interp_rows_kernel, instantiated by this source and that one,
//     which nvcc compiles side by side.
// The TPU's per-tile grid exists because VMEM cannot hold the whole tile
// array; Hopper's limit is a block's 227 KB, which one extended tile
// exceeds on many geometries (2D ext 308^2 at 150^2 modes, 3D (108, 108,
// 108) at 50^3), so no block holds a tile here: it stages axis-0 rows.
//
// Design. One thread block serves a piece of one chunk (up to 512
// consecutive slots, one thread each) for one channel: every slot of a
// chunk lies in one tile. Each thread forms its rank axis windows into
// registers (planned: loaded; unplanned: evaluated; banded: es_window_
// exact, axis 0 from its sub-chunk's band origin) and computes
//     rank 1: c = sum_i F[s0 + i] * w0[i]
//     rank 2: c = sum_i w0[i] * (sum_j w1[j] * F[s0 + i, s1 + j])
//     rank 3: c = sum_{i,j} (w0[i] * w1[j]) * (sum_k w2[k] * F[..]),
// the order of the TPU kernels' contractions (the last axis first, then
// the Khatri-Rao-folded leading axes), the rows i ascending. At rank 1
// (chunk_interp_values' sum(mats[0] * f), pallas_interp.py:56-57) a row
// is one cell: the block stages the span of its slots' windows on the
// tile's line (all 1032 cells, 4 KB, at the 1D headline) and each thread
// reads its w cells from shared memory in window order. The block
// stages the axis-0 rows its windows touch (the span of its slots' axis-0
// windows; banded, the union of its sub-chunks' bands: about 24 rows for
// 512 slots at the 3D binned headline against 16 for each 128-slot
// sub-chunk) in pieces of `slab` rows, double-buffered: for one channel a
// piece's rows are one contiguous range of the tile array, copied with
// 16-byte cp.async (4-byte where rows do not align) while the block
// contracts the piece before it. Two buffers of up to 8 rows let two
// blocks share an SM (110.6 KB at ext (136, 24, 72), 55 KB at (24, 24,
// 72)). Where two rows do not fit a block (a 3D plane above 113 KB: ext
// (188, 188, 188) at 90^3), the block reads the tile array in place
// through L1. The pieces ascend, so each slot's rows are summed in
// increasing order as in one pass: each slot has one owner and a fixed
// order, the result is bit-repeatable, and it equals the block-per-tile
// kernel this design replaced bit for bit. Padded slots have their
// window out of range and give exactly 0; blocks of chunks past
// tile_bounds[-1] exit at once, and those chunks are never written.
//
// What bounds it on the H100: width^rank shared-memory reads per slot and
// channel (49 at 2D, 343 at 3D, width 7) at scattered addresses, plus,
// unplanned, rank * width kernel evaluations per slot; global traffic is
// the tile rows each block stages (at the 3D headline all 24 rows of a
// tile for each of its 2.5 chunks and each channel: 166 KB a block, 0.86
// GB from L2 over the call), the windows or coords and the output. The
// kernel is instantiated per width at rank 3, so the window loops unroll
// and the windows stay in registers; the block-per-tile design before it
// held one 166 KB tile block per SM with the leading windows in local
// memory (PERF.md has the card times).
#include "interp_rows.cuh"

namespace {

using tnt::kMaxWidth;
using interp_rows::InterpFn;
using interp_rows::interp_rows_kernel;

// Rank 3 staged: one kernel per width; ranks 1 and 2 and the in-place
// reads: a bound on the width. A rank-1 line always stages
// (kernels/interp.py:piece_rows).
InterpFn interp_fn(int rank, bool staged, int width) {
  if (width < 2 || width > kMaxWidth) return nullptr;
  if (rank == 1) {
    if (!staged) return nullptr;
    return width <= 8 ? interp_rows_kernel<1, 8, false, true>
                      : interp_rows_kernel<1, kMaxWidth, false, true>;
  }
  if (rank == 3)
    return staged ? interp_rows::rank3_fn<false>(width)
                  : interp_rows_kernel<3, kMaxWidth, false, false>;
  if (!staged) return interp_rows_kernel<2, kMaxWidth, false, false>;
  return width <= 8 ? interp_rows_kernel<2, 8, false, true>
                    : interp_rows_kernel<2, kMaxWidth, false, true>;
}

}  // namespace

// planned != 0: weights/starts are the planned artifact and coords is
// unused; planned == 0: coords is the [2 * rank, slots] payload. tiles is
// [num_tiles, B2, *ext]; out is [num_chunks, B2, chunk] (only the chunks
// the tiles own are written). One channel per block (group 1). Returns
// the launch's CUDA error.
extern "C" int tnt_interp(int planned, const void* tile_bounds,
                          const void* tiles, const void* coords,
                          const void* weights, const void* starts,
                          void* out, const int* ip, const float* fp,
                          void* stream) {
  const tnt::Geometry g = tnt::geometry_from(ip);
  const tnt::EsKernel k = tnt::es_from(ip, fp);
  const tnt::Band bd = tnt::band_from(ip);
  if (g.rank < 1 || g.rank > 3) return (int)cudaErrorInvalidValue;
  return (int)interp_rows::launch(
      interp_fn(g.rank, bd.slab > 0, k.width), (const int*)tile_bounds,
      nullptr, (const float*)tiles, planned ? nullptr : (const float*)coords,
      planned ? (const float*)weights : nullptr, (const int*)starts,
      (float*)out, g, k, bd, ip, (cudaStream_t)stream);
}
