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
// Design (ranks 2 and 3). One thread block serves a piece of one chunk
// (up to 512 consecutive slots, one thread each) for one channel: every
// slot of a chunk lies in one tile. Each thread forms its rank axis
// windows into registers (planned: loaded; unplanned: evaluated; banded:
// es_window_exact, axis 0 from its sub-chunk's band origin) and computes
//     rank 2: c = sum_i w0[i] * (sum_j w1[j] * F[s0 + i, s1 + j])
//     rank 3: c = sum_{i,j} (w0[i] * w1[j]) * (sum_k w2[k] * F[..]),
// the order of the TPU kernels' contractions (the last axis first, then
// the Khatri-Rao-folded leading axes), the rows i ascending. The block
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
//
// Rank 1 (chunk_interp_values' sum(mats[0] * f), pallas_interp.py:56-57)
// has its own kernel, interp_line_kernel, one per width 2-16 so the
// window loop unrolls to w. A block takes up to 8 consecutive units of a
// chunk's slots in turn (256 slots a unit at the 1D headline, one thread
// each), for every channel: the block stages its tile's line of each
// channel (1032 cells, 4 KB a channel, at the headline) by cp.async,
// every channel of the launch in one stage where they fit 113 KB, and
// stages it again only where its units reach the next tile (each tile's
// line is read from L2 about 3 times, not once per chunk: 20 chunks a
// tile at the headline); else groups of channels in two buffers, each
// group's copy overlapping the contraction of the one before. A unit's
// first copy starts before its windows are formed. Each thread forms
// its slot's window once, in registers (loaded where planned, else
// es_window, phi' on deriv_axis 0), and sums F[s0 + i] w0[i], i
// ascending, for each channel in turn: the order, and so the bits, of
// the kernel it replaced, which took one block a chunk and a channel,
// evaluated each window B2 times and staged the line once per chunk and
// channel. A line longer than half of 113 KB (ext 20258 at fine 20250) is
// staged one channel at a time in pieces. What bounds it on the H100:
// the window evaluation (n_horner steps per cell, 13 at tol 1e-6, width
// 7, taken for the window's cells in lockstep, es_eval_cells) and the
// scattered shared-memory reads, w per slot and channel; global traffic
// is the coords or windows, the output and the staged lines.
#include "interp_rows.cuh"

namespace {

using tnt::EsKernel;
using tnt::Geometry;
using tnt::kMaxWidth;
using interp_rows::InterpFn;
using interp_rows::interp_rows_kernel;
using interp_rows::kMaxSlotThreads;

// The rank-1 interp (source note above). Block: bd.run consecutive
// units of bd.sublen slots (units of one chunk, one slot a thread in
// each; threads past it only help stage), taken in turn, for every
// channel. The block stages its tile's line for a group of g.group
// channels at a time, in pieces of bd.slab cells (more than one piece
// only for one channel a group), each stage copied by cp.async while
// the block works on the one before it (two buffers of g.group * bd.slab
// floats; one where a single stage holds every channel's line, and then
// the block stages it again only where its units reach the next tile);
// a unit's first copy starts before its windows are formed. Each
// thread forms its slot's window once, kW = the width (ws: the planned
// artifact [slots][w]; else es_window from coords [2, slots], phi' where
// deriv_axis is 0), and sums F[s0 + i] w0[i], i ascending, per channel
// into out [num_chunks, B2, chunk]. Chunks past tile_bounds[-1] are not
// written (the wrapper zeroes out).
template <int kW>
__global__ void __launch_bounds__(kMaxSlotThreads)
    interp_line_kernel(const int* __restrict__ tile_bounds,
                       const float* __restrict__ tiles,
                       const float* __restrict__ coords,
                       const float* __restrict__ ws,
                       const int* __restrict__ st, float* __restrict__ out,
                       Geometry g, EsKernel k, tnt::Band bd) {
  extern __shared__ float4 line4[];
  const int nt = tnt::num_tiles(g);
  const int per = bd.sublen;
  const int units = g.chunk / per;  // a chunk's units
  const int used = tile_bounds[nt] * units;
  const int u0 = blockIdx.x * bd.run;
  if (u0 >= used) return;  // units of chunks no tile owns (uniform)
  const int u1 = min(u0 + bd.run, used);
  const int e0 = g.e[0], b2 = g.batch2;
  const int t = threadIdx.x;
  const int slab = bd.slab, group = g.group;
  const int pieces = (e0 + slab - 1) / slab;
  const int stages = (b2 + group - 1) / group * pieces;
  const bool vec = e0 % 4 == 0 && slab % 4 == 0 &&
                   reinterpret_cast<size_t>(tiles) % 16 == 0;
  const unsigned base =
      static_cast<unsigned>(__cvta_generic_to_shared(line4));
  // Stage s of tile `tile`: channels [c0, c0 + nc) of group s / pieces,
  // cells [r0, r0 + len) of piece s % pieces, into buffer s & 1
  // ([nc][slab]).
  auto copy_stage = [&](int tile, int s) {
    const int c0 = s / pieces * group, nc = min(group, b2 - c0);
    const int r0 = s % pieces * slab, len = min(slab, e0 - r0);
    const float* src = tiles + ((size_t)tile * b2 + c0) * e0 + r0;
    const unsigned dst = base + 4u * (unsigned)((s & 1) * group * slab);
    if (vec) {
      const int q = len / 4;
      for (int x = t; x < nc * q; x += blockDim.x) {
        const int c = x / q, i = 4 * (x - c * q);
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                         dst + 4u * (unsigned)(c * slab + i)),
                     "l"(src + (size_t)c * e0 + i));
      }
    } else {
      for (int x = t; x < nc * len; x += blockDim.x) {
        const int c = x / len, i = x - c * len;
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                         dst + 4u * (unsigned)(c * slab + i)),
                     "l"(src + (size_t)c * e0 + i));
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  const float* f = reinterpret_cast<const float*>(line4);
  const bool mine = t < per;
  int tile = tnt::owner_tile(tile_bounds, nt, u0 / units);
  int staged = -1;  // one stage: the tile whose lines shared memory holds
  for (int u = u0; u < u1; ++u) {
    const int kc = u / units;
    while (tile_bounds[tile + 1] <= kc) ++tile;  // uniform
    const bool fresh = stages > 1 || tile != staged;
    if (fresh) {
      if (stages == 1 && u > u0) __syncthreads();  // the old lines are read
      copy_stage(tile, 0);
    }
    const int slot = u * per + (mine ? t : 0);
    float w0[kW];
    int s0;
    if (ws != nullptr) {
      s0 = st[slot];
#pragma unroll
      for (int j = 0; j < kW; ++j) w0[j] = ws[(size_t)slot * kW + j];
    } else {
      float origin;
      tnt::tile_origins<1>(g, tile, &origin);
      s0 = tnt::es_window<kW>(coords[slot], coords[g.slots + slot], origin,
                              k, w0, k.deriv_axis == 0);
    }
    float* dst = out + (size_t)kc * b2 * g.chunk + (u - kc * units) * per + t;
    float acc = 0.0f;  // one channel's sum across pieces
    for (int s = 0; s < stages; ++s) {
      if (fresh) {
        if (s + 1 < stages) {
          copy_stage(tile, s + 1);
          interp_rows::wait_async<1>();
        } else {
          interp_rows::wait_async<0>();
        }
        __syncthreads();  // stage s is in shared memory
      }
      const int c0 = s / pieces * group, nc = min(group, b2 - c0);
      const int p = s % pieces;
      const int r0 = p * slab, len = min(slab, e0 - r0);
      const float* fb = f + (s & 1) * group * slab;
      for (int c = 0; c < nc; ++c) {
        float a = p > 0 ? acc : 0.0f;
#pragma unroll
        for (int i = 0; i < kW; ++i) {
          const int r = s0 + i - r0;  // padded slots: far out of range
          if ((unsigned)r < (unsigned)len)
            a = __fadd_rn(a, __fmul_rn(fb[c * slab + r], w0[i]));
        }
        acc = a;
        if (p == pieces - 1 && mine) dst[(size_t)(c0 + c) * g.chunk] = a;
      }
      if (stages > 1) __syncthreads();  // stage s is read before s + 2
    }
    staged = tile;
  }
}

using LineFn = void (*)(const int*, const float*, const float*, const float*,
                        const int*, float*, Geometry, EsKernel, tnt::Band);

template <int... kWs>
LineFn line_fn(int width, std::integer_sequence<int, kWs...>) {
  LineFn fn = nullptr;
  ((fn = width == kWs ? interp_line_kernel<kWs> : fn), ...);
  return fn;
}

// Launches the rank-1 interp on grid (units / run), units = slots /
// sublen, after checking the layout it takes; returns the CUDA error.
cudaError_t launch_line(const int* tile_bounds, const float* tiles,
                        const float* coords, const float* ws, const int* st,
                        float* out, const Geometry& g, const EsKernel& k,
                        const tnt::Band& bd, const int* ip, cudaStream_t s) {
  const LineFn fn = line_fn(
      k.width, std::integer_sequence<int, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11,
                                     12, 13, 14, 15, 16>{});
  const int per = bd.sublen;
  const int threads = ip[tnt::kThreads], smem = ip[tnt::kSmem];
  // More than one piece of the line only for one channel a group; two
  // buffers unless one stage holds every channel's line.
  const bool whole = bd.slab >= g.e[0];
  const int bufs = whole && g.group >= g.batch2 ? 1 : 2;
  if (fn == nullptr || per < 1 || g.chunk % per || bd.run < 1 ||
      threads != (per + 31) / 32 * 32 || threads > kMaxSlotThreads ||
      bd.slab < 1 || g.group < 1 || (!whole && g.group != 1) ||
      smem != bufs * g.group * bd.slab * 4)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int units = g.slots / per;
  fn<<<(units + bd.run - 1) / bd.run, threads, smem, s>>>(
      tile_bounds, tiles, coords, ws, st, out, g, k, bd);
  return cudaGetLastError();
}

// Ranks 2 and 3. Rank 3 staged: one kernel per width; rank 2 and the
// in-place reads: a bound on the width.
InterpFn interp_fn(int rank, bool staged, int width) {
  if (width < 2 || width > kMaxWidth) return nullptr;
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
// the tiles own are written). Rank 1: every channel in one block, in
// groups of g.group (interp_line_kernel); ranks 2 and 3: one channel a
// block (group 1). Returns the launch's CUDA error.
extern "C" int tnt_interp(int planned, const void* tile_bounds,
                          const void* tiles, const void* coords,
                          const void* weights, const void* starts,
                          void* out, const int* ip, const float* fp,
                          void* stream) {
  const tnt::Geometry g = tnt::geometry_from(ip);
  const tnt::EsKernel k = tnt::es_from(ip, fp);
  const tnt::Band bd = tnt::band_from(ip);
  if (g.rank == 1)
    return (int)launch_line(
        (const int*)tile_bounds, (const float*)tiles,
        planned ? nullptr : (const float*)coords,
        planned ? (const float*)weights : nullptr,
        planned ? (const int*)starts : nullptr, (float*)out, g, k, bd, ip,
        (cudaStream_t)stream);
  if (g.rank < 2 || g.rank > 3) return (int)cudaErrorInvalidValue;
  return (int)interp_rows::launch(
      interp_fn(g.rank, bd.slab > 0, k.width), (const int*)tile_bounds,
      nullptr, (const float*)tiles, planned ? nullptr : (const float*)coords,
      planned ? (const float*)weights : nullptr, (const int*)starts,
      (float*)out, g, k, bd, ip, (cudaStream_t)stream);
}
