// The rank-3 banded interp (the binned level; csrc/interp.cu has the
// design): its own source so that its fifteen width instantiations
// compile beside interp.cu's.
#include "interp_rows.cuh"

// Rank-3 banded interp: tiles [num_tiles, B2, *ext], coords [6, slots],
// zorigins [num_chunks * subs]; out [num_chunks, B2, chunk] (only the
// chunks the tiles own are written). One channel per block (group 1).
// Returns the launch's CUDA error.
extern "C" int tnt_interp_banded(const void* tile_bounds,
                                 const void* zorigins, const void* tiles,
                                 const void* coords, void* out,
                                 const int* ip, const float* fp,
                                 void* stream) {
  const tnt::Geometry g = tnt::geometry_from(ip);
  const tnt::EsKernel k = tnt::es_from(ip, fp);
  const tnt::Band bd = tnt::band_from(ip);
  if (g.rank != 3 || bd.slab < 1 || bd.sublen < 1 || bd.run < 1 ||
      bd.band > g.e[0] || k.width < 2 || k.width > tnt::kMaxWidth)
    return (int)cudaErrorInvalidValue;
  return (int)interp_rows::launch(
      interp_rows::rank3_fn<true>(k.width), (const int*)tile_bounds,
      (const int*)zorigins, (const float*)tiles, (const float*)coords,
      nullptr, nullptr, (float*)out, g, k, bd, ip, (cudaStream_t)stream);
}
