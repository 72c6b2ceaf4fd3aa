// The ragged kernel's bf16 forms on the wgmma walk (paged_walk_wgmma.cuh
// with WgRaggedTiles): the wide form at the widths of
// PSTT_FOR_EACH_WG_WIDTH (head dims 257 to 512), then the tile 256 (129
// to 256), over a cache of the query's type and int8. A source of its
// own, so that the build compiles it beside the others and its launches
// take tiles from its own scheduler (wg_next_tile); see paged_ragged.cu.

#include "paged_ragged.cuh"

int pstt::ragged_wgmma_launch_bf16(const RaggedArgs& args, int cache_dtype) {
  PSTT_FOR_EACH_BF16_RAGGED_WG(PSTT_RAGGED_WG_CASE)
  return cudaErrorInvalidValue;
}
