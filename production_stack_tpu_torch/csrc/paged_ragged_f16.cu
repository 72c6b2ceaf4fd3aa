// The ragged kernels instantiated for f16 queries on the mma.sync walks
// (every cache type, the head-dim tiles up to 128 and the slabs above
// 512: PSTT_FOR_EACH_F16_RAGGED_MMA); head dims 129 to 512 go to
// paged_ragged_wgmma_f16.cu's wgmma walk first. See paged_ragged.cu.

#include "paged_ragged.cuh"

int pstt::ragged_launch_f16(const RaggedArgs& args, int cache_dtype) {
  if (ragged_wgmma_head_dim(args.head_dim))
    return ragged_wgmma_launch_f16(args, cache_dtype);
  PSTT_FOR_EACH_F16_RAGGED_MMA(PSTT_RAGGED_CASE)
  return cudaErrorInvalidValue;
}
