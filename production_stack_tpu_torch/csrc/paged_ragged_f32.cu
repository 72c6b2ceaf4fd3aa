// The ragged kernels instantiated for f32 queries (every cache type
// and head-dim tile of PSTT_FOR_EACH_F32_GEOMETRY): see
// paged_ragged.cu.

#include "paged_ragged.cuh"

int pstt::ragged_launch_f32(const RaggedArgs& args, int cache_dtype) {
  PSTT_FOR_EACH_F32_GEOMETRY(PSTT_RAGGED_CASE)
  return cudaErrorInvalidValue;
}
