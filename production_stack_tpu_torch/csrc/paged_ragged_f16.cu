// The ragged kernels instantiated for f16 queries (every cache type
// and head-dim tile of PSTT_FOR_EACH_F16_GEOMETRY): see
// paged_ragged.cu.

#include "paged_ragged.cuh"

int pstt::ragged_launch_f16(const RaggedArgs& args, int cache_dtype) {
  PSTT_FOR_EACH_F16_GEOMETRY(PSTT_RAGGED_CASE)
  return cudaErrorInvalidValue;
}
