// The chunked-prefill kernels instantiated for f32 queries (every
// cache type and head-dim tile of PSTT_FOR_EACH_F32_GEOMETRY): see
// paged_prefill.cu.

#include "paged_prefill.cuh"

int pstt::prefill_launch_f32(const PrefillArgs& args, int cache_dtype) {
  PSTT_FOR_EACH_F32_GEOMETRY(PSTT_PREFILL_CASE)
  return cudaErrorInvalidValue;
}
