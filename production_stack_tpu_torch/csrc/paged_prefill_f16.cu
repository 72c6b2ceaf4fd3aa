// The chunked-prefill kernels instantiated for f16 queries (every
// cache type and head-dim tile of PSTT_FOR_EACH_F16_GEOMETRY, and
// the wgmma walk's wide form at PSTT_FOR_EACH_F16_WIDE): see
// paged_prefill.cu.

#include "paged_prefill.cuh"

int pstt::prefill_launch_f16(const PrefillArgs& args, int cache_dtype) {
  PSTT_FOR_EACH_F16_WIDE(PSTT_PREFILL_WIDE_CASE)
  PSTT_FOR_EACH_F16_GEOMETRY(PSTT_PREFILL_CASE)
  return cudaErrorInvalidValue;
}
