// The decode kernels instantiated for bf16 queries (every cache type
// and head-dim tile of PSTT_FOR_EACH_BF16_GEOMETRY): see paged_decode.cu.

#include "paged_decode.cuh"

int pstt::decode_launch_bf16(const DecodeArgs& args, int cache_dtype) {
  PSTT_FOR_EACH_BF16_GEOMETRY(PSTT_DECODE_CASE)
  return cudaErrorInvalidValue;
}
