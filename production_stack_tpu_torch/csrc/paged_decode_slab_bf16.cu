// The decode kernels' slab walk (head dims above 256, see
// paged_kv_common.cuh) for bf16 queries over a cache of their type and
// over int8, in a source of its own so that it compiles beside the
// tile kernels of paged_decode_bf16.cu: see paged_decode.cu.

#include "paged_decode.cuh"

PSTT_DECODE_SLAB_LAUNCH(__nv_bfloat16, __nv_bfloat16)
PSTT_DECODE_SLAB_LAUNCH(__nv_bfloat16, int8_t)
