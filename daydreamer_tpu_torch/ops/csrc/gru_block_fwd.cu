// The block forward of gru.cu (deters past MAX_D), compiled beside it by an
// nvcc of its own and linked into the same library, so that the
// instantiations of the three parts build at once (ops/build.py, `parts`).

#define GRU_BLOCK_FWD_PART
#include "gru.cu"
