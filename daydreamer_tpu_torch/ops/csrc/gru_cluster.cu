// The cluster backward of gru.cu (deters past MAX_D), compiled beside it by
// an nvcc of its own and linked into the same library, so that the
// instantiations of the two halves build at once (ops/build.py, `parts`).

#define GRU_CLUSTER_PART
#include "gru.cu"
