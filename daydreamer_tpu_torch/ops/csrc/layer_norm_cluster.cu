// The cluster backward of layer_norm.cu (rows past the plan), compiled
// beside it by an nvcc of its own and linked into the same library, so
// that the instantiations of the two halves build at once (ops/build.py,
// `parts`).

#define LAYER_NORM_CLUSTER_PART
#include "layer_norm.cu"
