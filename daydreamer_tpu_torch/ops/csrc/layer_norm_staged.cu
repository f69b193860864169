// The staged forward of layer_norm.cu (rows past the plan), compiled
// beside it by an nvcc of its own and linked into the same library, as
// layer_norm_cluster.cu is (ops/build.py, `parts`).

#define LAYER_NORM_STAGED_PART
#include "layer_norm.cu"
