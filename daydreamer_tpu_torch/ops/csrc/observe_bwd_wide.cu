// The wide path of observe_bwd.cu (more prior layers than MAXL, none, or
// vectors past shared memory), compiled beside it by an nvcc of its own
// and linked into the same library, so that the two halves of the
// kernel's instantiations build at once (ops/build.py, `parts`).

#define OBSERVE_BWD_WIDE
#include "observe_bwd.cu"
