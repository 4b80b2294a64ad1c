// B2's earlier design at four blocks an SM, measured beside the kernel by
// tools/merkle_flag_forms.py --parent: the earlier design's merkle.cu (on
// the include path, from a tree of the commit before the redesign) with its
// __launch_bounds__(kThreads) read as __launch_bounds__(kThreads, 4), at
// most 64 registers a thread and four blocks an SM (-maxrregcount does not
// bind a kernel that has launch bounds). Not part of the program.

#include <cuda_runtime.h>

#undef __launch_bounds__
#define __launch_bounds__(threads, ...) __attribute__((launch_bounds(threads, 4)))

#include "merkle.cu"
