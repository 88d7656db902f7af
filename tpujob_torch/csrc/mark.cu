// Phase marks of the train step for Hopper (sm_90a): one one-thread kernel a
// boundary, whose name in a profiler's trace says which boundary it is.
//
// The marks stand in for the name stack that XLA gives every op of the JAX
// package's step, tpujob/workloads/train_lib.py:_step_body, in a TPU trace
// (the forward under jvp, the backward under transpose(jvp), the update
// after them).  On one card the port replays the whole step as one CUDA
// graph, whose kernels carry no host context; a mark launched between two
// phases is a node of that graph, so the kernels that start between two
// marks belong to the phase the second one closes
// (train_lib.PhaseMarks).  Two more bracket a dropless expert layer's work
// inside a phase (moe_in where it starts, moe_out where it ends, in the
// forward, remat's recompute and the backward alike).
//
// Bound on an H100 SXM: one 4-byte store a launch, so the launch itself, a
// few microseconds of device time (no bytes or operations to speak of).
//
// Each kernel writes its index into one device word the caller allocated
// once: a capture records the launch as a kernel node and allocates nothing
// in the graph's pool.  The names avoid every substring by which a trace's
// kernels are sorted into matrix products, convolutions and flash kernels.
#include <cuda_runtime.h>

#define TPUJOB_MARK(phase, index)                                 \
  extern "C" __global__ void tpujob_mark_##phase(int* word) {     \
    *word = index;                                                \
  }

TPUJOB_MARK(begin, 0)
TPUJOB_MARK(forward, 1)
TPUJOB_MARK(backward, 2)
TPUJOB_MARK(fold, 3)
TPUJOB_MARK(update, 4)
TPUJOB_MARK(moe_in, 5)
TPUJOB_MARK(moe_out, 6)

// Launch the mark of boundary `which` (the index above) on `stream`.
extern "C" int tpujob_mark(int which, void* word, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* w = static_cast<int*>(word);
  switch (which) {
    case 0: tpujob_mark_begin<<<1, 1, 0, s>>>(w); break;
    case 1: tpujob_mark_forward<<<1, 1, 0, s>>>(w); break;
    case 2: tpujob_mark_backward<<<1, 1, 0, s>>>(w); break;
    case 3: tpujob_mark_fold<<<1, 1, 0, s>>>(w); break;
    case 4: tpujob_mark_update<<<1, 1, 0, s>>>(w); break;
    case 5: tpujob_mark_moe_in<<<1, 1, 0, s>>>(w); break;
    case 6: tpujob_mark_moe_out<<<1, 1, 0, s>>>(w); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
