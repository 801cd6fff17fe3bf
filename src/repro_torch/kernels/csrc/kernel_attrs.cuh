// Register and shared-memory use of a library's kernels, as the runtime
// reports them (cudaFuncGetAttributes), for the logs of a card run.
#pragma once
#include <cuda_runtime.h>

struct KernelEntry {
  const char* name;
  const void* fn;
};

// Entry i of table: writes {registers a thread, static shared bytes,
// largest dynamic shared bytes the launches have allowed, local (spill)
// bytes a thread} to out and the entry's name to *name.  Returns 0, the
// CUDA error of the query, or -1 when i is past the last entry.
inline int kernel_attrs(const KernelEntry* table, int n, int i, int* out,
                        const char** name) {
  if (i < 0 || i >= n) return -1;
  cudaFuncAttributes fa;
  const cudaError_t err = cudaFuncGetAttributes(&fa, table[i].fn);
  if (err != cudaSuccess) return (int)err;
  out[0] = fa.numRegs;
  out[1] = (int)fa.sharedSizeBytes;
  out[2] = fa.maxDynamicSharedSizeBytes;
  out[3] = (int)fa.localSizeBytes;
  *name = table[i].name;
  return 0;
}
