// Opting a kernel into more than 48 KB of shared memory.
//
// Above 48 KB in all, static and dynamic, a launch must be preceded by
// cudaFuncSetAttribute(MaxDynamicSharedMemorySize).  That host call costs
// microseconds, so each launch site keeps what it has set, per device, and
// sets it again only to grow.
#pragma once
#include <cuda_runtime.h>
#include <cstddef>

namespace sa {

struct SmemOptIn {
    static constexpr int MAX_DEVICES = 64;
    int allowed[MAX_DEVICES] = {};  // dynamic bytes opted into, per device

    template <typename Kernel>
    cudaError_t allow(Kernel kernel, size_t total, size_t dynamic) {
        if (total <= 48 * 1024) return cudaSuccess;
        int dev = 0;
        cudaError_t e = cudaGetDevice(&dev);
        if (e != cudaSuccess) return e;
        const int bytes = static_cast<int>(dynamic);
        if (dev < MAX_DEVICES && allowed[dev] >= bytes) return cudaSuccess;
        e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 bytes);
        if (e == cudaSuccess && dev < MAX_DEVICES) allowed[dev] = bytes;
        return e;
    }
};

}  // namespace sa
