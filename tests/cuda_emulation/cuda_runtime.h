// A stand-in for <cuda_runtime.h> that lets g++ compile
// cpecan_tpu_torch/csrc/wavefront.cu for the CPU, as rewritten by
// tests/test_torch_wavefront_emulated.py (which replaces the shared-memory
// declarations, the cp.async and prefetch helpers and the <<<...>>>
// launches with the emu_* calls below).
//
// A launch runs its blocks one after another, each as blockDim.x threads
// of the host (one std::thread per CUDA thread), with:
//  - __syncthreads() a barrier of the block's threads;
//  - __shfl_xor_sync() an exchange through a block buffer between two
//    barriers (every thread of the block calls it, as block_max and
//    block_sum do);
//  - the dynamic shared memory a block buffer filled with NaN, so that a
//    read of an entry no thread wrote shows in the outputs;
//  - cp.async copies queued per thread and done at the latest moment the
//    hardware may do them: cp.async.wait_group N completes every committed
//    group but the N newest, so a read that the kernel does not wait for
//    sees the slot's old contents;
//  - prefetches no-ops and atomicAdd a locked add.
// The float arithmetic is the host's (glibc's logf and expf): it equals
// another kernel's under the same emulation bit for bit where both take
// the same operations in the same order, and the plain PyTorch versions to
// within a few ulps.
#pragma once

#include <math.h>

#include <condition_variable>
#include <cstddef>
#include <deque>
#include <functional>
#include <mutex>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline

struct uint3 {
    unsigned x, y, z;
};

typedef void* cudaStream_t;
typedef int cudaError_t;
enum {
    cudaSuccess = 0,
    cudaErrorInvalidValue = 1,
    cudaFuncAttributeMaxDynamicSharedMemorySize = 8
};

inline const char* cudaGetErrorString(cudaError_t code) {
    return code == cudaSuccess ? "no error (emulated)"
                               : "invalid argument (emulated)";
}

inline cudaError_t cudaGetLastError() { return cudaSuccess; }

template <class F>
cudaError_t cudaFuncSetAttribute(F*, int, int) {
    return cudaSuccess;
}

inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }

// a reusable barrier of n threads
class EmuBarrier {
  public:
    explicit EmuBarrier(int n) : n_(n) {}
    void wait() {
        std::unique_lock<std::mutex> lock(m_);
        const unsigned gen = gen_;
        if (++count_ == n_) {
            count_ = 0;
            ++gen_;
            cv_.notify_all();
        } else {
            cv_.wait(lock, [&] { return gen_ != gen; });
        }
    }

  private:
    std::mutex m_;
    std::condition_variable cv_;
    int n_, count_ = 0;
    unsigned gen_ = 0;
};

struct EmuBlock {
    EmuBarrier barrier;
    std::vector<float> shared, xchg;
    EmuBlock(int threads, size_t smem_bytes)
        : barrier(threads),
          shared(smem_bytes / sizeof(float) + 1, NAN),
          xchg(threads) {}
};

struct EmuCopy {
    float* dst;
    const float* src;
};

inline thread_local uint3 threadIdx, blockIdx, blockDim;
inline thread_local EmuBlock* emu_block = nullptr;
inline thread_local std::vector<EmuCopy> emu_open;
inline thread_local std::deque<std::vector<EmuCopy>> emu_groups;
inline std::mutex emu_atomic_mutex;

inline float* emu_shared() { return emu_block->shared.data(); }

inline void __syncthreads() { emu_block->barrier.wait(); }

inline float __shfl_xor_sync(unsigned, float v, int lane_mask) {
    EmuBlock& b = *emu_block;
    b.xchg[threadIdx.x] = v;
    b.barrier.wait();
    const float out = b.xchg[threadIdx.x ^ lane_mask];
    b.barrier.wait();
    return out;
}

inline float atomicAdd(float* p, float v) {
    std::lock_guard<std::mutex> lock(emu_atomic_mutex);
    const float old = *p;
    *p = old + v;
    return old;
}

inline void emu_cp_async4(float* dst, const float* src) {
    emu_open.push_back({dst, src});
}

inline void emu_cp_async_commit() {
    emu_groups.push_back(std::move(emu_open));
    emu_open.clear();
}

inline void emu_cp_async_wait(size_t pending) {
    while (emu_groups.size() > pending) {
        for (const EmuCopy& c : emu_groups.front()) *c.dst = *c.src;
        emu_groups.pop_front();
    }
}

// kernel<<<grid, block, smem>>>(...): run ``body`` (the kernel call) on
// every thread of every block
inline void emu_launch(unsigned grid, unsigned block, size_t smem,
                       const std::function<void()>& body) {
    for (unsigned b = 0; b < grid; ++b) {
        EmuBlock blk(static_cast<int>(block), smem);
        std::vector<std::thread> threads;
        threads.reserve(block);
        for (unsigned t = 0; t < block; ++t) {
            threads.emplace_back([&, b, t] {
                threadIdx = {t, 0, 0};
                blockIdx = {b, 0, 0};
                blockDim = {block, 1, 1};
                emu_block = &blk;
                emu_open.clear();
                emu_groups.clear();
                body();
            });
        }
        for (std::thread& th : threads) th.join();
    }
}
