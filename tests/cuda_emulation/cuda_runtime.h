// A stand-in for <cuda_runtime.h> that lets g++ compile
// cpecan_tpu_torch/csrc/wavefront.cu for the CPU, as rewritten by
// tests/test_torch_wavefront_emulated.py (which replaces the shared-memory
// declarations, the cp.async and prefetch helpers and the <<<...>>>
// launches with the emu_* calls below).
//
// A launch runs its blocks one after another, each as blockDim.x fibers
// (ucontext, one per CUDA thread) that take turns on the calling host
// thread, with:
//  - __syncthreads() a barrier of the block's threads: a thread's turn
//    ends there, and the next phase starts once every thread has reached
//    it (or returned); the turns go up the lanes in one phase and down
//    them in the next, so that a read of another lane's entry that no
//    barrier orders sees its old contents in one of the two;
//  - __shfl_xor_sync() an exchange through a block buffer between two
//    barriers (every thread of the block calls it, as block_max and
//    block_sum do);
//  - the dynamic shared memory a block buffer filled with NaN, so that a
//    read of an entry no thread wrote shows in the outputs;
//  - cp.async copies queued per thread and done at the latest moment the
//    hardware may do them: cp.async.wait_group N completes every committed
//    group but the N newest, so a read that the kernel does not wait for
//    sees the slot's old contents;
//  - prefetches no-ops and atomicAdd a plain add (one host thread runs the
//    block).
// The float arithmetic is the host's (glibc's logf and expf): it equals
// another kernel's under the same emulation bit for bit where both take
// the same operations in the same order, and the plain PyTorch versions to
// within a few ulps.  No host thread waits on another: a barrier is a
// context switch, so the run's time does not depend on how busy the
// host's cores are.
#pragma once

#include <math.h>
#include <ucontext.h>

#include <cstddef>
#include <deque>
#include <functional>
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

struct EmuCopy {
    float* dst;
    const float* src;
};

// one CUDA thread: its context and stack, and its cp.async queue (the
// open group and the committed ones, oldest first)
struct EmuFiber {
    ucontext_t ctx;
    std::vector<char> stack;
    unsigned tid = 0;
    bool done = false;
    std::vector<EmuCopy> open;
    std::deque<std::vector<EmuCopy>> groups;
};

struct EmuBlock {
    std::vector<float> shared, xchg;
    EmuBlock(int threads, size_t smem_bytes)
        : shared(smem_bytes / sizeof(float) + 1, NAN), xchg(threads) {}
};

// the running thread's coordinates, block, fiber and body, and the
// scheduler's context (set before each switch to a fiber)
inline thread_local uint3 threadIdx, blockIdx, blockDim;
inline thread_local EmuBlock* emu_block = nullptr;
inline thread_local EmuFiber* emu_fiber = nullptr;
inline thread_local const std::function<void()>* emu_body = nullptr;
inline thread_local ucontext_t emu_sched;

inline float* emu_shared() { return emu_block->shared.data(); }

// end this thread's turn until the block's next phase
inline void __syncthreads() { swapcontext(&emu_fiber->ctx, &emu_sched); }

inline float __shfl_xor_sync(unsigned, float v, int lane_mask) {
    EmuBlock& b = *emu_block;
    b.xchg[threadIdx.x] = v;
    __syncthreads();
    const float out = b.xchg[threadIdx.x ^ lane_mask];
    __syncthreads();
    return out;
}

inline float atomicAdd(float* p, float v) {
    const float old = *p;
    *p = old + v;
    return old;
}

inline void emu_cp_async4(float* dst, const float* src) {
    emu_fiber->open.push_back({dst, src});
}

inline void emu_cp_async_commit() {
    emu_fiber->groups.push_back(std::move(emu_fiber->open));
    emu_fiber->open.clear();
}

inline void emu_cp_async_wait(size_t pending) {
    auto& groups = emu_fiber->groups;
    while (groups.size() > pending) {
        for (const EmuCopy& c : groups.front()) *c.dst = *c.src;
        groups.pop_front();
    }
}

inline void emu_fiber_main() {
    (*emu_body)();
    emu_fiber->done = true;
}

// kernel<<<grid, block, smem>>>(...): run ``body`` (the kernel call) on
// every thread of every block, each block in phases: every thread not yet
// returned runs until its next barrier, up the lanes on even phases and
// down them on odd ones
inline void emu_launch(unsigned grid, unsigned block, size_t smem,
                       const std::function<void()>& body) {
    constexpr size_t STACK = 256 * 1024;
    std::vector<EmuFiber> fibers(block);
    for (EmuFiber& f : fibers) f.stack.resize(STACK);
    emu_body = &body;
    blockDim = {block, 1, 1};
    for (unsigned b = 0; b < grid; ++b) {
        EmuBlock blk(static_cast<int>(block), smem);
        emu_block = &blk;
        blockIdx = {b, 0, 0};
        for (unsigned t = 0; t < block; ++t) {
            EmuFiber& f = fibers[t];
            f.tid = t;
            f.done = false;
            f.open.clear();
            f.groups.clear();
            getcontext(&f.ctx);
            f.ctx.uc_stack.ss_sp = f.stack.data();
            f.ctx.uc_stack.ss_size = STACK;
            f.ctx.uc_link = &emu_sched;
            makecontext(&f.ctx, emu_fiber_main, 0);
        }
        for (unsigned phase = 0, live = block; live > 0; ++phase) {
            live = 0;
            for (unsigned k = 0; k < block; ++k) {
                EmuFiber& f = fibers[phase % 2 ? block - 1 - k : k];
                if (f.done) continue;
                emu_fiber = &f;
                threadIdx = {f.tid, 0, 0};
                swapcontext(&emu_sched, &f.ctx);
                live += !f.done;
            }
        }
    }
    emu_fiber = nullptr;
    emu_block = nullptr;
}
