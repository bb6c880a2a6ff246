// Stand-ins that let a kernel source (csrc/*.cu, csrc/bls/*.cu, its C
// entries cut off) build with g++ and run on the host, one std::thread per
// CUDA thread: __syncthreads and __syncwarp are std::barriers (__syncwarp(mask)
// one of popcount(mask) threads for each mask a warp names; the shuffles of
// a full warp exchange through memory between two), __shared__
// memory is plain memory that the threads of a block share, __constant__
// arrays are static const. host_launch runs the blocks one after another;
// host_launch_coop runs them all at once, as a cooperative launch does,
// with a grid barrier for cooperative_groups::this_grid().sync() (its
// kernel may use the dynamic shared memory lh_smem in one block only: the
// blocks share the one array; LH_BLOCK_SMEM is each block's own). The headers of host_include/ stand in for
// <cuda_runtime.h> and <cooperative_groups.h>. Multiply lowering 0 only
// (no __dp4a). For the CPU tests (testing/host_cuda.py); the card remains
// the judge of the real build.
#pragma once
#include <barrier>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <map>
#include <mutex>
#include <thread>
#include <vector>

#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __global__
#define __constant__ static const
#define __restrict__ __restrict
#define __launch_bounds__(...)
#define __shared__

struct dim3 { unsigned x = 0, y = 0, z = 0; };
thread_local dim3 threadIdx, blockIdx;
dim3 blockDim, gridDim;
struct uint4 { unsigned x, y, z, w; };
inline uint4 make_uint4(unsigned x, unsigned y, unsigned z, unsigned w) {
    return {x, y, z, w};
}
inline uint32_t __funnelshift_r(uint32_t lo, uint32_t hi, unsigned shift) {
    return (uint32_t)((((uint64_t)hi << 32) | lo) >> (shift & 31));
}

// the barriers of a warp's partial masks, made at first use
struct LhMaskBarriers {
    std::mutex m;
    std::map<unsigned, std::barrier<>*> bars;
    std::map<unsigned, int> votes;
    long long xchg[32];     // the lanes' values of a shuffle
    ~LhMaskBarriers() {
        for (auto& kv : bars) delete kv.second;
    }
};

// a block's barriers: __syncthreads, each warp's, each warp's partial
// masks; and its own dynamic shared memory (LH_BLOCK_SMEM)
struct LhBlock {
    std::barrier<> bar;
    std::vector<std::barrier<>*> warps;
    std::vector<LhMaskBarriers*> masks;
    std::vector<uint4> smem;
    explicit LhBlock(unsigned block) : bar(block), smem(16384) {
        for (unsigned w = 0; w * 32 < block; ++w) {
            warps.push_back(new std::barrier<>(
                block - 32 * w < 32 ? block - 32 * w : 32));
            masks.push_back(new LhMaskBarriers);
        }
    }
    ~LhBlock() {
        for (auto* w : warps) delete w;
        for (auto* w : masks) delete w;
    }
};
thread_local LhBlock* lh_block = nullptr;
// a block's dynamic shared memory, for a source that asks for it by this
// name (lh_smem below is one array that all blocks share)
#define LH_BLOCK_SMEM (lh_block->smem.data())
std::barrier<>* lh_grid_barrier = nullptr;

namespace cooperative_groups {
struct grid_group {
    void sync() const { lh_grid_barrier->arrive_and_wait(); }
};
inline grid_group this_grid() { return {}; }
}  // namespace cooperative_groups

inline int __clzll(long long v) {
    return v ? __builtin_clzll((unsigned long long)v) : 64;
}
inline int __ffs(int v) { return __builtin_ffs(v); }
template <class T> inline T __ldg(const T* p) { return *p; }
inline void __syncthreads() { lh_block->bar.arrive_and_wait(); }
inline void __syncwarp(unsigned mask = 0xffffffffu) {
    if (mask == 0xffffffffu) {
        lh_block->warps[threadIdx.x / 32]->arrive_and_wait();
        return;
    }
    LhMaskBarriers* w = lh_block->masks[threadIdx.x / 32];
    std::barrier<>* bar;
    {
        std::lock_guard<std::mutex> lock(w->m);
        std::barrier<>*& b = w->bars[mask];
        if (!b) b = new std::barrier<>(__builtin_popcount(mask));
        bar = b;
    }
    bar->arrive_and_wait();
}

// __any_sync(mask, p): three barriers of the mask's threads around an
// or of their predicates (the last one lets the first thread clear it)
inline bool __any_sync(unsigned mask, int pred) {
    LhMaskBarriers* w = lh_block->masks[threadIdx.x / 32];
    std::barrier<>* bar;
    int* vote;
    {
        std::lock_guard<std::mutex> lock(w->m);
        std::barrier<>*& b = w->bars[mask];
        if (!b) b = new std::barrier<>(__builtin_popcount(mask));
        bar = b;
        vote = &w->votes[mask];
    }
    bar->arrive_and_wait();
    if (pred) __atomic_store_n(vote, 1, __ATOMIC_SEQ_CST);
    bar->arrive_and_wait();
    const bool any = __atomic_load_n(vote, __ATOMIC_SEQ_CST) != 0;
    bar->arrive_and_wait();
    if ((unsigned)__builtin_ctz(mask) == threadIdx.x % 32)
        __atomic_store_n(vote, 0, __ATOMIC_SEQ_CST);
    return any;
}

// __shfl_up_sync / __shfl_sync of a warp of 32 threads (the full mask):
// each lane writes its value, a barrier, each reads its source lane's, a
// barrier
template <class T> inline T lh_shfl(T v, int src) {
    std::barrier<>* bar = lh_block->warps[threadIdx.x / 32];
    long long* x = lh_block->masks[threadIdx.x / 32]->xchg;
    x[threadIdx.x % 32] = (long long)v;
    bar->arrive_and_wait();
    const T got = (T)x[src];
    bar->arrive_and_wait();
    return got;
}
template <class T> inline T __shfl_up_sync(unsigned, T v, unsigned d) {
    const int l = threadIdx.x % 32;
    return lh_shfl(v, l >= (int)d ? l - (int)d : l);
}
template <class T> inline T __shfl_sync(unsigned, T v, int src) {
    return lh_shfl(v, src);
}

// the dynamic shared memory of the kernels (extern __shared__ lh_smem[])
uint4 lh_smem[16384];

// run body() as grid blocks of block threads, one block after another
template <class F> void host_launch(unsigned grid, unsigned block, F body) {
    blockDim.x = block;
    gridDim.x = grid;
    for (unsigned b = 0; b < grid; ++b) {
        LhBlock blk(block);
        std::vector<std::thread> threads;
        for (unsigned t = 0; t < block; ++t)
            threads.emplace_back([=, &blk] {
                threadIdx.x = t;
                blockIdx.x = b;
                lh_block = &blk;
                body();
            });
        for (auto& t : threads) t.join();
    }
}

// run body() as grid blocks of block threads all at once (a cooperative
// launch), the grid barrier held by every thread of the grid
template <class F> void host_launch_coop(unsigned grid, unsigned block,
                                         F body) {
    blockDim.x = block;
    gridDim.x = grid;
    std::barrier<> grid_bar(grid * block);
    lh_grid_barrier = &grid_bar;
    std::vector<LhBlock*> blocks;
    for (unsigned b = 0; b < grid; ++b) blocks.push_back(new LhBlock(block));
    std::vector<std::thread> threads;
    for (unsigned b = 0; b < grid; ++b)
        for (unsigned t = 0; t < block; ++t)
            threads.emplace_back([=] {
                threadIdx.x = t;
                blockIdx.x = b;
                lh_block = blocks[b];
                body();
            });
    for (auto& t : threads) t.join();
    for (auto* b : blocks) delete b;
    lh_grid_barrier = nullptr;
}

inline std::vector<int32_t> host_read(const char* path) {
    FILE* f = fopen(path, "rb");
    if (!f) exit(3);
    fseek(f, 0, SEEK_END);
    const long n = ftell(f);
    fseek(f, 0, SEEK_SET);
    std::vector<int32_t> v(n / 4);
    if (fread(v.data(), 4, v.size(), f) != v.size()) exit(3);
    fclose(f);
    return v;
}

inline void host_write(const char* path, const std::vector<int32_t>& v) {
    FILE* f = fopen(path, "wb");
    if (!f || fwrite(v.data(), 4, v.size(), f) != v.size()) exit(3);
    fclose(f);
}
