// Stand-ins that let a BLS kernel source (csrc/bls/*.cu, its C entries
// cut off) build with g++ and run on the host, one std::thread per CUDA
// thread: __syncthreads and __syncwarp are std::barriers, __shared__
// memory is plain memory that the threads of the one running block
// share, __constant__ arrays are static const. Multiply lowering 0 only
// (no __dp4a). For the CPU tests (testing/host_cuda.py); the card remains
// the judge of the real build.
#pragma once
#include <barrier>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <thread>
#include <vector>

#define __device__
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

std::barrier<>* lh_block_barrier = nullptr;
std::vector<std::barrier<>*> lh_warp_barriers;

inline int __clzll(long long v) {
    return v ? __builtin_clzll((unsigned long long)v) : 64;
}
inline int __ffs(int v) { return __builtin_ffs(v); }
inline void __syncthreads() { lh_block_barrier->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
    lh_warp_barriers[threadIdx.x / 32]->arrive_and_wait();
}

// the dynamic shared memory of the kernels (extern __shared__ lh_smem[])
uint4 lh_smem[16384];

// run body() as grid blocks of block threads, one block after another
template <class F> void host_launch(unsigned grid, unsigned block, F body) {
    blockDim.x = block;
    gridDim.x = grid;
    for (unsigned b = 0; b < grid; ++b) {
        std::barrier<> bar(block);
        lh_block_barrier = &bar;
        std::vector<std::barrier<>*> warps;
        for (unsigned w = 0; w * 32 < block; ++w)
            warps.push_back(new std::barrier<>(
                block - 32 * w < 32 ? block - 32 * w : 32));
        lh_warp_barriers = warps;
        std::vector<std::thread> threads;
        for (unsigned t = 0; t < block; ++t)
            threads.emplace_back([=] {
                threadIdx.x = t;
                blockIdx.x = b;
                body();
            });
        for (auto& t : threads) t.join();
        for (auto* w : warps) delete w;
    }
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
