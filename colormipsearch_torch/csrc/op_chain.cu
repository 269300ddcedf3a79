// Elementwise-op throughput microbenchmark for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU (Pallas) kernel of scripts/op_microbench.py:37
// (make_bench.run): a dependent chain acc = op(acc, y) of `steps` steps
// over every element of an array, which the TPU kept in VMEM. Here each
// element lives in a register for the whole chain: thread t of the grid
// owns elements t, t + G, t + 2G, t + 3G (G = the grid's thread count, so
// loads and stores are coalesced) as ILP = 4 independent chains, which
// hides the ALU latency with 4 blocks of 4 warps on each SM at the
// benchmark's 256 x 1024 elements. Memory is touched once per element
// before and after the chain, so the kernel is bound by the SMs' issue
// rate for the op, which is what it measures.
//
// Elision: a compiler may fold a loop of `acc += y` into acc + steps*y
// (LLVM's induction-variable simplification), or a compare-select chain
// into one step, and the answer would still be right. So every op is an
// `asm volatile` PTX instruction, which the compiler keeps and does not
// reorder, and the caller times every case at S and 2S steps and expects
// a ratio near 2. S is 64 times the reference's 512 steps: on an H100 a
// 512-step chain over 256 x 1024 elements takes less time than a launch.
// The 2S/S ratio cannot see a fold by a fixed factor. So the constant of
// MUL_I32_1000 arrives as a kernel argument: ptxas could merge multiplies
// by an immediate. ptxas may still merge two dependent steps into one
// three-input instruction (IADD3 a + y + y, VIMNMX3): the steps are all
// computed, but by fewer instructions. The main loop is one block of
// UNROLL steps of each chain, so its SASS body holds UNROLL * ILP steps
// plus three instructions of loop control; op_microbench reads that body
// (cuobjdump -sass) and reports instructions per step beside the rate.
//
// Dtypes: Hopper's integer ALUs have no lanes narrower than 32 bits, so
// 16-bit ops run on 16-bit PTX registers (which ptxas maps to 32-bit
// ones) and the u8 add runs as a 16-bit add whose low byte is stored:
// (a + b) mod 2^16 mod 2^8 = (a + b) mod 2^8, exact. bf16 mul is the
// native mul.rn.bf16 (sm_90): the product of two bf16 values is exact in
// f32, so its round-to-nearest-even equals the plain version's f32
// product rounded to bf16.

#include "multimask_common.cuh"  // cms::on_device

namespace {

constexpr int THREADS = 128;
constexpr int ILP = 4;
constexpr int UNROLL = 64;  // steps of each chain per main-loop iteration

// the ten cases of scripts/op_microbench.py:main, in its order
enum Case {
  ADD_I32 = 0,
  MUL_I32,
  MUL_I32_1000,
  ADD_I16,
  MUL_I16,
  MUL_U16,
  ADD_U8,
  MUL_F32,
  MUL_BF16,
  CMPSEL_I32,
  N_CASES
};

// Op<C>: T the element type in memory, R its register type, step the op
// (c: the constant operand of MUL_I32_1000, 1000 at run time).
template <int C> struct Op;

template <> struct Op<ADD_I32> {
  using T = int32_t; using R = int32_t;
  static __device__ __forceinline__ void step(R& a, R y, int) {
    asm volatile("add.s32 %0, %0, %1;" : "+r"(a) : "r"(y));
  }
};
template <> struct Op<MUL_I32> {
  using T = int32_t; using R = int32_t;
  static __device__ __forceinline__ void step(R& a, R y, int) {
    asm volatile("mul.lo.s32 %0, %0, %1;" : "+r"(a) : "r"(y));
  }
};
template <> struct Op<MUL_I32_1000> {  // y unused, as in the reference
  using T = int32_t; using R = int32_t;
  static __device__ __forceinline__ void step(R& a, R, int c) {
    asm volatile("mul.lo.s32 %0, %0, %1;" : "+r"(a) : "r"(c));
  }
};
template <> struct Op<ADD_I16> {
  using T = int16_t; using R = int16_t;
  static __device__ __forceinline__ void step(R& a, R y, int) {
    asm volatile("add.s16 %0, %0, %1;" : "+h"(a) : "h"(y));
  }
};
template <> struct Op<MUL_I16> {
  using T = int16_t; using R = int16_t;
  static __device__ __forceinline__ void step(R& a, R y, int) {
    asm volatile("mul.lo.s16 %0, %0, %1;" : "+h"(a) : "h"(y));
  }
};
template <> struct Op<MUL_U16> {
  using T = uint16_t; using R = uint16_t;
  static __device__ __forceinline__ void step(R& a, R y, int) {
    asm volatile("mul.lo.u16 %0, %0, %1;" : "+h"(a) : "h"(y));
  }
};
template <> struct Op<ADD_U8> {  // 16-bit add, low byte stored (above)
  using T = uint8_t; using R = uint16_t;
  static __device__ __forceinline__ void step(R& a, R y, int) {
    asm volatile("add.u16 %0, %0, %1;" : "+h"(a) : "h"(y));
  }
};
template <> struct Op<MUL_F32> {
  using T = float; using R = float;
  static __device__ __forceinline__ void step(R& a, R y, int) {
    asm volatile("mul.rn.f32 %0, %0, %1;" : "+f"(a) : "f"(y));
  }
};
template <> struct Op<MUL_BF16> {  // bf16 bits in a 16-bit register
  using T = uint16_t; using R = uint16_t;
  static __device__ __forceinline__ void step(R& a, R y, int) {
    asm volatile("mul.rn.bf16 %0, %0, %1;" : "+h"(a) : "h"(y));
  }
};
template <> struct Op<CMPSEL_I32> {  // where(a > y, a, y)
  using T = int32_t; using R = int32_t;
  static __device__ __forceinline__ void step(R& a, R y, int) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "setp.gt.s32 p, %0, %1;\n\t"
        "selp.s32 %0, %0, %1, p;\n\t}"
        : "+r"(a) : "r"(y));
  }
};

template <int C>
__global__ void __launch_bounds__(THREADS)
op_chain_kernel(const typename Op<C>::T* __restrict__ x,
                const typename Op<C>::T* __restrict__ y,
                typename Op<C>::T* __restrict__ out, int n, int steps,
                int c) {
  using T = typename Op<C>::T;
  using R = typename Op<C>::R;
  const int g = gridDim.x * THREADS;
  const int t0 = blockIdx.x * THREADS + threadIdx.x;
  R acc[ILP];
  R yv[ILP];
#pragma unroll
  for (int i = 0; i < ILP; ++i) {
    const int e = t0 + i * g;
    acc[i] = e < n ? static_cast<R>(x[e]) : R(0);
    yv[i] = e < n ? static_cast<R>(y[e]) : R(0);
  }
  int s = 0;
#pragma unroll 1
  for (; steps - s >= UNROLL; s += UNROLL) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
      for (int i = 0; i < ILP; ++i) Op<C>::step(acc[i], yv[i], c);
    }
  }
#pragma unroll 1
  for (; s < steps; ++s) {
#pragma unroll
    for (int i = 0; i < ILP; ++i) Op<C>::step(acc[i], yv[i], c);
  }
#pragma unroll
  for (int i = 0; i < ILP; ++i) {
    const int e = t0 + i * g;
    if (e < n) out[e] = static_cast<T>(acc[i]);
  }
}

template <int C>
cudaError_t launch(const void* x, const void* y, void* out, int n, int steps,
                   cudaStream_t stream) {
  using T = typename Op<C>::T;
  const int blocks = (n + THREADS * ILP - 1) / (THREADS * ILP);
  op_chain_kernel<C><<<blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<T*>(out), n, steps, 1000);
  return cudaGetLastError();
}

using LaunchFn = cudaError_t (*)(const void*, const void*, void*, int, int,
                                 cudaStream_t);
constexpr LaunchFn kLaunch[N_CASES] = {
    launch<ADD_I32>, launch<MUL_I32>, launch<MUL_I32_1000>,
    launch<ADD_I16>, launch<MUL_I16>, launch<MUL_U16>,
    launch<ADD_U8>,  launch<MUL_F32>, launch<MUL_BF16>,
    launch<CMPSEL_I32>};

}  // namespace

// Plain C entry point (bound with ctypes by cds/kernels.py): out = the
// chain of `steps` ops of case `op_case` (the Case order above) over the
// n elements of x and y, all of the case's element type. Launches on
// `stream` of card `device` and returns cudaGetLastError() of the launch
// (0 on success); the caller's current device is restored.
extern "C" int cms_op_chain(int op_case, const void* x, const void* y,
                            void* out, int n, int steps, void* stream,
                            int device) {
  if (op_case < 0 || op_case >= N_CASES || steps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  return cms::on_device(device, [&] {
    return kLaunch[op_case](x, y, out, n, steps,
                            static_cast<cudaStream_t>(stream));
  });
}

// Steps (of all of a thread's chains) in one iteration of the main loop,
// the body whose SASS op_microbench reads.
extern "C" int cms_op_chain_loop_steps() { return UNROLL * ILP; }
