// Fused RMSNorm forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel `_rmsnorm_kernel` of src/repro/kernels/rmsnorm.py
// (launched by `rmsnorm`).  It computes the same function on x viewed as
// (rows, d): y = x * rsqrt(mean(x^2) + eps) * (1 + gamma), the arithmetic in
// fp32, y stored in x's type (fp32 or bf16); gamma is fp32 of shape (d,).
//
// Bound: the kernel moves bytes and does ~4 flops an element.  It must read
// x and gamma once and write y once: at (4096, 3072) that is 50.3 MB in bf16
// (15 us at 3.35 TB/s) and 100.7 MB in fp32 (30 us).
//
// Design, and what differs from the TPU kernel:
// * The TPU kernel normalises a (128, d) tile per sequential grid step in
//   VMEM.  Here the row is the unit: one block a row, blocks in any order.
// * One pass over device memory.  Each thread issues all its 16-byte loads
//   of the row at once (VPT of them, a compile-time count, neighbouring
//   threads on neighbouring addresses), keeps the values in registers while
//   the sum of squares is reduced (warp shuffles, then the warps' sums through
//   shared memory), and scales and stores them from there: x is read once.
//   A row of the training batch (3072 values) in fp32 is 768 vectors: 256
//   threads of 3, so an SM holds 8 rows, 96 KB of loads in flight.
// * The wrapper picks (VPT, threads) from d (`rmsnorm.instance`): VPT =
//   ceil(vectors / 256) up to 8, threads the vectors over VPT rounded up to a
//   warp.  That covers every d_model of the repo's configs (384 to 12288) and
//   any d a multiple of the vector width up to 8 x 1024 vectors.
// * Every other input (d not a multiple of 4 fp32 or 8 bf16 values, a
//   pointer off a 16-byte boundary, or a row too long for the registers)
//   takes the general path, `rmsnorm_rows`: one warp a row, 8 rows a block,
//   16-byte accesses where aligned and element-wise otherwise, reading the
//   row a second time to write y.  It is a kernel too, not a fallback to the
//   plain version.
// * Both launch on the caller's stream, neither allocates nor synchronises,
//   and the entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int ROWS_WARPS = 8;  // rows a block of the general path
constexpr int ROWS_THREADS = ROWS_WARPS * 32;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_float(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_float(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

// y of one 16-byte vector (index i of the row) from its x values and the scale r.
template <typename T>
__device__ __forceinline__ uint4 scale_vector(const uint4& raw, const float* __restrict__ gamma,
                                              int i, float r) {
  constexpr int VEC = 16 / sizeof(T);
  const T* e = reinterpret_cast<const T*>(&raw);
  uint4 out;
  T* o = reinterpret_cast<T*>(&out);
#pragma unroll
  for (int j = 0; j < VEC; j += 4) {
    const float4 g = reinterpret_cast<const float4*>(gamma)[(i * VEC + j) / 4];
    from_float(o + j + 0, (to_float(e[j + 0]) * r) * (1.0f + g.x));
    from_float(o + j + 1, (to_float(e[j + 1]) * r) * (1.0f + g.y));
    from_float(o + j + 2, (to_float(e[j + 2]) * r) * (1.0f + g.z));
    from_float(o + j + 3, (to_float(e[j + 3]) * r) * (1.0f + g.w));
  }
  return out;
}

// One block a row, VPT 16-byte vectors a thread held in registers.
template <typename T, int VPT>
__global__ void __launch_bounds__(1024)
rmsnorm_row(const T* __restrict__ x, const float* __restrict__ gamma, T* __restrict__ y, int d,
            float eps) {
  constexpr int VEC = 16 / sizeof(T);
  __shared__ float warp_ss[32];
  const int nvec = d / VEC;
  const size_t row = blockIdx.x;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * d);
  uint4* yr = reinterpret_cast<uint4*>(y + row * d);

  uint4 raw[VPT];
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    raw[k] = i < nvec ? xr[i] : make_uint4(0, 0, 0, 0);
  }
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const T* e = reinterpret_cast<const T*>(&raw[k]);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float f = to_float(e[j]);
      ss += f * f;
    }
  }
  ss = warp_sum(ss);
  if (threadIdx.x % 32 == 0) warp_ss[threadIdx.x / 32] = ss;
  __syncthreads();
  ss = 0.f;
  for (int w = 0; w < blockDim.x / 32; ++w) ss += warp_ss[w];  // the same order in every thread
  const float r = 1.0f / sqrtf(ss / static_cast<float>(d) + eps);

#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (i < nvec) yr[i] = scale_vector<T>(raw[k], gamma, i, r);
  }
}

// The general path: one warp a row, 8 rows a block; 16-byte accesses when
// `vectorised`, else element by element; the row is read twice.
template <typename T>
__global__ void __launch_bounds__(ROWS_THREADS)
rmsnorm_rows(const T* __restrict__ x, const float* __restrict__ gamma, T* __restrict__ y,
             int rows, int d, float eps, int vectorised) {
  constexpr int VEC = 16 / sizeof(T);
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * ROWS_WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warps leave together: the shuffles stay full
  const T* xr = x + row * d;
  T* yr = y + row * d;
  const int nvec = vectorised ? d / VEC : 0;

  float ss = 0.f;
  for (int i = lane; i < nvec; i += 32) {
    const uint4 raw = reinterpret_cast<const uint4*>(xr)[i];
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float f = to_float(e[j]);
      ss += f * f;
    }
  }
  for (int c = nvec * VEC + lane; c < d; c += 32) {
    const float f = to_float(xr[c]);
    ss += f * f;
  }
  ss = warp_sum(ss);
  const float r = 1.0f / sqrtf(ss / static_cast<float>(d) + eps);

  for (int i = lane; i < nvec; i += 32)
    reinterpret_cast<uint4*>(yr)[i] =
        scale_vector<T>(reinterpret_cast<const uint4*>(xr)[i], gamma, i, r);
  for (int c = nvec * VEC + lane; c < d; c += 32) {
    from_float(yr + c, (to_float(xr[c]) * r) * (1.0f + gamma[c]));
  }
}

template <typename T, int VPT>
cudaError_t launch_row(const void* x, const float* gamma, void* y, int rows, int d, float eps,
                       int threads, cudaStream_t stream) {
  rmsnorm_row<T, VPT><<<rows, threads, 0, stream>>>(static_cast<const T*>(x), gamma,
                                                    static_cast<T*>(y), d, eps);
  return cudaGetLastError();
}

// vpt = 0: the general path; vpt = 1 .. 8: one block of `threads` a row.
template <typename T>
cudaError_t launch(const void* x, const float* gamma, void* y, int rows, int d, float eps,
                   int vpt, int threads, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vectorised = d % VEC == 0 && aligned(x) && aligned(y) && aligned(gamma);
  if (vpt == 0) {
    const unsigned blocks =
        static_cast<unsigned>((static_cast<long long>(rows) + ROWS_WARPS - 1) / ROWS_WARPS);
    rmsnorm_rows<T><<<blocks, ROWS_THREADS, 0, stream>>>(
        static_cast<const T*>(x), gamma, static_cast<T*>(y), rows, d, eps, vectorised);
    return cudaGetLastError();
  }
  if (!vectorised || threads % 32 || threads > 1024 ||
      static_cast<long long>(vpt) * threads < d / VEC)
    return cudaErrorInvalidValue;
  switch (vpt) {
    case 1: return launch_row<T, 1>(x, gamma, y, rows, d, eps, threads, stream);
    case 2: return launch_row<T, 2>(x, gamma, y, rows, d, eps, threads, stream);
    case 3: return launch_row<T, 3>(x, gamma, y, rows, d, eps, threads, stream);
    case 4: return launch_row<T, 4>(x, gamma, y, rows, d, eps, threads, stream);
    case 5: return launch_row<T, 5>(x, gamma, y, rows, d, eps, threads, stream);
    case 6: return launch_row<T, 6>(x, gamma, y, rows, d, eps, threads, stream);
    case 7: return launch_row<T, 7>(x, gamma, y, rows, d, eps, threads, stream);
    case 8: return launch_row<T, 8>(x, gamma, y, rows, d, eps, threads, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int repro_rmsnorm_fwd(const void* x, const void* gamma, void* y, int dtype, int rows,
                                 int d, float eps, int vpt, int threads, void* stream) {
  const auto* g = static_cast<const float*>(gamma);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch<float>(x, g, y, rows, d, eps, vpt, threads, s));
    case 1:
      return static_cast<int>(launch<__nv_bfloat16>(x, g, y, rows, d, eps, vpt, threads, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
