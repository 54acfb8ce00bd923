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
//   VMEM.  Here one warp owns one row and a block of 8 warps owns 8 rows, so a
//   (4096, d) input gives 512 blocks, several per SM; blocks run in any order
//   and share nothing.
// * Loads and stores are 16 bytes a lane (4 fp32 or 8 bf16 values) when d is
//   a multiple of that width and the pointers are 16-byte aligned, with
//   neighbouring lanes on neighbouring addresses; the rest of a row, or the
//   whole row otherwise, goes element by element.  So neither d nor the row
//   count has to be a power of two, and nothing is padded.
// * The sum of squares is accumulated in fp32 per lane and reduced across the
//   warp with shuffles; mean = sum / d, as jnp.mean.  The row is read a second
//   time to write y: a row is at most a few tens of KB, so that read mostly
//   hits L1/L2 rather than device memory.
// * It launches on the caller's stream, neither allocates nor synchronises,
//   and the entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int WARPS = 8;  // rows per block
constexpr int THREADS = WARPS * 32;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_float(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_float(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ gamma, T* __restrict__ y,
               int rows, int d, float eps, int vectorised) {
  constexpr int VEC = 16 / sizeof(T);  // values in one 16-byte access
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
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
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float r = 1.0f / sqrtf(ss / static_cast<float>(d) + eps);

  for (int i = lane; i < nvec; i += 32) {
    const uint4 raw = reinterpret_cast<const uint4*>(xr)[i];
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
    reinterpret_cast<uint4*>(yr)[i] = out;
  }
  for (int c = nvec * VEC + lane; c < d; c += 32) {
    from_float(yr + c, (to_float(xr[c]) * r) * (1.0f + gamma[c]));
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* gamma, void* y, int rows, int d, float eps,
                   cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const int vectorised = d % VEC == 0 && aligned(x) && aligned(y) && aligned(gamma);
  const unsigned blocks = static_cast<unsigned>((static_cast<long long>(rows) + WARPS - 1) / WARPS);
  rmsnorm_kernel<T><<<blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(x), gamma, static_cast<T*>(y), rows, d, eps, vectorised);
  return cudaGetLastError();
}

}  // namespace

extern "C" int repro_rmsnorm_fwd(const void* x, const void* gamma, void* y, int dtype, int rows,
                                 int d, float eps, void* stream) {
  const auto* g = static_cast<const float*>(gamma);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch<float>(x, g, y, rows, d, eps, s));
    case 1:
      return static_cast<int>(launch<__nv_bfloat16>(x, g, y, rows, d, eps, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
