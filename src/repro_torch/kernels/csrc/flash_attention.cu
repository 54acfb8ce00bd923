// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes:
// the SIMT kernel, arithmetic in fp32 on the CUDA cores.  It serves fp32
// inputs, and bf16 at head_dim 8; bf16 at head_dim >= 16 goes to the
// tensor-core kernel of flash_attention_sm90.cu (kernels/flash_attention.py,
// `variant`).  It still takes bf16 at every head_dim, for comparison.
//
// Replaces the TPU kernel `_flash_fwd_kernel` of
// src/repro/kernels/flash_attention.py (launched by `flash_attention_fwd`).
// It computes the same function: softmax(Q K^T / sqrt(D) + mask) V with an
// online softmax that keeps the running max m, sum l and accumulator in fp32;
// GQA (query head h reads kv head h / (H / KV)); masks kpos < Sk, causal
// kpos <= qpos, window kpos > qpos - window; masked scores take the finite
// NEG_INF = -1e30 (never -inf: a row whose first visited tile is fully masked
// is repaired by alpha = exp(-1e30 - m) = 0 on the next tile); the output is
// acc / max(l, 1e-30) in the input type.
//
// Bound at the llama3.2-3b prefill shape (B = 4, S = 2048, H = 24, KV = 8,
// D = 128, causal):
//   operations  4 * B * H * D * S (S + 1) / 2 ~= 1.0e11 -> ~0.10 ms at 989 TFLOP/s bf16
//   bytes       q, k, v read once and o written once ~= 0.13 GB -> ~0.04 ms at 3.35 TB/s
// so the kernel is compute-bound.  It does its arithmetic in fp32 on the CUDA
// cores (67 TFLOP/s, a bound of ~1.5 ms), not on the tensor cores, so in bf16
// it sits well above the bf16 bound; in fp32 that is the bound it answers to.
//
// Design, and what differs from the TPU kernel:
// * One block per (q tile, b * H + h).  The TPU's sequential kv grid axis,
//   whose state persisted in VMEM scratch, becomes a loop inside the block,
//   and its block pruning becomes loop bounds: k_hi = min(Sk, q_start + BQ)
//   when causal, k_lo = max(0, q_start - window + 1) rounded down to a tile
//   when windowed.  Q tiles are issued heaviest (last) first.
// * BQ = BK = 64.  The Q tile and one K and V tile are staged in shared memory
//   as fp32 (Q and K transposed, so a thread reads its rows and columns with
//   unit stride); scores for the tile go through shared memory once as P.
//   That is ~113 KB at D = 128, so the launch raises the dynamic shared-memory
//   limit, and two blocks fit on an SM.
// * 128 threads: thread (ty, tx) owns query rows 4*ty .. 4*ty+3, score columns
//   tx + 8*j of the tile and output columns tx + 8*c; row max and row sum are
//   reduced across the 8 lanes of a row group with warp shuffles.
// * No padding: keys at or past Sk are masked (their V rows zero-filled), and
//   no output row at or past Sq is stored.
// * Inputs are fp32 or bf16 (converted with the intrinsics); accumulation is
//   fp32.  The kernel launches on the caller's stream, neither allocates nor
//   synchronises, and the entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 128;  // 16 row groups x 8 column lanes
constexpr int RPT = 4;        // query rows per thread
constexpr int CPT = BK / 8;   // score columns per thread
constexpr int KT_STRIDE = BK + 1;  // transposed K: conflict-free stores
constexpr int P_STRIDE = BK + 2;   // P: conflict-free stores and row reads
constexpr float NEG_INF = -1e30f;

template <typename T>
struct Convert;

template <>
struct Convert<float> {
  __device__ static float load(const float* p) { return *p; }
  __device__ static void store(float* p, float x) { *p = x; }
};

template <>
struct Convert<__nv_bfloat16> {
  __device__ static float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
  __device__ static void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
};

template <int D>
constexpr size_t smem_floats() {
  return size_t(D) * BQ + size_t(D) * KT_STRIDE + size_t(BK) * D + size_t(BQ) * P_STRIDE;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int Sq, int Sk, int H, int KV, int causal, int window,
                 float scale) {
  constexpr int DC = D / 8;  // output columns per thread
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);  // [D][BQ]
  float* Kt = Qt + D * BQ;                      // [D][KT_STRIDE]
  float* Vs = Kt + D * KT_STRIDE;               // [BK][D]
  float* Ps = Vs + BK * D;                      // [BQ][P_STRIDE]

  const int tid = threadIdx.x;
  const int tx = tid & 7;
  const int ty = tid >> 3;
  const int q_start = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int kvh = h / (H / KV);

  const size_t q_row = size_t(H) * D;
  const size_t kv_row = size_t(KV) * D;
  const T* qb = q + (size_t(b) * Sq * H + h) * D;
  const T* kb = k + (size_t(b) * Sk * KV + kvh) * D;
  const T* vb = v + (size_t(b) * Sk * KV + kvh) * D;
  T* ob = o + (size_t(b) * Sq * H + h) * D;

  // Q tile, transposed; consecutive threads take consecutive rows.
  for (int idx = tid; idx < BQ * D; idx += THREADS) {
    const int r = idx % BQ, d = idx / BQ;
    const int s = q_start + r;
    Qt[d * BQ + r] = s < Sq ? Convert<T>::load(qb + s * q_row + d) : 0.f;
  }

  float m[RPT], l[RPT], acc[RPT][DC];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  const int k_hi = causal ? min(Sk, q_start + BQ) : Sk;
  const int k_lo = window > 0 ? max(0, q_start - window + 1) / BK * BK : 0;

  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    __syncthreads();  // Q tile stored; previous K, V and P no longer read
    for (int idx = tid; idx < BK * D; idx += THREADS) {
      const int r = idx / D, d = idx % D;
      const int s = k0 + r;
      const bool ok = s < Sk;
      Kt[d * KT_STRIDE + r] = ok ? Convert<T>::load(kb + s * kv_row + d) : 0.f;
      Vs[r * D + d] = ok ? Convert<T>::load(vb + s * kv_row + d) : 0.f;
    }
    __syncthreads();

    float sc[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) sc[i][j] = 0.f;

#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(&Qt[d * BQ + ty * RPT]);
      const float qr[RPT] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float kd = Kt[d * KT_STRIDE + tx + 8 * j];
#pragma unroll
        for (int i = 0; i < RPT; ++i) sc[i][j] = fmaf(qr[i], kd, sc[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int qpos = q_start + ty * RPT + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int kpos = k0 + tx + 8 * j;
        bool ok = kpos < Sk;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        sc[i][j] = ok ? sc[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p = expf(sc[i][j] - m_new);
        rs += p;
        Ps[(ty * RPT + i) * P_STRIDE + tx + 8 * j] = p;
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // P complete

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float p[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) p[i] = Ps[(ty * RPT + i) * P_STRIDE + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float vd = Vs[kk * D + tx + 8 * c];
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i][c] = fmaf(p[i], vd, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int s = q_start + ty * RPT + i;
    if (s >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c) Convert<T>::store(ob + s * q_row + tx + 8 * c, acc[i][c] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk,
                   int H, int KV, int causal, int window, cudaStream_t stream) {
  constexpr size_t smem = smem_floats<D>() * sizeof(float);
  auto kernel = flash_fwd_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Sq, Sk, H, KV, causal, window, 1.0f / sqrtf(float(D)));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                       int Sk, int H, int KV, int D, int causal, int window,
                       cudaStream_t stream) {
  switch (D) {
    case 8: return launch<T, 8>(q, k, v, o, B, Sq, Sk, H, KV, causal, window, stream);
    case 16: return launch<T, 16>(q, k, v, o, B, Sq, Sk, H, KV, causal, window, stream);
    case 32: return launch<T, 32>(q, k, v, o, B, Sq, Sk, H, KV, causal, window, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, Sq, Sk, H, KV, causal, window, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, Sq, Sk, H, KV, causal, window, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o: (B, Sq, H, D); k, v: (B, Sk, KV, D); all contiguous, on the device.
// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 on success).
extern "C" int repro_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                         int dtype, int B, int Sq, int Sk, int H, int KV, int D,
                                         int causal, int window, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, o, B, Sq, Sk, H, KV, D, causal, window, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, o, B, Sq, Sk, H, KV, D, causal, window, s);
  return cudaErrorInvalidValue;
}
