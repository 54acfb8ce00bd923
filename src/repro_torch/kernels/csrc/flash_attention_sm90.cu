// Flash-attention forward in bf16 for Hopper (sm_90a): TMA loads, wgmma on the
// tensor cores and a warp-specialised producer/consumer pipeline.  Plain C
// interface for ctypes.
//
// Replaces the TPU kernel `_flash_fwd_kernel` of
// src/repro/kernels/flash_attention.py (launched by `flash_attention_fwd`) for
// bf16 inputs with head_dim 16, 32, 64 or 128; fp32 inputs, and bf16 at
// head_dim 8, stay on csrc/flash_attention.cu.  It computes the same function:
// softmax(Q K^T / sqrt(D) + mask) V with an online softmax whose running max,
// sum and accumulator are fp32; GQA (query head h reads kv head h / (H / KV));
// masks kpos < Sk, causal kpos <= qpos (top-left aligned when Sq != Sk) and
// window kpos > qpos - window; masked scores take the finite -1e30, never -inf
// (a row whose first visited tile is fully masked is repaired by
// alpha = exp(-1e30 - m) = 0 on the next tile); the output is
// acc / max(l, 1e-30) in bf16.
//
// Bound at the llama3.2-3b prefill shape (B = 4, S = 2048, H = 24, KV = 8,
// D = 128, causal):
//   operations  4 * B * H * D * S (S + 1) / 2 ~= 1.03e11 -> ~0.104 ms at 989 TFLOP/s bf16
//   bytes       q, k, v read once and o written once ~= 0.13 GB -> ~0.040 ms at 3.35 TB/s
// so the kernel is bound by the tensor cores, which only wgmma drives at their
// full rate.
//
// Design:
// * One CTA per (128-row q tile, b * H + h).  The grid is (B * H, q tiles) and
//   the q tiles are issued heaviest (last) first, so under a causal mask the
//   long tiles of every head start in the first waves.  The loop over kv tiles
//   runs inside the CTA and is pruned to [k_lo, k_hi): k_hi = min(Sk, q_start +
//   128) when causal, k_lo = max(0, q_start - window + 1) rounded down to a tile
//   when windowed.
// * 384 threads in three warpgroups.  Warpgroup 2 is the producer: it lowers
//   its register limit to 40 and one thread issues every TMA load.  Warpgroups
//   0 and 1 are consumers of 64 q rows each and raise theirs to 232.
// * Shared memory holds the Q tile (loaded once) and a ring of STAGES K and V
//   tiles of 128 keys, each with a full barrier that TMA completes by bytes,
//   and one empty barrier per stage that the 256 consumer threads arrive on
//   when both products of the stage are done.  A tile row is at most 128
//   bytes, the widest TMA box row under swizzling, so a 128 x D tile at D = 128
//   is two boxes of 64 columns; D = 32 and 16 use 64- and 32-byte swizzle.
//   At D = 128: Q 32 KB + 2 x (K 32 KB + V 32 KB) = 160 KB.
// * S = Q K^T: wgmma m64n128k16, A = Q and B = K from shared memory (both
//   K-major), the 64 x 128 fp32 scores in registers (64 a thread).
// * Online softmax on the accumulator fragment, in fp32 and in the log2
//   domain (scale * log2(e) folded into one multiply, then ex2): row max by
//   two quad shuffles; row sums kept per thread and reduced once at the end.
//   Masks are evaluated only on tiles that cross Sk, the causal diagonal or
//   the window's edge.  Rows and keys past Sq and Sk come from TMA as zeros,
//   so keys past Sk are masked like any other (a zero key scores 0, not
//   -1e30).
// * O += P V: P is rounded to bf16 in registers, where the m64nNk16
//   accumulator layout, packed in pairs, is the register-A fragment of the
//   next k16 slab.  V is the B operand in its natural keys x D layout, read
//   through the descriptor's MN-major (transpose) mode.  O stays in fp32
//   registers.
// * Epilogue: acc / max(l, 1e-30) to bf16, staged through the warpgroup's own
//   rows of the Q buffer, then 16-byte stores; rows at or past Sq are not
//   written.
// * The kernel launches on the caller's stream, neither allocates nor
//   synchronises.  The host builds the three tensor maps per call with
//   cuTensorMapEncodeTiled, reached through the runtime's driver entry point
//   (no -lcuda), and passes them as __grid_constant__ parameters.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "sm90.cuh"

namespace {

constexpr int BQ = 128;  // q rows a CTA
constexpr int BK = 128;  // keys a tile
constexpr int STAGES = 2;
constexpr int CONSUMERS = 2;  // warpgroups of 64 q rows
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr float NEG_INF = -1e30f;
constexpr int ENCODE_FAILED = 10000;  // + CUresult, for a tensor map that cannot be built

// Geometry of a 128-row bf16 tile of width D in shared memory, as TMA writes it.
template <int D>
struct Tile {
  static constexpr int ROW_BYTES = D >= 64 ? 128 : 2 * D;  // a box row = the swizzle width
  static constexpr int BOX_COLS = ROW_BYTES / 2;
  static constexpr int BOXES = D / BOX_COLS;
  static constexpr int BOX_BYTES = 128 * ROW_BYTES;
  static constexpr int BYTES = BOXES * BOX_BYTES;
  static constexpr int KSTEPS_PER_BOX = ROW_BYTES / 32;  // k16 slabs of bf16 in a box row
  static_assert(BQ == 128 && BK == 128, "a box is 128 rows of q or keys");
};

// Byte offset of element (row, col) in a tile: the box, then the row, then the
// 16-byte group XOR-ed with bits 7.. of the offset (TMA's and wgmma's swizzle).
template <int D>
__device__ __forceinline__ uint32_t tile_offset(int row, int col) {
  using T = Tile<D>;
  const uint32_t off = row * T::ROW_BYTES + (col % T::BOX_COLS) * 2;
  constexpr uint32_t mask = T::ROW_BYTES / 16 - 1;
  return (col / T::BOX_COLS) * T::BOX_BYTES + (off ^ (((off >> 7) & mask) << 4));
}

struct Barriers {
  uint64_t q;
  uint64_t k[STAGES];
  uint64_t v[STAGES];
  uint64_t empty[STAGES];
};

template <int D>
constexpr size_t smem_bytes() {
  return 1024 + (1 + 2 * STAGES) * size_t(Tile<D>::BYTES) + sizeof(Barriers);  // 1024: alignment
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_sm90(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o, int Sq,
               int Sk, int H, int KV, int causal, int window, float scale_log2) {
  using T = Tile<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sq = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sk = sq + T::BYTES;
  uint8_t* sv = sk + STAGES * T::BYTES;
  Barriers& bar = *reinterpret_cast<Barriers*>(sv + STAGES * T::BYTES);

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int kvh = h / (H / KV);
  const int q_start = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int k_hi = causal ? min(Sk, q_start + BQ) : Sk;
  const int k_lo = window > 0 ? max(0, q_start - window + 1) / BK * BK : 0;
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + BK - 1) / BK : 0;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    sm90::mbar_init(&bar.q, 1);
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&bar.k[s], 1);
      sm90::mbar_init(&bar.v[s], 1);
      sm90::mbar_init(&bar.empty[s], 128 * CONSUMERS);
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // ---- producer: one thread keeps the ring of K and V tiles full ----
    sm90::reg_dealloc<40>();
    if (threadIdx.x == CONSUMERS * 128) {
      sm90::mbar_arrive_expect_tx(&bar.q, T::BYTES);
      for (int c = 0; c < T::BOXES; ++c)
        sm90::tma_load_4d(sq + c * T::BOX_BYTES, &tm_q, &bar.q, c * T::BOX_COLS, h, q_start, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        const int k0 = k_lo + j * BK;
        sm90::mbar_wait(&bar.empty[s], ((j / STAGES) & 1) ^ 1);  // round 0 passes at once
        sm90::mbar_arrive_expect_tx(&bar.k[s], T::BYTES);
        for (int c = 0; c < T::BOXES; ++c)
          sm90::tma_load_4d(sk + s * T::BYTES + c * T::BOX_BYTES, &tm_k, &bar.k[s],
                            c * T::BOX_COLS, kvh, k0, b);
        sm90::mbar_arrive_expect_tx(&bar.v[s], T::BYTES);
        for (int c = 0; c < T::BOXES; ++c)
          sm90::tma_load_4d(sv + s * T::BYTES + c * T::BOX_BYTES, &tm_v, &bar.v[s],
                            c * T::BOX_COLS, kvh, k0, b);
      }
    }
  } else {
    // ---- consumers: 64 q rows a warpgroup ----
    sm90::reg_alloc<232>();
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    // This thread's rows of the CTA tile are row0 and row0 + 8; its columns of
    // every 8-column block are col0 and col0 + 1 (the wgmma accumulator layout:
    // element i sits at row row0 + 8 * ((i / 2) % 2), column 8 * (i / 4) + col0 + i % 2).
    const int row0 = wg * 64 + (tid / 32) * 16 + lane / 4;
    const int col0 = (lane % 4) * 2;
    const int q_first = q_start + wg * 64;  // this warpgroup's first q row
    const uint32_t q_addr = sm90::smem_addr(sq) + wg * 64 * T::ROW_BYTES;

    float acc[D / 2];
    float sc[BK / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
    float m[2] = {NEG_INF, NEG_INF};
    float l[2] = {0.f, 0.f};

    sm90::mbar_wait(&bar.q, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % STAGES;
      const uint32_t parity = (j / STAGES) & 1;
      const int k0 = k_lo + j * BK;

      // S = Q K^T, K-major A and B, D / 16 slabs of k16
      sm90::mbar_wait(&bar.k[s], parity);
      const uint32_t k_addr = sm90::smem_addr(sk + s * T::BYTES);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off =
            (kk / T::KSTEPS_PER_BOX) * T::BOX_BYTES + (kk % T::KSTEPS_PER_BOX) * 32;
        sm90::wgmma_m64n128k16_ss(
            sc, sm90::make_desc(q_addr + off, 16, 8 * T::ROW_BYTES, T::ROW_BYTES),
            sm90::make_desc(k_addr + off, 16, 8 * T::ROW_BYTES, T::ROW_BYTES), kk > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) sm90::fence_operand(sc[i]);

      // scale into the log2 domain; mask only a tile that crosses an edge
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) sc[i] *= scale_log2;
      const bool crosses = k0 + BK > Sk || (causal && k0 + BK - 1 > q_first) ||
                           (window > 0 && k0 <= q_first + 63 - window);
      if (crosses) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const int kpos = k0 + 8 * (i / 4) + col0 + i % 2;
          const int qpos = q_start + row0 + 8 * ((i / 2) % 2);
          bool keep = kpos < Sk;
          if (causal) keep = keep && kpos <= qpos;
          if (window > 0) keep = keep && kpos > qpos - window;
          if (!keep) sc[i] = NEG_INF;
        }
      }

      // online softmax, one row per r
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = m[r];
#pragma unroll
        for (int c = 0; c < BK / 8; ++c)
          mx = fmaxf(mx, fmaxf(sc[4 * c + 2 * r], sc[4 * c + 2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float alpha = ex2(m[r] - mx);
        m[r] = mx;
        float sum = 0.f;
#pragma unroll
        for (int c = 0; c < BK / 8; ++c) {
          sc[4 * c + 2 * r] = ex2(sc[4 * c + 2 * r] - mx);
          sc[4 * c + 2 * r + 1] = ex2(sc[4 * c + 2 * r + 1] - mx);
          sum += sc[4 * c + 2 * r] + sc[4 * c + 2 * r + 1];
        }
        l[r] = l[r] * alpha + sum;
#pragma unroll
        for (int c = 0; c < D / 8; ++c) {
          acc[4 * c + 2 * r] *= alpha;
          acc[4 * c + 2 * r + 1] *= alpha;
        }
      }

      // P to bf16: accumulator registers 8kk .. 8kk+7, in pairs, are the
      // A fragment of keys 16kk .. 16kk+15
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int t = 0; t < 4; ++t)
          pa[kk][t] = pack_bf16(sc[8 * kk + 2 * t], sc[8 * kk + 2 * t + 1]);

      // O += P V, V as an MN-major B operand: 16 keys a slab, boxes of
      // BOX_COLS columns BOX_BYTES apart (leading), 8-key groups 8 rows apart (stride)
      sm90::mbar_wait(&bar.v[s], parity);
      const uint32_t v_addr = sm90::smem_addr(sv + s * T::BYTES);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        sm90::wgmma_rs<D>(acc, pa[kk],
                          sm90::make_desc(v_addr + kk * 16 * T::ROW_BYTES, T::BOX_BYTES,
                                          8 * T::ROW_BYTES, T::ROW_BYTES));
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < D / 2; ++i) sm90::fence_operand(acc[i]);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int t = 0; t < 4; ++t) sm90::fence_operand(pa[kk][t]);
      sm90::mbar_arrive(&bar.empty[s]);
    }

    // epilogue: normalise, stage in this warpgroup's rows of the Q buffer (its
    // last read of them has completed), then 16-byte stores of rows < Sq
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = 1.f / fmaxf(l[r], 1e-30f);
    }
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<uint32_t*>(sq + tile_offset<D>(row0 + 8 * r, 8 * c + col0)) =
            pack_bf16(acc[4 * c + 2 * r] * inv[r], acc[4 * c + 2 * r + 1] * inv[r]);
    sm90::named_barrier(1 + wg, 128);
    constexpr int VECS = D / 8;  // 16-byte vectors a row
    for (int idx = tid; idx < 64 * VECS; idx += 128) {
      const int row = wg * 64 + idx / VECS;
      const int col = (idx % VECS) * 8;
      const int qpos = q_start + row;
      if (qpos < Sq)
        *reinterpret_cast<uint4*>(o + ((size_t(b) * Sq + qpos) * H + h) * D + col) =
            *reinterpret_cast<const uint4*>(sq + tile_offset<D>(row, col));
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// (B, S, heads, D) bf16, contiguous, seen as dims (D, heads, S, B) innermost
// first, cut into boxes of (BOX_COLS, 1, 128, 1); rows past S read as zeros.
template <int D>
int encode(CUtensorMap* map, const void* base, int batch, int seq, int heads) {
  using T = Tile<D>;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return ENCODE_FAILED + CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(heads), cuuint64_t(seq),
                              cuuint64_t(batch)};
  const cuuint64_t strides[3] = {2ull * D, 2ull * D * heads, 2ull * D * heads * seq};  // bytes
  const cuuint32_t box[4] = {T::BOX_COLS, 1, 128, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = T::ROW_BYTES == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : T::ROW_BYTES == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                          : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult res =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
         unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : ENCODE_FAILED + int(res);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk, int H,
           int KV, int causal, int window, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (int err = encode<D>(&tq, q, B, Sq, H)) return err;
  if (int err = encode<D>(&tk, k, B, Sk, KV)) return err;
  if (int err = encode<D>(&tv, v, B, Sk, KV)) return err;
  constexpr size_t smem = smem_bytes<D>();
  auto kernel = flash_fwd_sm90<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  kernel<<<grid, THREADS, smem, stream>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(o), Sq, Sk, H,
                                          KV, causal, window,
                                          1.4426950408889634f / std::sqrt(float(D)));
  return cudaGetLastError();
}

}  // namespace

// q, o: (B, Sq, H, D); k, v: (B, Sk, KV, D); bf16, contiguous, 16-byte aligned,
// on the device.  Returns 0 on success, else a cudaError_t, or ENCODE_FAILED
// (10000) + the CUresult of a tensor map that could not be built.
extern "C" int repro_flash_attention_fwd_sm90(const void* q, const void* k, const void* v,
                                              void* o, int B, int Sq, int Sk, int H, int KV,
                                              int D, int causal, int window, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(q, k, v, o, B, Sq, Sk, H, KV, causal, window, s);
    case 32: return launch<32>(q, k, v, o, B, Sq, Sk, H, KV, causal, window, s);
    case 64: return launch<64>(q, k, v, o, B, Sq, Sk, H, KV, causal, window, s);
    case 128: return launch<128>(q, k, v, o, B, Sq, Sk, H, KV, causal, window, s);
    default: return cudaErrorInvalidValue;
  }
}
