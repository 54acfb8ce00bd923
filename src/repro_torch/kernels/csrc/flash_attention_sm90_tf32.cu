// Flash-attention forward in fp32 for Hopper (sm_90a): every product on the
// tensor cores as three TF32 products (3xTF32), TMA loads and a
// warp-specialised producer/consumer pipeline.  Plain C interface for ctypes.
//
// Replaces the TPU kernel `_flash_fwd_kernel` of
// src/repro/kernels/flash_attention.py (launched by `flash_attention_fwd`) for
// fp32 inputs with head_dim 8, 16, 32, 64 or 128; bf16 goes to
// flash_attention_sm90.cu (head_dim >= 16) and flash_attention.cu (8).  It
// computes the same function: softmax(Q K^T / sqrt(D) + mask) V with an online
// softmax whose running max, sum and accumulator are fp32; GQA (query head h
// reads kv head h / (H / KV)); masks kpos < Sk, causal kpos <= qpos (top-left
// aligned when Sq != Sk) and window kpos > qpos - window; masked scores take
// the finite -1e30, never -inf (a row whose first visited tile is fully
// masked is repaired by alpha = exp(-1e30 - m) = 0 on the next tile); the
// output is acc / max(l, 1e-30) in fp32.
//
// 3xTF32.  A TF32 operand keeps 10 mantissa bits, so one TF32 product has a
// relative error of ~2^-11 an operand, which breaks the 2e-5 tolerance of
// the fp32 path.  Each operand x is split as x_hi = tf32(x) (cvt.rna) and
// x_lo = tf32(x - x_hi), and each product a b is formed as a_hi b_hi +
// a_hi b_lo + a_lo b_hi on the tensor cores, accumulated in fp32: the
// dropped a_lo b_lo and the rounding of the lo parts leave ~2^-21 relative.
// This holds for S = Q K^T and for O += P V.  A raw fp32 operand is never
// handed to the tensor cores: every operand is an exact tf32 value, so it
// does not matter how the hardware treats the low 13 bits.
//
// Accuracy beyond the tolerance.  The training step holds each gradient leaf
// of llama3.2-3b to the difference between two plain fp32 paths (its fp32
// floor), and the init's near one-hot attention amplifies any change in the
// forward's rounding: even an fp64 attention lands not far inside that floor
// (chip_smoke.py measures it beside the gate).  Two things push a 3xTF32
// kernel past it, and the design avoids both.  Q_lo rounded to bf16 (2^-20
// of Q): it is kept as fp16 scaled by a power of two a row, exactly.  And the
// tensor cores round each k8 step's sum against the accumulator, so a long
// chain of steps into one large accumulator loses more than fp32 FMAs do: S
// is summed in two accumulators (the small products first, then half the
// slabs of Q_hi K_hi each), and P V from zero for each tile, added to O in
// fp32.
//
// Bound at the llama3.2-3b training shape (B = 2, S = 2048, H = 24, KV = 8,
// D = 128, causal):
//   operations  4 * B * H * D * S (S + 1) / 2 ~= 5.16e10 flop of fp32-accurate
//               work; three TF32 products each at 495 TFLOP/s -> ~0.313 ms
//               (on the CUDA cores at 67 TFLOP/s: ~0.770 ms)
//   bytes       q, k, v read once and o written once ~= 0.10 GB -> ~0.030 ms
//               at 3.35 TB/s, ~0.050 ms with the split copies below
// so the kernel is bound by the tensor cores' TF32 rate.
//
// Design (from flash_attention_sm90.cu, where fp32 breaks its assumptions):
// * The split of K and V, and V's transpose, are done once a call by a small
//   kernel (`split_kv`), not in every CTA: each K and V tile is read by the
//   16 q tiles and 3 query heads that share it at the training shape, and
//   the split would be repeated for each.  It writes k_hi and k_lo in k's
//   layout and vt_hi and vt_lo as (B, KV, D, Skp), keys contiguous, Skp = Sk
//   rounded up to 8 (zeros past Sk): 67 MB written and 34 MB read at the
//   training shape, ~30 us at 3.35 TB/s, inside the wrapper's call and its
//   time.
// * V^T because tf32 wgmma takes K-major operands only (no transpose
//   immediates), so the B operand of P V must hold keys contiguous.  The
//   split kernel writes it rather than the consumers transposing V in shared
//   memory, which would cost a pass over every tile in every CTA.
// * The keys of V^T are permuted within each group of 8.  The accumulator of
//   S gives a thread columns 2t and 2t + 1 of each 8-key group (t = lane % 4),
//   and the register-A fragment of P V asks for columns t and t + 4.  Rather
//   than shuffle P within quads, the kernel passes the accumulator's values
//   as they are, so logical column j of the k8 slab holds key perm(j) = 2j
//   (j < 4) or 2(j - 4) + 1 (j >= 4), and V^T stores key perm(j) at position
//   j of its group to match.  The wrapper's plain `split_kv` does the same,
//   and a CPU test holds P V through this fragment order against P V.
// * Q is split in the CTA, once: each consumer thread reads its own fragment
//   positions of the raw Q tile (TMA-loaded), writes Q_hi back in place for
//   the shared-memory A operand of Q_hi K_hi and Q_hi K_lo, and stores Q_lo
//   in fragment order (8 bytes a thread and k8 slab) as fp16 times 2^(12 - e),
//   2^e <= max |Q| of the row < 2^(e + 1): at most 4 there, and fp16's 11
//   significant bits hold a tf32 exactly (a lo below 2^-26 of the row's
//   largest value falls under fp16's normal range and is off by less than
//   2^-36 of that value, far below fp32's rounding).  Each tile reloads
//   Q_lo, two slabs at a time (the fewest registers live beside S and O),
//   as the register-A operand of Q_lo K_hi, scaled back by 2^(e - 12).  It
//   is not held in registers across the kv loop: ptxas 12.9 gave a
//   loop-carried register-A operand's registers to P's fragments within the
//   loop at D = 64 (the SASS showed it; every D = 64 case then missed the
//   tolerance by 7x), and at D = 128 it would take 64 registers for the whole
//   loop.  Not fp32: 64 KB would not fit at D = 128.
// * One CTA per (128-row q tile, b * H + h), heaviest q tiles first.  288
//   threads: two consumer warpgroups of 64 q rows and one producer warp whose
//   first thread issues every TMA load.  No setmaxnreg: ptxas allocates every
//   thread within the launch's register count anyway (168 at 288 threads).
// * Shared memory, with T = 64 keys x D x 4 bytes (a K or V^T tile): Q
//   128 x D x 4 = 2T, Q_lo in fp16 = T, and a ring of STAGES stages of
//   K_hi + K_lo and V^T_hi + V^T_lo (4T a stage), K and V with their own
//   full and empty barriers so that the next K loads while this tile's P V
//   runs.  D = 128: T = 32 KB and STAGES = 1, 64 + 32 + 128 = 224 KB, with
//   1 KB of alignment and the barriers 230,440 of the 232,448 bytes a block
//   may have.  D <= 64: STAGES = 2, at most 32 + 16 + 128 = 176 KB.
// * A TMA box row is at most 128 bytes (the widest swizzle), 32 fp32 values:
//   a Q or K row of D = 128 is four boxes, 64 two, 32 one at 128-byte
//   swizzle, 16 one at 64-byte and 8 one at 32-byte swizzle (16 bytes is
//   TMA's least box row).  A V^T tile is D rows of 64 keys, two boxes of 32
//   keys at 128-byte swizzle.
// * S = Q K^T: 3 x D / 8 wgmma m64n64k8 a tile (Q_hi K_hi and Q_hi K_lo from
//   shared memory, Q_lo K_hi with Q_lo in registers).  Online softmax on the
//   accumulator fragment in the log2 domain, masks only on tiles that cross
//   Sk, the causal diagonal or the window's edge, as in the bf16 kernel.
//   P is split into P_hi and P_lo fragments in registers; O += P V is
//   3 x 8 wgmma m64nNk8 a tile, N = min(D, 64) columns of O at a time, with
//   B = V^T_hi or V^T_lo from shared memory.
// * Registers at D = 128: O 64, and either S 32 + 32 and Q_lo 8 (S = Q K^T)
//   or P_hi and P_lo 64 and the tile's O 32 (O += P V).  ptxas gives a block
//   of 288 threads at most 168 registers a thread (a launch above that fails
//   with too many resources), so D = 128 spills a little.
// * Epilogue: acc / max(l, 1e-30), staged in the warpgroup's own rows of the
//   Q buffer, then 16-byte stores of the rows < Sq.
// * Both kernels launch on the caller's stream and neither allocates nor
//   synchronises: the wrapper allocates the split copies.  The host builds
//   the five tensor maps per call with cuTensorMapEncodeTiled, reached
//   through the runtime's driver entry point (no -lcuda).

#include <cuda.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "sm90.cuh"

namespace {

constexpr int BQ = 128;  // q rows a CTA
constexpr int BK = 64;   // keys a tile
constexpr int CONSUMERS = 2;  // warpgroups of 64 q rows
constexpr int THREADS = 128 * CONSUMERS + 32;  // + one producer warp
constexpr float NEG_INF = -1e30f;
constexpr int ENCODE_FAILED = 10000;  // + CUresult, for a tensor map that cannot be built
constexpr int SPLIT_KEYS = 32;  // keys a block of split_kv

// Geometry of fp32 tiles of width D in shared memory, as TMA writes them.
template <int D>
struct Tile {
  static constexpr int ROW_BYTES = D >= 32 ? 128 : 4 * D;  // a Q or K box row
  static constexpr int BOX_COLS = ROW_BYTES / 4;
  static constexpr int BOXES = D / BOX_COLS;
  static constexpr int SLABS_PER_BOX = ROW_BYTES / 32;  // k8 slabs of tf32 in a box row
  static constexpr int Q_BOX_BYTES = BQ * ROW_BYTES;
  static constexpr int K_BOX_BYTES = BK * ROW_BYTES;
  static constexpr int VT_BOX_BYTES = D * 128;  // D rows of 32 keys
  static constexpr int Q_BYTES = BQ * D * 4;
  static constexpr int QLO_BYTES = BQ * D * 2;  // Q_lo in fp16, fragment order
  static constexpr int KV_BYTES = BK * D * 4;  // one K or V^T tile, hi or lo
  static constexpr int STAGES = D == 128 ? 1 : 2;
};


// Byte offset of element (row, col) of a Q tile: the box, then the row, then
// the 16-byte group XOR-ed with bits 7.. of the offset (TMA's and wgmma's swizzle).
template <int D>
__device__ __forceinline__ uint32_t q_offset(int row, int col) {
  using T = Tile<D>;
  const uint32_t off = row * T::ROW_BYTES + (col % T::BOX_COLS) * 4;
  constexpr uint32_t mask = T::ROW_BYTES / 16 - 1;
  return (col / T::BOX_COLS) * T::Q_BOX_BYTES + (off ^ (((off >> 7) & mask) << 4));
}

template <int STAGES>
struct Barriers {
  uint64_t q;
  uint64_t k_full[STAGES];
  uint64_t k_empty[STAGES];
  uint64_t v_full[STAGES];
  uint64_t v_empty[STAGES];
};

template <int D>
constexpr size_t smem_bytes() {
  using T = Tile<D>;
  return 1024 + T::Q_BYTES + T::QLO_BYTES + size_t(4) * T::STAGES * T::KV_BYTES +
         sizeof(Barriers<T::STAGES>);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Position j of an 8-key group of V^T holds key perm(j) of the group.
__host__ __device__ __forceinline__ int key_perm(int j) { return j < 4 ? 2 * j : 2 * (j - 4) + 1; }

// k (B, Sk, KV, D) -> k_hi, k_lo in the same layout; v (B, Sk, KV, D) ->
// vt_hi, vt_lo (B, KV, D, Skp) with keys permuted in groups of 8 and zeros
// past Sk.  One block per (32 keys, kv head, batch); V goes through shared
// memory so that both its reads and its transposed writes are coalesced.
template <int D>
__global__ void __launch_bounds__(256)
split_kv(const float* __restrict__ k, const float* __restrict__ v, float* __restrict__ k_hi,
         float* __restrict__ k_lo, float* __restrict__ vt_hi, float* __restrict__ vt_lo, int Sk,
         int KV, int Skp) {
  __shared__ float tile[SPLIT_KEYS][D + 1];
  const int s0 = blockIdx.x * SPLIT_KEYS;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  for (int idx = threadIdx.x; idx < SPLIT_KEYS * D; idx += blockDim.x) {
    const int r = idx / D, c = idx % D;
    const int s = s0 + r;
    float kx = 0.f, vx = 0.f;
    const size_t at = ((size_t(b) * Sk + s) * KV + kvh) * D + c;
    if (s < Sk) {
      kx = k[at];
      vx = v[at];
      const float hi = __uint_as_float(sm90::to_tf32(kx));
      k_hi[at] = hi;
      k_lo[at] = __uint_as_float(sm90::to_tf32(kx - hi));
    }
    tile[r][c] = vx;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < SPLIT_KEYS * D; idx += blockDim.x) {
    const int c = idx / SPLIT_KEYS, j = idx % SPLIT_KEYS;
    const int p = s0 + j;
    if (p >= Skp) continue;
    const float x = tile[(j / 8) * 8 + key_perm(j % 8)][c];
    const float hi = __uint_as_float(sm90::to_tf32(x));
    const size_t at = ((size_t(b) * KV + kvh) * D + c) * Skp + p;
    vt_hi[at] = hi;
    vt_lo[at] = __uint_as_float(sm90::to_tf32(x - hi));
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_tf32(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_khi,
               const __grid_constant__ CUtensorMap tm_klo,
               const __grid_constant__ CUtensorMap tm_vhi,
               const __grid_constant__ CUtensorMap tm_vlo, float* __restrict__ o, int Sq, int Sk,
               int H, int KV, int causal, int window, float scale_log2) {
  using T = Tile<D>;
  constexpr int ST = T::STAGES;
  constexpr int QCH = D / 8 < 2 ? D / 8 : 2;  // Q_lo slabs in registers at a time
  constexpr int PN = D < 64 ? D : 64;         // columns of O a pass of P V
  constexpr int HH2 = D / 16;                  // slabs of Q_hi K_hi summed in sc2
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sq = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sqlo = sq + T::Q_BYTES;
  // stage s: K_hi, K_lo, V^T_hi, V^T_lo, each KV_BYTES
  uint8_t* skv = sqlo + T::QLO_BYTES;
  Barriers<ST>& bar = *reinterpret_cast<Barriers<ST>*>(skv + 4 * ST * T::KV_BYTES);

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
    for (int s = 0; s < ST; ++s) {
      sm90::mbar_init(&bar.k_full[s], 1);
      sm90::mbar_init(&bar.v_full[s], 1);
      sm90::mbar_init(&bar.k_empty[s], 128 * CONSUMERS);
      sm90::mbar_init(&bar.v_empty[s], 128 * CONSUMERS);
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // ---- producer: one thread keeps the K and V rings full ----
    if (threadIdx.x == CONSUMERS * 128) {
      sm90::mbar_arrive_expect_tx(&bar.q, T::Q_BYTES);
      for (int c = 0; c < T::BOXES; ++c)
        sm90::tma_load_4d(sq + c * T::Q_BOX_BYTES, &tm_q, &bar.q, c * T::BOX_COLS, h, q_start, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % ST;
        const uint32_t parity = ((j / ST) & 1) ^ 1;  // round 0 passes at once
        const int k0 = k_lo + j * BK;
        uint8_t* st = skv + 4 * s * T::KV_BYTES;
        sm90::mbar_wait(&bar.k_empty[s], parity);
        sm90::mbar_arrive_expect_tx(&bar.k_full[s], 2 * T::KV_BYTES);
        for (int c = 0; c < T::BOXES; ++c) {
          sm90::tma_load_4d(st + c * T::K_BOX_BYTES, &tm_khi, &bar.k_full[s], c * T::BOX_COLS,
                            kvh, k0, b);
          sm90::tma_load_4d(st + T::KV_BYTES + c * T::K_BOX_BYTES, &tm_klo, &bar.k_full[s],
                            c * T::BOX_COLS, kvh, k0, b);
        }
        sm90::mbar_wait(&bar.v_empty[s], parity);
        sm90::mbar_arrive_expect_tx(&bar.v_full[s], 2 * T::KV_BYTES);
        for (int c = 0; c < BK / 32; ++c) {
          sm90::tma_load_4d(st + 2 * T::KV_BYTES + c * T::VT_BOX_BYTES, &tm_vhi, &bar.v_full[s],
                            k0 + 32 * c, 0, kvh, b);
          sm90::tma_load_4d(st + 3 * T::KV_BYTES + c * T::VT_BOX_BYTES, &tm_vlo, &bar.v_full[s],
                            k0 + 32 * c, 0, kvh, b);
        }
      }
    }
  } else {
    // ---- consumers: 64 q rows a warpgroup ----
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    // This thread's rows of the CTA tile are row0 and row0 + 8; its columns of
    // every 8-column block are col0 and col0 + 1 in the accumulator layout
    // (element i at row row0 + 8 * ((i / 2) % 2), column 8 * (i / 4) + col0 + i % 2)
    // and lane % 4 and lane % 4 + 4 in the register-A fragment.
    const int row0 = wg * 64 + (tid / 32) * 16 + lane / 4;
    const int col0 = (lane % 4) * 2;
    const int q_first = q_start + wg * 64;  // this warpgroup's first q row
    const uint32_t q_addr = sm90::smem_addr(sq) + wg * 64 * T::ROW_BYTES;
    // descriptors of k8 slab kk of this warpgroup's Q_hi and of a K tile at tile_addr
    const auto q_desc = [&](int kk) {
      return sm90::make_desc(q_addr + (kk / T::SLABS_PER_BOX) * T::Q_BOX_BYTES +
                                 (kk % T::SLABS_PER_BOX) * 32,
                             16, 8 * T::ROW_BYTES, T::ROW_BYTES);
    };
    const auto k_desc = [&](uint32_t tile_addr, int kk) {
      return sm90::make_desc(tile_addr + (kk / T::SLABS_PER_BOX) * T::K_BOX_BYTES +
                                 (kk % T::SLABS_PER_BOX) * 32,
                             16, 8 * T::ROW_BYTES, T::ROW_BYTES);
    };

    // split this thread's fragment positions of Q: Q_hi back in place; Q_lo,
    // times 2^(12 - e) with 2^e <= max |Q| of its row < 2^(e + 1), to fp16 (at
    // most 4 there, and its 11 significant bits hold a tf32 exactly), 8 bytes a
    // thread and slab (element t in the half t % 2 of word t / 2)
    uint2* qlo_s = reinterpret_cast<uint2*>(sqlo) + wg * (D / 8) * 128 + tid;
    const auto q_at = [&](int kk, int t) {
      return reinterpret_cast<float*>(
          sq + q_offset<D>(row0 + 8 * (t % 2), 8 * kk + lane % 4 + 4 * (t / 2)));
    };
    sm90::mbar_wait(&bar.q, 0);
    float rmax[2] = {0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk)
#pragma unroll
      for (int t = 0; t < 4; ++t) rmax[t % 2] = fmaxf(rmax[t % 2], fabsf(*q_at(kk, t)));
    float scale[2], unscale[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rmax[r] = fmaxf(rmax[r], __shfl_xor_sync(0xffffffffu, rmax[r], 1));
      rmax[r] = fmaxf(rmax[r], __shfl_xor_sync(0xffffffffu, rmax[r], 2));
      const int e = max(-100, int(__float_as_uint(rmax[r]) >> 23 & 0xFF) - 127);
      scale[r] = __uint_as_float(uint32_t(127 + 12 - e) << 23);
      unscale[r] = __uint_as_float(uint32_t(127 - 12 + e) << 23);
    }
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      __half lo[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        float* p = q_at(kk, t);
        const float x = *p;
        const float hi = __uint_as_float(sm90::to_tf32(x));
        *p = hi;
        lo[t] = __float2half_rn(__uint_as_float(sm90::to_tf32(x - hi)) * scale[t % 2]);
      }
      const __half2 h01 = __halves2half2(lo[0], lo[1]), h23 = __halves2half2(lo[2], lo[3]);
      qlo_s[kk * 128] = make_uint2(*reinterpret_cast<const uint32_t*>(&h01),
                                   *reinterpret_cast<const uint32_t*>(&h23));
    }
    sm90::fence_proxy_async();
    sm90::named_barrier(1 + wg, 128);

    float acc[D / 2];
    float sc[BK / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
    float m[2] = {NEG_INF, NEG_INF};
    float l[2] = {0.f, 0.f};

    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % ST;
      const uint32_t parity = (j / ST) & 1;
      const int k0 = k_lo + j * BK;
      const uint32_t st = sm90::smem_addr(skv + 4 * s * T::KV_BYTES);

      // S = Q_hi K_hi + Q_hi K_lo + Q_lo K_hi over D / 8 slabs of k8, in two
      // accumulators: sc2 sums the small products first, then the last HH2
      // slabs of Q_hi K_hi; sc the first D / 8 - HH2.  The tensor cores round
      // each k8 step's sum to fp32 against the accumulator, so the fewer large
      // steps an accumulator takes, the closer S comes to the plain version.
      sm90::mbar_wait(&bar.k_full[s], parity);
      float sc2[BK / 2];
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        sm90::wgmma_tf32_ss<BK>(sc2, q_desc(kk), k_desc(st + T::KV_BYTES, kk), kk > 0);
        if (kk < D / 8 - HH2) sm90::wgmma_tf32_ss<BK>(sc, q_desc(kk), k_desc(st, kk), kk > 0);
      }
      sm90::wgmma_commit();
      // Q_lo K_hi, QCH slabs of Q_lo at a time from shared memory: fp16 times
      // this row's power of two, an exact tf32
#pragma unroll
      for (int c0 = 0; c0 < D / 8; c0 += QCH) {
        uint32_t qlo[QCH][4];
#pragma unroll
        for (int c = 0; c < QCH; ++c) {
          const uint2 pair = qlo_s[(c0 + c) * 128];
          const __half2 h01 = *reinterpret_cast<const __half2*>(&pair.x);
          const __half2 h23 = *reinterpret_cast<const __half2*>(&pair.y);
          qlo[c][0] = __float_as_uint(__low2float(h01) * unscale[0]);
          qlo[c][1] = __float_as_uint(__high2float(h01) * unscale[1]);
          qlo[c][2] = __float_as_uint(__low2float(h23) * unscale[0]);
          qlo[c][3] = __float_as_uint(__high2float(h23) * unscale[1]);
        }
        sm90::wgmma_fence();
#pragma unroll
        for (int c = 0; c < QCH; ++c)
          sm90::wgmma_tf32_rs<BK>(sc2, qlo[c], k_desc(st, c0 + c), 1);
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
#pragma unroll
        for (int c = 0; c < QCH; ++c)
#pragma unroll
          for (int t = 0; t < 4; ++t) sm90::fence_operand(qlo[c][t]);
      }
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = D / 8 - HH2; kk < D / 8; ++kk)
        sm90::wgmma_tf32_ss<BK>(sc2, q_desc(kk), k_desc(st, kk), 1);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        sm90::fence_operand(sc[i]);
        sm90::fence_operand(sc2[i]);
        sc[i] += sc2[i];
      }
      sm90::mbar_arrive(&bar.k_empty[s]);

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

      // P split into tf32 hi and lo fragments.  The accumulator's registers
      // 4kk .. 4kk+3 hold (row0, 2t), (row0, 2t+1), (row0+8, 2t), (row0+8, 2t+1)
      // of keys 8kk .. 8kk+7; passed as a[0], a[2], a[1], a[3] they stand at
      // logical columns t and t + 4, which V^T's key permutation matches.
      uint32_t phi[BK / 8][4], plo[BK / 8][4];
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk)
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const float x = sc[4 * kk + (t == 1 ? 2 : t == 2 ? 1 : t)];
          phi[kk][t] = sm90::to_tf32(x);
          plo[kk][t] = sm90::to_tf32(x - __uint_as_float(phi[kk][t]));
        }

      // O += P_hi V_hi + P_hi V_lo + P_lo V_hi, V^T K-major: slab kk is 32
      // bytes into box kk / 4 of 32 keys, 8-row groups 1024 bytes apart.  The
      // tile's products are summed from zero, PN columns of O at a time, and
      // added to O in fp32, so that the tensor cores' rounding is against this
      // tile's sum and not against O's.
      sm90::mbar_wait(&bar.v_full[s], parity);
#pragma unroll
      for (int h = 0; h < D / PN; ++h) {
        float ot[PN / 2];
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 8; ++kk) {
          const uint32_t off = (kk / 4) * T::VT_BOX_BYTES + (kk % 4) * 32 + h * PN * 128;
          const uint64_t vhd = sm90::make_desc(st + 2 * T::KV_BYTES + off, 16, 1024, 128);
          const uint64_t vld = sm90::make_desc(st + 3 * T::KV_BYTES + off, 16, 1024, 128);
          sm90::wgmma_tf32_rs<PN>(ot, phi[kk], vhd, kk > 0);
          sm90::wgmma_tf32_rs<PN>(ot, phi[kk], vld, 1);
          sm90::wgmma_tf32_rs<PN>(ot, plo[kk], vhd, 1);
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < PN / 2; ++i) {
          sm90::fence_operand(ot[i]);
          acc[h * (PN / 2) + i] += ot[i];
        }
      }
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk)
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          sm90::fence_operand(phi[kk][t]);
          sm90::fence_operand(plo[kk][t]);
        }
      sm90::mbar_arrive(&bar.v_empty[s]);
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
        *reinterpret_cast<float2*>(sq + q_offset<D>(row0 + 8 * r, 8 * c + col0)) =
            make_float2(acc[4 * c + 2 * r] * inv[r], acc[4 * c + 2 * r + 1] * inv[r]);
    sm90::named_barrier(1 + wg, 128);
    constexpr int VECS = D / 4;  // 16-byte vectors a row
    for (int idx = tid; idx < 64 * VECS; idx += 128) {
      const int row = wg * 64 + idx / VECS;
      const int col = (idx % VECS) * 4;
      const int qpos = q_start + row;
      if (qpos < Sq)
        *reinterpret_cast<uint4*>(o + ((size_t(b) * Sq + qpos) * H + h) * D + col) =
            *reinterpret_cast<const uint4*>(sq + q_offset<D>(row, col));
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

// A contiguous fp32 tensor of dims (innermost first) `dims`, cut into boxes
// `box` whose rows are `row_bytes` (the swizzle width); reads past an edge
// give zeros.
int encode(CUtensorMap* map, const void* base, const cuuint64_t (&dims)[4],
           const cuuint32_t (&box)[4], int row_bytes) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return ENCODE_FAILED + CUDA_ERROR_NOT_FOUND;
  const cuuint64_t strides[3] = {4 * dims[0], 4 * dims[0] * dims[1],
                                 4 * dims[0] * dims[1] * dims[2]};  // bytes
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = row_bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : row_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                       : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult res =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(base), dims, strides, box,
         unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : ENCODE_FAILED + int(res);
}

template <int D>
int launch_split(const float* k, const float* v, float* k_hi, float* k_lo, float* vt_hi,
                 float* vt_lo, int B, int Sk, int KV, int Skp, cudaStream_t stream) {
  const dim3 grid((Skp + SPLIT_KEYS - 1) / SPLIT_KEYS, KV, B);
  split_kv<D><<<grid, 256, 0, stream>>>(k, v, k_hi, k_lo, vt_hi, vt_lo, Sk, KV, Skp);
  return cudaGetLastError();
}

template <int D>
int launch(const void* q, const void* k_hi, const void* k_lo, const void* vt_hi,
           const void* vt_lo, void* o, int B, int Sq, int Sk, int H, int KV, int Skp, int causal,
           int window, cudaStream_t stream) {
  using T = Tile<D>;
  CUtensorMap tq, tkh, tkl, tvh, tvl;
  const cuuint32_t q_box[4] = {T::BOX_COLS, 1, BQ, 1};
  const cuuint32_t k_box[4] = {T::BOX_COLS, 1, BK, 1};
  const cuuint32_t vt_box[4] = {32, D, 1, 1};
  const cuuint64_t q_dims[4] = {D, cuuint64_t(H), cuuint64_t(Sq), cuuint64_t(B)};
  const cuuint64_t k_dims[4] = {D, cuuint64_t(KV), cuuint64_t(Sk), cuuint64_t(B)};
  const cuuint64_t vt_dims[4] = {cuuint64_t(Skp), D, cuuint64_t(KV), cuuint64_t(B)};
  if (int err = encode(&tq, q, q_dims, q_box, T::ROW_BYTES)) return err;
  if (int err = encode(&tkh, k_hi, k_dims, k_box, T::ROW_BYTES)) return err;
  if (int err = encode(&tkl, k_lo, k_dims, k_box, T::ROW_BYTES)) return err;
  if (int err = encode(&tvh, vt_hi, vt_dims, vt_box, 128)) return err;
  if (int err = encode(&tvl, vt_lo, vt_dims, vt_box, 128)) return err;
  constexpr size_t smem = smem_bytes<D>();
  auto kernel = flash_fwd_tf32<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  kernel<<<grid, THREADS, smem, stream>>>(tq, tkh, tkl, tvh, tvl, static_cast<float*>(o), Sq, Sk,
                                          H, KV, causal, window,
                                          1.4426950408889634f / std::sqrt(float(D)));
  return cudaGetLastError();
}

}  // namespace

// k, v: (B, Sk, KV, D) fp32, contiguous, on the device; k_hi, k_lo in k's
// layout and vt_hi, vt_lo (B, KV, D, Skp), Skp = Sk rounded up to 8, written.
// Returns 0 on success, else a cudaError_t.
extern "C" int repro_flash_tf32_split_kv(const void* k, const void* v, void* k_hi, void* k_lo,
                                         void* vt_hi, void* vt_lo, int B, int Sk, int KV, int D,
                                         int Skp, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  auto* kh = static_cast<float*>(k_hi);
  auto* kl = static_cast<float*>(k_lo);
  auto* vh = static_cast<float*>(vt_hi);
  auto* vl = static_cast<float*>(vt_lo);
  switch (D) {
    case 8: return launch_split<8>(kf, vf, kh, kl, vh, vl, B, Sk, KV, Skp, s);
    case 16: return launch_split<16>(kf, vf, kh, kl, vh, vl, B, Sk, KV, Skp, s);
    case 32: return launch_split<32>(kf, vf, kh, kl, vh, vl, B, Sk, KV, Skp, s);
    case 64: return launch_split<64>(kf, vf, kh, kl, vh, vl, B, Sk, KV, Skp, s);
    case 128: return launch_split<128>(kf, vf, kh, kl, vh, vl, B, Sk, KV, Skp, s);
    default: return cudaErrorInvalidValue;
  }
}

// q, o: (B, Sq, H, D); k_hi, k_lo: (B, Sk, KV, D); vt_hi, vt_lo: (B, KV, D, Skp)
// from repro_flash_tf32_split_kv; fp32, contiguous, 16-byte aligned, on the
// device.  Returns 0 on success, else a cudaError_t, or ENCODE_FAILED (10000)
// + the CUresult of a tensor map that could not be built.
extern "C" int repro_flash_attention_fwd_tf32(const void* q, const void* k_hi, const void* k_lo,
                                              const void* vt_hi, const void* vt_lo, void* o,
                                              int B, int Sq, int Sk, int H, int KV, int D,
                                              int Skp, int causal, int window, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto run = [&](auto launcher) {
    return launcher(q, k_hi, k_lo, vt_hi, vt_lo, o, B, Sq, Sk, H, KV, Skp, causal, window, s);
  };
  switch (D) {
    case 8: return run(launch<8>);
    case 16: return run(launch<16>);
    case 32: return run(launch<32>);
    case 64: return run(launch<64>);
    case 128: return run(launch<128>);
    default: return cudaErrorInvalidValue;
  }
}
