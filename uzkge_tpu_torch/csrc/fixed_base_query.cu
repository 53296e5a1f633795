// The fixed-base query over BN254 G1: the MSM over the signed-window table,
// the device half of msm/fixed_base.py::FixedBaseTable.msm_mont.  Per-lane
// arithmetic in fixed_base_query.cuh; the level's batch inversion is
// fixed_base.cu's fq_batch_inv.
//
// fb_select replaces msm/fixed_base.py::_select_kernel (uzkge_tpu, :607).  The
//   TPU streams the whole vertical (D, 32, K) table through a D-way where-chain
//   because its gathers of 64 B rows were slow; here one thread per (MSM p,
//   leaf k) reads the one 64 B row |d| - 1 of its leaf's block of D rows and
//   writes x and y (negated for d < 0) and the identity flag.  Bound: bytes,
//   P*K rows of 64 B gathered (268 MB at P = 8, K = 524288, against 4.29 GB
//   for a stream of the table), the digits read and the leaves written; rows
//   are 64 B aligned, so a row is two whole 32 B sectors.
// fb_pair_den replaces _pair_den_kernel (:630) and _pair_den_small_kernel
//   (:737): one thread per (p, pair j) of a level pairs leaf j with leaf
//   j + H of its MSM and writes den = x2 - x1 (1 where substituted) and the
//   flags.  Bound: bytes (no product).  One kernel for every H: the TPU's
//   small variant existed only for levels narrower than its 128 lanes.
// fb_pair_combine replaces _pair_combine_kernel (:652) and
//   _pair_combine_small_kernel (:757): three Montgomery products per (p,
//   pair).  Bound: bytes (232 B per pair against 792 32-bit multiplies: at
//   the card's rates the bytes take longer), so the design keeps the memory
//   busy while the products run.  Pairs j .. j + B - 1 of MSM p (a tile; B
//   the largest power of two dividing H up to 128, so a tile never straddles
//   an MSM) read five contiguous spans of B elements: x[p, j..], x[p,
//   j + H..], y[p, j..], y[p, j + H..] and dinv[p H + j..].  Persistent
//   blocks (4 per SM) walk the tiles; in each block one thread issues the
//   tile's five spans as TMA bulk copies (cp.async.bulk, completing on an
//   mbarrier) into a ring of 2 stages of shared memory.  The threads take a
//   tile's operands into registers, and the stage is refilled at once with
//   the tile after next, whose bytes are then in flight while this tile's
//   products run.  A thread takes one pair of the tile (the flags, 4 B a
//   pair, it loads itself before waiting: a tile's flags may be under the
//   bulk copies' 16 B granule), writes the sums into shared memory, and the
//   block copies them out 16 bytes a thread, neighbours adjacent.  The
//   arithmetic is fb_pair_combine_pair, which the CPU suite runs.
// fb_fold replaces _fold8_kernel (:680) and the XLA halving of the remainder
//   (:1164-1174): block b folds the tile of T consecutive points b*T ..
//   b*T + T - 1 (T a power of two up to 512 dividing each MSM's count) to
//   one, by 8-to-1 halving trees while 8 divides the count, then one tree
//   over the 2 or 4 left.  Bound: operations (12 products per addition
//   against 96 B per point), but a thread's additions are a dependent chain
//   of ~20 us each, so the time is the depth of the tree in additions, and
//   the design cuts that depth: the tree runs across threads.  In each
//   halving step thread t adds pairs t, t + B, ... (fb_fold_pair), the first
//   step from device memory, later ones from the T / 2 sums in shared memory
//   (X, Y and Z in separate planes), each round of B pairs reading before a
//   barrier and rewriting after it (fb_fold_tile, which the CPU suite also
//   runs).  The launch takes the widest block B that lets every tile's
//   block be resident at once (one wave): at P = 8 MSMs of 65,536 points,
//   1024 blocks of 64 threads, 13 additions deep, then one block of 64 per
//   MSM over the 128 left, 7 deep; a thread per group of 8 ran 7 additions
//   in a row per 8-to-1 fold, 36 in all, over several waves.  Values stay
//   canonical, where the TPU kept afield's lazy [0, 2p).
#include <cuda_runtime.h>

#include "fixed_base_query.cuh"
#include "launch.cuh"

namespace {

__global__ void __launch_bounds__(256)
fb_select_kernel(const uint32_t *__restrict__ table, const int32_t *__restrict__ digits,
                 uint32_t *__restrict__ x, uint32_t *__restrict__ y, int32_t *__restrict__ inf,
                 long long P, long long K, int D) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;  // t = p * K + k
  if (t < P * K) fb_select_lane(table, digits, x, y, inf, t, K, D);
}

__global__ void __launch_bounds__(256)
fb_pair_den_kernel(const uint32_t *__restrict__ x, const int32_t *__restrict__ inf,
                   uint32_t *__restrict__ den, int32_t *__restrict__ flags, long long P,
                   long long H) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;  // t = p * H + j
  if (t < P * H) fb_pair_den_lane(x, inf, den, flags, t, H);
}

#define PC_PAIRS 128  // pairs per tile (at most), one thread each
#define PC_STAGES 2   // tiles in the ring
#define PC_BLOCKS_PER_SM 4

__device__ __forceinline__ uint32_t smem_u32(const void *p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t *bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// arrive on `bar` and expect `bytes` more of transactions in this phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t *bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t *bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA bulk copy of `bytes` (a multiple of 16, both ends 16 B aligned) from
// device memory into shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(void *dst, const void *src, uint32_t bytes,
                                          uint64_t *bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Shared memory: PC_STAGES stages of five spans of B elements (x1, x2, y1,
// y2, dinv), then the sums (xo, yo: 2B elements), then the stages' mbarriers.
__global__ void __launch_bounds__(PC_PAIRS)
fb_pair_combine_kernel(const uint32_t *__restrict__ x, const uint32_t *__restrict__ y,
                       const uint32_t *__restrict__ dinv, const int32_t *__restrict__ flags,
                       uint32_t *__restrict__ xo, uint32_t *__restrict__ yo,
                       int32_t *__restrict__ info, long long H, long long tiles) {
  extern __shared__ uint4 pc_smem[];
  const int B = (int)blockDim.x, tid = (int)threadIdx.x;
  uint32_t *stage0 = reinterpret_cast<uint32_t *>(pc_smem);
  uint32_t *out = stage0 + PC_STAGES * 5 * B * 8;
  uint64_t *bar = reinterpret_cast<uint64_t *>(out + 2 * B * 8);
  const long long first = blockIdx.x, stride = gridDim.x;
  const long long mine = tiles > first ? (tiles - first + stride - 1) / stride : 0;
  const uint32_t span = (uint32_t)B * 32;

  auto issue = [&](long long it) {  // thread 0: the spans of tile `it` of this block
    const long long t0 = (first + it * stride) * B, p = t0 / H, j = t0 % H;
    const int s = (int)(it % PC_STAGES);
    uint32_t *st = stage0 + s * 5 * B * 8;
    mbar_expect_tx(&bar[s], 5 * span);
    bulk_load(st, x + (p * 2 * H + j) * 8, span, &bar[s]);
    bulk_load(st + B * 8, x + (p * 2 * H + H + j) * 8, span, &bar[s]);
    bulk_load(st + 2 * B * 8, y + (p * 2 * H + j) * 8, span, &bar[s]);
    bulk_load(st + 3 * B * 8, y + (p * 2 * H + H + j) * 8, span, &bar[s]);
    bulk_load(st + 4 * B * 8, dinv + t0 * 8, span, &bar[s]);
  };

  if (tid == 0) {
    for (int s = 0; s < PC_STAGES; s++) mbar_init(&bar[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (long long it = 0; it < PC_STAGES && it < mine; it++) issue(it);

  for (long long it = 0; it < mine; it++) {
    const long long t0 = (first + it * stride) * B;
    const int32_t f = flags[t0 + tid];
    const int s = (int)(it % PC_STAGES);
    mbar_wait(&bar[s], (uint32_t)((it / PC_STAGES) & 1));
    const uint32_t *st = stage0 + s * 5 * B * 8;
    uint32_t x1[8], x2[8], y1[8], y2[8], d[8], ox[8], oy[8];
    ld_fp(x1, st + tid * 8);
    ld_fp(x2, st + (B + tid) * 8);
    ld_fp(y1, st + (2 * B + tid) * 8);
    ld_fp(y2, st + (3 * B + tid) * 8);
    ld_fp(d, st + (4 * B + tid) * 8);
    __syncthreads();  // stage s is in registers (and the last tile's `out` copied)
    if (tid == 0 && it + PC_STAGES < mine) issue(it + PC_STAGES);
    info[t0 + tid] = fb_pair_combine_pair(x1, x2, y1, y2, d, f, ox, oy);
    st_fp(out + tid * 8, ox);
    st_fp(out + (B + tid) * 8, oy);
    __syncthreads();  // the tile's sums are in `out`
    for (int c = tid; c < 4 * B; c += B) {  // 16-byte chunks: xo's 2B, then yo's 2B
      uint32_t *dst = c < 2 * B ? xo + t0 * 8 + c * 4 : yo + t0 * 8 + (c - 2 * B) * 4;
      *reinterpret_cast<uint4 *>(dst) = *reinterpret_cast<const uint4 *>(out + c * 4);
    }
  }
}

__global__ void __launch_bounds__(FB_FOLD_THREADS, 2)
fb_fold_kernel(const uint32_t *__restrict__ X, const uint32_t *__restrict__ Y,
               const uint32_t *__restrict__ Z, uint32_t *__restrict__ oX,
               uint32_t *__restrict__ oY, uint32_t *__restrict__ oZ, int T) {
  extern __shared__ uint4 fold_smem[];  // three planes of T / 2 points
  uint32_t *sX = reinterpret_cast<uint32_t *>(fold_smem);
  uint32_t *sY = sX + (T / 2) * 8, *sZ = sY + (T / 2) * 8;
  FoldBlock blk;
  blk.B = (int)blockDim.x;
  fb_fold_tile(blk, X, Y, Z, sX, sY, sZ, oX, oY, oZ, (long long)blockIdx.x, T);
}

unsigned blocks_for(long long lanes, int threads) {
  return (unsigned)((lanes + threads - 1) / threads);
}

}  // namespace

extern "C" int fb_select_launch(const void *table, const void *digits, void *x, void *y, void *inf,
                                long long P, long long K, int D, void *stream) {
  if (P < 1 || K < 1 || D < 1) return (int)cudaErrorInvalidValue;
  fb_select_kernel<<<blocks_for(P * K, 256), 256, 0, (cudaStream_t)stream>>>(
      (const uint32_t *)table, (const int32_t *)digits, (uint32_t *)x, (uint32_t *)y,
      (int32_t *)inf, P, K, D);
  return (int)cudaGetLastError();
}

extern "C" int fb_pair_den_launch(const void *x, const void *inf, void *den, void *flags,
                                  long long P, long long H, void *stream) {
  if (P < 1 || H < 1) return (int)cudaErrorInvalidValue;
  fb_pair_den_kernel<<<blocks_for(P * H, 256), 256, 0, (cudaStream_t)stream>>>(
      (const uint32_t *)x, (const int32_t *)inf, (uint32_t *)den, (int32_t *)flags, P, H);
  return (int)cudaGetLastError();
}

extern "C" int fb_pair_combine_launch(const void *x, const void *y, const void *dinv,
                                      const void *flags, void *xo, void *yo, void *info,
                                      long long P, long long H, void *stream) {
  if (P < 1 || H < 1) return (int)cudaErrorInvalidValue;
  const long long low = H & -H;  // the tile: the largest power of two dividing H, <= PC_PAIRS
  const int B = (int)(low < PC_PAIRS ? low : PC_PAIRS);
  const long long tiles = P * H / B;
  const size_t smem = (size_t)(PC_STAGES * 5 + 2) * B * 32 + PC_STAGES * 8;
  const cudaError_t e = allow_smem((const void *)fb_pair_combine_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const long long most = (long long)device_sms() * PC_BLOCKS_PER_SM;
  const long long grid = tiles < most ? tiles : most;
  fb_pair_combine_kernel<<<(unsigned)grid, B, smem, (cudaStream_t)stream>>>(
      (const uint32_t *)x, (const uint32_t *)y, (const uint32_t *)dinv, (const int32_t *)flags,
      (uint32_t *)xo, (uint32_t *)yo, (int32_t *)info, H, tiles);
  return (int)cudaGetLastError();
}

// tiles = P * Kc / T: the output's elements
extern "C" int fb_fold_launch(const void *X, const void *Y, const void *Z, void *oX, void *oY,
                              void *oZ, long long tiles, int T, void *stream) {
  if (tiles < 1 || T < 2 || T > FB_FOLD_TILE || (T & (T - 1))) return (int)cudaErrorInvalidValue;
  const int B = fold_threads((const void *)fb_fold_kernel, tiles, T, FB_FOLD_THREADS);
  fb_fold_kernel<<<(unsigned)tiles, B, (size_t)T * 48, (cudaStream_t)stream>>>(
      (const uint32_t *)X, (const uint32_t *)Y, (const uint32_t *)Z, (uint32_t *)oX,
      (uint32_t *)oY, (uint32_t *)oZ, T);
  return (int)cudaGetLastError();
}
