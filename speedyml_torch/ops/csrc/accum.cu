// Compensated normal-equation accumulation for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of speedyml/ops/accum.py:
//   * _accum_scan_pallas / _kernel_scan (accum.py:77-128): fold a whole
//     training series, chunk by chunk, into the (hi, lo) pair;
//   * _accum_pallas / _kernel (accum.py:39-74): the same fold for ONE chunk.
// One kernel serves both: the single-chunk case is T == chunk.
//
// What it computes, for every region r:
//   for each chunk c of the T axis:  D = aug_c^T aug_c   (f32 accuracy, na x na)
//                                    (hi, lo) <- two_sum(hi, lo, D)
// The kernel's chunk is 32 time steps whatever the caller's: two-sum keeps
// the rounding error of every hi + D exactly, so folding shorter pieces
// loses nothing, and a shorter D suffers less from the tensor cores'
// truncating accumulator (see 2. below).
// aug is read in its (T, R, na) layout through the strides it is given. hi
// and lo are updated IN PLACE, where the Pallas chunk kernel aliased its
// inputs to its outputs (input_output_aliases={2: 0, 3: 1}).
//
// What bounds it on an H100: per region the fold costs 2*T*na^2 FLOP against
// 2*na^2*8 bytes of hi/lo traffic (each read once and written once). For the
// short series of one training block (T = 256) the accumulator traffic is
// the larger floor (3.35 TB/s of HBM); for a long series the product is.
// Plain f32 FFMA (67 TFLOP/s) would sit above both, so the product goes to
// the tensor cores. The design, in two launches:
//
//   1. split_kernel, a small pre-pass. TF32 keeps 11 significand bits, far
//      fewer than the f32 accuracy D needs, so every aug value is split into
//      big = tf32(a) and small = tf32(a - big) (the subtraction is exact)
//      and D is formed from three tensor-core products,
//      small*big + big*small + big*big, summed in f32 accumulators. wgmma
//      takes TF32 operands from shared memory only with the reduction axis
//      (here: time) contiguous, while aug is contiguous along na. The
//      pre-pass therefore writes both planes transposed, zero-padded at the
//      ragged na and T edges, and already in the 128-byte-swizzled image
//      that wgmma reads: 64 (na) x 32 (time) tiles of 8 KB, ordered
//      [region][plane][time block][na tile]. Any aug strides are taken here,
//      with plain loads; the scratch it writes is always aligned.
//   2. fold_kernel. One warpgroup per block owns a 64 x 128 tile of one
//      region and keeps its D, hi and lo values in registers for the whole
//      series (3 x 64 per thread), so the accumulators cross HBM exactly
//      once per launch, as the TPU scan kernel kept its block resident in
//      VMEM across t. The operand tiles come through a ring of shared-memory
//      stages filled by bulk asynchronous copies (cp.async.bulk, the TMA
//      engine without a tensor map: every tile image is one contiguous
//      block of the scratch), completion signalled on an mbarrier per stage.
//      Loads of the next time block run under the wgmma products of the
//      current one and of its fold. Two blocks are resident per SM: one
//      block's hi/lo traffic, folds and stores overlap the other's products.
//      The hi and lo tiles travel as bulk copies too, a row (up to 512
//      bytes) a thread, through the stage buffers while the ring is idle
//      (before the first and after the last time block): read straight into
//      the wgmma fragment, a warp's access touches 8 rows at 32 bytes each
//      and the hi/lo pass alone takes twice a plain copy's time. Shapes
//      whose rows do not start on 16 bytes keep that direct path.
//      What sets the pace at T = 256 once hi and lo move at copy speed: the
//      operand tiles, 48 KB per block and time block from the L2 (every
//      64 x 128 tile re-reads them), about 6 TB/s over the card.
//      Sharing the column-side tile between two blocks of a cluster
//      (multicast) or between two warpgroups of one block was measured
//      slower: both tie the sharers into lockstep and lose the overlap.
//      The tensor cores add into their f32 accumulator by truncation, not by
//      rounding to nearest. Summed over a 128-step chunk in one accumulator
//      that bias reached 1.1e-6 of a diagonal entry; with D restarted every
//      32 steps and the small products added first it is 1.7e-7, and D's
//      rms error is below that of an f32 FFMA sum.
//
// Two-sum needs IEEE round-to-nearest adds and subtracts with no
// reassociation, no contraction and no flush-to-zero: the fold uses the
// __fadd_rn/__fsub_rn intrinsics (never fused or reordered by the compiler)
// and the library is built without --use_fast_math.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRows = 64;      // rows of D per warpgroup (wgmma M) and per scratch tile
constexpr int kCols = 128;     // columns of D per block (wgmma N)
constexpr int kDepth = 32;     // time steps per stage: 128 bytes of tf32, one swizzle row
constexpr int kImage = kRows * kDepth;        // floats in one 64 x 32 tile image
constexpr int kImageBytes = kImage * 4;       // 8 KB
constexpr int kSplitThreads = 256;

__device__ __forceinline__ void two_sum(float &hi, float &lo, float d) {
  const float s = __fadd_rn(hi, d);
  const float v = __fsub_rn(s, hi);
  const float e = __fadd_rn(__fsub_rn(hi, __fsub_rn(s, v)), __fsub_rn(d, v));
  hi = s;
  lo = __fadd_rn(lo, e);
}

__device__ __forceinline__ float to_tf32(float x) {
  uint32_t u;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(u) : "f"(x));
  return __uint_as_float(u);
}

// ---------------------------------------------------------------------------
// Pre-pass: split, transpose, pad and swizzle.
// grid (na tiles of 64, time blocks of 32, regions)
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kSplitThreads)
split_kernel(const float *__restrict__ aug, long long s_t, long long s_r,
             long long s_a, float *__restrict__ planes, int T, int na) {
  __shared__ float tile[kDepth][kRows + 1];
  const int nt64 = gridDim.x, KB = gridDim.y;
  const int tile64 = blockIdx.x, kb = blockIdx.y, r = blockIdx.z;
  const int t0 = kb * kDepth;
  const int a0 = tile64 * kRows;
  const float *aug_r = aug + (long long)r * s_r;

  // consecutive threads read consecutive columns (coalesced for s_a == 1)
  for (int e = threadIdx.x; e < kDepth * kRows; e += kSplitThreads) {
    const int k = e / kRows, col = e % kRows;
    const int t = t0 + k, a = a0 + col;
    tile[k][col] = (t < T && a < na)
                       ? aug_r[(long long)t * s_t + (long long)a * s_a] : 0.f;
  }
  __syncthreads();

  // image row = na index (128 bytes = 32 time steps); its 16-byte piece q is
  // stored at piece q ^ (row % 8): the 128-byte swizzle of wgmma and TMA
  float *big = planes + ((((size_t)r * 2 + 0) * KB + kb) * nt64 + tile64) * kImage;
  float *small = planes + ((((size_t)r * 2 + 1) * KB + kb) * nt64 + tile64) * kImage;
  for (int e = threadIdx.x; e < kRows * 8; e += kSplitThreads) {
    const int row = e / 8, q = e % 8;
    float b[4], s[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float v = tile[4 * q + i][row];
      b[i] = to_tf32(v);
      s[i] = to_tf32(__fsub_rn(v, b[i]));
    }
    const int off = row * kDepth + ((q ^ (row & 7)) * 4);
    *reinterpret_cast<float4 *>(big + off) = make_float4(b[0], b[1], b[2], b[3]);
    *reinterpret_cast<float4 *>(small + off) = make_float4(s[0], s[1], s[2], s[3]);
  }
}

// ---------------------------------------------------------------------------
// PTX helpers
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void *p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// contiguous global -> shared copy by the TMA engine, completion on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void *src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// contiguous shared -> global copy by the TMA engine, tracked by the
// sending thread's bulk group
__device__ __forceinline__ void bulk_store(void *dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst),
               "r"(src), "r"(bytes)
               : "memory");
}

// wgmma shared-memory descriptor: K-major tile, 128-byte swizzle, 8-row
// groups 1024 bytes apart (the leading offset is unused in this mode)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// pins the accumulator registers between the asynchronous products and the
// code around them: the compiler sees no other tie from the wait to d
__device__ __forceinline__ void fence_operand(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, f32) = a (64 x 8) * b (128 x 8)^T + (scale_d ? d : 0), tf32
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// two neighbouring accumulator values of one row; streaming (hi/lo are
// touched once per launch and should not push the operand tiles out of L2)
__device__ __forceinline__ void load2(const float *p, int row, int col, int na,
                                      bool vec2, float &x, float &y) {
  x = 0.f;
  y = 0.f;
  if (row < na && col < na) {
    const float *q = p + (size_t)row * na + col;
    if (vec2) {
      const float2 v = __ldcs(reinterpret_cast<const float2 *>(q));
      x = v.x;
      y = v.y;
    } else {
      x = __ldcs(q);
      if (col + 1 < na) y = __ldcs(q + 1);
    }
  }
}

__device__ __forceinline__ void store2(float *p, int row, int col, int na,
                                       bool vec2, float x, float y) {
  if (row < na && col < na) {
    float *q = p + (size_t)row * na + col;
    if (vec2) {
      __stcs(reinterpret_cast<float2 *>(q), make_float2(x, y));
    } else {
      __stcs(q, x);
      if (col + 1 < na) __stcs(q + 1, y);
    }
  }
}

// ---------------------------------------------------------------------------
// The fold.
// grid (column tiles of 128, row tiles of 64, regions), one warpgroup a block
// ---------------------------------------------------------------------------
constexpr int kThreads = 128;
constexpr int kStages = 2;
constexpr int kABytes = kImageBytes;          // one plane, row side (64 rows)
constexpr int kBBytes = 2 * kImageBytes;      // one plane, column side (128 rows)
constexpr int kStageBytes = 2 * kABytes + 2 * kBBytes;
constexpr int kSmemBytes = kStages * kStageBytes + 1024;   // + alignment
// hi and lo tiles pass through the (then idle) stage buffers on their way in
// and out: rows of 128 floats on a pitch of 136, which keeps the float2
// accesses of the accumulator fragment free of bank conflicts
constexpr int kAccPitch = kCols + 8;
constexpr int kAccTileBytes = kRows * kAccPitch * 4;
static_assert(2 * kAccTileBytes <= kStages * kStageBytes, "staging fits");

// kBulk: hi and lo rows start on 16 bytes and travel as bulk copies
template <bool kBulk>
__global__ void __launch_bounds__(kThreads, 2)
fold_kernel(const float *__restrict__ planes, float *__restrict__ hi,
            float *__restrict__ lo, int na, int nt64, int KB, int vec2) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages + 1];   // + hi/lo arrival

  const int tid = threadIdx.x;
  const int jt = blockIdx.x, it = blockIdx.y, r = blockIdx.z;
  // the swizzle is a function of the address: tiles start on 1024 bytes
  const uint32_t smem = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar0 = smem_u32(full);
  const uint32_t acc_bar = bar0 + 8 * kStages;

  if (tid == 0) {
    for (int s = 0; s <= kStages; ++s) mbar_init(bar0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // thread 0 is the producer: one stage = both planes of the row-side tile
  // (64 rows) and of the column-side tile (128 rows) of time block kb
  auto request = [&](int kb) {
    const int s = kb % kStages;
    const uint32_t bar = bar0 + 8 * s;
    const uint32_t dst = smem + s * kStageBytes;
    mbar_expect_tx(bar, kStageBytes);
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const float *src = planes + (((size_t)r * 2 + p) * KB + kb) * nt64 * kImage;
      bulk_load(dst + p * kABytes, src + (size_t)it * kImage, kABytes, bar);
      bulk_load(dst + 2 * kABytes + p * kBBytes, src + (size_t)jt * 2 * kImage,
                kBBytes, bar);
    }
  };
  // accumulator fragment of wgmma m64n128: thread (warp w, lane l) holds, for
  // n = 0..15, rows 16 w + l / 4 (+ 8) and columns 8 n + 2 (l % 4) (+ 1)
  const int lane = tid % 32, warp = tid / 32;
  const int row0 = it * kRows + warp * 16 + lane / 4;
  const int col0 = jt * kCols + 2 * (lane % 4);
  float *hi_r = hi + (size_t)r * na * na;
  float *lo_r = lo + (size_t)r * na * na;

  // Where rows start on 16 bytes (kBulk), the tile's rows travel as bulk
  // copies of up to 512 bytes through shared memory, one row of hi or lo a
  // thread: every request to the L2 is a full line. Read straight into the
  // fragment instead, a warp's load touches 8 rows at 32 bytes each, and
  // the request rate, not the bytes, sets the pace (measured: twice the
  // time of a plain copy). That direct path stays for odd shapes.
  const int rows_valid = min(kRows, na - it * kRows);
  const uint32_t row_bytes = 4 * min(kCols, na - jt * kCols);
  const int my_row = tid % kRows, my_mat = tid / kRows;     // 0: hi, 1: lo
  float *my_g = (my_mat ? lo_r : hi_r) +
                (size_t)(it * kRows + my_row) * na + jt * kCols;
  const uint32_t my_s = smem + my_mat * kAccTileBytes + my_row * kAccPitch * 4;
  // this thread's first fragment element in a staged tile
  const uint32_t frag_s = smem + ((warp * 16 + lane / 4) * kAccPitch +
                                  2 * (lane % 4)) * 4;

  float h[64], l[64], d[64];
  if constexpr (kBulk) {
    if (tid == 0) mbar_expect_tx(acc_bar, 2 * rows_valid * row_bytes);
    __syncthreads();
    if (my_row < rows_valid) bulk_load(my_s, my_g, row_bytes, acc_bar);
    mbar_wait(acc_bar, 0);
    // rows and columns past na hold whatever the buffer held; they are
    // folded like the rest and never stored
#pragma unroll
    for (int n = 0; n < 16; ++n) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const uint32_t a = frag_s + (8 * half * kAccPitch + 8 * n) * 4;
        const int i = 4 * n + 2 * half;
        // "memory": these reads stay before the barrier below
        asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];"
                     : "=f"(h[i]), "=f"(h[i + 1]) : "r"(a) : "memory");
        asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];"
                     : "=f"(l[i]), "=f"(l[i + 1]) : "r"(a + kAccTileBytes)
                     : "memory");
      }
    }
    // the staged tiles are read: the ring may start. The ring is written by
    // the copy engine, which is ordered after these reads only by the fence.
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
  } else {
#pragma unroll
    for (int n = 0; n < 16; ++n) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + 8 * half, col = col0 + 8 * n, i = 4 * n + 2 * half;
        load2(hi_r, row, col, na, vec2, h[i], h[i + 1]);
        load2(lo_r, row, col, na, vec2, l[i], l[i + 1]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;

  int next = 0;                       // next time block to request (thread 0)
  if (tid == 0)
    for (; next < KB && next < kStages; ++next) request(next);
  __syncwarp();

  for (int kb = 0; kb < KB; ++kb) {
    const int s = kb % kStages;
    mbar_wait(bar0 + 8 * s, (kb / kStages) & 1);
    const uint32_t st = smem + s * kStageBytes;
    const uint64_t a_big = smem_desc(st);
    const uint64_t a_small = smem_desc(st + kABytes);
    const uint64_t b_big = smem_desc(st + 2 * kABytes);
    const uint64_t b_small = smem_desc(st + 2 * kABytes + kBBytes);

    // D of these 32 time steps, from 0. 8 time steps = 32 bytes along the
    // swizzled row: +2 in the descriptor. The small products go first: the
    // accumulator truncates, and their sum from 0 is small enough for that
    // to cost nothing; only the four big products round at D's own size.
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kDepth / 8; ++ks) {
      wgmma_tf32(d, a_small + 2 * ks, b_big + 2 * ks, ks != 0);
      wgmma_tf32(d, a_big + 2 * ks, b_small + 2 * ks, 1);
    }
#pragma unroll
    for (int ks = 0; ks < kDepth / 8; ++ks)
      wgmma_tf32(d, a_big + 2 * ks, b_big + 2 * ks, 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(d);

    // every warp is past the products that read this stage: refill it, and
    // fold while the copy is on its way
    __syncthreads();
    if (tid == 0 && next < KB) request(next++);
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 64; ++i) two_sum(h[i], l[i], d[i]);
  }

  if constexpr (kBulk) {
    // the last products are done in every warp (the loop's barrier): the
    // stage buffers are free to carry the tiles out
    __syncthreads();
#pragma unroll
    for (int n = 0; n < 16; ++n) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const uint32_t a = frag_s + (8 * half * kAccPitch + 8 * n) * 4;
        const int i = 4 * n + 2 * half;
        asm volatile("st.shared.v2.f32 [%0], {%1, %2};" ::"r"(a), "f"(h[i]),
                     "f"(h[i + 1]) : "memory");
        asm volatile("st.shared.v2.f32 [%0], {%1, %2};" ::"r"(a + kAccTileBytes),
                     "f"(l[i]), "f"(l[i + 1]) : "memory");
      }
    }
    // make the writes visible to the copy engine, then every thread sends
    // its row and waits until the engine has read it
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (my_row < rows_valid) bulk_store(my_g, my_s, row_bytes);
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  } else {
#pragma unroll
    for (int n = 0; n < 16; ++n) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + 8 * half, col = col0 + 8 * n, i = 4 * n + 2 * half;
        store2(hi_r, row, col, na, vec2, h[i], h[i + 1]);
        store2(lo_r, row, col, na, vec2, l[i], l[i + 1]);
      }
    }
  }
}

}  // namespace

extern "C" {

// Floats of scratch that accum_ss_launch needs for a (T, R, na) series.
long long accum_ss_scratch_floats(int T, int R, int na) {
  const long long KB = (T + kDepth - 1) / kDepth;
  const long long nt64 = (na + kCols - 1) / kCols * 2;
  return (long long)R * 2 * KB * nt64 * kImage;
}

// Launches the pre-pass and the fold on `stream` (a cudaStream_t) of device
// `device`.
// aug: (T, R, na) f32 read through the element strides s_t, s_r, s_a;
// hi, lo: contiguous (R, na, na) f32, updated in place;
// planes: accum_ss_scratch_floats(T, R, na) floats, 16-byte aligned.
// Returns the first CUDA error of the two launches (0 on success).
int accum_ss_launch(const float *aug, long long s_t, long long s_r,
                    long long s_a, float *hi, float *lo, float *planes, int T,
                    int R, int na, int device, void *stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int KB = (T + kDepth - 1) / kDepth;
  const int nt64 = (na + kCols - 1) / kCols * 2;
  split_kernel<<<dim3(nt64, KB, R), kSplitThreads, 0, stream>>>(
      aug, s_t, s_r, s_a, planes, T, na);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // float2 accesses to hi/lo need row starts on 8 bytes, bulk copies on 16
  const int vec2 = na % 2 == 0 && (uintptr_t)hi % 8 == 0 && (uintptr_t)lo % 8 == 0;
  const bool bulk = na % 4 == 0 && (uintptr_t)hi % 16 == 0 && (uintptr_t)lo % 16 == 0;
  auto kernel = bulk ? fold_kernel<true> : fold_kernel<false>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(nt64 / 2, (na + kRows - 1) / kRows, R);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(planes, hi, lo, na, nt64, KB,
                                                 vec2);
  return (int)cudaGetLastError();
}

const char *accum_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
