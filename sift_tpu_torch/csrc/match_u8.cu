// Brute-force matching of uint8 descriptors with Lowe's ratio test, from
// the rows and masks straight to the int32 indices.
//
// Replaces no TPU kernel: the JAX package leaves the matcher to XLA
// (sift_tpu/pipeline/matcher.py).  It replaces the port's PyTorch distance
// chain (kernels/match.match_u8_plain): a float32 Gram product and some
// twenty-five elementwise and reduction kernels over [..., Q, S] float32
// temporaries.  Its result is the plain version's, index for index.
//
// What it computes, per train set b and query row q:
//   d[q, j] = |q|^2 + |t_j|^2 - 2 q.t_j  as exact integers (d < 2^23), or
//             exactly 1e9 where train row j is masked;
//   min1 and its column (the lowest one on a tie), min2 the smallest over
//   the other columns (a duplicate of min1 gives min2 == min1);
//   out = (float)min1 < (float)ratio * (float)min2 && q_valid ? col : -1.
//
// Bound on the H100: int8 tensor-core operations, 2 * Q * S * 128 a set
// (bench_port/rooflines.match_work: 2.56e11 a 4K call, 0.129 ms at 1979
// TOP/s).  Beside the product sit Q * S top-2 updates on the CUDA cores
// (1e9 a 4K call).  What the design does about both:
//   * the product is wgmma m64n64k32 u8 x u8 -> s32 (exact): a block is
//     one warpgroup that owns 64 query rows, held as register A fragments
//     for the whole kernel; the train rows come in tiles of 64 through a
//     three-slot cp.async ring in shared memory, 128-byte swizzled as
//     wgmma reads them.  A tile's four k-steps are issued back to back and
//     waited for once; the five warpgroups resident on an SM overlap one's
//     product with another's epilogue.  Not mma.sync: it runs u8 at about
//     a quarter of the peak, and on it the product set the pace (0.52 ms a
//     4K call, against 0.41 here).  One accumulator set: with a second one,
//     to overlap inside a warpgroup, ptxas serialises the k-steps (C7514)
//     and the kernel is slower.
//   * no [..., Q, S] value leaves the registers: each accumulator is
//     turned into one 32-bit key by ONE integer multiply-add,
//         key = acc * -64 + cols[j],  cols[j] = (|t_j|^2 + 2^24) * 32 + id,
//     whose bits above the low 5 order the distances (|q|^2 is a constant
//     of the row and is added at the end) and whose low 5 bits name the column
//     among the 32 that a thread sees of each 128 (lower id, lower
//     column); a masked or padded row has |t_j|^2 replaced by 2^25, which
//     puts its key above every real one;
//   * the running top-2 of keys is three min/max a value:
//         k2 = min(k2, max(k1, k)),  k1 = min(k1, k);
//     every 128 columns the keys are folded into the thread's (min1,
//     column, min2) in distance units, and after the last tile the four
//     threads that share a row merge theirs with two shuffles.
//   A pre-pass kernel makes cols[] (the masked norms) once a call.  No
//   atomics: the result does not depend on the order of the blocks.
#include "common.cuh"

#define MU_THREADS 128        // one warpgroup
#define MU_QROWS 64           // query rows a block owns: 16 a warp
#define MU_TROWS 64           // train rows a ring slot holds (wgmma's N)
#define MU_NSTAGE 3           // slots of the shared-memory ring
#define MU_MIN_BLOCKS 5       // blocks resident on an SM
#define MU_EPOCH 128          // columns a key's 5-bit id spans
#define MU_OFF (1 << 24)      // keeps every key positive
#define MU_SENT (1 << 25)     // |t|^2 of a masked or padded train row
#define MU_MASKED (1 << 25)   // a distance unit at or above it is 1e9
#define MU_BIG 1e9f           // the masked distance, as the plain version
#define MU_KEY_MAX 0x7fffffff
#define MU_TILE_BYTES (MU_TROWS * 128)

__device__ __forceinline__ void mu_cp_async16(unsigned dst, const void* src,
                                              int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes));
}

// Stage train rows [base, base + MU_TROWS) of a set at the shared address
// ``slot`` (1024-byte aligned), 128-byte swizzled: the 16-byte chunk c of
// row r lands at r * 128 + (c ^ (r % 8)) * 16, the layout wgmma reads with
// a SWIZZLE_128B descriptor.  Rows at or past s are zero-filled (nothing is
// read for them).  Their cols[] go to ``cslot`` (nothing past s_pad).  No
// commit.
__device__ __forceinline__ void mu_load_tile(unsigned slot, unsigned cslot,
                                             const uint8_t* tb,
                                             const int* cb, int base,
                                             int s, int s_pad) {
#pragma unroll
  for (int i = 0; i < MU_TROWS * 8 / MU_THREADS; ++i) {
    const int c = i * MU_THREADS + threadIdx.x;
    const int r = c >> 3, ch = c & 7;
    const bool in = base + r < s;
    mu_cp_async16(slot + r * 128 + ((ch ^ (r & 7)) << 4),
                  tb + (long long)(in ? base + r : 0) * 128 + ch * 16,
                  in ? 16 : 0);
  }
  if (threadIdx.x < MU_TROWS / 4)
    mu_cp_async16(cslot + threadIdx.x * 16,
                  cb + (base < s_pad ? base : 0) + threadIdx.x * 4,
                  base < s_pad ? 16 : 0);
}

// wgmma's shared-memory descriptor of a K-major, 128-byte swizzled tile:
// start address >> 4, leading offset 1 (unused when swizzled), stride 1024
// bytes between 8-row groups, layout SWIZZLE_128B.
__device__ __forceinline__ unsigned long long mu_desc(unsigned addr) {
  return (unsigned long long)((addr >> 4) & 0x3FFF) | (1ull << 16) |
         ((unsigned long long)(1024 >> 4) << 32) | (1ull << 62);
}

// The warpgroup's d[64 x 64] (+)= a[64 x 32] (registers) * tile[64 x 32]^T.
__device__ __forceinline__ void mu_wgmma(int* d, const unsigned* a,
                                         unsigned long long desc,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.u8.u8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate));
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous product's issue and wait.
__device__ __forceinline__ void mu_pin(int* d) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d = the product of the tile at shared address ``slot``: four k-steps of
// 32 bytes (the first one overwrites d), one commit group, waited for.
__device__ __forceinline__ void mu_product(int* d, const unsigned (*a)[4],
                                           unsigned slot) {
  mu_pin(d);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    mu_wgmma(d, a[ks], mu_desc(slot + ks * 32), ks);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  mu_pin(d);
}

__device__ __forceinline__ void mu_top2(int& k1, int& k2, int k) {
  k2 = min(k2, max(k1, k));
  k1 = min(k1, k);
}

// cols[b, j] for j < s_pad: the key constant of train row j of set b.
__global__ void __launch_bounds__(256)
match_u8_cols_kernel(const uint8_t* __restrict__ train, long long t_bstride,
                     const uint8_t* __restrict__ tvalid,
                     long long tv_bstride, int* __restrict__ cols, int nsets,
                     int s, int s_pad) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)nsets * s_pad) return;
  const int b = (int)(i / s_pad), j = (int)(i % s_pad);
  int tn = MU_SENT;
  if (j < s && (tvalid == nullptr || tvalid[b * tv_bstride + j])) {
    const uint4* row =
        (const uint4*)(train + b * t_bstride + (long long)j * 128);
    unsigned acc = 0;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const uint4 w = row[c];
      acc = __dp4a(w.x, w.x, acc);
      acc = __dp4a(w.y, w.y, acc);
      acc = __dp4a(w.z, w.z, acc);
      acc = __dp4a(w.w, w.w, acc);
    }
    tn = (int)acc;
  }
  cols[i] = (tn + MU_OFF) * 32 + ((j & (MU_EPOCH - 1)) >> 3) * 2 + (j & 1);
}

// A thread's running top-2 of its two rows (h = 0, 1: rows g and g + 8 of
// its warp): the keys of the current 128-column epoch, and the distance
// units and column of everything before it.
struct MuState {
  int k1[2], k2[2], v1[2], i1[2], v2[2];
};

// Tile ``it``'s accumulators into the running top-2.  Accumulator 4 n + e
// of the tile is row e / 2, column 8 n + 2 tq + e % 2.  ``FOLD``: the tile
// ends a 128-column epoch (the odd tiles), whose keys are then folded into
// distance units; a strict < keeps the earlier (lower) column on a tie.
template <bool FOLD>
__device__ __forceinline__ void mu_epilogue(MuState& st, const int* d,
                                            const int* ct, int it, int tq) {
#pragma unroll
  for (int n = 0; n < MU_TROWS / 8; ++n) {
    const int2 c = *(const int2*)&ct[n * 8 + tq * 2];
    mu_top2(st.k1[0], st.k2[0], d[4 * n] * -64 + c.x);
    mu_top2(st.k1[0], st.k2[0], d[4 * n + 1] * -64 + c.y);
    mu_top2(st.k1[1], st.k2[1], d[4 * n + 2] * -64 + c.x);
    mu_top2(st.k1[1], st.k2[1], d[4 * n + 3] * -64 + c.y);
  }
  if (FOLD) {
    const int eb = it / 2 * MU_EPOCH;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int u1 = st.k1[h] >> 5, u2 = st.k2[h] >> 5, id = st.k1[h] & 31;
      const int col = eb + (id >> 1) * 8 + tq * 2 + (id & 1);
      st.v2[h] = min(st.v2[h], min(u2, max(st.v1[h], u1)));
      st.i1[h] = u1 < st.v1[h] ? col : st.i1[h];
      st.v1[h] = min(st.v1[h], u1);
      st.k1[h] = st.k2[h] = MU_KEY_MAX;
    }
  }
}

// The ring's step ``it``: once tile it has landed, tile it + MU_NSTAGE - 1
// goes into the slot of tile it - 1 (done with), and tile it's product
// goes through the epilogue.  One cp.async commit group a step, empty past
// the last tile, so that every wait counts the same.
template <bool FOLD>
__device__ __forceinline__ void mu_step(int it, int* d,
                                        const unsigned (*a)[4],
                                        unsigned ring, unsigned cring,
                                        const int* cts, const uint8_t* tb,
                                        const int* cb, int s, int s_pad,
                                        MuState& st, int tq) {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(MU_NSTAGE - 2));
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const int fill = it + MU_NSTAGE - 1;
  mu_load_tile(ring + (fill % MU_NSTAGE) * MU_TILE_BYTES,
               cring + (fill % MU_NSTAGE) * MU_TROWS * 4, tb, cb,
               fill * MU_TROWS, s, s_pad);
  asm volatile("cp.async.commit_group;\n" ::);
  mu_product(d, a, ring + (it % MU_NSTAGE) * MU_TILE_BYTES);
  mu_epilogue<FOLD>(st, d, cts + (it % MU_NSTAGE) * MU_TROWS, it, tq);
}

__global__ void __launch_bounds__(MU_THREADS, MU_MIN_BLOCKS)
match_u8_kernel(const uint8_t* __restrict__ query, long long q_bstride,
                const uint8_t* __restrict__ qvalid, long long qv_bstride,
                const uint8_t* __restrict__ train, long long t_bstride,
                const int* __restrict__ cols, int nq, int s, int s_pad,
                float ratio, int* __restrict__ out) {
  // The ring's slots on 1024-byte boundaries (the swizzle's period).
  __shared__ __align__(1024) uint8_t raw[MU_NSTAGE * MU_TILE_BYTES + 1024];
  __shared__ __align__(16) int ctile[MU_NSTAGE * MU_TROWS];
  const unsigned ring =
      ((unsigned)__cvta_generic_to_shared(raw) + 1023u) & ~1023u;
  const unsigned cring = (unsigned)__cvta_generic_to_shared(ctile);

  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int row0 = blockIdx.x * MU_QROWS + (threadIdx.x >> 5) * 16;
  const uint8_t* tb = train + b * t_bstride;
  const int* cb = cols + (long long)b * s_pad;

  // The warp's 16 query rows as A fragments, k-steps of 32 bytes: a thread
  // holds rows g (h = 0) and g + 8 (h = 1), bytes 4 tq .. 4 tq + 3 and
  // 16 + 4 tq .. of each step; qn[h] is the row's |q|^2.
  unsigned a[4][4];
  int qn[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + h * 8 + g;
    const unsigned* p =
        (const unsigned*)(query + b * q_bstride + (long long)r * 128);
    unsigned sq = 0;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const unsigned lo = r < nq ? p[ks * 8 + tq] : 0u;
      const unsigned hi = r < nq ? p[ks * 8 + 4 + tq] : 0u;
      a[ks][h] = lo;
      a[ks][2 + h] = hi;
      sq = __dp4a(lo, lo, sq);
      sq = __dp4a(hi, hi, sq);
    }
    sq += __shfl_xor_sync(0xffffffffu, sq, 1);
    sq += __shfl_xor_sync(0xffffffffu, sq, 2);
    qn[h] = (int)sq;
  }

  MuState st;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    st.k1[h] = st.k2[h] = st.v1[h] = st.v2[h] = MU_KEY_MAX;
    st.i1[h] = 0;
  }
  int acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0;

  // Tiles 0 .. MU_NSTAGE - 2 in flight, then the steps, two at a time: the
  // odd tiles end a 128-column epoch.
  const int ntiles = s_pad / MU_TROWS;   // even: s_pad is a multiple of 128
#pragma unroll
  for (int p = 0; p < MU_NSTAGE - 1; ++p) {
    mu_load_tile(ring + p * MU_TILE_BYTES, cring + p * MU_TROWS * 4, tb, cb,
                 p * MU_TROWS, s, s_pad);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int it = 0; it < ntiles; it += 2) {
    mu_step<false>(it, acc, a, ring, cring, ctile, tb, cb, s, s_pad, st, tq);
    mu_step<true>(it + 1, acc, a, ring, cring, ctile, tb, cb, s, s_pad, st,
                  tq);
  }

  // Merge the four threads of a row (tq = 0..3): the lower column wins a
  // tie, as in the plain version.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const int o1 = __shfl_xor_sync(0xffffffffu, st.v1[h], off);
      const int oi = __shfl_xor_sync(0xffffffffu, st.i1[h], off);
      const int o2 = __shfl_xor_sync(0xffffffffu, st.v2[h], off);
      st.v2[h] = min(max(st.v1[h], o1), min(st.v2[h], o2));
      st.i1[h] = (o1 < st.v1[h] || (o1 == st.v1[h] && oi < st.i1[h]))
                     ? oi : st.i1[h];
      st.v1[h] = min(st.v1[h], o1);
    }
  }
  // Threads tq = 0 and 1 of the quad write rows g and g + 8.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + h * 8 + g;
    if (h != tq || row >= nq) continue;
    // Every real distance is an integer below 2^23: exact in float32.  All
    // rows masked: min1 == min2 == 1e9 at column 0, as torch.min gives.
    const bool none = st.v1[h] >= MU_MASKED;
    const float d1 = none ? MU_BIG : (float)(qn[h] + st.v1[h] - MU_OFF);
    const float d2 = st.v2[h] >= MU_MASKED
                         ? MU_BIG : (float)(qn[h] + st.v2[h] - MU_OFF);
    const bool ok = d1 < __fmul_rn(ratio, d2) &&
                    (qvalid == nullptr || qvalid[b * qv_bstride + row]);
    out[(long long)b * nq + row] = ok ? (none ? 0 : st.i1[h]) : -1;
  }
}

// query [*, nq, 128] u8 (set b at query + b * q_bstride bytes: 0 where
// one query set serves every train set), qvalid bool (b * qv_bstride + q,
// or null: all valid), train [*, s, 128] u8 (b * t_bstride), tvalid bool
// (b * tv_bstride + j, or null), cols: int32 scratch of nsets * s_pad,
// s_pad = s rounded up to 128; out: [nsets, nq] int32.  Every row pointer
// is 16-byte aligned.  Two launches on ``stream``, no synchronisation;
// returns cudaGetLastError().
SIFT_API int sift_match_u8(const void* query, long long q_bstride,
                           const void* qvalid, long long qv_bstride,
                           const void* train, long long t_bstride,
                           const void* tvalid, long long tv_bstride,
                           void* cols, void* out, int nsets, int nq, int s,
                           float ratio, void* stream) {
  if (nsets <= 0 || nq <= 0 || s <= 0) return 0;
  const int s_pad = (s + MU_EPOCH - 1) / MU_EPOCH * MU_EPOCH;
  const cudaStream_t st = (cudaStream_t)stream;
  const long long n = (long long)nsets * s_pad;
  match_u8_cols_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      (const uint8_t*)train, t_bstride, (const uint8_t*)tvalid, tv_bstride,
      (int*)cols, nsets, s, s_pad);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dim3 grid((nq + MU_QROWS - 1) / MU_QROWS, nsets);
  match_u8_kernel<<<grid, MU_THREADS, 0, st>>>(
      (const uint8_t*)query, q_bstride, (const uint8_t*)qvalid, qv_bstride,
      (const uint8_t*)train, t_bstride, (const int*)cols, nq, s, s_pad,
      ratio, (int*)out);
  return (int)cudaGetLastError();
}
