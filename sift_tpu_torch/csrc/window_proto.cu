// Three schemes for loading per-keypoint windows, head to head on a toy
// column sum:  out[k, :] = sum_i slab[ys0[k]+i, xs0[k] : xs0[k]+128]  for
// k < count, zeros for count <= k < K.
//
// Replaces the TPU experiment kernels of scripts/dma_proto.py:
//   window_colsum_static  p0  (:86, pallas_call :101): static grid over the
//                         capacity, 2-slot double buffer of whole windows;
//   window_colsum_par     p0b (:123, pallas_call :142): p0 plus a blocked
//                         [block_k, 16] parameter tile, par[k, 0] added to
//                         every live row k with k % block_k == 0;
//   window_colsum_ring    p1  (:196, pallas_call :210): one program that
//                         loops over the LIVE blocks only, nbuf-slot ring.
//
// What bounds them on the H100.  The bytes bound counts each input byte
// once: the slab rows the live windows touch (at most the slab), the
// output and the origins (0.00265 ms at the experiment's workload).  But
// the windows overlap: 1080 live 72 x 128 windows come from 1,281 distinct
// positions of a 6.3 MB slab, 39.8 MB of window reads.  A kernel that gets
// each window on its own (a warp loading it from global memory, or a TMA
// tile per window) moves those 39.8 MB from L2 into the SMs, ~7x the slab,
// at the L2 -> SM rate, and cannot come near the bound however it stages.
//
// static / par: strip owners instead of window owners, two launches.
//   colsum_bucket  one block per key (strip of strip_rows rows holding
//                  y0, 128-column tile of x0).  Every block clamps the live
//                  origins, counts the windows per key and scans windows
//                  and items per key; then it writes its own key's items
//                  (runs of at most `chunk` windows) and its windows'
//                  indices and clamped origins in index order (a stable
//                  counting sort, one key per block).
//   colsum_strip   a grid fixed by the capacity, ceil(K / chunk) + keys
//                  blocks, so the host never waits for the count.  Block
//                  b < items stages the bounding box of its item's windows
//                  ONCE in shared memory with 16-byte cp.async (for
//                  128-aligned origins at most strip_rows + rows - 1 rows
//                  x 128 columns); each warp then sums up to STRIP_MAXM
//                  windows ranked by row: every lane one float4 column,
//                  rows in order from shared memory, each row read once for
//                  all of the warp's windows that share their columns,
//                  par[k, 0] (par) added last.  Windows of a strip share
//                  their rows, so the L2 -> SM bytes fall to the boxes
//                  (~11 MB at the workload).  The blocks left without an
//                  item write the zero rows past count.  A box the buffer
//                  cannot hold (x0 not 128-aligned, an out-of-contract
//                  rows) is staged in loads of as many rows as it holds.
//                  The sum of every window is the plain version's,
//                  0 + row 0 + row 1 + ... in float32: bit for bit.
//   ring           Hopper's counterpart of the TPU's DMA ring: a persistent
//                  grid (as many blocks as the card holds at once) whose
//                  blocks walk the live windows only, interleaved (block b
//                  takes windows b, b + grid, ...).  Thread 0 copies each
//                  window in bands of band_rows x 128 f32 with the Tensor
//                  Memory Accelerator (cp.async.bulk.tensor.2d, one
//                  instruction per band, a tensor map over the slab) into
//                  an nbuf-slot ring in shared memory; each slot has a
//                  "full" mbarrier that the copy completes by its byte
//                  count and an "empty" one that every warp arrives on once
//                  it has summed the slot.  The ring runs across window
//                  boundaries.  The warps split a window's rows, read the
//                  slot with float4 loads and combine their sums in a fixed
//                  order (another order than the plain version's).
//
// Origins are clamped into the slab and xs0 aligned down to 4 floats, so an
// out-of-contract origin can never fault (the plain version does the same).
#include <cuda.h>  // CUtensorMap and its enums: types only, no -lcuda

#include "common.cuh"

#define WP_LANES 128
#define RING_ROW_BYTES (WP_LANES * 4)
#define WP_NPAR 16
// The most dynamic shared memory one block may have (bytes).
#define WP_SMEM_MAX (227 * 1024)
// Metadata bytes per window of a strip item (index, origin, parameter,
// rank), besides 16 bytes for the item's box.
#define STRIP_META 20
// The most windows one warp of a strip block sums.
#define STRIP_MAXM 2
// Warps of a bucket block.
#define BUCKET_WARPS 8

__device__ __forceinline__ void clamp_origin(const int* ys0, const int* xs0,
                                             int k, int h, int w, int rows,
                                             int* y0, int* x0) {
  int y = ys0[k], x = xs0[k];
  y = y < 0 ? 0 : (y > h - rows ? h - rows : y);
  x = x < 0 ? 0 : (x > w - WP_LANES ? w - WP_LANES : x);
  *y0 = y;
  *x0 = x & ~3;
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// --- static / par: bucket pass, then strip owners --------------------------

// The plan both launches share, in int32 words of one scratch tensor
// (perf/window_proto.plan_views reads the same layout):
//   items[max_items] as int4 {key, first, n, 0}, n_items (+3 words of pad),
//   bucket_count[n_buckets], bucket_start[n_buckets], origin[k_cap] as int2
//   {y0, x0} (clamped) and order[k_cap] (window indices), both by position.
struct StripPlan {
  int4* items;
  int* n_items;
  int* bucket_count;
  int* bucket_start;
  int2* origin;
  int* order;
};

__host__ __device__ __forceinline__ StripPlan strip_plan_at(int* base,
                                                         int max_items,
                                                         int n_buckets,
                                                         int k_cap) {
  StripPlan p;
  p.items = reinterpret_cast<int4*>(base);
  p.n_items = base + 4 * max_items;
  p.bucket_count = p.n_items + 4;
  p.bucket_start = p.bucket_count + n_buckets;
  p.origin = reinterpret_cast<int2*>(p.bucket_start + n_buckets);
  p.order = reinterpret_cast<int*>(p.origin + k_cap);
  return p;
}

// Rows of one strip load: the aligned box, at least 2 (so that a box of
// 63 float4 columns still takes a row), at most what the block may hold
// beside its metadata (STRIP_META bytes per window, 16 for the box).
static int strip_buf_rows(int rows, int strip_rows, int chunk) {
  const int fit = (WP_SMEM_MAX - STRIP_META * chunk - 16) / RING_ROW_BYTES;
  int r = strip_rows + rows - 1;
  r = r < 2 ? 2 : r;
  return r < fit ? r : fit;
}

static int strip_smem_bytes(int buf_rows, int chunk) {
  return buf_rows * RING_ROW_BYTES + STRIP_META * chunk + 16;
}

// Shared memory of a bucket block (bytes; 0 if it does not fit): 32 scan
// slots of 8 bytes, per window its clamped origin and key, the count per
// key, the block's key's first slot and first item, 32 warp totals.
static int bucket_smem_bytes(int n_buckets, int k_cap) {
  const long long b = 4ll * (64 + 3ll * k_cap + n_buckets + 2 + 32);
  return b <= WP_SMEM_MAX ? (int)b : 0;
}

// Exclusive prefix sum over the block of one value per thread; *total gets
// the sum.  ``red``: 32 slots.  Returns synchronised.
__device__ __forceinline__ long long block_exclusive_scan(long long v,
                                                          long long* red,
                                                          long long* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  long long x = v;
  for (int d = 1; d < 32; d <<= 1) {
    const long long y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) red[warp] = x;
  __syncthreads();
  if (warp == 0) {
    long long s = lane < nw ? red[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const long long y = __shfl_up_sync(0xffffffffu, s, d);
      if (lane >= d) s += y;
    }
    red[lane] = s;
  }
  __syncthreads();
  *total = red[31];
  return x - v + (warp > 0 ? red[warp - 1] : 0);
}

// One block per key b, BUCKET_WARPS warps.  Every block keys all live
// windows and counts them per key (shared-memory atomics: counts do not
// depend on the order), scans windows and items per key (counts in the
// low, items in the high 32 bits), then compacts ITS key's windows in
// index order (one ballot per 32 windows, the warps' totals scanned per
// tile of blockDim windows) into order / origin from the key's first slot
// on, and writes the key's items.  Block 0 writes the item count.  The
// blocks share no data, so the plan is the same whichever order they run
// in.
__global__ void __launch_bounds__(32 * BUCKET_WARPS)
colsum_bucket_kernel(const int* __restrict__ ys0, const int* __restrict__ xs0,
                     const int* __restrict__ count, int* __restrict__ scratch,
                     int k_cap, int h, int w, int rows, int strip_rows,
                     int chunk, int tiles_x, int n_buckets, int max_items) {
  extern __shared__ long long bucket_smem[];
  long long* red = bucket_smem;                      // [32]
  int2* org = reinterpret_cast<int2*>(red + 32);     // [k_cap]
  int* key = reinterpret_cast<int*>(org + k_cap);    // [k_cap]
  int* hist = key + k_cap;                           // [n_buckets]
  int* mine = hist + n_buckets;                      // first slot, item
  int* wtot = mine + 2;                              // [32]
  const StripPlan plan = strip_plan_at(scratch, max_items, n_buckets, k_cap);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.x;
  for (int i = tid; i < n_buckets; i += blockDim.x) hist[i] = 0;
  const int live = max(0, min(*count, k_cap));
  __syncthreads();
#pragma unroll 4
  for (int k = tid; k < live; k += blockDim.x) {
    int y0, x0;
    clamp_origin(ys0, xs0, k, h, w, rows, &y0, &x0);
    const int kb =
        (int)((unsigned)y0 / (unsigned)strip_rows) * tiles_x + (x0 >> 7);
    key[k] = kb;
    org[k] = make_int2(y0, x0);
    atomicAdd(&hist[kb], 1);
  }
  __syncthreads();
  // Per key (a contiguous run of keys per thread): first slot, first item.
  const int per = (n_buckets + blockDim.x - 1) / blockDim.x;
  const int b_lo = min(tid * per, n_buckets);
  const int b_hi = min(b_lo + per, n_buckets);
  long long run = 0;
  for (int a = b_lo; a < b_hi; ++a)
    run += ((long long)((hist[a] + chunk - 1) / chunk) << 32) + hist[a];
  long long total;
  long long at = block_exclusive_scan(run, red, &total);
  for (int a = b_lo; a < b_hi; ++a) {
    if (a == b) {
      mine[0] = (int)(at & 0xffffffffll);
      mine[1] = (int)(at >> 32);
    }
    at += ((long long)((hist[a] + chunk - 1) / chunk) << 32) + hist[a];
  }
  __syncthreads();
  const int first = mine[0], item0 = mine[1], n = hist[b];
  if (tid == 0) {
    plan.bucket_start[b] = first;
    plan.bucket_count[b] = n;
    if (b == 0) *plan.n_items = (int)(total >> 32);
  }
  for (int j = tid; j * chunk < n; j += blockDim.x)
    plan.items[item0 + j] =
        make_int4(b, first + j * chunk, min(chunk, n - j * chunk), 0);
  // This key's windows, in index order.
  int slot = first;
  for (int k0 = 0; k0 < live && slot < first + n; k0 += blockDim.x) {
    const int k = k0 + tid;
    const bool in = k < live && key[k] == b;
    const unsigned m = __ballot_sync(0xffffffffu, in);
    if (lane == 0) wtot[warp] = __popc(m);
    __syncthreads();
    int before = 0, all = 0;
    for (int i = 0; i < (int)(blockDim.x >> 5); ++i) {
      const int c = wtot[i];
      before += i < warp ? c : 0;
      all += c;
    }
    if (in) {
      const int pos = slot + before + __popc(m & ((1u << lane) - 1u));
      plan.order[pos] = k;
      plan.origin[pos] = org[k];
    }
    slot += all;
    __syncthreads();  // wtot is read before the next tile writes it
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// One item of the plan, its windows summed by warps of up to M of them.
// Warp 0 reads the item's windows (index, clamped origin, parameter; chunk
// <= 32, one per lane), their bounding box and their ranks by (row,
// position).  The block stages the box once (in loads of at most
// buf_rows x 32 float4 if it is larger); then warp i sums the windows of
// ranks [i * M, i * M + M) in row order.  A warp whose windows share their
// columns reads each box row once and adds it to every one of them that
// covers it.  wk, wy, wx, wp: the windows by position; ws: positions by
// rank; box: ymin, ymax, xmin, xmax.
template <bool PAR, int M>
__device__ __forceinline__ void strip_item(
    const float* __restrict__ slab, const float* __restrict__ par,
    const StripPlan& plan, int4 item, float4* __restrict__ out, int w,
    int rows, int buf_rows, int block_k, float4* buf, int* wk, int* wy,
    int* wx, float* wp, int* ws, int* box) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nwarps = blockDim.x >> 5;
  const int n = item.z;
  if (warp == 0) {
    int k = 0, y = 0x7fffffff, x = 0x7fffffff;
    float v = 0.f;
    if (lane < n) {
      k = plan.order[item.y + lane];
      const int2 o = plan.origin[item.y + lane];
      y = o.x;
      x = o.y;
      if (PAR && k % block_k == 0) v = par[(size_t)k * WP_NPAR];
    }
    const unsigned all = 0xffffffffu;
    int r = 0;
    for (int j = 0; j < n; ++j) {
      const int yj = __shfl_sync(all, y, j);
      r += yj < y || (yj == y && j < lane);
    }
    const int ymin = __reduce_min_sync(all, y), xmin = __reduce_min_sync(all, x);
    const int ymax = __reduce_max_sync(all, lane < n ? y : -1);
    const int xmax = __reduce_max_sync(all, lane < n ? x : -1);
    if (lane < n) {
      wk[lane] = k;
      wy[lane] = y;
      wx[lane] = x;
      wp[lane] = v;
      ws[r] = lane;
    }
    if (lane == 0) {
      box[0] = ymin;
      box[1] = ymax;
      box[2] = xmin;
      box[3] = xmax;
    }
  }
  __syncthreads();
  const int ymin = box[0], xmin = box[2];
  const int box_rows = box[1] - ymin + rows;
  const int q = ((box[3] - xmin) >> 2) + 32;  // float4 columns of the box
  const int load_rows = min(box_rows, buf_rows * 32 / q);
  const int first = min(warp * M, n), mw = min(first + M, n) - first;
  int lo[M], cx[M];
  float4 acc[M];
  int rlo = box_rows, rhi = 0;
#pragma unroll
  for (int i = 0; i < M; ++i) {
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    lo[i] = box_rows;  // no row: the predicate below is false
    cx[i] = 0;
    if (i < mw) {
      const int t = ws[first + i];
      lo[i] = wy[t] - ymin;
      cx[i] = (wx[t] - xmin) >> 2;
      rlo = min(rlo, lo[i]);
      rhi = max(rhi, lo[i] + rows);
    }
  }
  bool shared_cols = true;
#pragma unroll
  for (int i = 1; i < M; ++i) shared_cols = shared_cols && (i >= mw || cx[i] == cx[0]);
  for (int c0 = 0; c0 < box_rows; c0 += load_rows) {
    const int c1 = min(c0 + load_rows, box_rows);
    if (c0 > 0) __syncthreads();  // every warp is done with the last load
    for (int r = c0 + warp; r < c1; r += nwarps) {
      const float* src = slab + (size_t)(ymin + r) * w + xmin;
      float4* dst = buf + (size_t)(r - c0) * q;
      for (int c = lane; c < q; c += 32) cp_async16(dst + c, src + 4 * c);
    }
    cp_async_wait_all();
    __syncthreads();  // the load has landed, every thread's part
    if (M == 1 || shared_cols) {
      const int r0 = max(rlo, c0), r1 = min(rhi, c1);
      const float4* p = buf + (size_t)(r0 - c0) * q + cx[0] + lane;
      if (M == 1) {
#pragma unroll 8
        for (int r = r0; r < r1; ++r, p += q) acc[0] = add4(acc[0], *p);
      } else {
#pragma unroll 4
        for (int r = r0; r < r1; ++r, p += q) {
          const float4 v = *p;
#pragma unroll
          for (int i = 0; i < M; ++i)
            if ((unsigned)(r - lo[i]) < (unsigned)rows) acc[i] = add4(acc[i], v);
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < M; ++i) {
        const int r0 = max(lo[i], c0), r1 = min(lo[i] + rows, c1);
        const float4* p = buf + (size_t)(r0 - c0) * q + cx[i] + lane;
#pragma unroll 4
        for (int r = r0; r < r1; ++r, p += q) acc[i] = add4(acc[i], *p);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < M; ++i) {
    if (i < mw) {
      const int t = ws[first + i];
      if (PAR && wk[t] % block_k == 0) {
        const float v = wp[t];
        acc[i] = add4(acc[i], make_float4(v, v, v, v));
      }
      out[(size_t)wk[t] * 32 + lane] = acc[i];
    }
  }
  __syncthreads();  // the buffer and the metadata are free again
}

// `warps` warps per block; dynamic shared memory strip_smem_bytes(buf_rows,
// chunk): buf_rows x 32 float4 of staged rows, then per window of an item
// its index, clamped origin, parameter and rank.  Block b takes items b,
// b + grid, ...; the grid is ceil(k_cap / chunk) + n_buckets, one block for
// every item there can be.  The blocks left without an item (every block,
// if none is left) write the zero rows past the live count.
template <bool PAR>
__global__ void __launch_bounds__(1024)
colsum_strip_kernel(const float* __restrict__ slab,
                    const float* __restrict__ par,
                    const int* __restrict__ count, int* __restrict__ scratch,
                    float4* __restrict__ out, int k_cap, int w, int rows,
                    int chunk, int buf_rows, int n_buckets, int max_items,
                    int block_k) {
  extern __shared__ float4 strip_smem[];
  float4* buf = strip_smem;
  int* box = reinterpret_cast<int*>(buf + (size_t)buf_rows * 32);
  int* wk = box + 4;
  int* wy = wk + chunk;
  int* wx = wy + chunk;
  int* ws = wx + chunk;
  float* wp = reinterpret_cast<float*>(ws + chunk);
  const StripPlan plan = strip_plan_at(scratch, max_items, n_buckets, k_cap);
  // Windows per warp: the block's warps share an item of at most `chunk`.
  const int m = (chunk + (blockDim.x >> 5) - 1) / (blockDim.x >> 5);
  // The first item is read with the count, before it is known to exist.
  int4 item = plan.items[blockIdx.x];
  const int n_items = *plan.n_items;
  for (int it = blockIdx.x; it < n_items; it += gridDim.x) {
    if (it != (int)blockIdx.x) item = plan.items[it];
#define STRIP_ITEM(M)                                                     \
  strip_item<PAR, M>(slab, par, plan, item, out, w, rows, buf_rows, block_k, \
                     buf, wk, wy, wx, wp, ws, box)
    if (m == 1) STRIP_ITEM(1); else STRIP_ITEM(2);
#undef STRIP_ITEM
  }
  const int zfirst = n_items < (int)gridDim.x ? n_items : 0;
  if ((int)blockIdx.x >= zfirst) {
    const int live = max(0, min(*count, k_cap));
    const int nwarps = blockDim.x >> 5, warp = threadIdx.x >> 5;
    const int z = blockIdx.x - zfirst, nz = gridDim.x - zfirst;
    for (int k = live + z * nwarps + warp; k < k_cap; k += nz * nwarps)
      out[(size_t)k * 32 + (threadIdx.x & 31)] =
          make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// --- the ring: TMA tiles into an mbarrier-guarded ring ---------------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}
// One arrival that also raises the phase's expected transaction bytes.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}
// Returns once the barrier's phase of parity ``parity`` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// The [box rows x 128] f32 tile at column x, row y of the slab into shared
// memory; completion is counted in bytes on ``bar``.
__device__ __forceinline__ void tma_load_tile(void* dst, const CUtensorMap* map,
                                              int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"((uint64_t)map), "r"(x), "r"(y), "r"(smem_u32(bar))
      : "memory");
}

// Dynamic shared memory of the ring kernel, in this order: nbuf slots of
// band x 128 f32 (each a multiple of 512 bytes, so 128-byte aligned as TMA
// wants), the per-warp window sums [2][block_k][32] float4 (double-buffered
// by window parity), then full[nbuf] and empty[nbuf] mbarriers; plus 128
// bytes of slack to align the base.  perf/window_proto.ring_smem_bytes is
// the same formula.
static int ring_smem_bytes(int block_k, int nbuf, int band) {
  return nbuf * band * RING_ROW_BYTES + 2 * block_k * RING_ROW_BYTES +
         2 * nbuf * 8 + 128;
}

// Persistent grid; block b owns windows b, b + gridDim.x, ... below the
// live count, so a short live prefix still spreads over every SM.  Its work
// is the flat sequence of (window, band) items; item n lands in slot
// n % nbuf.  Thread 0 is the producer: it arms the slot's full barrier with
// the tile's bytes and starts the TMA copy, and refills a slot once every
// warp has arrived on its empty barrier.  Every warp consumes every item:
// warp c sums the window rows r with r % block_k == c (float4 per lane), and
// at a window's last band the block adds the warps' sums in warp order, so
// the result does not depend on timing.
__global__ void __launch_bounds__(1024)
colsum_ring_kernel(const __grid_constant__ CUtensorMap map,
                   const int* __restrict__ ys0, const int* __restrict__ xs0,
                   const int* __restrict__ count, float4* __restrict__ out,
                   int k_cap, int h, int w, int rows, int band, int nbuf) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  const int block_k = blockDim.x >> 5;
  float* ring = reinterpret_cast<float*>(base);
  float4* part = reinterpret_cast<float4*>(base + nbuf * band * RING_ROW_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(part + 2 * block_k * 32);
  uint64_t* empty = full + nbuf;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int live = min(*count, k_cap);
  if (tid == 0) {
    for (int s = 0; s < nbuf; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, block_k);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int first = blockIdx.x, stride = gridDim.x;
  const int n_win = first < live ? (live - first + stride - 1) / stride : 0;
  const int bands = rows / band;
  const int total = n_win * bands;
  const unsigned slot_bytes = (unsigned)band * RING_ROW_BYTES;
  auto load = [&](int n) {
    const int k = first + (n / bands) * stride;
    int y0, x0;
    clamp_origin(ys0, xs0, k, h, w, rows, &y0, &x0);
    const int s = n % nbuf;
    mbar_expect_tx(full + s, slot_bytes);
    tma_load_tile(ring + (size_t)s * band * WP_LANES, &map, x0,
                  y0 + (n % bands) * band, full + s);
  };
  if (tid == 0)
    for (int n = 0; n < nbuf && n < total; ++n) load(n);

  // Rows at or past the live count are zero, while the first tiles land.
  for (int k = live + blockIdx.x * block_k + warp; k < k_cap;
       k += gridDim.x * block_k)
    out[(size_t)k * 32 + lane] = make_float4(0.f, 0.f, 0.f, 0.f);

  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int n = 0; n < total; ++n) {
    // Refill the slot item n - 1 used with item n - 1 + nbuf, once every
    // warp has released it.
    if (tid == 0 && n > 0 && n - 1 + nbuf < total) {
      mbar_wait(empty + (n - 1) % nbuf, ((n - 1) / nbuf) & 1);
      load(n - 1 + nbuf);
    }
    __syncwarp();
    const int s = n % nbuf;
    mbar_wait(full + s, (n / nbuf) & 1);
    const int b = n % bands;
    const float4* slot =
        reinterpret_cast<const float4*>(ring + (size_t)s * band * WP_LANES) +
        lane;
    // This warp's rows of the window that fall in this band.
    int j = (warp - (b * band) % block_k + block_k) % block_k;
    for (; j < band; j += block_k) acc = add4(acc, slot[j * 32]);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);
    if (b == bands - 1) {
      const int m = n / bands;
      float4* p = part + (m & 1) * block_k * 32;
      p[warp * 32 + lane] = acc;
      acc = make_float4(0.f, 0.f, 0.f, 0.f);
      __syncthreads();
      if (warp == 0) {
        float4 t = p[lane];
        for (int c = 1; c < block_k; ++c) t = add4(t, p[c * 32 + lane]);
        out[(size_t)(first + m * stride) * 32 + lane] = t;
      }
    }
  }
}

// slab: [h, w] f32 (w % 4 == 0, h >= rows, w >= 128, 16-byte aligned);
// ys0/xs0: [k_cap] i32; count: 1 i32 ON THE DEVICE; out: [k_cap, 128] f32.
// Each launch goes on ``stream``, does not synchronise, and returns
// cudaGetLastError() (-1 for arguments the kernels cannot take).

// Sizes of the strip design (perf/window_proto.strip_geometry is the same
// arithmetic): keys = strips x 128-column tiles of the origins' range,
// items at most ceil(k_cap / chunk) + keys, one strip block per possible
// item.
struct StripGeom {
  int tiles_x, n_buckets, max_items, buf_rows, smem, bucket_smem;
};

static int strip_geometry(int k_cap, int h, int w, int rows, int strip_rows,
                          int chunk, int warps, StripGeom* g) {
  if (k_cap < 0 || rows < 1 || h < rows || w < WP_LANES || w % 4 ||
      strip_rows < 1 || warps < 1 || warps > 32 || chunk < 1 || chunk > 32 ||
      chunk > STRIP_MAXM * warps)
    return -1;
  g->tiles_x = (w - WP_LANES) / WP_LANES + 1;
  g->n_buckets = ((h - rows) / strip_rows + 1) * g->tiles_x;
  g->max_items = (k_cap + chunk - 1) / chunk + g->n_buckets;
  g->buf_rows = strip_buf_rows(rows, strip_rows, chunk);
  g->smem = strip_smem_bytes(g->buf_rows, chunk);
  g->bucket_smem = bucket_smem_bytes(g->n_buckets, k_cap);
  return g->bucket_smem > 0 ? 0 : -1;
}

// scratch: the plan's int32 words (StripPlan).  par: NULL
// for static, else [k_cap, 16] f32 with par[k, 0] added to the live rows k
// with k % block_k == 0.
static int colsum_strip_launch(const void* slab, const void* ys0,
                               const void* xs0, const void* par,
                               const void* count, void* out, void* scratch,
                               int k_cap, int h, int w, int rows, int block_k,
                               int strip_rows, int chunk, int warps,
                               void* stream) {
  if (k_cap <= 0) return 0;
  StripGeom g;
  if (strip_geometry(k_cap, h, w, rows, strip_rows, chunk, warps, &g) ||
      block_k < 1)
    return -1;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaFuncSetAttribute(
      colsum_bucket_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      g.bucket_smem);
  if (e != cudaSuccess) return (int)e;
  colsum_bucket_kernel<<<g.n_buckets, 32 * BUCKET_WARPS, g.bucket_smem, st>>>(
      (const int*)ys0, (const int*)xs0, (const int*)count, (int*)scratch,
      k_cap, h, w, rows, strip_rows, chunk, g.tiles_x, g.n_buckets,
      g.max_items);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  auto kern = par ? colsum_strip_kernel<true> : colsum_strip_kernel<false>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           g.smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<g.max_items, 32 * warps, g.smem, st>>>(
      (const float*)slab, (const float*)par, (const int*)count,
      (int*)scratch, (float4*)out, k_cap, w, rows, chunk, g.buf_rows,
      g.n_buckets, g.max_items, block_k);
  return (int)cudaGetLastError();
}

// Strip geometry for these arguments, into out[8]: strip-kernel shared
// memory (bytes), strip blocks one SM holds (occupancy calculator, the par
// variant if par != 0), keys, bucket-kernel shared memory, bucket-kernel
// threads, buffer rows, grid (= the most items), column tiles.  Returns a
// cudaError_t, -1 for arguments the kernels cannot take.
SIFT_API int sift_window_colsum_strip_geometry(int k_cap, int h, int w,
                                               int rows, int strip_rows,
                                               int chunk, int warps, int par,
                                               int* out) {
  StripGeom g;
  if (strip_geometry(k_cap, h, w, rows, strip_rows, chunk, warps, &g))
    return -1;
  out[0] = g.smem;
  out[1] = 0;
  out[2] = g.n_buckets;
  out[3] = g.bucket_smem;
  out[4] = 32 * BUCKET_WARPS;
  out[5] = g.buf_rows;
  out[6] = g.max_items;
  out[7] = g.tiles_x;
  auto kern = par ? colsum_strip_kernel<true> : colsum_strip_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], kern,
                                                            32 * warps, g.smem);
}

SIFT_API int sift_window_colsum_static(const void* slab, const void* ys0,
                                       const void* xs0, const void* count,
                                       void* out, void* scratch, int k_cap,
                                       int h, int w, int rows, int strip_rows,
                                       int chunk, int warps, void* stream) {
  return colsum_strip_launch(slab, ys0, xs0, nullptr, count, out, scratch,
                             k_cap, h, w, rows, 1, strip_rows, chunk, warps,
                             stream);
}

// par: [k_cap, 16] f32.
SIFT_API int sift_window_colsum_par(const void* slab, const void* ys0,
                                    const void* xs0, const void* par,
                                    const void* count, void* out,
                                    void* scratch, int k_cap, int h, int w,
                                    int rows, int block_k, int strip_rows,
                                    int chunk, int warps, void* stream) {
  if (!par) return -1;
  return colsum_strip_launch(slab, ys0, xs0, par, count, out, scratch, k_cap,
                             h, w, rows, block_k, strip_rows, chunk, warps,
                             stream);
}

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point
// query, so that the library needs no -lcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

static EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn) return fn;
  void* p = nullptr;
  cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
  cudaError_t e = cudaGetDriverEntryPointByVersion(
      "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
  cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                          cudaEnableDefault, &q);
#endif
  if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
    fn = (EncodeTiledFn)p;
  return fn;
}

// Shared memory (bytes) of one ring block and how many such blocks one SM
// of the current device holds at once (registers, threads and shared
// memory all counted).  Returns a cudaError_t, -1 for a ring that does not
// fit a block.
SIFT_API int sift_window_colsum_ring_geometry(int block_k, int nbuf,
                                              int band_rows, long long* smem,
                                              int* blocks_per_sm) {
  const int bytes = ring_smem_bytes(block_k, nbuf, band_rows);
  *smem = bytes;
  *blocks_per_sm = 0;
  if (bytes > 227 * 1024 || block_k < 1 || block_k > 32) return -1;
  cudaError_t e = cudaFuncSetAttribute(
      colsum_ring_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, colsum_ring_kernel, 32 * block_k, bytes);
}

// nbuf slots of band_rows x 128 f32 (1 <= band_rows <= 256, rows %
// band_rows == 0); block_k consumer warps; grid: number of persistent
// blocks.  The tensor map spans the whole slab: dims {w, h}, row stride
// w * 4 bytes, box {128, band_rows}, no swizzle (perf/window_proto.
// ring_tensor_map gives the same arguments).  Returns -1 for arguments the
// kernel cannot take, -2 without cuTensorMapEncodeTiled, the
// CUresult + 1000 if encoding fails, else cudaGetLastError().
SIFT_API int sift_window_colsum_ring(const void* slab, const void* ys0,
                                     const void* xs0, const void* count,
                                     void* out, int k_cap, int h, int w,
                                     int rows, int block_k, int nbuf,
                                     int band_rows, int grid, void* stream) {
  if (k_cap <= 0) return 0;
  if (band_rows < 1 || band_rows > 256 || rows % band_rows || nbuf < 1 ||
      block_k < 1 || block_k > 32 || grid < 1 || w % 4 || w < WP_LANES ||
      h < rows)
    return -1;
  const int smem = ring_smem_bytes(block_k, nbuf, band_rows);
  if (smem > 227 * 1024) return -1;
  EncodeTiledFn encode = encode_tiled();
  if (!encode) return -2;
  CUtensorMap map;
  const cuuint64_t dims[2] = {(cuuint64_t)w, (cuuint64_t)h};
  const cuuint64_t strides[1] = {(cuuint64_t)w * sizeof(float)};
  const cuuint32_t box[2] = {WP_LANES, (cuuint32_t)band_rows};
  const cuuint32_t estr[2] = {1, 1};
  CUresult r = encode(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                      const_cast<void*>(slab), dims, strides, box, estr,
                      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return 1000 + (int)r;
  cudaError_t e = cudaFuncSetAttribute(
      colsum_ring_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  colsum_ring_kernel<<<grid, 32 * block_k, smem, (cudaStream_t)stream>>>(
      map, (const int*)ys0, (const int*)xs0, (const int*)count, (float4*)out,
      k_cap, h, w, rows, band_rows, nbuf);
  return (int)cudaGetLastError();
}
