// Fused masked bid + argmax — the auction round's score/choose.
//
// Replaces the Pallas TPU kernel slurm_bridge_tpu/ops/bid_argmax.py:_kernel
// (wrapper bid_argmax). For every live pending shard p it finds
//
//   choice[p] = argmax_n where(ok[p, n], bid[p, n], -inf)
//   bid[p, n] = jitter * u24(hash(p_base+p, n_base+n, salt)) / 2^24
//               + w * (-sum_r dem_n[p, r] * free_n[n, r]) - price[n]
//   ok[p, n]  = (job_part[p] == node_part[n] || job_part[p] < 0)
//               && (node_feat[n] & req_feat[p]) == req_feat[p]
//               && dem[p, r] <= free[n, r] + 1e-6   for r < 3
//               && (incumbent[p] < 0 || incumbent[p] == n_base + n)
//
// and returns (best[p], choice[p]); choice == num_nodes where no node is
// feasible or the row is not live. Ties go to the lowest node index.
//
// What bounds it: integer issue on the cells the inputs need. Each (row,
// node) cell costs ~20 integer and ~8 f32 instructions and one int->float
// conversion; the operands are a few MB. Tensor cores have nothing to take:
// there is no matrix product beyond the 3-term affinity.
//
// What the design does about it:
// - only live rows are scored: two short passes (bid_argmax_count_live,
//   bid_argmax_compact) compact them, in rows sorted by partition, and the
//   live count stays on the device; blocks past it exit at once;
// - each row tile walks only the partition-ordered node range that covers
//   its rows' partitions (all nodes if a row takes any partition), so about
//   3 of 4 cells of a 4-partition cluster are never scored;
// - a block owns one (row tile, node chunk) work item, so even a late round
//   of a few thousand live rows spreads over all 132 SMs;
// - each thread holds kRowsPerThread rows in registers and scores every
//   staged node against all of them: one broadcast 16-byte shared load
//   feeds several rows. Node records are packed once per call (in node
//   order, 16-byte aligned) and staged with cp.async.
//
// Tie rule and merge: blocks see the nodes in no fixed order, so the
// comparison is explicit — a higher value wins, an equal value goes
// to the lower node index. Chunks of one row merge through a 64-bit
// atomicMax on (order-preserving value bits, ~node index), which gives the
// same winner in any block order. A last pass decodes the winner and
// recomputes its value with the same arithmetic (so the value keeps its
// exact bits, the sign of a zero included).
//
// Numbers: all hash arithmetic is uint32 with logical shifts, and the f32
// arithmetic uses the _rn intrinsics (the library is built with
// --fmad=false), so nothing is contracted but what is written as
// __fmaf_rn. The bid is rounded as the JAX package's dense round on the CPU
// rounds it (XLA fuses a multiply into the add after it there): at w == 0
// jit * jitter - price, two roundings; with affinity
//   aff = fma(dn2, fn2, fma(dn1, fn1, dn0 * fn0))
//   bid = fma(jit, jitter, w * -aff) - price
// each step rounded once. Values and choices match the plain PyTorch
// version (ops/bid_argmax.py:fma_f32 for the fused steps) bit for bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRowsPerThread = 4;
constexpr int kTileRows = kThreads * kRowsPerThread;  // rows per work item
constexpr int kChunk = 64;  // nodes per work item
constexpr int kFinishThreads = 256;
constexpr int kListThreads = 256;
constexpr int kListItems = 4;  // consecutive rows of the row order per thread
constexpr int kSlice = kListThreads * kListItems;  // rows per work-list block

constexpr uint32_t kC1 = 0x9E3779B1u;
constexpr uint32_t kC2 = 0x85EBCA77u;
constexpr uint32_t kC3 = 0xC2B2AE3Du;
constexpr uint32_t kC4 = 0x85EBCA6Bu;
constexpr uint32_t kC5 = 0xC2B2AE35u;

// The jitter term in [0, 1): the top 24 bits of the (row, node) hash.
__device__ __forceinline__ float unit_jitter(uint32_t row_h, uint32_t node_h) {
  uint32_t h = row_h ^ node_h;
  h ^= h >> 16;
  h *= kC4;
  h ^= h >> 13;
  h *= kC5;
  h ^= h >> 16;
  // h >> 8 < 2^24: exact in f32, and the 2^-24 scale is exact too
  return __fmul_rn(__uint2float_rn(h >> 8), 1.0f / 16777216.0f);
}

__device__ __forceinline__ float plain_bid(float jit, float jitter, float price) {
  return __fsub_rn(__fmul_rn(jit, jitter), price);
}

__device__ __forceinline__ float affinity_bid(float jit, float jitter, float price,
                                              float w, float dn0, float dn1,
                                              float dn2, float fn0, float fn1,
                                              float fn2) {
  float aff = __fmul_rn(dn0, fn0);
  aff = __fmaf_rn(dn1, fn1, aff);
  aff = __fmaf_rn(dn2, fn2, aff);
  // least free wins
  return __fsub_rn(__fmaf_rn(jit, jitter, __fmul_rn(w, -aff)), price);
}

// Larger key = larger value, then lower node index. -0.0 is folded onto
// +0.0 (they compare equal); -inf and NaN never reach a key, so every key
// is > 0 and 0 means "nothing feasible".
__device__ __forceinline__ unsigned long long make_key(float v, uint32_t n) {
  uint32_t b = __float_as_uint(__fadd_rn(v, 0.0f));
  b = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return (static_cast<unsigned long long>(b) << 32) | (0xFFFFFFFFu - n);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

// The work list (ops/bid_argmax.py:work_list_plain is its plain version):
// the live rows compacted in partition order, and their count. Two passes
// over slices of kSlice rows of the row order, one block per slice: the
// first counts each slice's live rows, the second places them after the
// rows of the earlier slices. Each thread takes kListItems consecutive rows.

__device__ __forceinline__ int load_slice(const bool* __restrict__ live,
                                          const int32_t* __restrict__ order,
                                          int p, int r[kListItems],
                                          bool f[kListItems]) {
  const int first = blockIdx.x * kSlice + threadIdx.x * kListItems;
  int c = 0;
#pragma unroll
  for (int j = 0; j < kListItems; ++j) r[j] = first + j < p ? order[first + j] : -1;
#pragma unroll
  for (int j = 0; j < kListItems; ++j) {
    f[j] = r[j] >= 0 && (live == nullptr || live[r[j]]);
    c += f[j] ? 1 : 0;
  }
  return c;
}

// Sum of v over the block; every thread gets it.
__device__ __forceinline__ int block_sum(int v, int* s_warp) {
  v = __reduce_add_sync(0xFFFFFFFFu, v);
  __syncthreads();  // s_warp may still be read by an earlier call
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = v;
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int w = 0; w < kListThreads / 32; ++w) total += s_warp[w];
  return total;
}

__global__ void __launch_bounds__(kListThreads) bid_argmax_count_live(
    const bool* __restrict__ live,  // [P] by row id, or null: every row live
    const int32_t* __restrict__ order,  // [P] row ids sorted by partition
    int p, int32_t* __restrict__ slice_counts) {
  __shared__ int s_warp[kListThreads / 32];
  int r[kListItems];
  bool f[kListItems];
  const int total = block_sum(load_slice(live, order, p, r, f), s_warp);
  if (threadIdx.x == 0) slice_counts[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kListThreads) bid_argmax_compact(
    const bool* __restrict__ live, const int32_t* __restrict__ order, int p,
    int slices, const int32_t* __restrict__ slice_counts,
    int32_t* __restrict__ rows_out, int32_t* __restrict__ count_out) {
  __shared__ int s_warp[kListThreads / 32];
  __shared__ int s_scan[kListThreads / 32];
  int before = 0, all = 0;
  for (int i = threadIdx.x; i < slices; i += kListThreads) {
    const int v = slice_counts[i];
    all += v;
    before += i < static_cast<int>(blockIdx.x) ? v : 0;
  }
  before = block_sum(before, s_warp);
  all = block_sum(all, s_warp);

  int r[kListItems];
  bool f[kListItems];
  const int c = load_slice(live, order, p, r, f);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = c;  // inclusive scan within the warp
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(0xFFFFFFFFu, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) s_scan[warp] = incl;
  __syncthreads();
  int pos = before + incl - c;
  for (int w = 0; w < warp; ++w) pos += s_scan[w];
#pragma unroll
  for (int j = 0; j < kListItems; ++j) {
    if (f[j]) rows_out[pos++] = r[j];
  }
  // past the live count, this slice's share of the output is -1
  const int end = min(p, static_cast<int>(blockIdx.x + 1) * kSlice);
  for (int i = max(all, static_cast<int>(blockIdx.x) * kSlice) + threadIdx.x; i < end;
       i += kListThreads) {
    rows_out[i] = -1;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *count_out = all;
}

// One record per node in partition order: {cap0, cap1, cap2, price} and
// {partition, features, node hash term, local node index}; with affinity,
// {free_n0, free_n1, free_n2, 0} in a second array. Also clears the keys.
__global__ void bid_argmax_pack(const float* __restrict__ free_,
                                const int32_t* __restrict__ node_part,
                                const uint32_t* __restrict__ node_feat,
                                const float* __restrict__ price,
                                const float* __restrict__ free_n,
                                const int32_t* __restrict__ order, int n,
                                uint32_t n_base, bool use_aff,
                                uint4* __restrict__ rec, uint4* __restrict__ rec_aff,
                                int p, unsigned long long* __restrict__ keys) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j < p) keys[j] = 0ull;
  if (j >= n) return;
  const int v = order[j];
  rec[2 * j] = make_uint4(__float_as_uint(__fadd_rn(free_[3 * v], 1e-6f)),
                          __float_as_uint(__fadd_rn(free_[3 * v + 1], 1e-6f)),
                          __float_as_uint(__fadd_rn(free_[3 * v + 2], 1e-6f)),
                          __float_as_uint(price[v]));
  rec[2 * j + 1] = make_uint4(static_cast<uint32_t>(node_part[v]), node_feat[v],
                              (n_base + static_cast<uint32_t>(v)) * kC2,
                              static_cast<uint32_t>(v));
  if (use_aff) {
    rec_aff[j] = make_uint4(__float_as_uint(free_n[3 * v]),
                            __float_as_uint(free_n[3 * v + 1]),
                            __float_as_uint(free_n[3 * v + 2]), 0u);
  }
}

// kAff: the affinity term is scored (affinity_weight != 0). Two
// instantiations keep the affinity operands out of the w == 0 loop.
template <bool kAff>
__global__ void __launch_bounds__(kThreads) bid_argmax_score(
    const uint4* __restrict__ rec, const uint4* __restrict__ rec_aff,
    const int32_t* __restrict__ rows,     // [P] live rows, compacted
    const int32_t* __restrict__ live_count,  // [1]
    const int32_t* __restrict__ offsets,  // [k + 1] partition runs of the nodes
    int k, int n, const float* __restrict__ dem, const int32_t* __restrict__ job_part,
    const uint32_t* __restrict__ req_feat,
    const int32_t* __restrict__ incumbent, const float* __restrict__ dem_n,
    uint32_t salt, uint32_t p_base, uint32_t n_base, float jitter,
    float affinity_weight, unsigned long long* __restrict__ keys) {
  __shared__ __align__(16) uint4 s_rec[2 * kChunk];
  __shared__ __align__(16) uint4 s_aff[kChunk];

  const int count = *live_count;
  const int first = blockIdx.x * kTileRows;
  if (first >= count) return;
  // the tile's range of the partition-ordered nodes: from its first live
  // row's partition to its last's (ops/bid_argmax.py:tile_ranges)
  int lo = 0, hi = n;
  const long long pf = job_part[rows[first]];
  if (pf >= 0) {  // else a row of any partition: every node
    const long long pl = job_part[rows[min(first + kTileRows, count) - 1]];
    lo = offsets[min(pf, static_cast<long long>(k))];
    hi = offsets[min(pl + 1, static_cast<long long>(k))];
  }
  lo += blockIdx.y * kChunk;
  hi = min(hi, lo + kChunk);
  if (lo >= hi) return;
  const int cnt = hi - lo;

  for (int s = threadIdx.x; s < 2 * cnt; s += kThreads) {
    cp_async16(&s_rec[s], &rec[2 * lo + s]);
  }
  if (kAff) {
    for (int s = threadIdx.x; s < cnt; s += kThreads) {
      cp_async16(&s_aff[s], &rec_aff[lo + s]);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);

  // this thread's rows, loaded while the copies fly
  const float kNaN = __int_as_float(0x7fc00000);
  int row[kRowsPerThread];
  float d0[kRowsPerThread], d1[kRowsPerThread], d2[kRowsPerThread];
  float dn0[kRowsPerThread], dn1[kRowsPerThread], dn2[kRowsPerThread];
  // the partition, feature and incumbent tests fold into one word that is
  // 0 exactly when all three pass: a mask of 0 waives a test
  uint32_t jp[kRowsPerThread], part_mask[kRowsPerThread];
  uint32_t rf[kRowsPerThread], inc_n[kRowsPerThread], inc_mask[kRowsPerThread];
  uint32_t row_h[kRowsPerThread];
  float best[kRowsPerThread];
  uint32_t best_n[kRowsPerThread];
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int pos = first + k * kThreads + threadIdx.x;
    const bool live = pos < count;
    const int r = live ? rows[pos] : 0;
    row[k] = live ? r : -1;
    // a row past the live count gets a NaN demand: no capacity test passes
    d0[k] = live ? dem[3 * r] : kNaN;
    d1[k] = dem[3 * r + 1];
    d2[k] = dem[3 * r + 2];
    dn0[k] = dem_n[3 * r];
    dn1[k] = dem_n[3 * r + 1];
    dn2[k] = dem_n[3 * r + 2];
    jp[k] = static_cast<uint32_t>(job_part[r]);
    part_mask[k] = job_part[r] < 0 ? 0u : 0xFFFFFFFFu;  // any partition
    rf[k] = req_feat[r];
    const int32_t inc = incumbent[r];
    inc_mask[k] = inc < 0 ? 0u : 0xFFFFFFFFu;  // no incumbent
    // incumbent == n_base + n (mod 2^32)  <=>  n == incumbent - n_base
    inc_n[k] = static_cast<uint32_t>(inc) - n_base;
    row_h[k] = ((p_base + static_cast<uint32_t>(r)) * kC1) ^ (salt * kC3);
    best[k] = __int_as_float(0xff800000);  // -inf
    best_n[k] = 0xFFFFFFFFu;
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

#pragma unroll 2
  for (int t = 0; t < cnt; ++t) {
    const uint4 a = s_rec[2 * t];
    const uint4 b = s_rec[2 * t + 1];
    const float cap0 = __uint_as_float(a.x), cap1 = __uint_as_float(a.y),
                cap2 = __uint_as_float(a.z), price = __uint_as_float(a.w);
    const uint32_t part = b.x, feat = b.y, node_h = b.z, nloc = b.w;
    uint4 f = make_uint4(0u, 0u, 0u, 0u);
    if (kAff) f = s_aff[t];
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      // (part == jp || any) && (feat & rf) == rf && (nloc == inc_n || none)
      const uint32_t miss = ((part ^ jp[k]) & part_mask[k]) |
                            ((nloc ^ inc_n[k]) & inc_mask[k]) | (rf[k] & ~feat);
      const bool ok = (miss == 0u) & (d0[k] <= cap0) & (d1[k] <= cap1) &
                      (d2[k] <= cap2);
      const float jit = unit_jitter(row_h[k], node_h);
      const float bid =
          kAff ? affinity_bid(jit, jitter, price, affinity_weight, dn0[k], dn1[k],
                              dn2[k], __uint_as_float(f.x), __uint_as_float(f.y),
                              __uint_as_float(f.z))
               : plain_bid(jit, jitter, price);
      // order-independent: higher value wins; on an equal value the lower
      // node index wins
      if (ok && (bid > best[k] || (bid == best[k] && nloc < best_n[k]))) {
        best[k] = bid;
        best_n[k] = nloc;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    if (best[k] > __int_as_float(0xff800000)) {  // a finite value won
      atomicMax(&keys[row[k]], make_key(best[k], best_n[k]));
    }
  }
}

// Every row: decode the winner (or the sentinel) and recompute its value.
__global__ void bid_argmax_finish(const unsigned long long* __restrict__ keys, int p,
                                  const float* __restrict__ price,
                                  const float* __restrict__ dem_n,
                                  const float* __restrict__ free_n, uint32_t salt,
                                  uint32_t p_base, uint32_t n_base, float jitter,
                                  float affinity_weight, int32_t num_nodes,
                                  float* __restrict__ best_out,
                                  int32_t* __restrict__ choice_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p) return;
  const unsigned long long key = keys[i];
  if (key == 0ull) {
    best_out[i] = __int_as_float(0xff800000);
    choice_out[i] = num_nodes;
    return;
  }
  const uint32_t n = 0xFFFFFFFFu - static_cast<uint32_t>(key);
  const uint32_t row_h = ((p_base + static_cast<uint32_t>(i)) * kC1) ^ (salt * kC3);
  const float jit = unit_jitter(row_h, (n_base + n) * kC2);
  const float bid =
      affinity_weight != 0.0f
          ? affinity_bid(jit, jitter, price[n], affinity_weight, dem_n[3 * i],
                         dem_n[3 * i + 1], dem_n[3 * i + 2], free_n[3 * n],
                         free_n[3 * n + 1], free_n[3 * n + 2])
          : plain_bid(jit, jitter, price[n]);
  best_out[i] = bid;
  choice_out[i] = static_cast<int32_t>(n_base + n);
}

}  // namespace

// Both entry points return a cudaError_t, or -1 when the caller's tile size
// is not this library's; sbt_bid_argmax returns -2 when the node axis needs
// more chunks than a grid holds. slice_counts holds one int per kSlice rows.
extern "C" int sbt_work_list(const bool* live, const int32_t* order, int p,
                             int32_t* slice_counts, int32_t* rows_out,
                             int32_t* count_out, void* stream) {
  if (p <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int slices = (p + kSlice - 1) / kSlice;
  bid_argmax_count_live<<<slices, kListThreads, 0, s>>>(live, order, p, slice_counts);
  bid_argmax_compact<<<slices, kListThreads, 0, s>>>(live, order, p, slices,
                                                     slice_counts, rows_out, count_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sbt_bid_argmax(
    const float* free_, const int32_t* node_part, const uint32_t* node_feat,
    const float* price, const float* dem, const int32_t* job_part,
    const uint32_t* req_feat, const int32_t* incumbent, const float* dem_n,
    const float* free_n, const int32_t* node_order, const int32_t* offsets,
    const int32_t* rows, const int32_t* live_count, int k, int p, int n,
    int tile_rows, int salt, int p_base, int n_base, float jitter,
    float affinity_weight, int num_nodes, void* rec, void* rec_aff, void* keys,
    float* best_out, int32_t* choice_out, void* stream) {
  if (tile_rows != kTileRows) return -1;
  const int chunks = (n + kChunk - 1) / kChunk;
  if (chunks > 65535) return -2;
  if (p <= 0 || n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* key = static_cast<unsigned long long*>(keys);
  const bool use_aff = affinity_weight != 0.0f;
  const int tiles = (p + kTileRows - 1) / kTileRows;
  bid_argmax_pack<<<(max(n, p) + 255) / 256, 256, 0, s>>>(
      free_, node_part, node_feat, price, free_n, node_order, n,
      static_cast<uint32_t>(n_base), use_aff, static_cast<uint4*>(rec),
      static_cast<uint4*>(rec_aff), p, key);
  auto* score = use_aff ? &bid_argmax_score<true> : &bid_argmax_score<false>;
  score<<<dim3(tiles, chunks), kThreads, 0, s>>>(
      static_cast<const uint4*>(rec), static_cast<const uint4*>(rec_aff), rows,
      live_count, offsets, k, n, dem, job_part, req_feat, incumbent, dem_n,
      static_cast<uint32_t>(salt), static_cast<uint32_t>(p_base),
      static_cast<uint32_t>(n_base), jitter, affinity_weight, key);
  bid_argmax_finish<<<(p + kFinishThreads - 1) / kFinishThreads, kFinishThreads, 0, s>>>(
      key, p, price, dem_n, free_n, static_cast<uint32_t>(salt),
      static_cast<uint32_t>(p_base), static_cast<uint32_t>(n_base), jitter,
      affinity_weight, num_nodes, best_out, choice_out);
  return static_cast<int>(cudaGetLastError());
}
