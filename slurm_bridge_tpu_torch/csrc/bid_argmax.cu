// Fused masked bid + running argmax — the auction round's score/choose.
//
// Replaces the Pallas TPU kernel slurm_bridge_tpu/ops/bid_argmax.py:_kernel
// (wrapper bid_argmax). For every pending shard p it finds
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
// feasible. Ties go to the lowest node index.
//
// Design (simple and right first):
// - one thread per pod row, its operands and the running (best, idx) in
//   registers; nothing of shape [P, N] exists anywhere;
// - a block of kThreads rows walks the nodes in tiles of kTile, staging each
//   node's words (free + 1e-6, part, feat, price, the node's hash term,
//   free_n) in shared memory; every thread reads the same node, so each
//   shared read is a broadcast;
// - the per-row (pi * C1 ^ salt * C3) and per-node (ni * C2) hash terms are
//   hoisted out of the cell loop.
//
// What bounds it: integer and f32 ALU issue. The operands are O((P+N)·R)
// words (a few MB at the 57,635 × 10,000 headline shape), while every one of
// the P·N cells costs ~30 ALU operations. The hoisting above removes the
// three row/node multiplies per cell; the known limit is occupancy: one
// thread per row gives ~57.6k threads at the headline shape, about a fifth
// of what the card can keep resident.
//
// Numbers: all hash arithmetic is uint32 with logical shifts, and the f32
// arithmetic uses the _rn intrinsics (and the library is built with
// --fmad=false), so nothing is contracted into an FMA: values and choices
// match the plain PyTorch version bit for bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // pod rows per block, one per thread
constexpr int kTile = kThreads;  // nodes staged per pass, one per thread

constexpr uint32_t kC1 = 0x9E3779B1u;
constexpr uint32_t kC2 = 0x85EBCA77u;
constexpr uint32_t kC3 = 0xC2B2AE3Du;
constexpr uint32_t kC4 = 0x85EBCA6Bu;
constexpr uint32_t kC5 = 0xC2B2AE35u;

__global__ void __launch_bounds__(kThreads) bid_argmax_kernel(
    const float* __restrict__ free_,      // [N, 3]
    const int32_t* __restrict__ node_part,  // [N]
    const uint32_t* __restrict__ node_feat,  // [N]
    const float* __restrict__ price,      // [N]
    const float* __restrict__ dem,        // [P, 3]
    const int32_t* __restrict__ job_part,  // [P]
    const uint32_t* __restrict__ req_feat,  // [P]
    const int32_t* __restrict__ incumbent,  // [P]
    const float* __restrict__ dem_n,      // [P, 3]
    const float* __restrict__ free_n,     // [N, 3]
    int p, int n, uint32_t salt, uint32_t p_base, uint32_t n_base,
    float jitter, float affinity_weight, int32_t num_nodes,
    float* __restrict__ best_out, int32_t* __restrict__ choice_out) {
  __shared__ float s_cap0[kTile], s_cap1[kTile], s_cap2[kTile];
  __shared__ int32_t s_part[kTile];
  __shared__ uint32_t s_feat[kTile];
  __shared__ float s_price[kTile];
  __shared__ uint32_t s_nh[kTile];
  __shared__ float s_fn0[kTile], s_fn1[kTile], s_fn2[kTile];

  const int row = blockIdx.x * kThreads + threadIdx.x;
  const bool live = row < p;
  const int r = live ? row : 0;  // dead rows compute on row 0, never store
  const float d0 = dem[3 * r], d1 = dem[3 * r + 1], d2 = dem[3 * r + 2];
  const float dn0 = dem_n[3 * r], dn1 = dem_n[3 * r + 1], dn2 = dem_n[3 * r + 2];
  const int32_t jp = job_part[r];
  const uint32_t rf = req_feat[r];
  const int32_t inc = incumbent[r];
  const uint32_t row_h = ((p_base + static_cast<uint32_t>(r)) * kC1) ^ (salt * kC3);
  const bool use_aff = affinity_weight != 0.0f;

  float best = __int_as_float(0xff800000);  // -inf
  int32_t idx = num_nodes;  // sentinel until a finite value wins
  for (int base = 0; base < n; base += kTile) {
    __syncthreads();  // the previous tile's reads are done
    const int j = base + threadIdx.x;
    if (j < n) {
      s_cap0[threadIdx.x] = __fadd_rn(free_[3 * j], 1e-6f);
      s_cap1[threadIdx.x] = __fadd_rn(free_[3 * j + 1], 1e-6f);
      s_cap2[threadIdx.x] = __fadd_rn(free_[3 * j + 2], 1e-6f);
      s_part[threadIdx.x] = node_part[j];
      s_feat[threadIdx.x] = node_feat[j];
      s_price[threadIdx.x] = price[j];
      s_nh[threadIdx.x] = (n_base + static_cast<uint32_t>(j)) * kC2;
      s_fn0[threadIdx.x] = free_n[3 * j];
      s_fn1[threadIdx.x] = free_n[3 * j + 1];
      s_fn2[threadIdx.x] = free_n[3 * j + 2];
    }
    __syncthreads();
    const int cnt = min(kTile, n - base);  // the ragged edge is never read
#pragma unroll 4
    for (int t = 0; t < cnt; ++t) {
      bool ok = (jp == s_part[t]) | (jp < 0);
      ok &= (s_feat[t] & rf) == rf;
      ok &= (d0 <= s_cap0[t]) & (d1 <= s_cap1[t]) & (d2 <= s_cap2[t]);
      const int32_t ni = static_cast<int32_t>(n_base + static_cast<uint32_t>(base + t));
      ok &= (inc < 0) | (ni == inc);
      uint32_t h = row_h ^ s_nh[t];
      h ^= h >> 16;
      h *= kC4;
      h ^= h >> 13;
      h *= kC5;
      h ^= h >> 16;
      // h >> 8 < 2^24: exact in f32, and the 2^-24 scale is exact too
      const float jit = __fmul_rn(__uint2float_rn(h >> 8), 1.0f / 16777216.0f);
      float bid = __fsub_rn(__fmul_rn(jit, jitter), s_price[t]);
      if (use_aff) {
        float aff = __fmul_rn(dn0, s_fn0[t]);
        aff = __fadd_rn(aff, __fmul_rn(dn1, s_fn1[t]));
        aff = __fadd_rn(aff, __fmul_rn(dn2, s_fn2[t]));
        bid = __fadd_rn(bid, __fmul_rn(affinity_weight, -aff));  // least free wins
      }
      // ascending node order + strictly greater: the lowest index wins a tie
      if (ok && bid > best) {
        best = bid;
        idx = ni;
      }
    }
  }
  if (live) {
    best_out[row] = best;
    choice_out[row] = idx;
  }
}

}  // namespace

extern "C" int sbt_bid_argmax(
    const float* free_, const int32_t* node_part, const uint32_t* node_feat,
    const float* price, const float* dem, const int32_t* job_part,
    const uint32_t* req_feat, const int32_t* incumbent, const float* dem_n,
    const float* free_n, int p, int n, int salt, int p_base, int n_base,
    float jitter, float affinity_weight, int num_nodes, float* best_out,
    int32_t* choice_out, void* stream) {
  if (p <= 0) return 0;
  const dim3 grid((p + kThreads - 1) / kThreads);
  bid_argmax_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      free_, node_part, node_feat, price, dem, job_part, req_feat, incumbent,
      dem_n, free_n, p, n, static_cast<uint32_t>(salt),
      static_cast<uint32_t>(p_base), static_cast<uint32_t>(n_base), jitter,
      affinity_weight, num_nodes, best_out, choice_out);
  return static_cast<int>(cudaGetLastError());
}
