// Native greedy packer — the in-process CPU baseline.
//
// Re-creates, as a tuned C++ library, what the reference achieves in-process
// on the Go side (SURVEY.md §6 "Scheduling algorithm"): priority-ordered
// best-fit placement with gang (all-or-nothing, distinct-node) groups.
// Semantics are bit-identical to slurm_bridge_tpu/solver/greedy.py — the
// Python oracle — which the test suite asserts.
//
// This is the baseline BASELINE.md's ">=10x" target is measured against.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

extern "C" {

// Returns number of placed shards. out_assign[p] = node index or -1.
// free_io is n*r floats, updated in place to post-placement free capacity.
int sbt_greedy_place(int n, int r, float* free_io, const int32_t* node_part,
                     const uint32_t* node_feat, int p, const float* dem,
                     const int32_t* job_part, const uint32_t* req_feat,
                     const float* prio, const int32_t* gang, int best_fit,
                     int32_t* out_assign) {
  if (p <= 0) return 0;
  // gang ids are segment ids in [0, p) — the Python wrapper remaps them;
  // reject anything else instead of indexing out of bounds
  for (int i = 0; i < p; ++i) {
    if (gang[i] < 0 || gang[i] >= p) return -1;
  }
  // stable order by priority descending
  std::vector<int32_t> order(p);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(), [&](int32_t a, int32_t b) {
    return prio[a] > prio[b];
  });

  // group shards by gang id, gangs ordered by first appearance in `order`
  std::vector<std::vector<int32_t>> gangs;
  {
    std::vector<int32_t> gang_slot(p, -1);
    for (int32_t idx : order) {
      int32_t g = gang[idx];
      if (gang_slot[g] < 0) {
        gang_slot[g] = static_cast<int32_t>(gangs.size());
        gangs.emplace_back();
      }
      gangs[gang_slot[g]].push_back(idx);
    }
  }

  std::fill(out_assign, out_assign + p, -1);
  std::vector<float> trial;  // scratch for multi-shard gangs
  std::vector<int32_t> chosen_shard, chosen_node;
  std::vector<char> gang_used(n, 0);
  std::vector<int32_t> gang_used_list;
  int placed = 0;

  for (const auto& shards : gangs) {
    const bool multi = shards.size() > 1;
    float* freep = free_io;
    if (multi) {
      trial.assign(free_io, free_io + static_cast<size_t>(n) * r);
      freep = trial.data();
    }
    chosen_shard.clear();
    chosen_node.clear();
    for (int32_t nd : gang_used_list) gang_used[nd] = 0;
    gang_used_list.clear();
    bool ok = true;

    for (int32_t s : shards) {
      const float* d = dem + static_cast<size_t>(s) * r;
      const int32_t jp = job_part[s];
      const uint32_t rf = req_feat[s];
      int best_node = -1;
      float best_leftover = 0.f;
      for (int nd = 0; nd < n; ++nd) {
        if (multi && gang_used[nd]) continue;
        if (jp >= 0 && node_part[nd] != jp) continue;
        if ((node_feat[nd] & rf) != rf) continue;
        const float* f = freep + static_cast<size_t>(nd) * r;
        bool fits = true;
        for (int k = 0; k < r; ++k) {
          if (f[k] < d[k]) {
            fits = false;
            break;
          }
        }
        if (!fits) continue;
        if (!best_fit) {
          best_node = nd;
          break;  // first fit
        }
        const float leftover = f[0] - d[0];
        if (best_node < 0 || leftover < best_leftover) {
          best_node = nd;
          best_leftover = leftover;
        }
      }
      if (best_node < 0) {
        ok = false;
        break;
      }
      float* f = freep + static_cast<size_t>(best_node) * r;
      for (int k = 0; k < r; ++k) f[k] -= d[k];
      chosen_shard.push_back(s);
      chosen_node.push_back(best_node);
      if (multi) {
        gang_used[best_node] = 1;
        gang_used_list.push_back(best_node);
      }
    }

    if (ok) {
      if (multi) std::memcpy(free_io, trial.data(), sizeof(float) * n * r);
      for (size_t i = 0; i < chosen_shard.size(); ++i) {
        out_assign[chosen_shard[i]] = chosen_node[i];
        ++placed;
      }
    }
  }
  return placed;
}

}  // extern "C"
