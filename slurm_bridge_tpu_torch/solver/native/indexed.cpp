// Indexed native packer — the CPU fast path.
//
// Same placement semantics as greedy.cpp (priority-ordered best-fit,
// all-or-nothing distinct-node gangs — the reference-parity algorithm,
// SURVEY.md §6 "Scheduling algorithm") but sub-linear per shard instead of
// the baseline's O(P·N) full-inventory scan. Nodes live in per-
// (partition, feature-mask) buckets; each bucket is a treap ordered by
// (free_cpu, node index) and augmented with subtree maxima of the OTHER
// resource dimensions, so "minimal cpu leftover subject to mem/gpu fitting"
// is answered by a pruned descent rather than a forward scan. (A plain
// ordered-set + scan version of this file measured 8.3M scan probes for
// 57.6k shards at the 50k×10k headline shape — mem-exhausted nodes camp at
// the start of every scan range; the subtree maxima skip them wholesale.)
//
// Results are bit-identical to greedy.cpp / the Python oracle — minimal
// free_cpu among feasible nodes, lowest node index on ties — which the
// test suite asserts. greedy.cpp itself stays untouched: it is the
// measured baseline (BASELINE.md) and must not inherit this speedup.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <memory>
#include <numeric>
#include <vector>

namespace {

constexpr int kNil = -1;
constexpr int kMaxAug = 4;  // max augmented dims (r <= 4 either mode)

// One treap over cluster-node ids, in one of two orders:
//  - best-fit mode: node nd's key is (free_cpu[nd], nd), augmented with
//    per-subtree maxima of the OTHER r-1 resource dims — answers "minimal
//    cpu leftover subject to the rest fitting" by pruned descent;
//  - first-fit mode (by_index): the key is the node INDEX itself and ALL
//    r dims are augmented — answers "lowest node index that fits every
//    dim" the same way. (The old claim that first-fit "cannot ride an
//    index" was true only of the cpu-ordered key.)
// All arrays are indexed by cluster node id — each node sits in exactly
// one bucket, so storage is shared across buckets.
struct Forest {
  int r_aug;       // number of augmented dims actually used
  bool by_index;   // first-fit key order instead of (free_cpu, idx)
  std::vector<int> left, right;
  std::vector<uint32_t> prio;  // deterministic hash of node id
  std::vector<float> key_cpu;
  // own[nd*kMaxAug+k]: node nd's value in augmented dim k (snapshot at
  // insert time; nodes are erased+reinserted on every free change)
  std::vector<float> own, smax;

  explicit Forest(int n, int r, bool ff)
      : r_aug(ff ? r : std::min(r - 1, kMaxAug)), by_index(ff) {
    left.assign(n, kNil);
    right.assign(n, kNil);
    prio.resize(n);
    key_cpu.assign(n, 0.f);
    own.assign(static_cast<size_t>(n) * kMaxAug, 0.f);
    smax.assign(static_cast<size_t>(n) * kMaxAug, 0.f);
    for (int i = 0; i < n; ++i) {
      // splitmix32: deterministic treap shape independent of libc rand
      uint32_t x = static_cast<uint32_t>(i) + 0x9e3779b9u;
      x ^= x >> 16;
      x *= 0x85ebca6bu;
      x ^= x >> 13;
      x *= 0xc2b2ae35u;
      x ^= x >> 16;
      prio[i] = x;
    }
  }

  bool less(int a, int b) const {  // strict (cpu, idx) order
    if (key_cpu[a] != key_cpu[b]) return key_cpu[a] < key_cpu[b];
    return a < b;
  }

  void pull(int t) {
    for (int k = 0; k < r_aug; ++k) {
      float m = own[static_cast<size_t>(t) * kMaxAug + k];
      if (left[t] != kNil)
        m = std::max(m, smax[static_cast<size_t>(left[t]) * kMaxAug + k]);
      if (right[t] != kNil)
        m = std::max(m, smax[static_cast<size_t>(right[t]) * kMaxAug + k]);
      smax[static_cast<size_t>(t) * kMaxAug + k] = m;
    }
  }

  int merge(int a, int b) {  // every key in a < every key in b
    if (a == kNil) return b;
    if (b == kNil) return a;
    if (prio[a] > prio[b]) {
      right[a] = merge(right[a], b);
      pull(a);
      return a;
    }
    left[b] = merge(a, left[b]);
    pull(b);
    return b;
  }

  // split t into (keys < pivot-node nd, keys >= nd) by (cpu, idx) order
  void split(int t, int nd, int* lo, int* hi) {
    if (t == kNil) {
      *lo = *hi = kNil;
      return;
    }
    if (less(t, nd)) {
      split(right[t], nd, lo, hi);
      right[t] = *lo;
      pull(t);
      *lo = t;
    } else {
      split(left[t], nd, lo, hi);
      left[t] = *hi;
      pull(t);
      *hi = t;
    }
  }

  int insert(int root, int nd, const float* res_row) {
    key_cpu[nd] = by_index ? static_cast<float>(nd) : res_row[0];
    const int off = by_index ? 0 : 1;
    for (int k = 0; k < r_aug; ++k)
      own[static_cast<size_t>(nd) * kMaxAug + k] = res_row[k + off];
    left[nd] = right[nd] = kNil;
    pull(nd);
    int lo, hi;
    split(root, nd, &lo, &hi);
    return merge(merge(lo, nd), hi);
  }

  int erase(int root, int nd) {
    if (root == kNil) return kNil;
    if (root == nd) return merge(left[root], right[root]);
    if (less(nd, root))
      left[root] = erase(left[root], nd);
    else
      right[root] = erase(right[root], nd);
    pull(root);
    return root;
  }

  // First-fit: leftmost (lowest-index, by_index key order) node whose
  // own[k] >= dem[k] for every dim; kNil if none. Exactly the answer the
  // baseline's lowest-index forward scan produces. ``bound`` prunes
  // indices >= it — a fitting node in an earlier bucket makes everything
  // above it irrelevant (per-dim smax is necessary-not-sufficient, so the
  // search can otherwise wander subtrees with no jointly-fitting node).
  int query_ff(int t, const float* dem, int bound) const {
    if (t == kNil) return kNil;
    for (int k = 0; k < r_aug; ++k) {
      if (smax[static_cast<size_t>(t) * kMaxAug + k] < dem[k]) return kNil;
    }
    if (t >= bound) return query_ff(left[t], dem, bound);
    int res = query_ff(left[t], dem, bound);
    if (res != kNil) return res;
    bool ok = true;
    for (int k = 0; k < r_aug; ++k) {
      if (own[static_cast<size_t>(t) * kMaxAug + k] < dem[k]) {
        ok = false;
        break;
      }
    }
    if (ok) return t;
    return query_ff(right[t], dem, bound);
  }

  // Worst-fit: RIGHTMOST node with key >= (d_cpu, any idx) whose
  // augmented dims all fit — max free cpu, highest index on ties (the
  // oracle's policy="worst"). Mirrored descent of query(); rides the same
  // cpu key, so it prunes as strongly as best-fit.
  int query_worst(int t, float d_cpu, const float* dem) const {
    if (t == kNil) return kNil;
    for (int k = 0; k < r_aug; ++k) {
      if (smax[static_cast<size_t>(t) * kMaxAug + k] < dem[k + 1]) return kNil;
    }
    if (key_cpu[t] < d_cpu) return query_worst(right[t], d_cpu, dem);
    int res = query_worst(right[t], d_cpu, dem);
    if (res != kNil) return res;
    bool ok = true;
    for (int k = 0; k < r_aug; ++k) {
      if (own[static_cast<size_t>(t) * kMaxAug + k] < dem[k + 1]) {
        ok = false;
        break;
      }
    }
    if (ok) return t;
    return query_worst(left[t], d_cpu, dem);
  }

  // Best-fit: leftmost node with key >= (d_cpu, any idx) whose augmented
  // dims all satisfy own[k] >= dem[k+1]; kNil if none. Exactly the answer
  // the baseline's forward scan produces.
  int query(int t, float d_cpu, const float* dem) const {
    if (t == kNil) return kNil;
    for (int k = 0; k < r_aug; ++k) {
      if (smax[static_cast<size_t>(t) * kMaxAug + k] < dem[k + 1]) return kNil;
    }
    if (key_cpu[t] < d_cpu) return query(right[t], d_cpu, dem);
    int res = query(left[t], d_cpu, dem);
    if (res != kNil) return res;
    bool ok = true;
    for (int k = 0; k < r_aug; ++k) {
      if (own[static_cast<size_t>(t) * kMaxAug + k] < dem[k + 1]) {
        ok = false;
        break;
      }
    }
    if (ok) return t;
    return query(right[t], d_cpu, dem);
  }
};

struct Bucket {
  int32_t part;
  uint32_t feat;
  int root = kNil;   // cpu-keyed (best-fit) treap
  int root2 = kNil;  // index-keyed (first-fit) twin, ff mode only
};

}  // namespace

extern "C" {

// Identical contract to sbt_greedy_place (greedy.cpp) in best-fit mode,
// plus incumbent pins: returns the number of placed shards, -1 on
// out-of-range gang ids, an out-of-range pin, or an unsupported resource
// arity (r must be 1..4; snapshot.py ships r=3).
// free_io is n*r floats updated in place; out_assign[p] = node index or -1.
//
// pin may be NULL (no incumbents) or p int32s: pin[s] >= 0 marks shard s a
// streaming incumbent on that node (a running Slurm job cannot migrate).
// Incumbents are handled reserve-first, preempt-only-when-necessary — the
// greedy.py oracle defines the semantics and this file must place
// bit-identically: a reservation pass (admission order) re-validates each
// pinned shard's node and subtracts its demand up front; in the gang loop
// a reserved shard converts its reservation into a placement, and a free
// agent that fits NOWHERE may evict strictly-lower-priority uncommitted
// reservations (last-admitted first, never its own gang-mates) on the
// node with the least potential capacity that suffices. A failed gang
// rolls back its placements and evictions and releases its own members'
// reservations (those incumbents are preempted as a unit).
//
// best_fit=0 packs first-fit (lowest node index that fits, the oracle's
// best_fit=False): the treap is keyed by node index with ALL dims
// augmented, so it is index-accelerated too — and at the 50k×10k headline
// it places MORE jobs than best-fit (45,183 vs 44,928, measured round 5).
// Tier-2 eviction is a best-fit-mode feature (matching the oracle's gate);
// pins/reservations work in both modes.
int sbt_indexed_place(int n, int r, float* free_io, const int32_t* node_part,
                      const uint32_t* node_feat, int p, const float* dem,
                      const int32_t* job_part, const uint32_t* req_feat,
                      const float* prio, const int32_t* gang, int best_fit,
                      const int32_t* pin, int32_t* out_assign) {
  // best_fit is a fit-policy selector: 1 = best-fit (default), 0 =
  // first-fit, 2 = worst-fit (max free cpu — at the 50k×10k headline it
  // places the most jobs of the three: 45,236 vs 45,183 / 44,928, at
  // best-fit speed since it rides the same cpu-keyed treap).
  const bool ff = best_fit == 0;
  const bool wf = best_fit == 2;
  if (p <= 0) return 0;
  if (r < 1 || r > 4) return -1;
  for (int i = 0; i < p; ++i) {
    if (gang[i] < 0 || gang[i] >= p) return -1;
    if (pin != nullptr && pin[i] >= n) return -1;
  }

  // stable order by priority descending, gangs grouped by first appearance
  std::vector<int32_t> order(p);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(), [&](int32_t a, int32_t b) {
    return prio[a] > prio[b];
  });
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

  // ---- reservation pass (admission order): pinned shards re-validate
  // their node (partition/feature/capacity) and reserve their demand up
  // front, so free agents best-fit around running work instead of through
  // it. state: 0 = none/lost, 1 = reservation alive, 2 = committed.
  // Runs BEFORE the index is built so the ~P reservations cost matrix
  // subtractions, not treap reindexes.
  std::vector<uint8_t> state(p, 0);
  std::vector<std::vector<int32_t>> pernode;  // reserved shards per node,
  int reserved_alive = 0;                     // admission-rank order
  // per-node sum of ALIVE reserved demand — an upper bound on what a
  // tier-2 eviction can recover there, so the common "fits nowhere even
  // with evictions" scan is O(n·r) instead of O(total reservations)
  std::vector<float> rsum;
  auto rsum_add = [&](int32_t nd, const float* d, float sign) {
    float* row = rsum.data() + static_cast<size_t>(nd) * r;
    for (int k = 0; k < r; ++k) row[k] += sign * d[k];
  };
  if (pin != nullptr) {
    pernode.assign(n, {});
    rsum.assign(static_cast<size_t>(n) * r, 0.f);
    for (int32_t s : order) {
      const int32_t pn = pin[s];
      if (pn < 0) continue;
      const float* d = dem + static_cast<size_t>(s) * r;
      const int32_t jp = job_part[s];
      const uint32_t rf = req_feat[s];
      bool ok_pin = (jp < 0 || node_part[pn] == jp) &&
                    ((node_feat[pn] & rf) == rf);
      float* f = free_io + static_cast<size_t>(pn) * r;
      for (int k = 0; ok_pin && k < r; ++k) ok_pin = f[k] >= d[k];
      if (!ok_pin) continue;
      for (int k = 0; k < r; ++k) f[k] -= d[k];
      state[s] = 1;
      pernode[pn].push_back(s);
      rsum_add(pn, d, 1.f);
      ++reserved_alive;
    }
  }

  // ---- build the index: bucket per distinct (partition, feature mask).
  // The cpu-keyed forest always exists: best-fit queries ride it, and in
  // first-fit mode it is the joint-feasibility oracle (its key ordering
  // prunes strongly; the index-keyed twin's per-dim maxima alone cannot
  // prove infeasibility, so unplaceable shards would wander it end to
  // end — measured 235 ms vs 63 ms at the 50k×10k headline).
  Forest forest(n, r, false);
  std::unique_ptr<Forest> forest2;  // index-keyed twin for first-fit
  if (ff) forest2.reset(new Forest(n, r, true));
  std::vector<Bucket> buckets;
  std::vector<int32_t> node_bucket(n, -1);
  for (int nd = 0; nd < n; ++nd) {
    int32_t b = -1;
    for (size_t i = 0; i < buckets.size(); ++i) {
      if (buckets[i].part == node_part[nd] && buckets[i].feat == node_feat[nd]) {
        b = static_cast<int32_t>(i);
        break;
      }
    }
    if (b < 0) {
      b = static_cast<int32_t>(buckets.size());
      buckets.push_back(Bucket{node_part[nd], node_feat[nd], kNil});
    }
    node_bucket[nd] = b;
    const float* row = free_io + static_cast<size_t>(nd) * r;
    buckets[b].root = forest.insert(buckets[b].root, nd, row);
    if (ff) buckets[b].root2 = forest2->insert(buckets[b].root2, nd, row);
  }

  std::fill(out_assign, out_assign + p, -1);

  auto reindex = [&](int32_t nd) {
    Bucket& bk = buckets[node_bucket[nd]];
    const float* row = free_io + static_cast<size_t>(nd) * r;
    bk.root = forest.erase(bk.root, nd);
    bk.root = forest.insert(bk.root, nd, row);
    if (ff) {
      bk.root2 = forest2->erase(bk.root2, nd);
      bk.root2 = forest2->insert(bk.root2, nd, row);
    }
  };
  auto idx_erase = [&](Bucket& bk, int32_t nd) {
    bk.root = forest.erase(bk.root, nd);
    if (ff) bk.root2 = forest2->erase(bk.root2, nd);
  };
  auto idx_insert = [&](Bucket& bk, int32_t nd) {
    const float* row = free_io + static_cast<size_t>(nd) * r;
    bk.root = forest.insert(bk.root, nd, row);
    if (ff) bk.root2 = forest2->insert(bk.root2, nd, row);
  };

  // Tier-2 failure certificates — an EXACT scan-skipping cache. The
  // potential capacity a tier-2 eviction can reach (free + alive
  // uncommitted reservations) is non-increasing across the solve: every
  // state transition either lowers it (placements, commits) or moves
  // value between the two terms (evict/release add to free what they
  // subtract from rsum), and a failed gang's rollback restores exactly
  // its start state. Likewise the set of strictly-lower-priority
  // reservations only shrinks. So once a FULL scan fails for demand d at
  // priority p (recorded only from single-shard gangs — no tentative
  // mid-gang state), any later shard with demand >= d per dim and
  // priority <= p must fail too and its O(n) scan can be skipped.
  // Two events break that monotonicity by converting priority-GATED
  // capacity into ungated free capacity — applying an eviction and
  // releasing a failed gang's reservations (a shard whose priority was
  // too low to count that reservation can use it once it lands in free) —
  // so the cache is cleared whenever either occurs; both are rare.
  // Placements are bit-identical with the cache on or off; without it the
  // steady-state backlog (thousands of unplaceable low-priority jobs
  // re-tried every streaming tick) pays ~n*r work per job per tick.
  struct FailCert {
    float dem[kMaxAug];
    float prio;
    int32_t part;   // recorder's partition constraint (-1 = any)
    uint32_t feat;  // recorder's required-feature mask
  };
  std::vector<FailCert> certs;
  // a cert covers a shard only when the shard's feasible-node domain is a
  // SUBSET of the recorder's: same-or-narrower partition (a -1 recorder
  // scanned everything) and a feature mask that contains the recorder's
  auto cert_covers = [&](const float* d, float prio_s, int32_t jp,
                         uint32_t rf) {
    for (const FailCert& c : certs) {
      if (prio_s > c.prio) continue;
      if (c.part >= 0 && jp != c.part) continue;
      if ((rf & c.feat) != c.feat) continue;
      bool dom = true;
      for (int k = 0; dom && k < r; ++k) dom = d[k] >= c.dem[k];
      if (dom) return true;
    }
    return false;
  };
  auto cert_record = [&](const float* d, float prio_s, int32_t jp,
                         uint32_t rf) {
    // keep a Pareto front per constraint class: smaller demand + higher
    // priority + wider domain = stronger
    for (size_t i = certs.size(); i-- > 0;) {
      const FailCert& c = certs[i];
      bool newer_stronger =
          prio_s >= c.prio && (jp < 0 || jp == c.part) &&
          (c.feat & rf) == rf;
      for (int k = 0; newer_stronger && k < r; ++k)
        newer_stronger = d[k] <= c.dem[k];
      if (newer_stronger) {
        certs[i] = certs.back();
        certs.pop_back();
      }
    }
    if (certs.size() >= 64) return;
    FailCert c;
    for (int k = 0; k < r; ++k) c.dem[k] = d[k];
    c.prio = prio_s;
    c.part = jp;
    c.feat = rf;
    certs.push_back(c);
  };

  // multi-shard gang bookkeeping: a chosen node is ERASED from its treap
  // (enforcing the distinct-node rule by construction) and the pre-gang
  // free row is logged so a failed gang restores matrix + index exactly
  std::vector<int32_t> touched_node;
  std::vector<float> touched_free;
  std::vector<int32_t> chosen_shard, chosen_node;
  std::vector<int32_t> evicted_this;
  int placed = 0;

  for (const auto& shards : gangs) {
    const bool multi = shards.size() > 1;
    const int32_t gcur = gang[shards[0]];
    chosen_shard.clear();
    chosen_node.clear();
    touched_node.clear();
    touched_free.clear();
    evicted_this.clear();
    bool ok = true;

    auto in_touched = [&](int32_t nd) {
      for (int32_t t : touched_node) {
        if (t == nd) return true;
      }
      return false;
    };

    for (int32_t s : shards) {
      const float* d = dem + static_cast<size_t>(s) * r;
      const int32_t jp = job_part[s];
      const uint32_t rf = req_feat[s];
      int best_node = kNil;
      const int32_t pn = pin != nullptr ? pin[s] : -1;
      bool was_reserved = false;
      if (pn >= 0 && state[s] == 1) {
        // the reservation converts into the placement — nothing more to
        // subtract, but gang distinctness still applies
        if (multi && in_touched(pn)) {
          ok = false;
          break;
        }
        best_node = pn;
        was_reserved = true;
      } else if (pn >= 0) {
        // lost (or never got) its reservation: one last chance on what
        // its node has left — pinned shards never evict
        bool ok_pin = (jp < 0 || node_part[pn] == jp) &&
                      ((node_feat[pn] & rf) == rf);
        const float* f = free_io + static_cast<size_t>(pn) * r;
        for (int k = 0; ok_pin && k < r; ++k) ok_pin = f[k] >= d[k];
        if (ok_pin && multi && in_touched(pn)) ok_pin = false;
        if (!ok_pin) {
          ok = false;
          break;
        }
        best_node = pn;
      } else {
        // best across matching buckets — best-fit: min (free_cpu, node
        // index), the baseline's min-leftover tie-break; first-fit:
        // lowest node index that fits every dim
        for (Bucket& bk : buckets) {
          if (jp >= 0 && bk.part != jp) continue;
          if ((bk.feat & rf) != rf) continue;
          int cand;
          if (ff) {
            // the cpu-keyed twin answers "does anything here fit at all"
            // and supplies a fitting node whose index caps the search
            const int c_bf = forest.query(bk.root, d[0], d);
            if (c_bf == kNil) continue;
            const int bound =
                best_node == kNil ? c_bf + 1 : std::min(best_node, c_bf + 1);
            cand = forest2->query_ff(bk.root2, d, bound);
          } else if (wf) {
            cand = forest.query_worst(bk.root, d[0], d);
          } else {
            cand = forest.query(bk.root, d[0], d);
          }
          if (cand == kNil) continue;
          if (ff) {
            if (best_node == kNil || cand < best_node) best_node = cand;
          } else if (wf) {
            // max (free_cpu, idx) across buckets — mirrors the in-bucket
            // rightmost pick
            if (best_node == kNil ||
                forest.key_cpu[cand] > forest.key_cpu[best_node] ||
                (forest.key_cpu[cand] == forest.key_cpu[best_node] &&
                 cand > best_node)) {
              best_node = cand;
            }
          } else if (best_node == kNil ||
                     forest.key_cpu[cand] < forest.key_cpu[best_node] ||
                     (forest.key_cpu[cand] == forest.key_cpu[best_node] &&
                      cand < best_node)) {
            best_node = cand;
          }
        }
        if (best_fit == 1 && best_node == kNil && reserved_alive > 0 &&
            !cert_covers(d, prio[s], jp, rf)) {
          // tier-2, preempt-only-when-necessary: the node with the least
          // potential capacity (own free + strictly-lower-priority
          // uncommitted reservations, never this gang's own) that fits
          const float prio_s = prio[s];
          float best_cpu = 0.f;
          float pot[kMaxAug + 1];
          for (int32_t nd = 0; nd < n; ++nd) {
            if (jp >= 0 && node_part[nd] != jp) continue;
            if ((node_feat[nd] & rf) != rf) continue;
            const float* f = free_io + static_cast<size_t>(nd) * r;
            {
              // prune on free + ALL alive reservations — an upper bound
              // on the filtered potential below, so hopeless nodes cost
              // O(r), not a walk of their reservation list
              const float* rs = rsum.data() + static_cast<size_t>(nd) * r;
              bool maybe = true;
              for (int k = 0; maybe && k < r; ++k) maybe = f[k] + rs[k] >= d[k];
              if (!maybe) continue;
            }
            if (multi && in_touched(nd)) continue;
            for (int k = 0; k < r; ++k) pot[k] = f[k];
            bool any = false;
            for (int32_t e : pernode[nd]) {  // admission-rank order —
              if (state[e] != 1) continue;   // float-add order is part of
              if (prio[e] >= prio_s) continue;  // the oracle contract
              if (gang[e] == gcur) continue;
              any = true;
              const float* de = dem + static_cast<size_t>(e) * r;
              for (int k = 0; k < r; ++k) pot[k] += de[k];
            }
            if (!any) continue;
            bool fits = true;
            for (int k = 0; fits && k < r; ++k) fits = pot[k] >= d[k];
            if (!fits) continue;
            if (best_node == kNil || pot[0] < best_cpu) {
              best_node = nd;
              best_cpu = pot[0];
            }
          }
          if (best_node != kNil) {
            // make room: evict last-admitted first until the shard fits
            float* f = free_io + static_cast<size_t>(best_node) * r;
            if (multi) {
              touched_node.push_back(best_node);
              touched_free.insert(touched_free.end(), f, f + r);
              idx_erase(buckets[node_bucket[best_node]], best_node);
            }
            const auto& lst = pernode[best_node];
            for (size_t i = lst.size(); i-- > 0;) {
              bool fits = true;
              for (int k = 0; fits && k < r; ++k) fits = f[k] >= d[k];
              if (fits) break;
              const int32_t e = lst[i];
              if (state[e] != 1 || prio[e] >= prio_s || gang[e] == gcur)
                continue;
              const float* de = dem + static_cast<size_t>(e) * r;
              for (int k = 0; k < r; ++k) f[k] += de[k];
              state[e] = 0;
              rsum_add(best_node, de, -1.f);
              --reserved_alive;
              evicted_this.push_back(e);
              certs.clear();  // gated capacity became free capacity
            }
            for (int k = 0; k < r; ++k) f[k] -= d[k];
            if (!multi) reindex(best_node);
            chosen_shard.push_back(s);
            chosen_node.push_back(best_node);
            continue;  // placement fully applied above
          }
          if (!multi) cert_record(d, prio_s, jp, rf);  // full scan failed
        }
      }
      if (best_node == kNil) {
        ok = false;
        break;
      }
      float* f = free_io + static_cast<size_t>(best_node) * r;
      if (multi) {
        touched_node.push_back(best_node);
        touched_free.insert(touched_free.end(), f, f + r);
        // take the node out of the index: gang-mates must use distinct
        // nodes, and commit/rollback reinserts it with the right values
        idx_erase(buckets[node_bucket[best_node]], best_node);
        if (!was_reserved) {
          for (int k = 0; k < r; ++k) f[k] -= d[k];
        }
      } else if (!was_reserved) {
        for (int k = 0; k < r; ++k) f[k] -= d[k];
        reindex(best_node);
      }
      chosen_shard.push_back(s);
      chosen_node.push_back(best_node);
    }

    if (ok) {
      for (size_t i = 0; i < chosen_shard.size(); ++i) {
        const int32_t s = chosen_shard[i];
        out_assign[s] = chosen_node[i];
        if (state[s] == 1) {
          state[s] = 2;  // committed — no longer evictable
          rsum_add(pin[s], dem + static_cast<size_t>(s) * r, -1.f);
          --reserved_alive;
        }
        ++placed;
      }
      if (multi) {
        for (int32_t nd : touched_node) {
          idx_insert(buckets[node_bucket[nd]], nd);
        }
      }
    } else {
      if (multi) {
        // roll back in reverse; nodes were erased, so restore + reinsert
        for (size_t i = touched_node.size(); i-- > 0;) {
          const int32_t nd = touched_node[i];
          std::memcpy(free_io + static_cast<size_t>(nd) * r,
                      touched_free.data() + i * r, sizeof(float) * r);
          idx_insert(buckets[node_bucket[nd]], nd);
        }
      }
      // un-evict (their capacity lives only in the rolled-back rows),
      // then release THIS gang's own reservations — its incumbents are
      // preempted as a unit
      for (int32_t e : evicted_this) {
        state[e] = 1;
        rsum_add(pin[e], dem + static_cast<size_t>(e) * r, 1.f);
        ++reserved_alive;
      }
      for (int32_t s : shards) {
        if (state[s] == 1) {
          const int32_t pn = pin[s];
          float* f = free_io + static_cast<size_t>(pn) * r;
          const float* d = dem + static_cast<size_t>(s) * r;
          for (int k = 0; k < r; ++k) f[k] += d[k];
          state[s] = 0;
          rsum_add(pn, d, -1.f);
          --reserved_alive;
          reindex(pn);
          certs.clear();  // gated capacity became free capacity
        }
      }
    }
    // single-shard failure on the non-evicting paths touched nothing
  }
  return placed;
}

}  // extern "C"
