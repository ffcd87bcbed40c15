// Native CMC/mAP ranking kernel of bpbreid_tpu_torch (a copy of
// bpbreid_tpu/native/rank.cpp).
//
// The reference ships a Cython implementation of the market1501/cuhk03
// ranking protocols (reference: torchreid/metrics/rank_cylib/rank_cy.pyx,
// built by rank_cylib/Makefile). This is the equivalent native component
// on the host: a multithreaded C++ kernel exposed through a plain C ABI
// and loaded with ctypes (no pybind11 dependency).
//
// Per query: argsort the distance row, drop same-(pid,camid) junk,
// then a single pass accumulates the CMC first-match rank and AP.
//
// Build (native/rank.py does it at first use, into _build/):
// g++ -O3 -std=c++17 -shared -fPIC -pthread rank.cpp -o librank-<hash>.so

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <thread>
#include <unordered_map>
#include <vector>

extern "C" {

// Returns 0 on success, -1 if no valid query.
// cmc_out: [max_rank] averaged CMC curve. map_out: scalar mAP.
int eval_market1501(const float* distmat, const int64_t* q_pids,
                    const int64_t* g_pids, const int64_t* q_camids,
                    const int64_t* g_camids, int64_t num_q, int64_t num_g,
                    int64_t max_rank, float* cmc_out, double* map_out,
                    int64_t num_threads) {
  if (max_rank > num_g) max_rank = num_g;
  std::vector<double> cmc_acc(max_rank, 0.0);
  std::vector<double> ap_acc(1, 0.0);
  std::atomic<int64_t> n_valid{0};

  int64_t hw = num_threads > 0
                   ? num_threads
                   : static_cast<int64_t>(std::thread::hardware_concurrency());
  if (hw < 1) hw = 1;
  if (hw > num_q) hw = num_q;

  std::vector<std::vector<double>> cmc_parts(hw,
                                             std::vector<double>(max_rank, 0));
  std::vector<double> ap_parts(hw, 0.0);

  auto worker = [&](int64_t tid) {
    std::vector<int32_t> order(num_g);
    for (int64_t q = tid; q < num_q; q += hw) {
      const float* row = distmat + q * num_g;
      std::iota(order.begin(), order.end(), 0);
      std::stable_sort(order.begin(), order.end(),
                       [&](int32_t a, int32_t b) { return row[a] < row[b]; });
      const int64_t pid = q_pids[q];
      const int64_t cam = q_camids[q];
      // single pass over the sorted gallery
      int64_t kept = 0;        // rank among kept entries
      int64_t num_rel = 0;     // true matches seen so far
      int64_t first_match = -1;
      double ap = 0.0;
      for (int64_t j = 0; j < num_g; ++j) {
        const int32_t g = order[j];
        const bool match = g_pids[g] == pid;
        if (match && g_camids[g] == cam) continue;  // junk
        if (match) {
          ++num_rel;
          ap += static_cast<double>(num_rel) / static_cast<double>(kept + 1);
          if (first_match < 0) first_match = kept;
        }
        ++kept;
      }
      if (num_rel == 0) continue;  // invalid query
      n_valid.fetch_add(1, std::memory_order_relaxed);
      ap_parts[tid] += ap / static_cast<double>(num_rel);
      if (first_match < max_rank) {
        for (int64_t r = first_match; r < max_rank; ++r)
          cmc_parts[tid][r] += 1.0;
      }
    }
  };

  std::vector<std::thread> threads;
  threads.reserve(hw);
  for (int64_t t = 0; t < hw; ++t) threads.emplace_back(worker, t);
  for (auto& t : threads) t.join();

  const int64_t valid = n_valid.load();
  if (valid == 0) return -1;
  double map_sum = 0.0;
  for (int64_t t = 0; t < hw; ++t) {
    map_sum += ap_parts[t];
    for (int64_t r = 0; r < max_rank; ++r) cmc_acc[r] += cmc_parts[t][r];
  }
  for (int64_t r = 0; r < max_rank; ++r)
    cmc_out[r] = static_cast<float>(cmc_acc[r] / valid);
  *map_out = map_sum / valid;
  return 0;
}

// Counter-based RNG: deterministic regardless of thread scheduling —
// every (seed, query, repeat, group) tuple hashes to an independent
// uniform draw, so results are bit-reproducible at any thread count.
static inline uint64_t splitmix64(uint64_t x) {
  x += 0x9e3779b97f4a7c15ULL;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ULL;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebULL;
  return x ^ (x >> 31);
}

// CUHK03 single-gallery-shot protocol (reference:
// torchreid/metrics/rank_cylib/rank_cy.pyx:35-151): per query, kept
// gallery entries are grouped by pid; each of num_repeats rounds
// samples one entry per group and ranks the true pid's pick among the
// sampled set. AP uses the full kept set (as in the reference).
int eval_cuhk03(const float* distmat, const int64_t* q_pids,
                const int64_t* g_pids, const int64_t* q_camids,
                const int64_t* g_camids, int64_t num_q, int64_t num_g,
                int64_t max_rank, int64_t num_repeats, uint64_t seed,
                float* cmc_out, double* map_out, int64_t num_threads) {
  if (max_rank > num_g) max_rank = num_g;

  int64_t hw = num_threads > 0
                   ? num_threads
                   : static_cast<int64_t>(std::thread::hardware_concurrency());
  if (hw < 1) hw = 1;
  if (hw > num_q) hw = num_q;

  // per-query accumulators (not per-thread) so the final reduction is
  // a fixed-order sum — results are bit-identical at any thread count
  std::vector<double> ap_q(num_q, 0.0);
  std::vector<uint8_t> valid_q(num_q, 0);
  std::vector<double> cmc_q(num_q * max_rank, 0.0);

  auto worker = [&](int64_t tid) {
    std::vector<int32_t> order(num_g);
    std::vector<int32_t> kept_gid;   // per kept entry: its group index
    std::vector<int32_t> group_len;
    std::vector<int64_t> group_pid;
    std::vector<int32_t> picked;
    std::vector<double> qcmc(max_rank);
    for (int64_t q = tid; q < num_q; q += hw) {
      const float* row = distmat + q * num_g;
      std::iota(order.begin(), order.end(), 0);
      std::stable_sort(order.begin(), order.end(),
                       [&](int32_t a, int32_t b) { return row[a] < row[b]; });
      const int64_t pid = q_pids[q];
      const int64_t cam = q_camids[q];

      kept_gid.clear();
      group_len.clear();
      group_pid.clear();
      std::unordered_map<int64_t, int64_t> gid_of_pid;
      gid_of_pid.reserve(64);
      int64_t kept = 0, num_rel = 0;
      double ap = 0.0;
      int64_t true_group = -1;
      for (int64_t j = 0; j < num_g; ++j) {
        const int32_t g = order[j];
        const bool match = g_pids[g] == pid;
        if (match && g_camids[g] == cam) continue;  // junk
        if (match) {
          ++num_rel;
          ap += static_cast<double>(num_rel) / static_cast<double>(kept + 1);
        }
        auto ins = gid_of_pid.emplace(
            g_pids[g], static_cast<int64_t>(group_pid.size()));
        const int64_t gi = ins.first->second;
        if (ins.second) {    // first kept entry of this pid
          group_pid.push_back(g_pids[g]);
          group_len.push_back(0);
          if (match) true_group = gi;
        }
        kept_gid.push_back(static_cast<int32_t>(gi));
        group_len[gi]++;
        ++kept;
      }
      if (num_rel == 0) continue;
      valid_q[q] = 1;
      ap_q[q] = ap / static_cast<double>(num_rel);

      // lay kept positions contiguously per group (counting sort):
      // group k owns grouped[starts[k] .. starts[k]+group_len[k])
      const int64_t n_groups = static_cast<int64_t>(group_pid.size());
      std::vector<int32_t> starts(n_groups), fill(n_groups, 0);
      int32_t acc = 0;
      for (int64_t k = 0; k < n_groups; ++k) {
        starts[k] = acc;
        acc += group_len[k];
      }
      std::vector<int32_t> grouped(kept_gid.size());
      for (int64_t p = 0; p < kept; ++p) {
        const int32_t gi = kept_gid[p];
        grouped[starts[gi] + fill[gi]++] = static_cast<int32_t>(p);
      }

      std::fill(qcmc.begin(), qcmc.end(), 0.0);
      picked.resize(n_groups);
      const int64_t cmc_lim = n_groups < max_rank ? n_groups : max_rank;
      for (int64_t rep = 0; rep < num_repeats; ++rep) {
        for (int64_t k = 0; k < n_groups; ++k) {
          const uint64_t h = splitmix64(
              seed ^ (static_cast<uint64_t>(q) << 40) ^
              (static_cast<uint64_t>(rep) << 20) ^ static_cast<uint64_t>(k));
          picked[k] = grouped[starts[k] + static_cast<int32_t>(
              h % static_cast<uint64_t>(group_len[k]))];
        }
        const int32_t true_pos = picked[true_group];
        int64_t rank = 0;
        for (int64_t k = 0; k < n_groups; ++k)
          rank += picked[k] < true_pos;
        for (int64_t r = rank; r < cmc_lim; ++r) qcmc[r] += 1.0;
      }
      for (int64_t r = 0; r < max_rank; ++r)
        cmc_q[q * max_rank + r] = qcmc[r] / static_cast<double>(num_repeats);
    }
  };

  std::vector<std::thread> threads;
  threads.reserve(hw);
  for (int64_t t = 0; t < hw; ++t) threads.emplace_back(worker, t);
  for (auto& t : threads) t.join();

  int64_t valid = 0;
  double map_sum = 0.0;
  std::vector<double> cmc_acc(max_rank, 0.0);
  for (int64_t q = 0; q < num_q; ++q) {   // fixed-order reduction
    if (!valid_q[q]) continue;
    ++valid;
    map_sum += ap_q[q];
    for (int64_t r = 0; r < max_rank; ++r) cmc_acc[r] += cmc_q[q * max_rank + r];
  }
  if (valid == 0) return -1;
  for (int64_t r = 0; r < max_rank; ++r)
    cmc_out[r] = static_cast<float>(cmc_acc[r] / valid);
  *map_out = map_sum / valid;
  return 0;
}

}  // extern "C"
