// Native host-side HNSW graph core.
//
// The reference (zhao-lang/redis_hnsw) implements its entire engine as a
// native Rust cdylib: pointer graph (src/hnsw/core.rs:92-319), insert
// (:489-599), select_neighbors (:677-757), delete repair (:824-863),
// search (:607-675, :865-892) and an AVX2 distance kernel
// (src/hnsw/metrics.rs:48-77). In this package the *batched* hot paths
// run on the card (PyTorch and the CUDA kernels beside this file), while
// the latency-sensitive, pointer-chasing host runtime -- graph surgery,
// sequential insert/delete/search, bulk-wave link application -- lives
// here, exposed over a C ABI and bound via ctypes
// (redis_hnsw_tpu_torch/native_core.py, built by utils/build.py). The
// Python engine in models/hnsw.py implements identical semantics and is
// the fallback when this library is not built. This file is the port's
// own copy of the JAX package's native/hnsw_core.cpp, the same code: the
// graphs the two build are byte-identical.
//
// Semantics notes (kept in lockstep with models/hnsw.py and the reference):
// * similarity = negative squared L2, f32 (metrics.rs:75-83); hamming =
//   negative popcount over packed u32 words.
// * search_level: visited-on-discovery, accept if sim > worst or |W| < ef,
//   pop-best expansion, early exit (core.rs:607-675).
// * select_neighbors with extend+keep_pruned both true reduces to top-m by
//   sim over candidates U their layer-lc neighbors (see models/hnsw.py
//   module docstring for the derivation).
// * tie-breaks follow models/hnsw.py: candidate pops prefer the smaller
//   row, result ordering is (-sim, row), "best of beam" is (sim, row)-max.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <queue>
#include <unordered_map>
#include <vector>

namespace {

using std::int32_t;
using std::uint32_t;

constexpr float NEG_INF = -std::numeric_limits<float>::infinity();

struct Core {
    int m = 5;
    int m_max = 5;
    int m_max0 = 10;
    int ef_construction = 200;
    int metric = 0;      // 0 = euclidean, 1 = hamming
    int width = 0;       // row width: dim (f32) or dim/32 (u32)
    const void* vecs = nullptr;  // borrowed row-major table [cap, width]
    long cap = 0;

    // adjacency: per row, per layer, neighbor row ids (insertion order,
    // unique). level < 0 means the row is free.
    std::vector<std::vector<std::vector<int32_t>>> adj;
    std::vector<int32_t> level;

    // epoch-stamped visited marks for search_level
    std::vector<uint64_t> stamp;
    uint64_t epoch = 0;  // u64: never wraps in practice (i32 overflowed after ~2^31 searches)

    // dirty-row tracking for incremental device snapshots: any row whose
    // adjacency (or existence) changed since the last drain
    std::vector<int32_t> dirty;
    std::vector<uint8_t> dirty_flag;

    void mark_dirty(int32_t row) {
        if ((long)dirty_flag.size() <= row) dirty_flag.resize(row + 1, 0);
        if (!dirty_flag[row]) {
            dirty_flag[row] = 1;
            dirty.push_back(row);
        }
    }

    const float* frow(int32_t r) const {
        return static_cast<const float*>(vecs) + (long)r * width;
    }
    const uint32_t* hrow(int32_t r) const {
        return static_cast<const uint32_t*>(vecs) + (long)r * width;
    }

    float sim_rows(const void* q, int32_t r) const {
        if (metric == 0) {
            const float* a = static_cast<const float*>(q);
            const float* b = frow(r);
            float acc = 0.0f;
            for (int i = 0; i < width; ++i) {
                float d = a[i] - b[i];
                acc += d * d;
            }
            return -acc;
        }
        const uint32_t* a = static_cast<const uint32_t*>(q);
        const uint32_t* b = hrow(r);
        int acc = 0;
        for (int i = 0; i < width; ++i) {
            acc += __builtin_popcount(a[i] ^ b[i]);
        }
        return -(float)acc;
    }

    void ensure(long n) {
        if ((long)adj.size() < n) {
            adj.resize(n);
            level.resize(n, -1);
            stamp.resize(n, 0);
        }
    }

    std::vector<int32_t>* nbrs(int32_t row, int lc) {
        auto& lists = adj[row];
        if (lc >= (int)lists.size()) return nullptr;
        return &lists[lc];
    }

    // add_neighbor semantics (core.rs:137-143): grow layers, dedupe.
    void add_link(int32_t row, int lc, int32_t other) {
        auto& lists = adj[row];
        if ((int)lists.size() < lc + 1) lists.resize(lc + 1);
        auto& l = lists[lc];
        if (std::find(l.begin(), l.end(), other) == l.end()) {
            l.push_back(other);
            mark_dirty(row);
        }
    }

    void rm_link(int32_t row, int lc, int32_t other) {
        auto& l = adj[row][lc];
        auto it = std::find(l.begin(), l.end(), other);
        if (it != l.end()) {
            l.erase(it);
            mark_dirty(row);
        }
    }

    // update_node_connections semantics (core.rs:776-822). ``del`` (when
    // non-null) generalizes ``ignored`` to a whole delete set: reverse
    // links toward rows being deleted are left stale, exactly like the
    // reference leaves the single deleted row's own list stale
    // (core.rs:810-816) -- those lists are freed by the caller anyway.
    void update_connections(int32_t row, const std::vector<int32_t>& keep,
                            const std::vector<int32_t>& old, int lc,
                            int32_t ignored,
                            const std::vector<uint8_t>* del = nullptr) {
        for (int32_t nb : keep) {
            add_link(row, lc, nb);
            add_link(nb, lc, row);
        }
        for (int32_t nb : old) {
            if (std::find(keep.begin(), keep.end(), nb) != keep.end())
                continue;
            rm_link(row, lc, nb);
            if (nb != ignored && !(del && (*del)[nb])) rm_link(nb, lc, row);
        }
    }

    // search_level (core.rs:607-675). Returns (sim, row) pairs, unordered
    // heap contents like the Python list. q points at one query row.
    void search_level(const void* q, int32_t ep, int ef, int lc,
                      std::vector<std::pair<float, int32_t>>& out) {
        out.clear();
        ++epoch;
        stamp[ep] = epoch;
        float s0 = sim_rows(q, ep);

        // cand: max by sim, tie -> smaller row (python heap on (-s, row))
        using CE = std::pair<float, int32_t>;
        auto cand_less = [](const CE& a, const CE& b) {
            if (a.first != b.first) return a.first < b.first;
            return a.second > b.second;  // smaller row wins ties
        };
        std::priority_queue<CE, std::vector<CE>, decltype(cand_less)> cand(
            cand_less);
        // res: min-heap by (sim, row)
        auto res_greater = [](const CE& a, const CE& b) { return a > b; };
        std::priority_queue<CE, std::vector<CE>, decltype(res_greater)> res(
            res_greater);

        cand.push({s0, ep});
        res.push({s0, ep});

        while (!cand.empty()) {
            auto [cs, crow] = cand.top();
            cand.pop();
            if (cs < res.top().first) break;
            auto* nl = nbrs(crow, lc);
            if (!nl) continue;
            for (int32_t n : *nl) {
                if (stamp[n] == epoch) continue;
                stamp[n] = epoch;
                float s = sim_rows(q, n);
                if (s > res.top().first || (int)res.size() < ef) {
                    cand.push({s, n});
                    res.push({s, n});
                    if ((int)res.size() > ef) res.pop();
                }
            }
        }
        while (!res.empty()) {
            out.push_back(res.top());
            res.pop();
        }
    }

    // select_neighbors net semantics (core.rs:677-757 with both flags
    // true): top-m by (-sim, row) over candidates U their layer-lc
    // neighbors, excluding q_row and ignored. q may be a non-row vector.
    // ``del`` (when non-null) is a whole-set generalization of
    // ``ignored`` for bulk deletes: candidates still extend one hop
    // THROUGH deleted rows' lists (that is how the reference's repair
    // finds replacement links, core.rs:834-853), but no deleted row can
    // be selected.
    void select_neighbors(const void* q, int32_t q_row,
                          const std::vector<std::pair<float, int32_t>>& cand,
                          int m, int lc, int32_t ignored,
                          std::vector<std::pair<float, int32_t>>& out,
                          const std::vector<uint8_t>* del = nullptr) {
        std::unordered_map<int32_t, float> sims;
        sims.reserve(cand.size() * 4);
        for (auto& [s, row] : cand) sims[row] = s;
        for (auto& [s, row] : cand) {
            auto* nl = nbrs(row, lc);
            if (!nl) continue;
            for (int32_t nb : *nl) {
                if (nb == q_row || nb == ignored) continue;
                if (del && (*del)[nb]) continue;
                if (sims.count(nb)) continue;
                sims[nb] = sim_rows(q, nb);
            }
        }
        sims.erase(q_row);
        sims.erase(ignored);
        if (del) {
            for (auto it = sims.begin(); it != sims.end();) {
                it = (*del)[it->first] ? sims.erase(it) : std::next(it);
            }
        }
        std::vector<std::pair<float, int32_t>> ranked;
        ranked.reserve(sims.size());
        for (auto& [row, s] : sims) ranked.push_back({s, row});
        std::sort(ranked.begin(), ranked.end(),
                  [](const auto& a, const auto& b) {
                      if (a.first != b.first) return a.first > b.first;
                      return a.second < b.second;
                  });
        if ((int)ranked.size() > m) ranked.resize(m);
        out = std::move(ranked);
    }

    // best of a search_level result: (sim, row) max, tie -> larger row
    // (python max() over (sim, row) tuples)
    static int32_t best_of(const std::vector<std::pair<float, int32_t>>& w) {
        auto it = std::max_element(w.begin(), w.end());
        return it->second;
    }

    void shrink_if_over(int32_t e_row, int lc, int cap_deg, bool extend) {
        auto* nl = nbrs(e_row, lc);
        if (!nl || (int)nl->size() <= cap_deg) return;
        const void* e_vec = metric == 0 ? (const void*)frow(e_row)
                                        : (const void*)hrow(e_row);
        std::vector<int32_t> old(*nl);
        std::vector<std::pair<float, int32_t>> econn;
        econn.reserve(old.size());
        for (int32_t r : old) econn.push_back({sim_rows(e_vec, r), r});
        std::vector<std::pair<float, int32_t>> keep;
        if (extend) {
            select_neighbors(e_vec, e_row, econn, cap_deg, lc, -1, keep);
        } else {
            std::sort(econn.begin(), econn.end(),
                      [](const auto& a, const auto& b) {
                          if (a.first != b.first) return a.first > b.first;
                          return a.second < b.second;
                      });
            if ((int)econn.size() > cap_deg) econn.resize(cap_deg);
            keep = std::move(econn);
        }
        std::vector<int32_t> keep_ids;
        keep_ids.reserve(keep.size());
        for (auto& [s, r] : keep) keep_ids.push_back(r);
        update_connections(e_row, keep_ids, old, lc, -1);
    }

    // the insert path (core.rs:489-599), given the sampled level and the
    // current enterpoint/max_layer (bookkeeping stays in Python).
    void insert(int32_t row, int l, const void* q, int32_t ep0, int l_max) {
        int32_t ep = ep0;
        std::vector<std::pair<float, int32_t>> w;
        int lc = l_max;
        while (lc > l) {
            search_level(q, ep, 1, lc, w);
            ep = best_of(w);
            if (lc == 0) break;
            --lc;
        }
        for (lc = std::min(l_max, l); lc >= 0; --lc) {
            search_level(q, ep, ef_construction, lc, w);
            std::vector<std::pair<float, int32_t>> selected;
            select_neighbors(q, row, w, m, lc, -1, selected);
            for (auto& [s, r] : selected) {
                add_link(row, lc, r);
                add_link(r, lc, row);
            }
            int cap_deg = lc == 0 ? m_max0 : m_max;
            for (auto& [s, r] : selected)
                shrink_if_over(r, lc, cap_deg, /*extend=*/true);
            ep = best_of(w);
        }
    }

    // delete repair (core.rs:414-475 + :824-863); the caller removes the
    // row from its layer set and re-elects the enterpoint.
    void delete_repair(int32_t row) {
        auto& lists = adj[row];
        for (int lc = 0; lc < (int)lists.size(); ++lc) {
            std::vector<int32_t> exn(lists[lc]);
            for (int32_t n_row : exn) {
                auto* nl = nbrs(n_row, lc);
                if (!nl) continue;
                std::vector<int32_t> old(*nl);
                const void* n_vec = metric == 0 ? (const void*)frow(n_row)
                                                : (const void*)hrow(n_row);
                std::vector<std::pair<float, int32_t>> nconn;
                nconn.reserve(old.size());
                for (int32_t r : old)
                    nconn.push_back({sim_rows(n_vec, r), r});
                int cap_deg = lc == 0 ? m_max0 : m_max;
                std::vector<std::pair<float, int32_t>> keep;
                select_neighbors(n_vec, n_row, nconn, cap_deg, lc, row, keep);
                std::vector<int32_t> keep_ids;
                for (auto& [s, r] : keep) keep_ids.push_back(r);
                update_connections(n_row, keep_ids, old, lc, row);
            }
        }
        adj[row].clear();
        level[row] = -1;
        mark_dirty(row);
    }

    // bulk delete with one-shot survivor repair (delete_batch in
    // models/hnsw.py -- semantics kept in lockstep). The reference has
    // no bulk delete; this generalizes its single-delete repair
    // (core.rs:824-863) to a whole delete set: each affected SURVIVOR
    // is re-selected once per layer with every deleted row excluded,
    // instead of once per deleted ex-neighbor. Repair order: layer
    // ascending, survivor row ascending (deterministic; matches the
    // Python twin). The caller frees names / layer sets / enterpoint.
    void delete_batch(const int32_t* rows_in, int n) {
        std::vector<uint8_t> del(adj.size(), 0);
        int max_layers = 0;
        for (int i = 0; i < n; ++i) {
            del[rows_in[i]] = 1;
            max_layers = std::max(max_layers, (int)adj[rows_in[i]].size());
        }
        std::vector<int32_t> survivors, keep_ids, old;
        std::vector<std::pair<float, int32_t>> nconn, keep;
        for (int lc = 0; lc < max_layers; ++lc) {
            survivors.clear();
            for (int i = 0; i < n; ++i) {
                auto& lists = adj[rows_in[i]];
                if (lc >= (int)lists.size()) continue;
                for (int32_t nb : lists[lc])
                    if (!del[nb]) survivors.push_back(nb);
            }
            std::sort(survivors.begin(), survivors.end());
            survivors.erase(
                std::unique(survivors.begin(), survivors.end()),
                survivors.end());
            int cap_deg = lc == 0 ? m_max0 : m_max;
            for (int32_t n_row : survivors) {
                auto* nl = nbrs(n_row, lc);
                if (!nl || nl->empty()) continue;
                old.assign(nl->begin(), nl->end());
                const void* n_vec = metric == 0 ? (const void*)frow(n_row)
                                                : (const void*)hrow(n_row);
                nconn.clear();
                for (int32_t r : old)
                    nconn.push_back({sim_rows(n_vec, r), r});
                select_neighbors(n_vec, n_row, nconn, cap_deg, lc, -1,
                                 keep, &del);
                keep_ids.clear();
                for (auto& [s, r] : keep) keep_ids.push_back(r);
                update_connections(n_row, keep_ids, old, lc, -1, &del);
            }
        }
        for (int i = 0; i < n; ++i) {
            adj[rows_in[i]].clear();
            level[rows_in[i]] = -1;
            mark_dirty(rows_in[i]);
        }
    }

    // bulk-wave surgery (redis_hnsw_tpu/ops/construct.py step 3): apply
    // device-scored candidates for W inserts in wave order.
    void apply_wave(const int32_t* rows, const int32_t* levels, int W,
                    const int32_t* up_ids, const float* up_sims, int n_up,
                    const int32_t* l0_ids, const float* l0_sims, int ef,
                    const float* cross, int l_max_snap) {
        std::vector<std::pair<float, int32_t>> cand;
        std::vector<int32_t> sel;
        for (int i = 0; i < W; ++i) {
            int32_t row = rows[i];
            int l = levels[i];
            for (int lc = std::min(l_max_snap, l); lc >= 0; --lc) {
                const int32_t* cids;
                const float* csims;
                if (lc == 0) {
                    cids = l0_ids + (long)i * ef;
                    csims = l0_sims + (long)i * ef;
                } else {
                    long off = ((long)(lc - 1) * W + i) * ef;
                    cids = up_ids + off;
                    csims = up_sims + off;
                }
                cand.clear();
                for (int c = 0; c < ef; ++c)
                    cand.push_back({csims[c], cids[c]});
                for (int j = 0; j < i; ++j)
                    if (levels[j] >= lc)
                        cand.push_back({cross[(long)i * W + j], rows[j]});
                std::sort(cand.begin(), cand.end(),
                          [](const auto& a, const auto& b) {
                              if (a.first != b.first)
                                  return a.first > b.first;
                              return a.second < b.second;
                          });
                // top-m distinct live rows (construct.py::_select_top_m)
                sel.clear();
                for (auto& [s, cid] : cand) {
                    if (cid < 0 || s == NEG_INF || cid == row) continue;
                    if (level[cid] < 0) continue;  // freed row
                    if (std::find(sel.begin(), sel.end(), cid) != sel.end())
                        continue;
                    sel.push_back(cid);
                    if ((int)sel.size() == m) break;
                }
                for (int32_t r : sel) {
                    add_link(row, lc, r);
                    add_link(r, lc, row);
                }
                int cap_deg = lc == 0 ? m_max0 : m_max;
                for (int32_t r : sel)
                    shrink_if_over(r, lc, cap_deg, /*extend=*/false);
            }
        }
    }
};

}  // namespace

extern "C" {

void* hnsw_new(int m, int m_max, int m_max0, int ef_construction,
               int metric, int width) {
    auto* c = new Core();
    c->m = m;
    c->m_max = m_max;
    c->m_max0 = m_max0;
    c->ef_construction = ef_construction;
    c->metric = metric;
    c->width = width;
    return c;
}

void hnsw_free(void* h) { delete static_cast<Core*>(h); }

// (re)attach the vector table after the host grows/reallocates it
void hnsw_attach(void* h, const void* vecs, long cap) {
    auto* c = static_cast<Core*>(h);
    c->vecs = vecs;
    c->cap = cap;
    c->ensure(cap);
}

void hnsw_alloc_node(void* h, int row, int lvl) {
    auto* c = static_cast<Core*>(h);
    c->ensure(row + 1);
    c->level[row] = lvl;
    c->adj[row].assign(lvl + 1, {});
    c->mark_dirty(row);
}

int hnsw_level(void* h, int row) {
    auto* c = static_cast<Core*>(h);
    if (row >= (int)c->level.size()) return -1;
    return c->level[row];
}

int hnsw_n_layers(void* h, int row) {
    return (int)static_cast<Core*>(h)->adj[row].size();
}

int hnsw_degree(void* h, int row, int lc) {
    auto* c = static_cast<Core*>(h);
    auto* nl = c->nbrs(row, lc);
    return nl ? (int)nl->size() : 0;
}

int hnsw_get_neighbors(void* h, int row, int lc, int32_t* out, int cap) {
    auto* c = static_cast<Core*>(h);
    auto* nl = c->nbrs(row, lc);
    if (!nl) return 0;
    int n = std::min((int)nl->size(), cap);
    std::memcpy(out, nl->data(), n * sizeof(int32_t));
    return n;
}

// restore path: overwrite one layer's list verbatim
void hnsw_set_neighbors(void* h, int row, int lc, const int32_t* ids,
                        int n) {
    auto* c = static_cast<Core*>(h);
    auto& lists = c->adj[row];
    if ((int)lists.size() < lc + 1) lists.resize(lc + 1);
    lists[lc].assign(ids, ids + n);
    c->mark_dirty(row);
}

void hnsw_insert(void* h, int row, int lvl, const void* q, int ep,
                 int l_max) {
    static_cast<Core*>(h)->insert(row, lvl, q, ep, l_max);
}

void hnsw_delete(void* h, int row) {
    static_cast<Core*>(h)->delete_repair(row);
}

void hnsw_delete_batch(void* h, const int32_t* rows, int n) {
    static_cast<Core*>(h)->delete_batch(rows, n);
}

// sequential search (core.rs:865-892); returns result count, descending
// (-sim, row) order like models/hnsw.py::search_knn
int hnsw_search(void* h, const void* q, int k, int ef, int ep, int l_max,
                int32_t* out_ids, float* out_sims) {
    auto* c = static_cast<Core*>(h);
    std::vector<std::pair<float, int32_t>> w;
    int32_t cur = ep;
    for (int lc = l_max; lc >= 1; --lc) {
        c->search_level(q, cur, 1, lc, w);
        cur = Core::best_of(w);
    }
    c->search_level(q, cur, ef, 0, w);
    std::sort(w.begin(), w.end(), [](const auto& a, const auto& b) {
        if (a.first != b.first) return a.first > b.first;
        return a.second < b.second;
    });
    int n = std::min((int)w.size(), k);
    for (int i = 0; i < n; ++i) {
        out_ids[i] = w[i].second;
        out_sims[i] = w[i].first;
    }
    return n;
}

void hnsw_apply_wave(void* h, const int32_t* rows, const int32_t* levels,
                     int W, const int32_t* up_ids, const float* up_sims,
                     int n_up, const int32_t* l0_ids, const float* l0_sims,
                     int ef, const float* cross, int l_max_snap) {
    static_cast<Core*>(h)->apply_wave(rows, levels, W, up_ids, up_sims,
                                      n_up, l0_ids, l0_sims, ef, cross,
                                      l_max_snap);
}

// snapshot export: max degree at a layer over rows [0, n)
int hnsw_max_degree(void* h, int lc, int n) {
    auto* c = static_cast<Core*>(h);
    int mx = 0;
    int lim = std::min<long>(n, c->adj.size());
    for (int r = 0; r < lim; ++r) {
        if (c->level[r] < 0) continue;
        auto* nl = c->nbrs(r, lc);
        if (nl) mx = std::max(mx, (int)nl->size());
    }
    return mx;
}

// fill a dense [n, deg] table (-1 padded) with layer lc adjacency for rows
// sel[0..n) (sel==nullptr: rows 0..n)
void hnsw_export_layer(void* h, int lc, const int32_t* sel, int n, int deg,
                       int32_t* out) {
    auto* c = static_cast<Core*>(h);
    for (int i = 0; i < n; ++i) {
        int32_t r = sel ? sel[i] : i;
        int32_t* dst = out + (long)i * deg;
        int filled = 0;
        if (r < (long)c->adj.size() && c->level[r] >= 0) {
            auto* nl = c->nbrs(r, lc);
            if (nl) {
                filled = std::min((int)nl->size(), deg);
                std::memcpy(dst, nl->data(), filled * sizeof(int32_t));
            }
        }
        for (int j = filled; j < deg; ++j) dst[j] = -1;
    }
}

// checkpoint export: total link count over rows [0, n)
long hnsw_total_links(void* h, int n) {
    auto* c = static_cast<Core*>(h);
    long total = 0;
    int lim = std::min<long>(n, c->adj.size());
    for (int r = 0; r < lim; ++r)
        for (auto& l : c->adj[r]) total += (long)l.size();
    return total;
}

// checkpoint export: per-(row, layer) counts into [n, n_layers] plus the
// concatenated ids into flat (sized by hnsw_total_links)
void hnsw_export_all(void* h, int n, int n_layers, int32_t* counts,
                     int32_t* flat) {
    auto* c = static_cast<Core*>(h);
    long pos = 0;
    int lim = std::min<long>(n, c->adj.size());
    for (int r = 0; r < lim; ++r) {
        for (int lc = 0; lc < n_layers; ++lc) {
            auto* nl = r < lim ? c->nbrs(r, lc) : nullptr;
            int cnt = (nl && c->level[r] >= 0) ? (int)nl->size() : 0;
            counts[(long)r * n_layers + lc] = cnt;
            if (cnt) {
                std::memcpy(flat + pos, nl->data(), cnt * sizeof(int32_t));
                pos += cnt;
            }
        }
    }
}

long hnsw_dirty_count(void* h) {
    return (long)static_cast<Core*>(h)->dirty.size();
}

// export-and-clear the dirty row set (for incremental snapshot deltas)
void hnsw_drain_dirty(void* h, int32_t* out) {
    auto* c = static_cast<Core*>(h);
    std::memcpy(out, c->dirty.data(), c->dirty.size() * sizeof(int32_t));
    for (int32_t r : c->dirty) c->dirty_flag[r] = 0;
    c->dirty.clear();
}

}  // extern "C"
