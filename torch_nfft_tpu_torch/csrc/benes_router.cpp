// Benes-network routing (the classic looping algorithm), C ABI for ctypes.
//
// Routes an arbitrary permutation of n = 2^q elements through the 2q-1
// stage Benes network (stage distances q-1..0..q-1). The swap decision of
// stage t's pair p is bit (p & 31) of out_bits[t*(n/64) + (p >> 5)] —
// per-PAIR bit packing, the minimal shippable representation (~n/2 bits
// per stage), expanded to per-element masks on the device (a reshape +
// broadcast; see torch_nfft_tpu/ops/pallas/benes.py:expand_pair_bits).
//
// The looping algorithm 2-colors the constraint cycles of each
// sub-permutation: an element and its input partner (i ^ h) must use
// different half-size subnetworks, as must the two elements sharing an
// output pair. Cycle-chasing is a chain of dependent cache misses
// (i = inv[P[i^h] ^ h] is two serial DRAM loads per step), so the single
// threaded version is memory-LATENCY-bound, not bandwidth-bound. Large
// levels therefore run K speculative chase chains interleaved in one
// thread: the out-of-order core keeps K independent miss chains in
// flight (memory-level parallelism). The 2-coloring of a constraint
// cycle is unique up to one global flip, so chains may color disjoint
// arcs of the same cycle independently; each chain tags its arc with
// (chain_id, color), and a reconciliation pass afterwards walks every
// OUTPUT pair (o, o^h) and records the required relative flip between
// the owning chains in a parity union-find. (Input pairs are tagged
// atomically by one chain, so they are consistent by construction; and
// reconciling at the pass — rather than only at walk collisions — is
// load-bearing: an interrupted chain's seed has a backward output edge
// no walk ever crosses when its neighbour was tagged in partner phase.)
// A final resolution pass applies the per-chain flips. Measured 2.3x on
// the 1-core plan hosts at n = 2^24..2^25 over the sequential chase
// (11.5 s vs 26.6 s at 2^24). Levels whose working set is
// cache-resident keep the plain serial chase. Subproblems are
// independent, so levels with many subproblems additionally split
// across threads on multi-core hosts. O(n log n) total work.
// NOTE: fusing the inverse-build and bit-emission into the chase was
// tried and measured 2.5x SLOWER at 2^25 — the extra random store
// streams contend with the latency-bound chain; keep the passes
// separate.
//
// This mirrors the role of the reference's CUDA atomics (its "router" is
// hardware, csrc/cuda/cuda_utils.cu:45-84); here the route is computed
// once per plan and applied at memory speed on the TPU.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------
// Parity union-find over chain ids: find() returns the root and the
// cumulative flip parity along the path; unite(a, b, rel) records
// flip[a] ^ flip[b] = rel. Chain counts are tiny (#cycles + #collisions
// per level), so no path compression is needed.
struct ParityUF {
  std::vector<int32_t> parent;
  std::vector<uint8_t> parw;  // parity of x relative to parent[x]

  int32_t add() {
    const int32_t id = (int32_t)parent.size();
    parent.push_back(id);
    parw.push_back(0);
    return id;
  }
  int32_t find(int32_t x, uint8_t& p) const {
    p = 0;
    while (parent[x] != x) {
      p ^= parw[x];
      x = parent[x];
    }
    return x;
  }
  void unite(int32_t a, int32_t b, uint8_t rel) {
    uint8_t pa, pb;
    const int32_t ra = find(a, pa), rb = find(b, pb);
    if (ra == rb) return;  // cycle closure; consistent by construction
    parent[ra] = rb;
    parw[ra] = (uint8_t)(pa ^ pb ^ rel);
  }
};

// Build the (block-local) inverse of P over global range [glo, ghi):
// inv[base + P[g]] = g - base for each subproblem block of size m.
void build_inv_range(const int32_t* P, int32_t* inv, int64_t glo, int64_t ghi,
                     int64_t m) {
  const int64_t bmask = ~(m - 1);
  for (int64_t g = glo; g < ghi; ++g) {
    const int64_t base = g & bmask;
    inv[base + (int64_t)P[g]] = (int32_t)(g - base);
  }
}

// Classic sequential chase over whole subproblems in [glo, ghi), writing
// colors into subnet (int8, -1 = uncolored). Used for cache-resident
// levels where dependent loads hit L2 anyway.
void chase_serial_range(const int32_t* P, const int32_t* inv, int8_t* subnet,
                        int64_t glo, int64_t ghi, int64_t m) {
  const int64_t h = m >> 1;
  for (int64_t base = glo; base < ghi; base += m) {
    for (int64_t seed = 0; seed < m; ++seed) {
      if (subnet[base + seed] >= 0) continue;
      int64_t i = seed;
      while (subnet[base + i] < 0) {
        subnet[base + i] = 0;
        subnet[base + (i ^ h)] = 1;
        i = (int64_t)inv[base + (int64_t)(P[base + (i ^ h)] ^ h)];
      }
    }
  }
}

// Speculative K-chain interleaved chase over whole subproblems in
// [glo, ghi), writing (chain_id << 1 | color) into tag (-1 = uncolored),
// then reconciling chain flips across all output pairs and resolving
// per-chain flips into subnet.
void chase_mlp_range(const int32_t* P, const int32_t* inv, int32_t* tag,
                     int8_t* subnet, int64_t glo, int64_t ghi, int64_t m,
                     int chains) {
  const int64_t h = m >> 1;
  const int64_t bmask = ~(m - 1);
  ParityUF uf;
  std::vector<int64_t> gi((size_t)chains);
  std::vector<int32_t> cid((size_t)chains);
  std::vector<uint8_t> active((size_t)chains, 0);
  int64_t cursor = glo;
  int live = 0;

  auto acquire = [&](int k) -> bool {
    while (cursor < ghi && tag[cursor] >= 0) ++cursor;
    if (cursor >= ghi) return false;
    gi[(size_t)k] = cursor++;  // advance so chains seed distinct cycles
    cid[(size_t)k] = uf.add();
    return true;
  };
  for (int k = 0; k < chains; ++k) {
    active[(size_t)k] = acquire(k) ? 1 : 0;
    live += active[(size_t)k];
  }

  while (live > 0) {
    for (int k = 0; k < chains; ++k) {
      if (!active[(size_t)k]) continue;
      const int64_t g = gi[(size_t)k];
      if (tag[g] >= 0) {
        // ran into a colored arc (another chain's, or our own closed
        // cycle); the relative flip is recovered by the reconciliation
        // pass below, so just move to a fresh seed
        if (!acquire(k)) {
          active[(size_t)k] = 0;
          --live;
        }
      } else {
        const int32_t id2 = cid[(size_t)k] << 1;
        tag[g] = id2;
        const int64_t gp = g ^ h;
        tag[gp] = id2 | 1;
        const int64_t base = g & bmask;
        const int64_t gn = base + (int64_t)inv[base + (int64_t)(P[gp] ^ h)];
        gi[(size_t)k] = gn;
        __builtin_prefetch(&tag[gn]);
        __builtin_prefetch(&P[gn ^ h]);
      }
    }
  }

  // Reconciliation: every output pair (o, o^h) of every subproblem must
  // route through different halves, i.e. the final colors of a = inv[o]
  // and b = inv[o^h] must differ:
  //   (bit_a ^ flip[chain_a]) ^ (bit_b ^ flip[chain_b]) = 1.
  // Input pairs need no pass: one chain tags both sides atomically.
  for (int64_t base = glo; base < ghi; base += m) {
    for (int64_t o = 0; o < h; ++o) {
      const int32_t ta = tag[base + (int64_t)inv[base + o]];
      const int32_t tb = tag[base + (int64_t)inv[base + o + h]];
      if ((ta >> 1) != (tb >> 1))
        uf.unite(ta >> 1, tb >> 1, (uint8_t)((ta ^ tb ^ 1) & 1));
    }
  }

  std::vector<uint8_t> flip(uf.parent.size());
  for (size_t x = 0; x < flip.size(); ++x) {
    uint8_t p;
    uf.find((int32_t)x, p);
    flip[x] = p;
  }
  for (int64_t g = glo; g < ghi; ++g) {
    const int32_t t = tag[g];
    subnet[g] = (int8_t)((t & 1) ^ flip[(size_t)(t >> 1)]);
  }
}

// Emit the pair bits of stages t_in/t_out and build the next-level
// sub-permutations, for whole subproblems in [glo, ghi).
void emit_and_next_range(const int32_t* P, const int32_t* inv,
                         const int8_t* subnet, int32_t* Pn, int64_t glo,
                         int64_t ghi, int64_t m, int d,
                         int64_t words_per_stage, int t_in, int t_out,
                         uint32_t* out_bits) {
  const int64_t h = m >> 1;
  const int64_t hm = h - 1;
  uint32_t* win = out_bits + (int64_t)t_in * words_per_stage;
  uint32_t* wout = out_bits + (int64_t)t_out * words_per_stage;
  for (int64_t base = glo; base < ghi; base += m) {
    // first pair id of this subproblem at stage distance d: pairs are
    // (base+j, base+j+h); base is a multiple of m = 2^(d+1)
    const int64_t pbase = (base >> (d + 1)) << d;
    for (int64_t j = 0; j < h; ++j) {
      if (subnet[base + j] == 1) {
        const int64_t p = pbase + j;
        win[p >> 5] |= (1u << (p & 31));
      }
    }
    for (int64_t o = 0; o < h; ++o) {
      if (subnet[base + (int64_t)inv[base + o]] == 1) {
        const int64_t p = pbase + o;
        wout[p >> 5] |= (1u << (p & 31));
      }
    }
    int32_t* U = Pn + base;
    int32_t* L = Pn + base + h;
    for (int64_t i = 0; i < m; ++i) {
      const int32_t tgt = (int32_t)(P[base + i] & hm);
      if (subnet[base + i] == 0)
        U[i & hm] = tgt;
      else
        L[i & hm] = tgt;
    }
  }
}

int64_t env_int(const char* name, int64_t dflt) {
  const char* v = std::getenv(name);
  if (!v || !*v) return dflt;
  return std::strtoll(v, nullptr, 10);
}

}  // namespace

extern "C" {

// perm: (n,) int32 permutation of [0, n); n = 2^q.
// out_bits: (2q-1) * (n/64) uint32, ZEROED by the caller.
// n_threads: worker threads for levels with many subproblems (<=1: serial).
// Returns 0 on success, -1 on invalid input.
int32_t nfft_benes_route(const int32_t* perm, int64_t n, uint32_t* out_bits,
                         int32_t n_threads) {
  if (n < 2) return -1;
  int q = 0;
  while ((1LL << q) < n) ++q;
  if ((1LL << q) != n) return -1;
  const int64_t words_per_stage = n >> 6;
  if (n_threads < 1) n_threads = 1;

  // Subproblems at least this large chase with K interleaved chains;
  // smaller ones are cache-resident and chase serially.
  const int64_t mlp_min = env_int("NFFT_BENES_MLP_MIN", 1LL << 16);
  const int chains = (int)env_int("NFFT_BENES_CHAINS", 32);

  std::vector<int32_t> pi(perm, perm + n), pnext(n), inv(n);
  std::vector<int8_t> subnet(n);
  std::vector<int32_t> tag;  // allocated lazily, only if an MLP level runs

  for (int l = 0;; ++l) {
    const int64_t m = n >> l;
    if (m == 2) {
      const int t = l;  // == q - 1, the middle stage (distance 1 pair)
      uint32_t* w = out_bits + (int64_t)t * words_per_stage;
      for (int64_t base = 0; base < n; base += 2) {
        if (pi[base] == 1) {
          const int64_t p = base >> 1;
          w[p >> 5] |= (1u << (p & 31));
        }
      }
      break;
    }
    const int d = q - 1 - l;
    const int t_in = l, t_out = 2 * q - 2 - l;
    const int64_t n_sub = n / m;
    const bool use_mlp = m >= mlp_min && chains > 1;
    // pair-bit words of distinct subproblems collide when h < 32; those
    // levels (and low-parallelism ones) run serial
    const bool can_thread =
        n_threads > 1 && n_sub >= 2 * n_threads && ((m >> 1) % 32 == 0);

    auto run_range = [&](int64_t glo, int64_t ghi) {
      build_inv_range(pi.data(), inv.data(), glo, ghi, m);
      if (use_mlp) {
        std::memset(tag.data() + glo, -1, (size_t)(ghi - glo) * 4);
        chase_mlp_range(pi.data(), inv.data(), tag.data(), subnet.data(),
                        glo, ghi, m, chains);
      } else {
        std::memset(subnet.data() + glo, -1, (size_t)(ghi - glo));
        chase_serial_range(pi.data(), inv.data(), subnet.data(), glo, ghi, m);
      }
      emit_and_next_range(pi.data(), inv.data(), subnet.data(), pnext.data(),
                          glo, ghi, m, d, words_per_stage, t_in, t_out,
                          out_bits);
    };

    if (use_mlp && tag.empty()) tag.resize((size_t)n);
    if (!can_thread) {
      run_range(0, n);
    } else {
      std::vector<std::thread> ts;
      const int64_t per = (n_sub + n_threads - 1) / n_threads;
      for (int64_t w = 0; w < n_threads; ++w) {
        const int64_t lo = w * per, hi = std::min(n_sub, lo + per);
        if (lo >= hi) break;
        ts.emplace_back([&, lo, hi]() { run_range(lo * m, hi * m); });
      }
      for (auto& t : ts) t.join();
    }
    std::swap(pi, pnext);
  }
  return 0;
}

}  // extern "C"
