// Native signal-core runtime: the reactive state machine in C++.
//
// Implements the same semantics as cortex_tpu/core/signal.py (which mirrors
// the reference src/signal.jl): bit-packed per-dependency
// flags (4 bits per dep: intermediate 0x1, weak 0x2, computed 0x4, fresh
// 0x8), lazy pending resolution with a SWAR chunk check, listener
// notification, and dependency traversal.
//
// Signal *values* stay in Python (arbitrary objects); this engine owns only
// the graph + state machine, which is where the dynamic path spends its time
// (notify fan-out, pending checks).  One improvement over the reference's
// notify: the dependency-slot of each (dependency -> listener) edge is
// precomputed at add_dependency time, so notification is O(listeners), not
// O(listeners x their dependency counts).  Duplicate-dependency behavior is
// preserved exactly (only the FIRST matching slot is ever notified).
//
// C ABI for ctypes; handles are dense int32 indices.

#include <cstdint>
#include <cstring>
#include <unordered_set>
#include <vector>

namespace {

constexpr uint64_t kIntermediateAll = 0x1111111111111111ULL;
constexpr uint64_t kWeakAll = 0x2222222222222222ULL;
constexpr uint64_t kComputedAll = 0x4444444444444444ULL;
constexpr uint64_t kFreshAll = 0x8888888888888888ULL;
constexpr uint64_t kPassTarget = 0x1111111111111111ULL;

constexpr uint64_t kIntermediate = 0x1;
constexpr uint64_t kWeak = 0x2;
constexpr uint64_t kComputed = 0x4;
constexpr uint64_t kFresh = 0x8;

struct ListenerEdge {
  int32_t listener;  // signal id of the listener
  int32_t slot;      // dependency slot of this edge inside the listener
  bool listen;       // whether updates set the listener potentially-pending
  bool first;        // only the first identity-matching slot is notified
};

struct SignalState {
  bool computed = false;
  bool potentially_pending = false;
  bool pending = false;
  int32_t ndeps = 0;
  std::vector<uint64_t> chunks{0};        // packed dep props
  std::vector<int32_t> deps;              // dependency signal ids
  std::vector<ListenerEdge> listeners;    // outgoing notification edges
  std::unordered_set<int32_t> listener_ids;  // O(1) duplicate-edge check
};

struct Engine {
  std::vector<SignalState> signals;
};

inline void set_bits(SignalState& s, int32_t slot, uint64_t mask) {
  s.chunks[slot >> 4] |= mask << ((slot & 15) << 2);
}

inline bool get_bits(const SignalState& s, int32_t slot, uint64_t mask) {
  return (s.chunks[slot >> 4] >> ((slot & 15) << 2)) & mask;
}

bool meets_pending_criteria(const SignalState& s) {
  const int32_t n = s.ndeps;
  if (n == 0) return false;
  const size_t nchunks = s.chunks.size();
  for (size_t i = 0; i + 1 < nchunks; ++i) {
    const uint64_t chunk = s.chunks[i];
    const uint64_t w = (chunk & kWeakAll) >> 1;
    const uint64_t c = (chunk & kComputedAll) >> 2;
    const uint64_t f = (chunk & kFreshAll) >> 3;
    if ((c & (w | f)) != kPassTarget) return false;
  }
  const int32_t off = ((n - 1) & 15) << 2;
  uint64_t last = s.chunks[(n - 1) >> 4];
  const int shift = off + 4;
  if (shift < 64) last |= ~0ULL << shift;
  const uint64_t w = (last & kWeakAll) >> 1;
  const uint64_t c = (last & kComputedAll) >> 2;
  const uint64_t f = (last & kFreshAll) >> 3;
  return (c & (w | f)) == kPassTarget;
}

}  // namespace

extern "C" {

Engine* ce_new() { return new Engine(); }

void ce_free(Engine* e) { delete e; }

int32_t ce_signal_new(Engine* e) {
  e->signals.emplace_back();
  return static_cast<int32_t>(e->signals.size() - 1);
}

int32_t ce_num_signals(Engine* e) {
  return static_cast<int32_t>(e->signals.size());
}

// Mirrors Signal.add_dependency (core/signal.py; reference
// src/signal.jl:286-337).  Self-dependency is a no-op.
void ce_add_dependency(Engine* e, int32_t sig, int32_t dep, int weak,
                       int listen, int check_computed, int intermediate) {
  if (sig == dep) return;
  SignalState& s = e->signals[sig];
  const int32_t slot = s.ndeps++;
  if ((4 * s.ndeps + 63) / 64 > static_cast<int32_t>(s.chunks.size()))
    s.chunks.push_back(0);
  if (weak) set_bits(s, slot, kWeak);
  if (intermediate) set_bits(s, slot, kIntermediate);
  s.deps.push_back(dep);

  SignalState& d = e->signals[dep];
  // Duplicate-dependency hazard parity: only the first edge between this
  // (dep, sig) pair carries notifications.  O(1) membership check.
  const bool first = d.listener_ids.insert(sig).second;
  d.listeners.push_back(ListenerEdge{sig, slot, listen != 0, first});

  if (check_computed && d.computed) {
    set_bits(s, slot, kComputed);
    if (!s.computed) set_bits(s, slot, kFresh);
    s.potentially_pending = true;
    s.pending = false;
  } else if (check_computed && !d.computed) {
    s.potentially_pending = false;
    s.pending = false;
  }
}

// Mirrors Signal.set_value's state transitions + notify_listener
// (reference src/signal.jl:232-253,339-356).
void ce_set_value(Engine* e, int32_t sig) {
  SignalState& s = e->signals[sig];
  s.computed = true;
  for (uint64_t& chunk : s.chunks) chunk &= ~kFreshAll;
  s.potentially_pending = false;
  s.pending = false;
  for (const ListenerEdge& le : s.listeners) {
    if (!le.first) continue;  // duplicate edges never notified
    SignalState& l = e->signals[le.listener];
    if (le.listen) {
      l.potentially_pending = true;
      l.pending = false;
    }
    set_bits(l, le.slot, kComputed | kFresh);
  }
}

int ce_is_computed(Engine* e, int32_t sig) {
  return e->signals[sig].computed ? 1 : 0;
}

// Lazy pending resolution (reference src/signal.jl:141-154).
int ce_is_pending(Engine* e, int32_t sig) {
  SignalState& s = e->signals[sig];
  if (s.pending) return 1;
  if (s.potentially_pending) {
    const bool now = meets_pending_criteria(s);
    s.potentially_pending = false;
    s.pending = now;
    return now ? 1 : 0;
  }
  return 0;
}

// request_inference_for marks dependencies potentially-pending
// (reference src/inference_engine.jl:305-318).
void ce_set_potentially_pending(Engine* e, int32_t sig) {
  SignalState& s = e->signals[sig];
  s.potentially_pending = true;
  s.pending = false;
}

int32_t ce_num_dependencies(Engine* e, int32_t sig) {
  return e->signals[sig].ndeps;
}

int32_t ce_get_dependency(Engine* e, int32_t sig, int32_t i) {
  return e->signals[sig].deps[i];
}

int32_t ce_num_listeners(Engine* e, int32_t sig) {
  return static_cast<int32_t>(e->signals[sig].listeners.size());
}

int32_t ce_get_listener(Engine* e, int32_t sig, int32_t i) {
  return e->signals[sig].listeners[i].listener;
}

int ce_is_dep_intermediate(Engine* e, int32_t sig, int32_t i) {
  return get_bits(e->signals[sig], i, kIntermediate) ? 1 : 0;
}

int ce_is_dep_weak(Engine* e, int32_t sig, int32_t i) {
  return get_bits(e->signals[sig], i, kWeak) ? 1 : 0;
}

int ce_is_dep_fresh(Engine* e, int32_t sig, int32_t i) {
  return get_bits(e->signals[sig], i, kFresh) ? 1 : 0;
}

int ce_is_dep_computed(Engine* e, int32_t sig, int32_t i) {
  return get_bits(e->signals[sig], i, kComputed) ? 1 : 0;
}

// Scanner fast path: walk the dependency tree of `root` exactly like
// process_dependencies(collect-pending, retry=true) with a callback that
// "processes" pending signals by collecting them WITHOUT computing
// (reference src/inference_engine.jl:528-546).  Returns count written.
static int32_t scan_rec(Engine* e, int32_t sig, int32_t* out, int32_t cap,
                        int32_t n) {
  SignalState& s = e->signals[sig];
  for (int32_t i = 0; i < s.ndeps; ++i) {
    const int32_t dep = s.deps[i];
    if (ce_is_pending(e, dep)) {
      if (n < cap) out[n] = dep;
      ++n;
    } else if (get_bits(s, i, kIntermediate)) {
      n = scan_rec(e, dep, out, cap, n);
    }
  }
  return n;
}

int32_t ce_scan_pending(Engine* e, int32_t root, int32_t* out, int32_t cap) {
  return scan_rec(e, root, out, cap, 0);
}

}  // extern "C"

extern "C" {

// Bulk edge insertion: add `n` dependencies (shared flags) to `sig` in one
// call — amortizes the FFI cost of graph construction.
void ce_add_dependencies_bulk(Engine* e, int32_t sig, const int32_t* deps,
                              int32_t n, int weak, int listen,
                              int check_computed, int intermediate) {
  for (int32_t i = 0; i < n; ++i) {
    ce_add_dependency(e, sig, deps[i], weak, listen, check_computed,
                      intermediate);
  }
}

}  // extern "C"
