// Hash grouped-aggregation table build for Hopper (sm_90a).
//
// Replaces the Pallas kernel daft_tpu/device/pallas_kernels.py:
// _agg_build_call (driven by hash_grouped_agg_impl). It computes the same
// table: each live row's packed key (1 or 2 u64 words, the layout of
// kernels._packed_chunks) hashes by splitmix64 to a slot of a power-of-two
// open-addressing table with linear probing, and each slot accumulates the
// count / sum / sumsq / min / max / first planes of agg_state_specs plus the
// group's first row. The claim count is the overflow contract: a row that
// finds the table full is dropped, the count then reads T > out_cap, and the
// caller re-dispatches at a larger bucket. A full table's planes may be
// partial: only its count is part of the contract.
//
// What bounds it on this card. The bytes are small (the live mask, each
// live row's key words and the value and contrib planes it reads, the
// T-slot planes written once): 1 to 37 MB at the main path's rungs, 0.3
// to 11 us at 3.35 TB/s. What costs is the table's atomics, which the TPU
// kernel never needed (its grid runs in order with one writer): one row
// updating P planes in a global table is P atomics on P cache lines, and
// rows of one group serialise on one address. And the fixed cost of a call
// (launches, fills, conversions) is of the same order as the work at the
// small rungs.
//
// Design, one answer per cost:
// - Two launches into one workspace. The wrapper allocates every plane as
//   one uint8 workspace (layout: hash_kernels.table_layout) and hands a
//   host descriptor; hash_agg_init_kernel writes every plane's identity
//   (fills[] of the descriptor), then hash_agg_build_kernel builds. The
//   build writes what the post-pass reads: `occ` as bytes, `frow` and
//   `first` as int64 rows, each plane in its spec's dtype (narrow ints by a
//   CAS on their 32-bit word), the claim count as an int64 cell.
// - Typed plane groups. The descriptor lists the planes sorted by combo
//   (kind, value type, plane type; `Combos` below, hash_kernels._COMBOS in
//   Python), and the kernel walks each combo's range with its types fixed
//   at compile time: no run-time switch per plane, and the descriptor is a
//   __grid_constant__ parameter, read in place and never copied.
// - Warp aggregation. Lanes whose rows carry the same key find each other
//   with __match_any_sync; only the lowest lane probes the table, and the
//   group combines its counts (popc of a ballot), earliest rows (the lowest
//   contributing lane: rows ascend with the lane), and sums, sumsq, min and
//   max (a tree of shuffles over the group's ranks) before one atomic per
//   plane. A warp without duplicate keys pays one match and one ballot.
// - Block-local pre-aggregation. When T slots of the record (key words,
//   first row, claim state, the planes) fit half an SM's shared memory (two
//   blocks to an SM: one block of 16 warps hides too little latency) and
//   the rows are many per slot (hash_kernels.uses_shared_table),
//   each block keeps its own table in shared memory, aggregates a
//   contiguous range of rows there with block-scope claims, and flushes
//   each occupied slot to the global table once: one find-or-claim, one
//   atomic per plane. A key that finds no slot within kLocalProbe
//   (triangular) steps goes to the global table directly, so a nearly
//   full block table costs a bounded probe. A block whose table fills
//   holds T distinct keys, so the global table will fill: it stops, and
//   the first such block (a flag in the workspace) flushes its T keys,
//   which fills the global table; the others drop their planes, as a full
//   table may.
// - Latency. Each plane's value load does not wait for its contrib load,
//   so the two are in flight together.
// - A cheaper probe. A slot is claimed by CAS of its state from 0 to 1; the
//   claimer writes the key word(s) and publishes state 2 with a release
//   store; probers read the state with acquire loads (device scope for the
//   global table, block scope for a block's own), never a fence per step,
//   and one that finds 1 spins until 2, so 2-word keys are never seen
//   half-written. (Relaxed loads are not enough: a prober then reads stale
//   key words and claims a second slot for one key.) The grid is
//   persistent (SMs x resident blocks, from the occupancy of this launch),
//   each block walking a contiguous range in tiles; in the global path
//   each warp reads the claim count once per tile and leaves as soon as it
//   reaches T, and a row probing a full table gives up after at most 8
//   more steps.
//
// Integer sums wrap in u64 like the reference's i64; float min/max follow
// the reference (NaN propagates, -0.0 < +0.0) through CAS loops on an order
// key; float sums change order (warp trees, shared then global atomics),
// inside the tolerance the checks state.

#include <cstdint>
#include <mutex>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;
typedef unsigned char u8;
typedef signed char i8;

constexpr int kMaxPlanes = 48;
constexpr int kMaxFills = kMaxPlanes + 8;
constexpr int kThreads = 512;
// probe steps in a block's table before a key goes to the global table
constexpr int kLocalProbe = 32;
constexpr unsigned kFull = 0xFFFFFFFFu;

enum Kind { K_CNT, K_FIRST, K_SUM, K_SUMSQ, K_MIN, K_MAX };

template <int K, typename V, typename P>
struct Op {
  static constexpr int kind = K;
  typedef V Val;
  typedef P Plane;
};

template <typename... Os>
struct List {};

// The combo ids of hash_kernels._COMBOS, in order. Bool values load as
// u8; min/max of bool keep an int8 plane.
typedef List<
    Op<K_CNT, u8, int>, Op<K_FIRST, u8, long long>,
    Op<K_SUM, u8, long long>, Op<K_SUM, i8, long long>,
    Op<K_SUM, short, long long>, Op<K_SUM, int, long long>,
    Op<K_SUM, long long, long long>, Op<K_SUM, float, float>,
    Op<K_SUM, double, double>,
    Op<K_SUMSQ, u8, double>, Op<K_SUMSQ, i8, double>,
    Op<K_SUMSQ, short, double>, Op<K_SUMSQ, int, double>,
    Op<K_SUMSQ, long long, double>, Op<K_SUMSQ, float, float>,
    Op<K_SUMSQ, double, double>,
    Op<K_MIN, u8, i8>, Op<K_MIN, u8, u8>, Op<K_MIN, i8, i8>,
    Op<K_MIN, short, short>, Op<K_MIN, int, int>,
    Op<K_MIN, long long, long long>, Op<K_MIN, float, float>,
    Op<K_MIN, double, double>,
    Op<K_MAX, u8, i8>, Op<K_MAX, u8, u8>, Op<K_MAX, i8, i8>,
    Op<K_MAX, short, short>, Op<K_MAX, int, int>,
    Op<K_MAX, long long, long long>, Op<K_MAX, float, float>,
    Op<K_MAX, double, double>>
    Combos;
constexpr int kCombos = 32;
template <class L>
struct Length;
template <class... Os>
struct Length<List<Os...>> {
  static constexpr int n = sizeof...(Os);
};
static_assert(Length<Combos>::n == kCombos, "kCombos must count Combos");

struct PlaneDesc {
  const void* val;
  const u8* contrib;
  long long off;
};

struct FillDesc {
  long long off;
  long long n;
  u64 bits;
  int size;
  int pad;
};

struct Desc {
  const long long* w0;
  const long long* w1;
  const u8* live;
  char* ws;
  long long C;
  long long chunk;  // rows per block, a multiple of kThreads
  long long off_tk0, off_tk1, off_frow, off_state, off_occ, off_count;
  long long local_bytes;
  int T;
  int n_fills;
  int start[kCombos + 1];
  PlaneDesc planes[kMaxPlanes];
  FillDesc fills[kMaxFills];
};

// ------------------------------------------------------------ primitives

// acquire / release of a claim state: device scope for the global table,
// block scope for a block's table in shared memory
template <bool GPU>
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  if (GPU)
    asm volatile("ld.acquire.gpu.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  else
    asm volatile("ld.acquire.cta.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

template <bool GPU>
__device__ __forceinline__ void st_release(int* p, int v) {
  if (GPU)
    asm volatile("st.release.gpu.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
  else
    asm volatile("st.release.cta.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

template <int NW>
__device__ __forceinline__ unsigned slot_of(u64 w0, u64 w1, unsigned tmask) {
  const u64 M1 = 0x9E3779B97F4A7C15ull;
  const u64 M2 = 0xBF58476D1CE4E5B9ull;
  const u64 M3 = 0x94D049BB133111EBull;
  u64 x = NW == 2 ? (w0 ^ (w1 * M1)) : w0;
  x = x + M1;
  x = (x ^ (x >> 30)) * M2;
  x = (x ^ (x >> 27)) * M3;
  x = x ^ (x >> 31);
  return static_cast<unsigned>(x) & tmask;
}

template <typename P>
struct Lim;
template <>
struct Lim<i8> {
  __device__ static i8 lo() { return -128; }
  __device__ static i8 hi() { return 127; }
};
template <>
struct Lim<u8> {
  __device__ static u8 lo() { return 0; }
  __device__ static u8 hi() { return 255; }
};
template <>
struct Lim<short> {
  __device__ static short lo() { return -32768; }
  __device__ static short hi() { return 32767; }
};
template <>
struct Lim<int> {
  __device__ static int lo() { return -2147483647 - 1; }
  __device__ static int hi() { return 2147483647; }
};
template <>
struct Lim<long long> {
  __device__ static long long lo() { return -9223372036854775807ll - 1; }
  __device__ static long long hi() { return 9223372036854775807ll; }
};
template <>
struct Lim<float> {
  __device__ static float lo() { return __uint_as_float(0xff800000u); }
  __device__ static float hi() { return __uint_as_float(0x7f800000u); }
};
template <>
struct Lim<double> {
  __device__ static double lo() {
    return __longlong_as_double(static_cast<long long>(0xfff0000000000000ull));
  }
  __device__ static double hi() {
    return __longlong_as_double(0x7ff0000000000000ll);
  }
};

// float total order for min/max: -0.0 < +0.0; NaN handled by the callers
__device__ __forceinline__ long long order_key(double x) {
  long long b = __double_as_longlong(x);
  return b < 0 ? (b ^ 0x7FFFFFFFFFFFFFFFll) : b;
}
__device__ __forceinline__ int order_key(float x) {
  int b = __float_as_int(x);
  return b < 0 ? (b ^ 0x7FFFFFFF) : b;
}

// does v replace cur? (NaN is absorbing: once a NaN is in, it stays)
template <typename F>
__device__ __forceinline__ bool replaces(F cur, F v, bool is_min) {
  if (cur != cur) return false;
  if (v != v) return true;
  return is_min ? order_key(v) < order_key(cur) : order_key(v) > order_key(cur);
}

__device__ __forceinline__ u64 to_bits(double x) {
  return static_cast<u64>(__double_as_longlong(x));
}
__device__ __forceinline__ unsigned to_bits(float x) {
  return __float_as_uint(x);
}
template <typename F>
__device__ __forceinline__ F from_bits(u64 b);
template <>
__device__ __forceinline__ double from_bits<double>(u64 b) {
  return __longlong_as_double(static_cast<long long>(b));
}
template <>
__device__ __forceinline__ float from_bits<float>(u64 b) {
  return __uint_as_float(static_cast<unsigned>(b));
}

template <typename F>
__device__ __forceinline__ bool same_bits(F a, F b) {
  return to_bits(a) == to_bits(b);
}

__device__ __forceinline__ void min_row(long long* p, long long row) {
  if (row < *reinterpret_cast<volatile long long*>(p)) atomicMin(p, row);
}

// The per-combo arithmetic. W is the type a warp reduces in (narrow ints
// widen to int, integer sums wrap in u64).
template <class O>
struct Arith {
  typedef typename O::Plane P;
  static constexpr int K = O::kind;
  static constexpr bool is_float = std::is_floating_point<P>::value;
  typedef typename std::conditional<
      K == K_SUM && !is_float, u64,
      typename std::conditional<(sizeof(P) < 4), int, P>::type>::type W;

  __device__ static W identity() {
    if constexpr (K == K_MIN) return static_cast<W>(Lim<P>::hi());
    else if constexpr (K == K_MAX) return static_cast<W>(Lim<P>::lo());
    else return static_cast<W>(0);
  }

  __device__ static W value(const void* val, long long r) {
    const typename O::Val v = static_cast<const typename O::Val*>(val)[r];
    if constexpr (K == K_SUMSQ) {
      const P x = static_cast<P>(v);
      if constexpr (sizeof(P) == 8) return __dmul_rn(x, x);
      else return __fmul_rn(x, x);
    } else if constexpr (K == K_SUM && !is_float) {
      return static_cast<u64>(static_cast<long long>(v));
    } else {
      return static_cast<W>(static_cast<P>(v));
    }
  }

  __device__ static W combine(W a, W b) {
    if constexpr (K == K_SUM || K == K_SUMSQ) {
      return a + b;
    } else if constexpr (is_float) {
      return replaces(a, b, K == K_MIN) ? b : a;
    } else if constexpr (K == K_MIN) {
      return b < a ? b : a;
    } else {
      return b > a ? b : a;
    }
  }

  // one atomic update of plane element p by x
  __device__ static void apply(P* p, W x) {
    if constexpr (K == K_SUM || K == K_SUMSQ) {
      if constexpr (is_float) atomicAdd(p, x);
      else atomicAdd(reinterpret_cast<u64*>(p), x);
    } else if constexpr (is_float) {
      typedef typename std::conditional<sizeof(P) == 8, u64, unsigned>::type U;
      U* a = reinterpret_cast<U*>(p);
      U old = *reinterpret_cast<volatile U*>(a);
      while (replaces(from_bits<P>(old), x, K == K_MIN)) {
        const U prev = atomicCAS(a, old, to_bits(x));
        if (prev == old) return;
        old = prev;
      }
    } else if constexpr (sizeof(P) >= 4) {
      const P cur = *reinterpret_cast<volatile P*>(p);
      if (K == K_MIN ? x < cur : x > cur) {
        if constexpr (K == K_MIN) atomicMin(p, x);
        else atomicMax(p, x);
      }
    } else {  // 1- or 2-byte ints: CAS on the aligned 32-bit word
      const size_t addr = reinterpret_cast<size_t>(p);
      unsigned* w = reinterpret_cast<unsigned*>(addr & ~size_t(3));
      const int shift = static_cast<int>(addr & 3) * 8;
      const unsigned mask = ((1u << (8 * sizeof(P))) - 1u) << shift;
      unsigned old = *reinterpret_cast<volatile unsigned*>(w);
      while (true) {
        const int cur = static_cast<int>(static_cast<P>((old & mask) >> shift));
        if (K == K_MIN ? !(x < cur) : !(x > cur)) return;
        const unsigned nw =
            (old & ~mask) | ((static_cast<unsigned>(x) << shift) & mask);
        const unsigned prev = atomicCAS(w, old, nw);
        if (prev == old) return;
        old = prev;
      }
    }
  }

  // fold a local slot's element into the global one (skipped when it
  // still holds the identity)
  __device__ static void merge(const P* l, P* g, long long C) {
    const P v = *l;
    if constexpr (K == K_CNT) {
      if (v) atomicAdd(g, v);
    } else if constexpr (K == K_FIRST) {
      if (v < C) min_row(g, v);
    } else if constexpr (K == K_SUM || K == K_SUMSQ) {
      if (v != static_cast<P>(0)) {
        if constexpr (is_float) apply(g, v);
        else apply(g, static_cast<u64>(v));
      }
    } else if constexpr (is_float) {
      if (!same_bits(v, K == K_MIN ? Lim<P>::hi() : Lim<P>::lo())) apply(g, v);
    } else {
      if (v != (K == K_MIN ? Lim<P>::hi() : Lim<P>::lo()))
        apply(g, static_cast<W>(v));
    }
  }
};

// ------------------------------------------------------- the warp's group

// lane of the q-th (0-based) set bit of m
__device__ __forceinline__ int nth_set_bit(unsigned m, int q) {
  int pos = 0;
#pragma unroll
  for (int w = 16; w >= 1; w >>= 1) {
    const int c = __popc(m & ((1u << w) - 1u));
    if (q >= c) {
      q -= c;
      m >>= w;
      pos += w;
    }
  }
  return pos;
}

// The lanes whose rows share one key (and so one slot), and the partners
// of a tree reduction over the group's ranks: at level k the member of
// rank r (r a multiple of 2^(k+1)) takes the partial of rank r + 2^k.
struct Group {
  unsigned peers;  // 0 for a lane without a slot
  bool leader;
  int nmax;        // the largest group of the warp
  int src[5];
  bool take[5];
};

template <class O>
__device__ __forceinline__ typename Arith<O>::W group_reduce(
    const Group& g, typename Arith<O>::W x) {
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    if ((1 << k) >= g.nmax) break;
    const typename Arith<O>::W y = __shfl_sync(kFull, x, g.src[k]);
    if (g.take[k]) x = Arith<O>::combine(x, y);
  }
  return x;
}

// ------------------------------------------------------------- the table

// The slot of key (w0, w1) in the table at `base`, claiming a free one;
// -1 when `max_steps` probes found neither, or (global table) when the
// table is full. `claims` counts the table's claimed slots (the global
// table's count is the int64 cell of the workspace).
template <int NW, bool GLOBAL, typename Count>
__device__ __forceinline__ int find_or_claim(const Desc& d, char* base,
                                             u64 w0, u64 w1, unsigned j,
                                             int max_steps, Count* claims) {
  int* state = reinterpret_cast<int*>(base + d.off_state);
  u64* tk0 = reinterpret_cast<u64*>(base + d.off_tk0);
  u64* tk1 = reinterpret_cast<u64*>(base + d.off_tk1);
  const unsigned tmask = static_cast<unsigned>(d.T - 1);
  for (int step = 0; step < max_steps; ++step) {
    int s = ld_acquire<GLOBAL>(state + j);
    if (s == 0) {
      if (atomicCAS(state + j, 0, 1) == 0) {  // claimed: publish the key
        tk0[j] = w0;
        if (NW == 2) tk1[j] = w1;
        st_release<GLOBAL>(state + j, 2);
        if (GLOBAL) d.ws[d.off_occ + j] = 1;
        atomicAdd(claims, static_cast<Count>(1));
        return static_cast<int>(j);
      }
      s = ld_acquire<GLOBAL>(state + j);
    }
    while (s == 1) s = ld_acquire<GLOBAL>(state + j);  // being published
    if (tk0[j] == w0 && (NW == 1 || tk1[j] == w1)) return static_cast<int>(j);
    // linear probing in the global table; triangular (quadratic) steps in
    // a block's table, which the block fills to the last slot when its rows
    // hold T keys (the steps visit every slot of a power-of-two table)
    j = (j + (GLOBAL ? 1u : static_cast<unsigned>(step) + 1u)) & tmask;
    if (GLOBAL && (step & 7) == 7 &&
        *reinterpret_cast<volatile Count*>(claims) >= static_cast<Count>(d.T))
      return -1;  // filled meanwhile: dropped, the count says so
  }
  return -1;
}

// identities into [0, limit) of the layout at `base`, thread `tid` of `nth`
__device__ __forceinline__ void fill_table(const Desc& d, char* base,
                                           long long limit, long long tid,
                                           long long nth) {
  for (int f = 0; f < d.n_fills; ++f) {
    const FillDesc& fd = d.fills[f];
    if (fd.off >= limit) continue;
    char* p = base + fd.off;
    for (long long e = tid; e < fd.n; e += nth) {
      switch (fd.size) {
        case 1: reinterpret_cast<u8*>(p)[e] = static_cast<u8>(fd.bits); break;
        case 2:
          reinterpret_cast<unsigned short*>(p)[e] =
              static_cast<unsigned short>(fd.bits);
          break;
        case 4:
          reinterpret_cast<unsigned*>(p)[e] = static_cast<unsigned>(fd.bits);
          break;
        default: reinterpret_cast<u64*>(p)[e] = fd.bits; break;
      }
    }
  }
}

// ---------------------------------------------------- walks over Combos

template <class O>
__device__ __forceinline__ void apply_combo(const Desc& d, int c, char* base,
                                            int slot, long long row,
                                            long long row0, bool act,
                                            const Group& g) {
  typedef typename O::Plane P;
  typedef Arith<O> A;
  for (int i = d.start[c]; i < d.start[c + 1]; ++i) {
    const PlaneDesc& pl = d.planes[i];
    const bool con = act && pl.contrib[row];
    const unsigned cb = __ballot_sync(kFull, con) & g.peers;
    P* p = reinterpret_cast<P*>(base + pl.off) + slot;
    if constexpr (O::kind == K_CNT) {
      if (g.leader && cb) atomicAdd(p, __popc(cb));
    } else if constexpr (O::kind == K_FIRST) {
      if (g.leader && cb) min_row(p, row0 + __ffs(cb) - 1);
    } else {
      // the value loads under `act`, not under the contrib mask, so the
      // two loads are in flight together
      typename A::W x = act ? A::value(pl.val, row) : A::identity();
      if (!con) x = A::identity();
      x = group_reduce<O>(g, x);
      if (g.leader && cb) A::apply(p, x);
    }
  }
}

template <int I>
__device__ __forceinline__ void apply_all(List<>, const Desc&, char*, int,
                                          long long, long long, bool,
                                          const Group&) {}

template <int I, class O, class... Rest>
__device__ __forceinline__ void apply_all(List<O, Rest...>, const Desc& d,
                                          char* base, int slot, long long row,
                                          long long row0, bool act,
                                          const Group& g) {
  apply_combo<O>(d, I, base, slot, row, row0, act, g);
  apply_all<I + 1>(List<Rest...>(), d, base, slot, row, row0, act, g);
}

template <int I>
__device__ __forceinline__ void merge_all(List<>, const Desc&, const char*,
                                          int, int) {}

template <int I, class O, class... Rest>
__device__ __forceinline__ void merge_all(List<O, Rest...>, const Desc& d,
                                          const char* local, int lj, int gj) {
  typedef typename O::Plane P;
  for (int i = d.start[I]; i < d.start[I + 1]; ++i) {
    const long long off = d.planes[i].off;
    Arith<O>::merge(reinterpret_cast<const P*>(local + off) + lj,
                    reinterpret_cast<P*>(d.ws + off) + gj, d.C);
  }
  merge_all<I + 1>(List<Rest...>(), d, local, lj, gj);
}

// ------------------------------------------------------------ one tile

// 32 rows [row0, row0 + 32) of one warp, below `end`. In the shared path
// `block` holds the block's flags: [0] its table's claims, [1] saturated
// (the table is full, so this block's rows hold T distinct keys and the
// global table will fill), [4] some key went to the global table.
template <int NW, bool LOCAL>
__device__ __forceinline__ void warp_rows(const Desc& d, char* local,
                                          int* block, long long row0,
                                          long long end) {
  const int lane = threadIdx.x & 31;
  const long long row = row0 + lane;
  const bool valid = row < end && d.live[row];
  const unsigned vmask = __ballot_sync(kFull, valid);
  if (vmask == 0) return;
  u64 w0 = 0, w1 = 0;
  unsigned peers = 0;
  if (valid) {
    w0 = static_cast<u64>(d.w0[row]);
    peers = __match_any_sync(vmask, w0);
    if (NW == 2) {
      w1 = static_cast<u64>(d.w1[row]);
      peers &= __match_any_sync(vmask, w1);
    }
  }
  // the group's lowest lane finds (or claims) its slot for all of it: in
  // the block's table within kLocalProbe steps, else (or in the global
  // path) in the global table unless that is full
  const int leader = valid ? __ffs(peers) - 1 : lane;
  u64* count = reinterpret_cast<u64*>(d.ws + d.off_count);
  int slot = -1;
  int glob = 1;
  if (valid && leader == lane) {
    const unsigned h = slot_of<NW>(w0, w1, static_cast<unsigned>(d.T - 1));
    if (LOCAL) {
      if (*reinterpret_cast<volatile int*>(block) < d.T) {
        slot = find_or_claim<NW, false>(d, local, w0, w1, h, kLocalProbe,
                                        block);
        glob = slot < 0;
      } else {
        *reinterpret_cast<volatile int*>(block + 1) = 1;
        glob = 0;
      }
      if (glob) {
        *reinterpret_cast<volatile int*>(block + 4) = 1;
        if (*reinterpret_cast<volatile u64*>(count) >= static_cast<u64>(d.T))
          glob = 0;  // full: dropped
      }
    }
    if (glob) slot = find_or_claim<NW, true>(d, d.ws, w0, w1, h, d.T, count);
  }
  slot = __shfl_sync(kFull, slot, leader);
  if (LOCAL) glob = __shfl_sync(kFull, glob, leader);
  const bool act = valid && slot >= 0;
  Group g;
  g.peers = act ? peers : 0u;
  g.leader = act && leader == lane;
  const int rank = __popc(g.peers & ((1u << lane) - 1u));
  const int n = act ? __popc(peers) : 1;
  g.nmax = static_cast<int>(__reduce_max_sync(kFull, static_cast<unsigned>(n)));
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const int s = 1 << k;
    g.take[k] = act && (rank & (2 * s - 1)) == 0 && rank + s < n;
    g.src[k] = lane;
    if (s < g.nmax && g.take[k]) g.src[k] = nth_set_bit(peers, rank + s);
  }
  char* base = (LOCAL && !glob) ? local : d.ws;
  if (g.leader) min_row(reinterpret_cast<long long*>(base + d.off_frow) + slot, row);
  apply_all<0>(Combos(), d, base, slot, row, row0, act, g);
}

// fold the block's table into the global one, until that is full (seen
// by any thread of the block: *full)
template <int NW>
__device__ __forceinline__ void flush(const Desc& d, const char* local,
                                      int* full) {
  const int* state = reinterpret_cast<const int*>(local + d.off_state);
  const u64* tk0 = reinterpret_cast<const u64*>(local + d.off_tk0);
  const u64* tk1 = reinterpret_cast<const u64*>(local + d.off_tk1);
  const long long* frow = reinterpret_cast<const long long*>(local + d.off_frow);
  u64* count = reinterpret_cast<u64*>(d.ws + d.off_count);
  for (int j = threadIdx.x; j < d.T; j += blockDim.x) {
    if (state[j] != 2) continue;
    if (*reinterpret_cast<volatile int*>(full)) return;  // the rest drops
    const u64 w0 = tk0[j];
    const u64 w1 = NW == 2 ? tk1[j] : 0ull;
    const int g = find_or_claim<NW, true>(
        d, d.ws, w0, w1, slot_of<NW>(w0, w1, static_cast<unsigned>(d.T - 1)),
        d.T, count);
    if (g < 0) {  // table full: dropped, and so is the rest
      *reinterpret_cast<volatile int*>(full) = 1;
      return;
    }
    min_row(reinterpret_cast<long long*>(d.ws + d.off_frow) + g, frow[j]);
    merge_all<0>(Combos(), d, local, j, g);
  }
}

__global__ void __launch_bounds__(kThreads)
    hash_agg_init_kernel(const __grid_constant__ Desc d) {
  fill_table(d, d.ws, 0x7FFFFFFFFFFFFFFFll,
             static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x,
             static_cast<long long>(gridDim.x) * blockDim.x);
}

template <int NW, bool LOCAL>
__global__ void __launch_bounds__(kThreads, 1)
    hash_agg_build_kernel(const __grid_constant__ Desc d) {
  extern __shared__ __align__(16) char local[];
  // local claims, saturated, flushes, global table seen full, overflowed
  __shared__ int block[5];
  if (LOCAL) {
    fill_table(d, local, d.local_bytes, threadIdx.x, blockDim.x);
    if (threadIdx.x < 5) block[threadIdx.x] = 0;
    __syncthreads();
  }
  const u64* count = reinterpret_cast<const u64*>(d.ws + d.off_count);
  const long long begin = static_cast<long long>(blockIdx.x) * d.chunk;
  const long long end = begin + d.chunk < d.C ? begin + d.chunk : d.C;
  const int lane = threadIdx.x & 31;
  const long long wrow = (threadIdx.x >> 5) * 32;
  for (long long t = begin; t < end; t += kThreads) {
    // once per warp and tile: stop when the global table is full (an
    // L1-cached read, refreshed by the probes' acquires; in the shared path
    // only once this block has sent a key there) or the block is saturated
    int stop = 0;
    if (lane == 0) {
      const volatile int* b = block;
      stop = LOCAL ? b[1] || (b[4] && __ldca(count) >= static_cast<u64>(d.T))
                   : __ldca(count) >= static_cast<u64>(d.T);
    }
    if (__shfl_sync(kFull, stop, 0)) break;
    warp_rows<NW, LOCAL>(d, local, block, t + wrow, end);
  }
  if (LOCAL) {
    // a saturated block fills the global table only if it is the first
    // (any T distinct keys fill it); the others' planes would be dropped
    __syncthreads();
    if (threadIdx.x == 0) {
      block[2] = !block[1] ||
                 atomicCAS(reinterpret_cast<int*>(d.ws + d.off_count + 8), 0,
                           1) == 0;
      block[3] = *reinterpret_cast<const volatile u64*>(count) >=
                 static_cast<u64>(d.T);
    }
    __syncthreads();
    if (block[2]) flush<NW>(d, local, block + 3);
  }
}

template <int NW, bool LOCAL>
int launch_build(const Desc& host, cudaStream_t stream, int dev, int sms) {
  auto kernel = hash_agg_build_kernel<NW, LOCAL>;
  const size_t smem = LOCAL ? static_cast<size_t>(host.local_bytes) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  // resident blocks per SM, asked once per (device, shared bytes)
  static std::mutex mu;
  static int cached_dev = -1;
  static size_t cached_smem = 0;
  static int cached_per_sm = 0;
  int per_sm = 0;
  {
    std::lock_guard<std::mutex> lock(mu);
    if (cached_dev == dev && cached_smem == smem) {
      per_sm = cached_per_sm;
    } else {
      const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, kThreads, smem);
      if (e != cudaSuccess) return static_cast<int>(e);
      cached_dev = dev;
      cached_smem = smem;
      cached_per_sm = per_sm;
    }
  }
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  // persistent grid: every resident block, each over a contiguous range
  const long long tiles = (host.C + kThreads - 1) / kThreads;
  long long grid = static_cast<long long>(sms) * per_sm;
  if (grid > tiles) grid = tiles;
  Desc d = host;
  d.chunk = (tiles + grid - 1) / grid * kThreads;
  grid = (host.C + d.chunk - 1) / d.chunk;
  kernel<<<static_cast<unsigned>(grid), kThreads, smem, stream>>>(d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// For the current device: out[0] the SM count, out[1] the dynamic shared
// memory a block may opt in to, out[2] the shared memory of an SM, out[3]
// the shared memory the system reserves per block.
extern "C" int daft_device_info(int* out) {
  const cudaDeviceAttr attrs[4] = {
      cudaDevAttrMultiProcessorCount, cudaDevAttrMaxSharedMemoryPerBlockOptin,
      cudaDevAttrMaxSharedMemoryPerMultiprocessor,
      cudaDevAttrReservedSharedMemoryPerBlock};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  for (int i = 0; i < 4 && e == cudaSuccess; ++i)
    e = cudaDeviceGetAttribute(out + i, attrs[i], dev);
  return static_cast<int>(e);
}

// One table build on `stream`: the init launch, then (C > 0) the build.
// meta (int64, built by hash_kernels._plan): [C, T, n_words, shared,
// n_planes, n_fills, tk0, tk1, frow, state, occ, count, local_bytes], then
// (combo, offset) per plane, then (offset, element bytes, elements, bits)
// per fill. ptrs: [w0, w1, live, workspace], then (value, contrib) per
// plane. Returns cudaErrorInvalidValue for arguments the kernels do not
// take, else cudaGetLastError() after the launches.
extern "C" int daft_hash_agg_build(const long long* meta,
                                   const unsigned long long* ptrs,
                                   void* stream) {
  const long long C = meta[0];
  const int T = static_cast<int>(meta[1]);
  const int n_words = static_cast<int>(meta[2]);
  const bool shared = meta[3] != 0;
  const int n_planes = static_cast<int>(meta[4]);
  const int n_fills = static_cast<int>(meta[5]);
  if (C < 0 || C > 0x7FFFFFFFll || T <= 0 || (T & (T - 1)) != 0 ||
      meta[1] > (1ll << 30) || n_words < 1 || n_words > 2 || n_planes < 0 ||
      n_planes > kMaxPlanes || n_fills < 0 || n_fills > kMaxFills)
    return static_cast<int>(cudaErrorInvalidValue);
  Desc d;
  d.w0 = reinterpret_cast<const long long*>(ptrs[0]);
  d.w1 = reinterpret_cast<const long long*>(ptrs[1]);
  d.live = reinterpret_cast<const u8*>(ptrs[2]);
  d.ws = reinterpret_cast<char*>(ptrs[3]);
  d.C = C;
  d.chunk = 0;
  d.T = T;
  d.off_tk0 = meta[6];
  d.off_tk1 = meta[7];
  d.off_frow = meta[8];
  d.off_state = meta[9];
  d.off_occ = meta[10];
  d.off_count = meta[11];
  d.local_bytes = meta[12];
  // planes sorted by combo (a stable counting sort), ranges in start[]
  const long long* pm = meta + 13;
  for (int c = 0; c <= kCombos; ++c) d.start[c] = 0;
  for (int i = 0; i < n_planes; ++i) {
    const long long c = pm[2 * i];
    if (c < 0 || c >= kCombos) return static_cast<int>(cudaErrorInvalidValue);
    ++d.start[c + 1];
  }
  for (int c = 0; c < kCombos; ++c) d.start[c + 1] += d.start[c];
  int next[kCombos];
  for (int c = 0; c < kCombos; ++c) next[c] = d.start[c];
  for (int i = 0; i < n_planes; ++i) {
    PlaneDesc& p = d.planes[next[pm[2 * i]]++];
    p.off = pm[2 * i + 1];
    p.val = reinterpret_cast<const void*>(ptrs[4 + 2 * i]);
    p.contrib = reinterpret_cast<const u8*>(ptrs[5 + 2 * i]);
  }
  const long long* fm = pm + 2 * n_planes;
  d.n_fills = n_fills;
  for (int f = 0; f < n_fills; ++f) {
    d.fills[f].off = fm[4 * f];
    d.fills[f].size = static_cast<int>(fm[4 * f + 1]);
    d.fills[f].n = fm[4 * f + 2];
    d.fills[f].bits = static_cast<u64>(fm[4 * f + 3]);
    d.fills[f].pad = 0;
  }
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  long long init_grid = (static_cast<long long>(T) + kThreads - 1) / kThreads;
  if (init_grid > 4ll * sms) init_grid = 4ll * sms;
  hash_agg_init_kernel<<<static_cast<unsigned>(init_grid), kThreads, 0, st>>>(d);
  e = cudaGetLastError();
  if (e != cudaSuccess || C == 0) return static_cast<int>(e);
  if (n_words == 1)
    return shared ? launch_build<1, true>(d, st, dev, sms)
                  : launch_build<1, false>(d, st, dev, sms);
  return shared ? launch_build<2, true>(d, st, dev, sms)
                : launch_build<2, false>(d, st, dev, sms);
}
