// One-pass hash grouped-aggregation table build for Hopper (sm_90a).
//
// Replaces the Pallas kernel daft_tpu/device/pallas_kernels.py:
// _agg_build_call (driven by hash_grouped_agg_impl). It computes the same
// table: each live row's packed key (1 or 2 u64 words, the layout of
// kernels._packed_chunks) hashes by splitmix64 to a slot of a power-of-two
// open-addressing table with linear probing, and each slot accumulates the
// count / sum / sumsq / min / max / first planes of agg_state_specs plus the
// group's first row. The claim count is the overflow contract: a row that
// finds the table full is dropped, the count then reads T > out_cap, and the
// caller re-dispatches at a larger bucket.
//
// Design. The TPU kernel relies on grid steps running in order with one
// writer. Hopper runs blocks in no order, so the table lives in global
// memory and every update is an atomic: one thread per row in a
// grid-stride loop. A slot is claimed by CAS of its state from 0 (empty) to
// 1 (claiming); the claimer writes the key word(s), fences, and publishes
// state 2 (ready). A prober that finds state 1 spins until it reads 2, then
// compares the words, so 2-word keys are never seen half-written. Integer
// sums wrap in u64 like the reference's i64; float min/max are CAS loops
// with the reference's semantics (NaN propagates, -0.0 < +0.0); `first` is
// an atomicMin of the row id, gathered by the wrapper.
//
// A full table (claim count T) stops the build early: every row that
// starts, or keeps probing, after the last slot was claimed is dropped, so
// a saturated launch costs about the rows it takes to fill T slots instead
// of T probes per row. Its planes are partial; the count is the contract.
//
// Bound on this card: memory. The build reads the live mask (C bytes) and,
// for each live row, its key words (8 * n_words bytes) and each distinct
// value and contrib plane once, writes each table plane once, and the
// table takes the atomics. Known costs left for a later change: atomic
// contention when few groups take many rows (warp-aggregated or
// shared-memory pre-aggregation would fix it), and the table living in
// global memory rather than shared memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxSpecs = 48;

// spec kinds (match hash_kernels._KIND)
enum Kind { K_CNT = 0, K_SUM = 1, K_SUMSQ = 2, K_MIN = 3, K_MAX = 4,
            K_FIRST = 5 };
// value element types (match hash_kernels._VTYPE)
enum VType { V_U8 = 0, V_I8 = 1, V_I16 = 2, V_I32 = 3, V_I64 = 4,
             V_F32 = 5, V_F64 = 6 };
// plane element types (match hash_kernels._PTYPE)
enum PType { P_I32 = 0, P_I64 = 1, P_F32 = 2, P_F64 = 3 };

struct Spec {
  const void* val;
  const unsigned char* contrib;
  void* plane;
  int kind;
  int vtype;
  int ptype;
  int pad;
};

struct Args {
  const long long* w0;
  const long long* w1;
  const unsigned char* live;
  unsigned long long* tk0;
  unsigned long long* tk1;
  int* state;
  int* frow;
  int* info;
  long long C;
  int T;
  int n_words;
  int n_specs;
  Spec specs[kMaxSpecs];
};

__device__ __forceinline__ unsigned slot_of(unsigned long long w0,
                                            unsigned long long w1,
                                            int n_words, unsigned tmask) {
  const unsigned long long M1 = 0x9E3779B97F4A7C15ull;
  const unsigned long long M2 = 0xBF58476D1CE4E5B9ull;
  const unsigned long long M3 = 0x94D049BB133111EBull;
  unsigned long long x = n_words == 2 ? (w0 ^ (w1 * M1)) : w0;
  x = x + M1;
  x = (x ^ (x >> 30)) * M2;
  x = (x ^ (x >> 27)) * M3;
  x = x ^ (x >> 31);
  return static_cast<unsigned>(x) & tmask;
}

__device__ __forceinline__ long long load_int(const void* p, int vt,
                                              long long r) {
  switch (vt) {
    case V_U8: return static_cast<const unsigned char*>(p)[r];
    case V_I8: return static_cast<const signed char*>(p)[r];
    case V_I16: return static_cast<const short*>(p)[r];
    case V_I32: return static_cast<const int*>(p)[r];
    default: return static_cast<const long long*>(p)[r];
  }
}

__device__ __forceinline__ double load_f64(const void* p, int vt,
                                           long long r) {
  if (vt == V_F64) return static_cast<const double*>(p)[r];
  if (vt == V_F32) return static_cast<const float*>(p)[r];
  return static_cast<double>(load_int(p, vt, r));
}

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
  if (cur != cur) return false;  // NaN
  if (v != v) return true;
  return is_min ? order_key(v) < order_key(cur) : order_key(v) > order_key(cur);
}

__device__ void atomic_minmax_f64(double* addr, double v, bool is_min) {
  unsigned long long* a = reinterpret_cast<unsigned long long*>(addr);
  unsigned long long old = *reinterpret_cast<volatile unsigned long long*>(a);
  while (replaces(__longlong_as_double(old), v, is_min)) {
    unsigned long long prev = atomicCAS(a, old, __double_as_longlong(v));
    if (prev == old) return;
    old = prev;
  }
}

__device__ void atomic_minmax_f32(float* addr, float v, bool is_min) {
  unsigned* a = reinterpret_cast<unsigned*>(addr);
  unsigned old = *reinterpret_cast<volatile unsigned*>(a);
  while (replaces(__uint_as_float(old), v, is_min)) {
    unsigned prev = atomicCAS(a, old, __float_as_uint(v));
    if (prev == old) return;
    old = prev;
  }
}

__device__ void update(const Spec& sp, long long r, unsigned j) {
  switch (sp.kind) {
    case K_CNT:
      atomicAdd(static_cast<int*>(sp.plane) + j, 1);
      return;
    case K_SUM:
      if (sp.ptype == P_I64) {
        atomicAdd(static_cast<unsigned long long*>(sp.plane) + j,
                  static_cast<unsigned long long>(load_int(sp.val, sp.vtype, r)));
      } else if (sp.ptype == P_F32) {
        atomicAdd(static_cast<float*>(sp.plane) + j,
                  static_cast<const float*>(sp.val)[r]);
      } else {
        atomicAdd(static_cast<double*>(sp.plane) + j,
                  load_f64(sp.val, sp.vtype, r));
      }
      return;
    case K_SUMSQ:
      if (sp.ptype == P_F32) {
        float x = static_cast<const float*>(sp.val)[r];
        atomicAdd(static_cast<float*>(sp.plane) + j, x * x);
      } else {
        double x = load_f64(sp.val, sp.vtype, r);
        atomicAdd(static_cast<double*>(sp.plane) + j, x * x);
      }
      return;
    case K_MIN:
    case K_MAX: {
      const bool is_min = sp.kind == K_MIN;
      if (sp.ptype == P_F64) {
        atomic_minmax_f64(static_cast<double*>(sp.plane) + j,
                          static_cast<const double*>(sp.val)[r], is_min);
      } else if (sp.ptype == P_F32) {
        atomic_minmax_f32(static_cast<float*>(sp.plane) + j,
                          static_cast<const float*>(sp.val)[r], is_min);
      } else if (sp.ptype == P_I64) {
        long long* p = static_cast<long long*>(sp.plane) + j;
        long long x = load_int(sp.val, sp.vtype, r);
        if (is_min) atomicMin(p, x); else atomicMax(p, x);
      } else {  // narrow ints and bool, widened to 32 bits
        int* p = static_cast<int*>(sp.plane) + j;
        int x = static_cast<int>(load_int(sp.val, sp.vtype, r));
        if (is_min) atomicMin(p, x); else atomicMax(p, x);
      }
      return;
    }
    default: {  // K_FIRST: earliest contributing row
      int* p = static_cast<int*>(sp.plane) + j;
      int row = static_cast<int>(r);
      if (row < *reinterpret_cast<volatile int*>(p)) atomicMin(p, row);
      return;
    }
  }
}

__global__ void hash_agg_build_kernel(Args a) {
  const unsigned tmask = static_cast<unsigned>(a.T - 1);
  const long long stride = static_cast<long long>(blockDim.x) * gridDim.x;
  volatile int* vstate = a.state;
  volatile unsigned long long* vtk0 = a.tk0;
  volatile unsigned long long* vtk1 = a.tk1;
  volatile int* vclaims = a.info;
  for (long long r = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       r < a.C; r += stride) {
    if (!a.live[r]) continue;
    // A full table only signals overflow (T > out_cap): the caller
    // discards its planes and re-dispatches, so rows stop here.
    if (*vclaims >= a.T) continue;
    const unsigned long long w0 = static_cast<unsigned long long>(a.w0[r]);
    const unsigned long long w1 =
        a.n_words == 2 ? static_cast<unsigned long long>(a.w1[r]) : 0ull;
    unsigned j = slot_of(w0, w1, a.n_words, tmask);
    bool found = false;
    for (int steps = 0; steps < a.T; ++steps) {
      int s = vstate[j];
      if (s == 0) {
        s = atomicCAS(a.state + j, 0, 1);
        if (s == 0) {  // claimed: publish the key, then the slot
          a.tk0[j] = w0;
          if (a.n_words == 2) a.tk1[j] = w1;
          __threadfence();
          atomicExch(a.state + j, 2);
          atomicAdd(a.info, 1);
          found = true;
          break;
        }
      }
      while (s == 1) s = vstate[j];  // another row is publishing its key
      __threadfence();
      if (vtk0[j] == w0 && (a.n_words == 1 || vtk1[j] == w1)) {
        found = true;
        break;
      }
      j = (j + 1) & tmask;
      if ((steps & 31) == 31 && *vclaims >= a.T) break;  // filled meanwhile
    }
    if (!found) continue;  // table full: dropped, the claim count says so
    const int row = static_cast<int>(r);
    if (row < *reinterpret_cast<volatile int*>(a.frow + j))
      atomicMin(a.frow + j, row);
    for (int i = 0; i < a.n_specs; ++i) {
      const Spec& sp = a.specs[i];
      if (sp.contrib[r]) update(sp, r, j);
    }
  }
}

}  // namespace

// Launches the table build on `stream`. The caller allocates every plane
// and fills it with its identity (state 0, frow and first at C, cnt/sum
// zero, min +max / max -max); info[0] receives the claim count. Returns
// cudaErrorInvalidValue for arguments the kernel does not take, else 0;
// the caller checks the launch itself (csrc/binding.cpp).
extern "C" int daft_hash_agg_build(
    const long long* w0, const long long* w1, const unsigned char* live,
    long long C, int n_words, int T, unsigned long long* tk0,
    unsigned long long* tk1, int* state, int* frow, int* info, int n_specs,
    const int* kinds, const int* vtypes, const int* ptypes,
    const unsigned long long* val_ptrs,
    const unsigned long long* contrib_ptrs,
    const unsigned long long* plane_ptrs, void* stream) {
  if (n_specs > kMaxSpecs || n_words < 1 || n_words > 2 || T <= 0 ||
      (T & (T - 1)) != 0 || C < 0 || C > 0x7FFFFFFFll)
    return static_cast<int>(cudaErrorInvalidValue);
  if (C == 0) return 0;
  Args a;
  a.w0 = w0;
  a.w1 = w1;
  a.live = live;
  a.tk0 = tk0;
  a.tk1 = tk1;
  a.state = state;
  a.frow = frow;
  a.info = info;
  a.C = C;
  a.T = T;
  a.n_words = n_words;
  a.n_specs = n_specs;
  for (int i = 0; i < n_specs; ++i) {
    a.specs[i].val = reinterpret_cast<const void*>(val_ptrs[i]);
    a.specs[i].contrib =
        reinterpret_cast<const unsigned char*>(contrib_ptrs[i]);
    a.specs[i].plane = reinterpret_cast<void*>(plane_ptrs[i]);
    a.specs[i].kind = kinds[i];
    a.specs[i].vtype = vtypes[i];
    a.specs[i].ptype = ptypes[i];
    a.specs[i].pad = 0;
  }
  const int block = 256;
  long long blocks = (C + block - 1) / block;
  if (blocks > 65535) blocks = 65535;
  hash_agg_build_kernel<<<static_cast<unsigned>(blocks), block, 0,
                          static_cast<cudaStream_t>(stream)>>>(a);
  return 0;
}
