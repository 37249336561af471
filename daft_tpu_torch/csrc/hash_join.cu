// Hash equi-join build and probe for Hopper (sm_90a).
//
// Replace the Pallas kernels of daft_tpu/device/pallas_kernels.py:
// _join_build_call (the chained-bucket build) and _join_probe_call (the
// probe stream), both driven by hash_join_impl. They compute the same
// function: for every live probe row, the live build rows with an equal
// u64 key code, in ascending build-row order, written as (left, right)
// pairs left-major at an exclusive-scan cursor; pairs at or past `cap` are
// dropped but every row's count stays true (the overflow contract).
//
// Design. The TPU kernels run their grid in order with one writer: the
// build appends each row at its chain's tail, so chains are born in row
// order, and the probe keeps a running cursor. Hopper runs blocks in no
// order, so both become passes over the rows with atomics, and the chains
// become CSR segments:
//
//   build  1. claim/count: one thread per live build row finds its key's
//             slot by splitmix64 and linear probing in a power-of-two table
//             of T > C slots, claiming an empty one by a 64-bit CAS on the
//             key word (EMPTY = INT64_MIN marks a free slot; the one key
//             equal to EMPTY lives in the extra slot T), records its slot
//             and bumps the slot's row count;
//          2. an exclusive scan of the counts into segment offsets (a
//             torch cumsum between the launches, device/join_kernels.py);
//          3. scatter: each row takes a place in its slot's segment through
//             an atomic cursor per slot (in no particular order);
//          4. segment sort: segments of up to 32 rows are insertion-sorted
//             by one thread each; longer ones are queued and sorted by one
//             block each (bitonic, in shared memory up to 8192 rows, in
//             global memory beyond), which restores ascending row order.
//   probe  1. count: one thread per live probe row finds its key's slot and
//             reads its segment length (0 when absent or dead);
//          2. an inclusive scan of the counts (torch cumsum, as above);
//          3. emit: one thread per output slot below min(total, cap) finds
//             its probe row by binary search over the scan and writes the
//             (left, right) pair, so a key with many matches spreads over
//             many threads and the slots at or past `cap` are never
//             written.
//
// A table of T = max(2 C_r, 128) slots can never fill (distinct keys <=
// live rows < T), so linear probing always ends at the key or at a free
// slot; the step bound T is defensive and a row that reaches it is counted
// in info[1] (always 0 by construction).
//
// Bound on this card: memory. The build reads the live mask and each live
// row's key once, and writes the key, offset and row planes; the probe
// reads each live row's key and its slot's key and offsets, each matched
// row id once, and writes the counts and the pairs. The atomics go to a
// table of 2 C_r slots, so contention is low for foreign-key joins (one
// row per key); a key with many rows serialises its count and cursor
// atomics and sorts its long segment in one block (a later change could
// give such keys a block-wide count and a multi-block sort).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr long long kEmpty = static_cast<long long>(0x8000000000000000ull);
constexpr int kSmallSegment = 32;
constexpr int kSharedSegment = 8192;
constexpr int kThreads = 256;
constexpr int kSortThreads = 1024;

__device__ __forceinline__ unsigned slot_of_key(long long key,
                                                unsigned tmask) {
  // splitmix64, as csrc/hash_agg.cu mixes a 1-word key
  const unsigned long long M1 = 0x9E3779B97F4A7C15ull;
  const unsigned long long M2 = 0xBF58476D1CE4E5B9ull;
  const unsigned long long M3 = 0x94D049BB133111EBull;
  unsigned long long x = static_cast<unsigned long long>(key) + M1;
  x = (x ^ (x >> 30)) * M2;
  x = (x ^ (x >> 27)) * M3;
  x = x ^ (x >> 31);
  return static_cast<unsigned>(x) & tmask;
}

unsigned grid_for(long long n, int threads) {
  long long b = (n + threads - 1) / threads;
  if (b > 8 * 132 * 16) b = 8 * 132 * 16;  // grid-stride beyond this
  return static_cast<unsigned>(b < 1 ? 1 : b);
}

// ---------------------------------------------------------------- build

__global__ void build_claim_kernel(const long long* __restrict__ code,
                                   const unsigned char* __restrict__ live,
                                   long long C, int T, long long* tk,
                                   int* cnt, int* __restrict__ slot_of,
                                   int* info) {
  const unsigned tmask = static_cast<unsigned>(T - 1);
  unsigned long long* tku = reinterpret_cast<unsigned long long*>(tk);
  for (long long r = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       r < C; r += static_cast<long long>(gridDim.x) * blockDim.x) {
    if (!live[r]) {
      slot_of[r] = -1;
      continue;
    }
    const long long k = code[r];
    int j = -1;
    if (k == kEmpty) {
      j = T;
      if (atomicAdd(&cnt[T], 1) == 0) atomicAdd(&info[0], 1);
      slot_of[r] = j;
      continue;
    }
    unsigned h = slot_of_key(k, tmask);
    for (int steps = 0; steps < T; ++steps) {
      long long cur = *reinterpret_cast<volatile long long*>(&tk[h]);
      if (cur == kEmpty) {
        cur = static_cast<long long>(atomicCAS(
            &tku[h], static_cast<unsigned long long>(kEmpty),
            static_cast<unsigned long long>(k)));
        if (cur == kEmpty) {  // claimed
          atomicAdd(&info[0], 1);
          j = static_cast<int>(h);
          break;
        }
      }
      if (cur == k) {
        j = static_cast<int>(h);
        break;
      }
      h = (h + 1) & tmask;
    }
    if (j < 0) {  // defensive: T > C makes this unreachable (unplaced)
      atomicAdd(&info[1], 1);
      slot_of[r] = -1;
      continue;
    }
    atomicAdd(&cnt[j], 1);
    slot_of[r] = j;
  }
}

__global__ void build_scatter_kernel(const int* __restrict__ slot_of,
                                     long long C,
                                     const int* __restrict__ off, int* fill,
                                     int* __restrict__ rows) {
  for (long long r = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       r < C; r += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int j = slot_of[r];
    if (j < 0) continue;
    const int pos = atomicAdd(&fill[j], 1);
    rows[off[j] + pos] = static_cast<int>(r);
  }
}

// Segments of up to kSmallSegment rows: one thread each, insertion sort
// in registers/local memory. Longer ones are queued for the block sort.
__global__ void sort_small_kernel(const int* __restrict__ off,
                                  long long n_slots, int* rows,
                                  int* __restrict__ long_list, int* info) {
  for (long long j = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       j < n_slots; j += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int s = off[j];
    const int n = off[j + 1] - s;
    if (n <= 1) continue;
    if (n > kSmallSegment) {
      long_list[atomicAdd(&info[2], 1)] = static_cast<int>(j);
      continue;
    }
    int v[kSmallSegment];
    for (int i = 0; i < n; ++i) v[i] = rows[s + i];
    for (int i = 1; i < n; ++i) {
      const int x = v[i];
      int m = i - 1;
      while (m >= 0 && v[m] > x) {
        v[m + 1] = v[m];
        --m;
      }
      v[m + 1] = x;
    }
    for (int i = 0; i < n; ++i) rows[s + i] = v[i];
  }
}

// Ascending bitonic sort of s[0, n) by the whole block, every
// compare-exchange putting the smaller value at the lower index; slots
// n..P-1 of the padded power-of-two length P read as +infinity, so a pair
// whose upper index is past n never moves. Callers synchronise before and
// after.
__device__ void block_bitonic(int* s, int n) {
  int P = 1;
  while (P < n) P <<= 1;
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < P; i += blockDim.x) {
        // first step of a stage: mirror within the k-block; then halves
        const int p = (j == (k >> 1)) ? (i ^ (k - 1)) : (i ^ j);
        if (p <= i || p >= n) continue;
        const int a = s[i], b = s[p];
        if (a > b) {
          s[i] = b;
          s[p] = a;
        }
      }
      __syncthreads();
    }
  }
}

__global__ void sort_long_kernel(const int* __restrict__ off, int* rows,
                                 const int* __restrict__ long_list,
                                 const int* __restrict__ info) {
  __shared__ int buf[kSharedSegment];
  const int n_long = info[2];
  for (int b = blockIdx.x; b < n_long; b += gridDim.x) {
    const int j = long_list[b];
    const int s = off[j];
    const int n = off[j + 1] - s;
    if (n <= kSharedSegment) {
      for (int i = threadIdx.x; i < n; i += blockDim.x) buf[i] = rows[s + i];
      __syncthreads();
      block_bitonic(buf, n);
      for (int i = threadIdx.x; i < n; i += blockDim.x) rows[s + i] = buf[i];
    } else {
      block_bitonic(rows + s, n);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------- probe

__global__ void probe_count_kernel(const long long* __restrict__ code,
                                   const unsigned char* __restrict__ live,
                                   long long C, int T,
                                   const long long* __restrict__ tk,
                                   const int* __restrict__ off,
                                   int* __restrict__ pslot,
                                   int* __restrict__ counts) {
  const unsigned tmask = static_cast<unsigned>(T - 1);
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < C; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    int j = -1;
    if (live[i]) {
      const long long k = code[i];
      if (k == kEmpty) {
        j = T;
      } else {
        unsigned h = slot_of_key(k, tmask);
        for (int steps = 0; steps < T; ++steps) {
          const long long cur = tk[h];
          if (cur == k) {
            j = static_cast<int>(h);
            break;
          }
          if (cur == kEmpty) break;
          h = (h + 1) & tmask;
        }
      }
    }
    const int c = j < 0 ? 0 : off[j + 1] - off[j];
    pslot[i] = c > 0 ? j : -1;
    counts[i] = c;
  }
}

// One thread per output slot o below min(total, cap) (grid-stride; the
// total is the scan's last entry, read on the device): its probe row is
// the first i with incl[i] > o (binary search), its match the
// (o - exclusive offset)-th row of that row's slot.
__global__ void probe_emit_kernel(const int* __restrict__ pslot,
                                  const int* __restrict__ counts,
                                  const long long* __restrict__ incl,
                                  long long C, const int* __restrict__ off,
                                  const int* __restrict__ rows,
                                  long long cap, int* __restrict__ owner,
                                  int* __restrict__ ridx) {
  const long long total = incl[C - 1];
  const long long n = total < cap ? total : cap;
  for (long long o = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       o < n; o += static_cast<long long>(gridDim.x) * blockDim.x) {
    long long lo = 0, hi = C - 1;
    while (lo < hi) {
      const long long mid = (lo + hi) >> 1;
      if (incl[mid] > o) hi = mid; else lo = mid + 1;
    }
    const long long k = o - (incl[lo] - counts[lo]);
    owner[o] = static_cast<int>(lo);
    ridx[o] = rows[off[pslot[lo]] + k];
  }
}

bool bad_table(long long C, int T) {
  return T <= 0 || (T & (T - 1)) != 0 || C < 0 || C >= T ||
         C > 0x7FFFFFFFll;
}

}  // namespace

// Each entry launches one pass on `stream` and returns
// cudaErrorInvalidValue for arguments the kernels do not take, else
// cudaGetLastError() after its launches, which the caller raises on
// (device/join_kernels.py, through ctypes). The caller allocates
// every plane: tk [T+1] filled with EMPTY, cnt and fill [T+1] zeros, off
// [T+2] with off[0] = 0 and off[1:] the inclusive scan of cnt, rows [C],
// slot_of [C], long_list [T+1], info [4] zeros (info[0]: occupied slots,
// info[1]: rows that found no slot, info[2]: segments longer than 32).

extern "C" int daft_hash_join_build_claim(const long long* code,
                                          const unsigned char* live,
                                          long long C, int T, long long* tk,
                                          int* cnt, int* slot_of, int* info,
                                          void* stream) {
  if (bad_table(C, T)) return static_cast<int>(cudaErrorInvalidValue);
  if (C == 0) return 0;
  build_claim_kernel<<<grid_for(C, kThreads), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      code, live, C, T, tk, cnt, slot_of, info);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int daft_hash_join_build_scatter(const int* slot_of, long long C,
                                            int T, const int* off, int* fill,
                                            int* rows, int* long_list,
                                            int* info, void* stream) {
  if (bad_table(C, T)) return static_cast<int>(cudaErrorInvalidValue);
  if (C == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  build_scatter_kernel<<<grid_for(C, kThreads), kThreads, 0, st>>>(
      slot_of, C, off, fill, rows);
  const long long n_slots = static_cast<long long>(T) + 1;
  sort_small_kernel<<<grid_for(n_slots, kThreads), kThreads, 0, st>>>(
      off, n_slots, rows, long_list, info);
  // two blocks per SM of the H100's 132; each loops over the queued
  // segments, whose count only the device knows
  sort_long_kernel<<<264, kSortThreads, 0, st>>>(off, rows, long_list, info);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int daft_hash_join_probe_count(const long long* code,
                                          const unsigned char* live,
                                          long long C, int T,
                                          const long long* tk, const int* off,
                                          int* pslot, int* counts,
                                          void* stream) {
  if (T <= 0 || (T & (T - 1)) != 0 || C < 0 || C > 0x7FFFFFFFll)
    return static_cast<int>(cudaErrorInvalidValue);
  if (C == 0) return 0;
  probe_count_kernel<<<grid_for(C, kThreads), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      code, live, C, T, tk, off, pslot, counts);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int daft_hash_join_probe_emit(const int* pslot, const int* counts,
                                         const long long* incl, long long C,
                                         const int* off, const int* rows,
                                         long long cap, int* owner, int* ridx,
                                         void* stream) {
  if (C < 0 || C > 0x7FFFFFFFll || cap < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (C == 0 || cap == 0) return 0;
  unsigned grid = grid_for(cap, kThreads);
  if (grid > 132 * 16) grid = 132 * 16;  // grid-stride over the outputs
  probe_emit_kernel<<<grid, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      pslot, counts, incl, C, off, rows, cap, owner, ridx);
  return static_cast<int>(cudaGetLastError());
}
