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
// The TPU kernels run their grid in order with one writer: the build
// appends each row at its chain's tail, so chains are born in row order,
// and the probe keeps a running cursor. Hopper runs blocks in no order, so
// the chains become CSR segments (slot j's rows are rows[off[j], off[j+1]))
// and the cursor becomes a scan.
//
// What bounds it on this card. The bytes: the build reads the live mask
// and each live row's key once and writes the key (T+1 int64), offset
// (T+2 int32) and row (C int32) planes, 147 MB at TPC-H Q3's lineitem join
// (C = 2^22, T = 2^23), 0.044 ms at 3.35 TB/s; the probe reads each live
// row's key, its slot's key and offsets, each matched row id, and writes
// the counts and the pairs. Beyond the bytes, three things cost: atomics
// on one address (a count of claims per row would serialise every
// distinct key on it), atomics of many lanes on one slot (build rows that
// arrive in key order), and the fixed cost of a call (launches, fills,
// passes over all T slots), which at an empty or small side is all there
// is. What the design below leaves: per distinct key, the count and
// scatter passes each touch a random line of planes larger than the 50 MB
// L2 (key 67 MB, count and offsets 33 MB each at T = 2^23); at the
// lineitem join they take 0.11 and 0.15 ms of the build's 0.36 ms of
// device time, about 8x the bound (PERF.md).
//
// Build, six launches into one workspace (device/join_kernels.py:
// build_layout), no fill, copy or scan outside them:
//   1. init: the key plane to EMPTY, the count plane, the scan's tile
//      status and the counters to 0.
//   2. count: lanes of a warp whose rows carry one key find each other
//      with __match_any_sync; the lowest probes (splitmix64, linear
//      probing in a power-of-two table of T > C slots; a 64-bit CAS of the
//      key word at each step claims a free slot or returns the key there:
//      EMPTY = INT64_MIN marks a free slot, and the one key equal to EMPTY
//      lives in the extra slot T) and adds the group's size to the slot's
//      count: one probe walk and one atomic per distinct key per warp.
//      Nothing counts claims.
//   3. scan: a single-pass exclusive scan of the T+1 counts into the
//      offsets (decoupled look-back over tiles of 4096 slots); each block
//      also counts its occupied slots, one atomic per block, which gives
//      n_keys.
//   4. scatter: warp-aggregated again. A group that holds its key's whole
//      segment writes it in lane order (row order) with no atomic; groups
//      that share a segment take their places by one atomicSub of the
//      group's size on the slot's count (which runs down to 0), in the
//      order they come. The first of them lists the segment: one of up to
//      32 rows on the short list (appends aggregated per warp), a longer
//      one as its chunks of 4096 rows on the chunk list. The row plane's
//      entries past the live count get -1 here.
//   5. order: one warp per listed short segment ranks its rows by
//      comparison (shuffles, no memory) unless they already ascend; one
//      block per chunk of a long segment checks its chunk (and the next
//      chunk's first row) and sorts it in shared memory (bitonic) only
//      when out of order, into the row plane (a segment of one chunk) or
//      the scratch plane, where a chunk out of order marks its segment.
//   6. merge: one block per chunk of a marked segment of several chunks
//      places each of its sorted rows at its index in the chunk plus the
//      rows below it in every other chunk of the segment (a binary search
//      in shared memory, then a short walk), so a segment's chunks spread
//      over as many blocks. Its work grows with rows x chunks: one key
//      holding 2^20 rows costs 0.67 ms here (PERF.md).
// No pass walks all T+1 slots to find the occupied ones; the only
// T-sized passes are the init and the scan, which write and read the
// planes the contract names.
//
// Probe, one memset (the packed matrix, zeros past the total, with the
// scratch and tile status) and two launches:
//   1. count and scan: one thread per probe row finds its key's slot and
//      reads its segment length into the counts; the block scans them and
//      takes its tile's prefix by decoupled look-back (int64), so each
//      row's end in the output is known without a torch cumsum.
//   2. emit: one thread per output slot below min(total, cap) finds its
//      probe row by binary search over the scan and writes the pair, so a
//      key with many matches spreads over many threads and the slots at
//      or past `cap` are never written.
//
// A table of T = max(2 C_r, 128) slots can never fill (distinct keys <=
// live rows < T), so linear probing always ends at the key or at a free
// slot; the step bound T is defensive and a row that reaches it is counted
// in `unplaced` (always 0 by construction).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

using u64 = unsigned long long;

constexpr long long kEmpty = static_cast<long long>(0x8000000000000000ull);
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kScanItems = 16;
constexpr int kScanTile = kThreads * kScanItems;  // join_kernels._SCAN_TILE
constexpr int kShortSegment = 32;
constexpr int kChunk = 4096;                      // join_kernels._CHUNK
constexpr int kSortThreads = 512;
constexpr int kPer = kChunk / kSortThreads;
// a look-back tile's status word: flag in the top two bits, value below
constexpr u64 kAggregate = 1ull << 62;
constexpr u64 kPrefix = 2ull << 62;
constexpr u64 kValue = (1ull << 62) - 1;

// info plane of the build workspace
constexpr int kKeys = 0, kUnplaced = 1, kShort = 2, kItems = 3, kTiles = 4;

__device__ __forceinline__ unsigned slot_of_key(long long key,
                                                unsigned tmask) {
  // splitmix64, as csrc/hash_agg.cu mixes a 1-word key
  const u64 M1 = 0x9E3779B97F4A7C15ull;
  const u64 M2 = 0xBF58476D1CE4E5B9ull;
  const u64 M3 = 0x94D049BB133111EBull;
  u64 x = static_cast<u64>(key) + M1;
  x = (x ^ (x >> 30)) * M2;
  x = (x ^ (x >> 27)) * M3;
  x = x ^ (x >> 31);
  return static_cast<unsigned>(x) & tmask;
}

__device__ __forceinline__ u64 ld_acquire(const u64* p) {
  u64 v;
  asm volatile("ld.acquire.gpu.b64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(u64* p, u64 v) {
  asm volatile("st.release.gpu.b64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned lanes_below() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

unsigned grid_for(long long n, int threads) {
  long long b = (n + threads - 1) / threads;
  if (b > 8 * 132 * 16) b = 8 * 132 * 16;  // grid-stride beyond this
  return static_cast<unsigned>(b < 1 ? 1 : b);
}

// Inclusive scan of v over the block (blockDim.x a multiple of 32, at most
// 1024); *total gets the block's sum. warp_sums holds 32 entries.
template <typename V>
__device__ __forceinline__ V block_scan(V v, V* warp_sums, V* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int d = 1; d < 32; d <<= 1) {
    const V u = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += u;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    V w = lane < n_warps ? warp_sums[lane] : V(0);
    for (int d = 1; d < 32; d <<= 1) {
      const V u = __shfl_up_sync(kFull, w, d);
      if (lane >= d) w += u;
    }
    if (lane < n_warps) warp_sums[lane] = w;
  }
  __syncthreads();
  if (warp > 0) v += warp_sums[warp - 1];
  *total = warp_sums[n_warps - 1];
  return v;
}

// Decoupled look-back: publishes tile `tile`'s aggregate, then the first
// warp walks back over its predecessors' status words, 32 at a time,
// summing aggregates until a word holds an inclusive prefix, and publishes
// the tile's own. Tiles are numbered in the order blocks start (a counter),
// so every predecessor is running or done and the walk ends. Returns the
// tile's exclusive prefix to every thread of the block.
__device__ long long tile_prefix(u64* status, int tile, long long agg,
                                 long long* excl_s) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    long long excl = 0;
    if (tile > 0) {
      if (lane == 0) st_release(status + tile, kAggregate | static_cast<u64>(agg));
      for (int idx = tile - 1;; idx -= 32) {
        const int t = idx - lane;
        u64 s = t >= 0 ? ld_acquire(status + t) : kPrefix;
        while (__any_sync(kFull, (s >> 62) == 0))
          if ((s >> 62) == 0) s = ld_acquire(status + t);
        const unsigned pre = __ballot_sync(kFull, (s >> 62) == 2);
        const int stop = pre ? __ffs(pre) - 1 : 31;
        long long v = lane <= stop ? static_cast<long long>(s & kValue) : 0;
        for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
        excl += v;
        if (pre) break;
      }
    }
    if (lane == 0) {
      st_release(status + tile, kPrefix | static_cast<u64>(excl + agg));
      *excl_s = excl;
    }
  }
  __syncthreads();
  return *excl_s;
}

// ---------------------------------------------------------------- build

__global__ void __launch_bounds__(kThreads)
    build_init_kernel(long long* __restrict__ tk, int n_tk,
                      int* __restrict__ cnt, u64* __restrict__ status,
                      int n_status, int* __restrict__ info) {
  const int stride = gridDim.x * blockDim.x;
  const int i0 = blockIdx.x * blockDim.x + threadIdx.x;
  // the planes start 256-byte aligned (join_kernels.build_layout)
  longlong2* tk2 = reinterpret_cast<longlong2*>(tk);
  int4* cnt4 = reinterpret_cast<int4*>(cnt);
  for (int i = i0; i < n_tk / 2; i += stride)
    tk2[i] = make_longlong2(kEmpty, kEmpty);
  for (int i = i0; i < n_tk / 4; i += stride) cnt4[i] = make_int4(0, 0, 0, 0);
  for (int i = i0; i < n_status; i += stride) status[i] = 0;
  if (i0 < 4) {  // tails: n_tk = T + 1 is odd
    if (i0 == 0) tk[n_tk - 1] = kEmpty;
    if ((n_tk / 4) * 4 + i0 < n_tk) cnt[(n_tk / 4) * 4 + i0] = 0;
  }
  if (i0 < 8) info[i0] = 0;
}

__device__ __forceinline__ int find_or_claim(long long k, long long* tk,
                                             int T) {
  if (k == kEmpty) return T;
  const unsigned tmask = static_cast<unsigned>(T - 1);
  u64* tku = reinterpret_cast<u64*>(tk);
  unsigned h = slot_of_key(k, tmask);
  for (int steps = 0; steps < T; ++steps) {
    // the CAS returns the slot's key whether it claims it or not: one
    // round trip per step, no read before it
    const long long cur = static_cast<long long>(atomicCAS(
        &tku[h], static_cast<u64>(kEmpty), static_cast<u64>(k)));
    if (cur == kEmpty || cur == k) return static_cast<int>(h);
    h = (h + 1) & tmask;
  }
  return -1;  // defensive: T > C makes this unreachable (unplaced)
}

// Grid-stride over whole warps (every lane runs every iteration, so the
// warp-wide intrinsics see all 32 lanes); a warp covers 32 consecutive
// rows, lane order is row order.
__global__ void __launch_bounds__(kThreads)
    build_count_kernel(const long long* __restrict__ code,
                       const unsigned char* __restrict__ live, long long C,
                       int T, long long* tk, int* cnt,
                       int* __restrict__ slot_of, int* info) {
  const int lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long r0 = static_cast<long long>(blockIdx.x) * blockDim.x +
                      (threadIdx.x & ~31);
       r0 < C; r0 += stride) {
    const long long r = r0 + lane;
    const bool act = r < C && live[r];
    const long long k = act ? code[r] : 0;
    const unsigned am = __ballot_sync(kFull, act);
    int j = -1;
    if (act) {
      const unsigned peers = __match_any_sync(am, k);
      const int leader = __ffs(peers) - 1;
      if (lane == leader) {
        j = find_or_claim(k, tk, T);
        atomicAdd(j >= 0 ? &cnt[j] : &info[kUnplaced], __popc(peers));
      }
      j = __shfl_sync(peers, j, leader);
    }
    if (r < C) slot_of[r] = j;
  }
}

// Exclusive scan of cnt[0, N) into off[0, N] (off[0] = 0, off[j+1] the end
// of slot j's segment), tile by tile in the order blocks start; each block
// adds its occupied slots to info[kKeys].
__global__ void __launch_bounds__(kThreads)
    build_scan_kernel(const int* __restrict__ cnt, int N,
                      int* __restrict__ off, u64* status, int* info) {
  __shared__ int buf[kScanTile + kScanTile / 32];  // padded: no conflicts
  __shared__ long long warp_sums[32];
  __shared__ int tile_s, keys_s;
  __shared__ long long excl_s;
  if (threadIdx.x == 0) {
    tile_s = atomicAdd(&info[kTiles], 1);
    keys_s = 0;
  }
  __syncthreads();
  const int tile = tile_s;
  const long long base = static_cast<long long>(tile) * kScanTile;
#pragma unroll
  for (int m = 0; m < kScanItems; ++m) {  // coalesced, striped
    const int i = m * kThreads + threadIdx.x;
    buf[i + (i >> 5)] = base + i < N ? cnt[base + i] : 0;
  }
  __syncthreads();
  int v[kScanItems];
  int sum = 0, occupied = 0;
#pragma unroll
  for (int m = 0; m < kScanItems; ++m) {  // 16 consecutive per thread
    const int i = threadIdx.x * kScanItems + m;
    v[m] = buf[i + (i >> 5)];
    sum += v[m];
    occupied += v[m] != 0;
  }
  occupied = __reduce_add_sync(kFull, static_cast<unsigned>(occupied));
  if ((threadIdx.x & 31) == 0 && occupied) atomicAdd(&keys_s, occupied);
  long long total;
  const long long incl = block_scan<long long>(sum, warp_sums, &total);
  const long long excl = tile_prefix(status, tile, total, &excl_s);
  if (threadIdx.x == 0 && keys_s) atomicAdd(&info[kKeys], keys_s);
  long long run = excl + incl - sum;
#pragma unroll
  for (int m = 0; m < kScanItems; ++m) {
    const int i = threadIdx.x * kScanItems + m;
    run += v[m];
    buf[i + (i >> 5)] = static_cast<int>(run);
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < kScanItems; ++m) {
    const int i = m * kThreads + threadIdx.x;
    if (base + i < N) off[base + i + 1] = buf[i + (i >> 5)];
  }
  if (tile == 0 && threadIdx.x == 0) off[0] = 0;
}

__global__ void __launch_bounds__(kThreads)
    build_scatter_kernel(const int* __restrict__ slot_of, long long C,
                         int T, const int* __restrict__ off, int* cnt,
                         int* __restrict__ rows, int* __restrict__ shorts,
                         int2* __restrict__ items, int* info) {
  const int lane = threadIdx.x & 31;
  const int n_live = off[T + 1];
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long r0 = static_cast<long long>(blockIdx.x) * blockDim.x +
                      (threadIdx.x & ~31);
       r0 < C; r0 += stride) {
    const long long r = r0 + lane;
    const int j = r < C ? slot_of[r] : -1;
    if (r < C && r >= n_live) rows[r] = -1;
    const unsigned am = __ballot_sync(kFull, j >= 0);
    bool listed = false;
    if (j >= 0) {
      const unsigned peers = __match_any_sync(am, j);
      const int leader = __ffs(peers) - 1;
      const int g = __popc(peers);
      int pos = 0;
      if (lane == leader) {
        const int s = off[j], n = off[j + 1] - s;
        // a group that holds its key's whole segment takes it without an
        // atomic; the others take their places in the order they come
        // (the count runs down to 0), mostly row order
        const int old = g == n ? n : atomicSub(&cnt[j], g);
        pos = s + n - old;
        if (g < n && old == n) {  // the first of several groups
          if (n <= kShortSegment) {
            listed = true;
          } else {
            const int nc = (n + kChunk - 1) / kChunk;
            const int b = atomicAdd(&info[kItems], nc);
            for (int c = 0; c < nc; ++c) items[b + c] = make_int2(j, c);
          }
        }
      }
      pos = __shfl_sync(peers, pos, leader);
      rows[pos + __popc(peers & lanes_below())] = static_cast<int>(r);
    }
    const unsigned lm = __ballot_sync(kFull, listed);
    if (lm) {
      const int first = __ffs(lm) - 1;
      int b = 0;
      if (lane == first) b = atomicAdd(&info[kShort], __popc(lm));
      b = __shfl_sync(kFull, b, first);
      if (listed) shorts[b + __popc(lm & lanes_below())] = j;
    }
  }
}

// Ascending bitonic sort of s[0, n) by the whole block; slots n..P-1 of the
// padded power-of-two length P read as +infinity, so a pair whose upper
// index is past n never moves. Callers synchronise before and after.
__device__ void block_bitonic(int* s, int n) {
  int P = 1;
  while (P < n) P <<= 1;
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int x = threadIdx.x; x < P / 2; x += blockDim.x) {
        // the x-th pair of the step: its lower index has bit j clear; the
        // first step of a stage mirrors within the k-block, then halves
        const int i = ((x & ~(j - 1)) << 1) | (x & (j - 1));
        const int p = (j == (k >> 1)) ? (i ^ (k - 1)) : (i | j);
        if (p >= n) continue;
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

__global__ void __launch_bounds__(kSortThreads)
    build_order_kernel(const int* __restrict__ off, int* rows,
                       int* __restrict__ scratch, int* __restrict__ cnt,
                       const int* __restrict__ shorts,
                       const int2* __restrict__ items,
                       const int* __restrict__ info) {
  __shared__ int buf[kChunk];
  const int lane = threadIdx.x & 31;
  const int n_short = info[kShort], n_items = info[kItems];
  const int warps = gridDim.x * (kSortThreads / 32);
  // short segments: one warp each; a row's place is the number of smaller
  // rows (row ids are distinct); one already in order is left as it is
  for (int w = blockIdx.x * (kSortThreads / 32) + (threadIdx.x >> 5);
       w < n_short; w += warps) {
    const int j = shorts[w];
    const int s = off[j], n = off[j + 1] - s;
    const int v = lane < n ? rows[s + lane] : INT_MAX;
    const int next = __shfl_down_sync(kFull, v, 1);
    if (__all_sync(kFull, lane + 1 >= n || v < next)) continue;
    int rank = 0;
    for (int m = 0; m < n; ++m) rank += __shfl_sync(kFull, v, m) < v;
    if (lane < n) rows[s + rank] = v;
  }
  // chunks of long segments: one block each, sorted in shared memory into
  // the row plane (a segment of one chunk) or the scratch plane; a chunk
  // out of order, or whose last row exceeds the next chunk's first, marks
  // its segment for the merge (its count, 0 after the scatter)
  for (int it = blockIdx.x; it < n_items; it += gridDim.x) {
    const int2 item = items[it];
    const int s = off[item.x], n = off[item.x + 1] - s;
    const int c0 = item.y * kChunk, m = min(kChunk, n - c0);
    __syncthreads();
    for (int i = threadIdx.x; i < m; i += kSortThreads)
      buf[i] = rows[s + c0 + i];
    __syncthreads();
    bool ok = true;
    for (int i = threadIdx.x; i + 1 < m; i += kSortThreads)
      ok = ok && buf[i] < buf[i + 1];
    if (threadIdx.x == 0 && c0 + m < n) ok = ok && buf[m - 1] < rows[s + c0 + m];
    const bool sorted = __syncthreads_and(ok);
    if (!sorted) block_bitonic(buf, m);
    if (n > kChunk) {
      for (int i = threadIdx.x; i < m; i += kSortThreads)
        scratch[s + c0 + i] = buf[i];
      if (!sorted && threadIdx.x == 0) atomicOr(&cnt[item.x], 1);
    } else if (!sorted) {
      for (int i = threadIdx.x; i < m; i += kSortThreads)
        rows[s + c0 + i] = buf[i];
    }
  }
}

// First index in s[lo, hi) whose value is not below v.
__device__ __forceinline__ int lower_bound(const int* s, int lo, int hi,
                                           int v) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// One block per chunk of a marked segment: each thread holds kPer
// consecutive rows of its sorted chunk and adds, for every other chunk of
// the segment (in shared memory), the number of its rows below each one:
// a binary search for the first, then a short walk (rows ascend) for the
// next. The sum is the row's place in the segment.
__global__ void __launch_bounds__(kSortThreads)
    build_merge_kernel(const int* __restrict__ off, int* __restrict__ rows,
                       const int* __restrict__ scratch,
                       const int* __restrict__ cnt,
                       const int2* __restrict__ items,
                       const int* __restrict__ info) {
  __shared__ int buf[kChunk];
  const int n_items = info[kItems];
  for (int it = blockIdx.x; it < n_items; it += gridDim.x) {
    const int2 item = items[it];
    const int s = off[item.x], n = off[item.x + 1] - s;
    if (n <= kChunk || cnt[item.x] == 0) continue;  // in order already
    const int nc = (n + kChunk - 1) / kChunk;
    const int c0 = item.y * kChunk, m = min(kChunk, n - c0);
    int v[kPer], rank[kPer];
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int i = threadIdx.x * kPer + q;
      v[q] = i < m ? scratch[s + c0 + i] : INT_MAX;
      rank[q] = i;  // rows of its own chunk below it: the chunk is sorted
    }
    for (int b = 0; b < nc; ++b) {
      if (b == item.y) continue;
      const int mb = min(kChunk, n - b * kChunk);
      __syncthreads();
      for (int i = threadIdx.x; i < mb; i += kSortThreads)
        buf[i] = scratch[s + b * kChunk + i];
      __syncthreads();
      int lo = lower_bound(buf, 0, mb, v[0]);
      rank[0] += lo;
#pragma unroll
      for (int q = 1; q < kPer; ++q) {
        int steps = 0;
        while (steps < 8 && lo < mb && buf[lo] < v[q]) {
          ++lo;
          ++steps;
        }
        if (steps == 8) lo = lower_bound(buf, lo, mb, v[q]);
        rank[q] += lo;
      }
    }
#pragma unroll
    for (int q = 0; q < kPer; ++q)
      if (static_cast<int>(threadIdx.x) * kPer + q < m)
        rows[s + rank[q]] = v[q];
  }
}

// ---------------------------------------------------------------- probe

__device__ __forceinline__ int find_slot(long long k,
                                         const long long* __restrict__ tk,
                                         int T) {
  if (k == kEmpty) return T;
  const unsigned tmask = static_cast<unsigned>(T - 1);
  unsigned h = slot_of_key(k, tmask);
  for (int steps = 0; steps < T; ++steps) {
    const long long cur = tk[h];
    if (cur == k) return static_cast<int>(h);
    if (cur == kEmpty) return -1;
    h = (h + 1) & tmask;
  }
  return -1;
}

// One probe row per thread, one tile per block (numbered in the order
// blocks start): counts, the slot of each matched row, and each row's
// inclusive end in the output (int64).
__global__ void __launch_bounds__(kThreads)
    probe_count_kernel(const long long* __restrict__ code,
                       const unsigned char* __restrict__ live, long long C,
                       int T, const long long* __restrict__ tk,
                       const int* __restrict__ off, int* __restrict__ counts,
                       int* __restrict__ pslot, long long* __restrict__ incl,
                       u64* status, int* tiles) {
  __shared__ long long warp_sums[32];
  __shared__ int tile_s;
  __shared__ long long excl_s;
  if (threadIdx.x == 0) tile_s = atomicAdd(tiles, 1);
  __syncthreads();
  const int tile = tile_s;
  const long long i = static_cast<long long>(tile) * kThreads + threadIdx.x;
  int j = -1, c = 0;
  if (i < C && live[i]) {
    j = find_slot(code[i], tk, T);
    if (j >= 0) c = off[j + 1] - off[j];
  }
  long long total;
  const long long inc = block_scan<long long>(c, warp_sums, &total);
  const long long excl = tile_prefix(status, tile, total, &excl_s);
  if (i < C) {
    counts[i] = c;
    pslot[i] = c > 0 ? j : -1;
    incl[i] = excl + inc;
  }
}

// One thread per output slot o below min(total, cap) (grid-stride; the
// total is the scan's last entry, read on the device): its probe row is
// the first i with incl[i] > o (binary search), its match the
// (o - exclusive offset)-th row of that row's slot.
__global__ void __launch_bounds__(kThreads)
    probe_emit_kernel(const int* __restrict__ pslot,
                      const int* __restrict__ counts,
                      const long long* __restrict__ incl, long long C,
                      const int* __restrict__ off,
                      const int* __restrict__ rows, long long cap,
                      int* __restrict__ owner, int* __restrict__ ridx) {
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

}  // namespace

// Each entry launches its kernels on `stream` and returns
// cudaErrorInvalidValue for arguments the kernels do not take, else
// cudaGetLastError() after its launches, which the caller raises on
// (device/join_kernels.py, through ctypes). The caller allocates the
// workspace; `lay` (host memory) gives its layout.

// The build into one uninitialised workspace `ws`. lay (byte offsets, from
// join_kernels.build_layout): [tk, off, rows, cnt, slot_of, shorts, items,
// status, info, status tiles, item capacity]. tk [T+1] int64, off [T+2],
// rows [C], cnt [T+1], slot_of [C] (then the merge's scratch), shorts
// [C/2+1] int32, items [item capacity] int2, status [tiles] u64, info [8]
// int32 (n_keys, unplaced, short segments listed, chunk items listed,
// scan tiles started).
extern "C" int daft_hash_join_build(const long long* code,
                                    const unsigned char* live, long long C,
                                    int T, void* ws, const long long* lay,
                                    void* stream) {
  if (T <= 0 || (T & (T - 1)) != 0 || T > (1 << 30) || C < 0 || C >= T ||
      lay[9] != (static_cast<long long>(T) + kScanTile) / kScanTile ||
      lay[10] < C / (kShortSegment + 1) + C / kChunk + 2)
    return static_cast<int>(cudaErrorInvalidValue);
  char* b = static_cast<char*>(ws);
  long long* tk = reinterpret_cast<long long*>(b + lay[0]);
  int* off = reinterpret_cast<int*>(b + lay[1]);
  int* rows = reinterpret_cast<int*>(b + lay[2]);
  int* cnt = reinterpret_cast<int*>(b + lay[3]);
  int* slot_of = reinterpret_cast<int*>(b + lay[4]);
  int* shorts = reinterpret_cast<int*>(b + lay[5]);
  int2* items = reinterpret_cast<int2*>(b + lay[6]);
  u64* status = reinterpret_cast<u64*>(b + lay[7]);
  int* info = reinterpret_cast<int*>(b + lay[8]);
  const int tiles = static_cast<int>(lay[9]);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  build_init_kernel<<<grid_for((T + 1) / 2, kThreads), kThreads, 0, st>>>(
      tk, T + 1, cnt, status, tiles, info);
  if (C > 0)
    build_count_kernel<<<grid_for(C, kThreads), kThreads, 0, st>>>(
        code, live, C, T, tk, cnt, slot_of, info);
  build_scan_kernel<<<tiles, kThreads, 0, st>>>(cnt, T + 1, off, status,
                                                info);
  if (C > 0) {
    build_scatter_kernel<<<grid_for(C, kThreads), kThreads, 0, st>>>(
        slot_of, C, T, off, cnt, rows, shorts, items, info);
    // four blocks per SM of the H100's 132; each loops over the listed
    // work, whose size only the device knows
    build_order_kernel<<<528, kSortThreads, 0, st>>>(
        off, rows, slot_of, cnt, shorts, items, info);
    build_merge_kernel<<<528, kSortThreads, 0, st>>>(off, rows, slot_of, cnt,
                                                     items, info);
  }
  return static_cast<int>(cudaGetLastError());
}

// The probe into `buf`, zeroed by the caller. lay (byte offsets, from
// join_kernels.probe_layout): [W, counts, incl, pslot, status, tile
// counter, tiles]; the packed int32 [3, W] matrix starts the buffer (row 0
// owners, row 1 matches, row 2 the counts).
extern "C" int daft_hash_join_probe(const long long* code,
                                    const unsigned char* live, long long C,
                                    int T, const long long* tk,
                                    const int* off, const int* rows,
                                    long long cap, void* buf,
                                    const long long* lay, void* stream) {
  const long long W = lay[0];
  if (T <= 0 || (T & (T - 1)) != 0 || C < 0 || C > 0x7FFFFFFFll ||
      cap < 0 || W < cap || W < C ||
      lay[6] != (C + kThreads - 1) / kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  if (C == 0) return 0;
  char* b = static_cast<char*>(buf);
  int* packed = reinterpret_cast<int*>(b);
  int* counts = reinterpret_cast<int*>(b + lay[1]);
  long long* incl = reinterpret_cast<long long*>(b + lay[2]);
  int* pslot = reinterpret_cast<int*>(b + lay[3]);
  u64* status = reinterpret_cast<u64*>(b + lay[4]);
  int* tile_ctr = reinterpret_cast<int*>(b + lay[5]);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  probe_count_kernel<<<static_cast<unsigned>(lay[6]), kThreads, 0, st>>>(
      code, live, C, T, tk, off, counts, pslot, incl, status, tile_ctr);
  if (cap > 0) {
    unsigned grid = grid_for(cap, kThreads);
    if (grid > 132 * 16) grid = 132 * 16;  // grid-stride over the outputs
    probe_emit_kernel<<<grid, kThreads, 0, st>>>(pslot, counts, incl, C, off,
                                                 rows, cap, packed,
                                                 packed + W);
  }
  return static_cast<int>(cudaGetLastError());
}
