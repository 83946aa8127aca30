// Stable counting sort by bin id for Hopper (sm_90a).
//
// Replaces the TPU kernel raytracer2_tpu/ops/pallas_binning.py::_scatter_kernel
// (scatter_rate_probe). That kernel runs the counting-sort scatter chain one
// element at a time on the TPU's scalar core, which has no vector scatter:
//     slot = cursor[id];  cursor[id] += 1;  stage[slot] = j
// with the cursors carried over the sequential grid, so each element's slot
// is its stable rank among the earlier elements of its id. Here the chain is
// the pair engine's binning (ops/cuda_pairs.py::bin_pairs): each element j
// of bin b with stable rank r stores j / div at out[base[b] + r], where base
// is the exclusive scan over bins of the bin counts rounded up to `pad`;
// every other slot of out holds -1.
//
// What bounds it: the bytes, the ids read once and the slots written once
// (50 MB for the 6,291,456 ids of a 262,144-ray pairs batch at k = 24, 15
// us at the HBM rate); the arithmetic is a few integer operations per
// element; the kernels move those bytes at a fraction of the memory rate,
// the per-tile sort's chain of phases between barriers taking the rest
// (PERF.md). A cursor bumped by an atomic would hand out slots in the order
// the threads happen to run, which changes from run to run, so the rank is
// computed instead and the output equals a stable sort's on every run.
//
// The design, three launches on tiles of kTile = 4096 ids, each thread of
// a block taking kItems = 16 consecutive ids (four 16-byte loads):
// 1. count_kernel: per tile, the count of each bin in shared memory, one
//    shared atomic add per run of equal ids in a thread's items (the pair
//    engine's rays list their k candidates one after another, the dead
//    ones, ~75% of the ids, in one bin at the end), written to
//    counts[bin][tile];
// 2. scan_kernel: one block per bin turns its row into the exclusive scan
//    over tiles (coalesced, kScanItems block scans per chunk) and writes the
//    bin's total. It stays a launch of its own: a scatter block that
//    scanned its own column would read O(tiles) counts per bin,
//    O(tiles^2 * bins) in all, and a look-back over tiles would wait
//    through the first wave's chain;
// 3. scatter_kernel: per tile, the ids' loads first and the bins' totals
//    and earlier-tile counts beside them, then a stable counting sort of
//    the tile in shared memory. Each warp first compacts, in index order,
//    its ids that need a rank (a bin; and a written one when no ranks are
//    asked for: the pair engine's dead-candidate bin drops out), then ranks
//    them 32 at a time: __match_any_sync gives the lanes that share an id,
//    a per-warp count per bin the earlier ones (warp-local: no block
//    barrier between the rounds). The warps' counts are scanned per bin and
//    the tile's written bins laid out one after another; every element of a
//    written bin puts its place in the tile and its bin at its place in
//    that sorted tile, and consecutive threads then write the sorted tile,
//    so each bin's run of slots is stored by consecutive threads
//    (coalesced). The same launch writes -1 (16-byte stores) in every slot
//    no element takes (each bin's padding and everything after the written
//    bins) as soon as the bases are known, so those stores overlap the
//    sort and the caller fills nothing.
// An id outside [0, n_bins) belongs to no bin: it is not counted, gets rank
// -1 and stores nothing.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;                // consecutive ids per thread
constexpr int kTile = kThreads * kItems;  // 4096 ids per block
constexpr int kWarpIds = 32 * kItems;     // 512 ids per warp
constexpr int kScanItems = 8;             // row entries per thread a chunk
constexpr int kScatterBlocks = 5;  // resident a SM: <= 48 registers
constexpr int kMaxBins = 1024;
constexpr int kBinsPerThread = kMaxBins / kThreads;
// a compacted id's code: label (id + 1) in the low 11 bits, its place in
// the warp's ids in the next 9, its rank in the warp above them
constexpr int kLabelBits = 11;
constexpr int kLabelMask = (1 << kLabelBits) - 1;
constexpr int kPlaceBits = 9;
constexpr int kRankShift = kLabelBits + kPlaceBits;
// a sorted tile entry: the id's place in the tile, its bin above
constexpr int kTileBits = 12;

// Exclusive scan of v over the block (kThreads threads); sets total to the
// sum over the block. Ends with a barrier, so warp_sums may be reused.
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_sums,
                                                    int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int before = 0;
  total = 0;
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) before += warp_sums[w];
    total += warp_sums[w];
  }
  __syncthreads();
  return before + incl - v;
}

// Exclusive scan of v over the warp.
__device__ __forceinline__ int warp_exclusive_scan(int v) {
  const int lane = threadIdx.x & 31;
  int incl = v;
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  return incl - v;
}

// the range [lo, hi) of `count` items that thread threadIdx.x takes
__device__ __forceinline__ void thread_range(int count, int& lo, int& hi) {
  const int per = (count + kThreads - 1) / kThreads;
  lo = min(count, static_cast<int>(threadIdx.x) * per);
  hi = min(count, lo + per);
}

// This thread's kItems labels of `tile` (label: id + 1 if the id names a
// bin, else 0, also past the end); four 16-byte loads when `vec` (ids is
// 16-byte aligned) and the items lie below n.
__device__ __forceinline__ void load_labels(const int* __restrict__ ids,
                                            int tile, long long n,
                                            int n_bins, bool vec,
                                            int (&label)[kItems]) {
  const long long j0 = static_cast<long long>(tile) * kTile +
                       threadIdx.x * kItems;
  if (vec && j0 + kItems <= n) {
    const int4* v = reinterpret_cast<const int4*>(ids + j0);
#pragma unroll
    for (int q = 0; q < kItems / 4; ++q) {
      const int4 x = v[q];
      label[4 * q] = x.x;
      label[4 * q + 1] = x.y;
      label[4 * q + 2] = x.z;
      label[4 * q + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      label[k] = j0 + k < n ? ids[j0 + k] : -1;
    }
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    label[k] = label[k] >= 0 && label[k] < n_bins ? label[k] + 1 : 0;
  }
}

__device__ __forceinline__ int padded(int count, int pad) {
  return (count + pad - 1) / pad * pad;
}

// -1 in out[from, to), the thread taking the int4 vectors g, g + stride, ..
// of it (scalar at the unaligned ends).
__device__ __forceinline__ void fill_minus_one(int* out, long long from,
                                               long long to, long long g,
                                               long long stride) {
  if (from >= to) return;
  const long long v0 = (from + 3) / 4, v1 = to / 4;  // whole vectors
  if (v0 >= v1) {
    for (long long s = from + g; s < to; s += stride) out[s] = -1;
    return;
  }
  for (long long s = from + g; s < 4 * v0; s += stride) out[s] = -1;
  for (long long s = 4 * v1 + g; s < to; s += stride) out[s] = -1;
  int4* vec = reinterpret_cast<int4*>(out);
  for (long long v = v0 + g; v < v1; v += stride) {
    vec[v] = make_int4(-1, -1, -1, -1);
  }
}

__global__ void __launch_bounds__(kThreads)
count_kernel(const int* __restrict__ ids, int* __restrict__ counts,
             long long n, int n_bins, int tiles, bool vec) {
  extern __shared__ int hist[];  // [n_bins]
  int label[kItems];
  load_labels(ids, blockIdx.x, n, n_bins, vec, label);
  for (int b = threadIdx.x; b < n_bins; b += kThreads) hist[b] = 0;
  __syncthreads();
  int cur = label[0], len = 1;
#pragma unroll
  for (int k = 1; k < kItems; ++k) {
    if (label[k] == cur) {
      ++len;
    } else {
      if (cur > 0) atomicAdd(&hist[cur - 1], len);
      cur = label[k];
      len = 1;
    }
  }
  if (cur > 0) atomicAdd(&hist[cur - 1], len);
  __syncthreads();
  for (int b = threadIdx.x; b < n_bins; b += kThreads) {
    counts[static_cast<long long>(b) * tiles + blockIdx.x] = hist[b];
  }
}

__global__ void __launch_bounds__(kThreads)
scan_kernel(int* __restrict__ counts, int* __restrict__ totals, int tiles) {
  __shared__ int warp_sums[kWarps];
  int* row = counts + static_cast<long long>(blockIdx.x) * tiles;
  int carry = 0;
  for (int t0 = 0; t0 < tiles; t0 += kThreads * kScanItems) {
    int v[kScanItems];
#pragma unroll
    for (int c = 0; c < kScanItems; ++c) {
      const int t = t0 + c * kThreads + threadIdx.x;
      v[c] = t < tiles ? row[t] : 0;
    }
#pragma unroll
    for (int c = 0; c < kScanItems; ++c) {
      int total;
      const int before = block_exclusive_scan(v[c], warp_sums, total);
      const int t = t0 + c * kThreads + threadIdx.x;
      if (t < tiles) row[t] = carry + before;
      carry += total;
    }
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = carry;
}

// Shared bytes of scatter_kernel at n_bins bins.
size_t scatter_smem(int n_bins) {
  return sizeof(long long) * n_bins             // base
         + sizeof(int) * (2 + kWarps) * n_bins  // prefix, start, counts
         + sizeof(int) * 2 * kTile;             // codes, sorted tile
}

__global__ void __launch_bounds__(kThreads, kScatterBlocks)
scatter_kernel(const int* __restrict__ ids, const int* __restrict__ offsets,
               const int* __restrict__ totals, int* __restrict__ out,
               int* __restrict__ ranks, long long n, int n_bins, int tiles,
               int n_write, int pad, int div, long long out_size, bool vec) {
  extern __shared__ long long smem[];
  long long* base = smem;                           // [n_bins] bin bases
  int* prefix = reinterpret_cast<int*>(base + n_bins);  // [n_bins] earlier
  int* start = prefix + n_bins;       // [n_bins] first sorted place
  int* warp_cnt = start + n_bins;     // [kWarps][n_bins]
  int* codes = warp_cnt + kWarps * n_bins;   // [kWarps][kWarpIds]
  int* sorted = codes + kTile;               // [kTile]
  __shared__ int warp_sums[kWarps];
  const int tile = blockIdx.x;  // gridDim.x is 1 when there is no tile
  const bool has_tile = tile < tiles;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const long long tile0 = static_cast<long long>(tile) * kTile;

  // the ids, and this thread's bins' totals and earlier-tile counts, all
  // loaded before any is used
  int label[kItems];
  if (has_tile) {
    load_labels(ids, tile, n, n_bins, vec, label);
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k) label[k] = 0;
  }
  int lo, hi;
  thread_range(n_bins, lo, hi);
  int tot[kBinsPerThread], pre[kBinsPerThread];
#pragma unroll
  for (int i = 0; i < kBinsPerThread; ++i) {
    const int b = lo + i;
    tot[i] = b < hi ? totals[b] : 0;
    pre[i] = b < hi && has_tile
                 ? offsets[static_cast<long long>(b) * tiles + tile]
                 : 0;
  }

  // the padded bin bases
  int sum = 0;
#pragma unroll
  for (int i = 0; i < kBinsPerThread; ++i) sum += padded(tot[i], pad);
  int total;
  long long run = block_exclusive_scan(sum, warp_sums, total);
#pragma unroll
  for (int i = 0; i < kBinsPerThread; ++i) {
    if (lo + i < hi) {
      base[lo + i] = run;
      prefix[lo + i] = pre[i];
      run += padded(tot[i], pad);
    }
  }
  for (int i = threadIdx.x; i < kWarps * n_bins; i += kThreads) {
    warp_cnt[i] = 0;
  }

  // this warp's ids that need a rank, compacted in index order (a rank -1
  // goes out at once for the others when ranks are asked for)
  int* my_codes = codes + warp * kWarpIds;
  unsigned need = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (label[k] > 0 && (label[k] <= n_write || ranks != nullptr)) {
      need |= 1u << k;
    }
  }
  const int mine = __popc(need);
  int at = warp_exclusive_scan(mine);
  const int listed = __shfl_sync(0xffffffffu, at + mine, 31);
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (need >> k & 1) {
      my_codes[at++] = label[k] | (lane * kItems + k) << kLabelBits;
    } else if (ranks != nullptr && has_tile) {
      const long long j = tile0 + threadIdx.x * kItems + k;
      if (j < n) ranks[j] = -1;
    }
  }
  __syncthreads();  // the bases, the prefix, the zeroed counts, the codes

  // -1 in the slots no element takes, early so the stores overlap the
  // sort: the padding of each written bin (block b % gridDim.x), then all
  // from the end of the written bins' runs on (grid-strided)
  if (out != nullptr) {
    for (int b = tile; b < n_write; b += gridDim.x) {
      const int count = totals[b];
      fill_minus_one(out, base[b] + count,
                     min(base[b] + padded(count, pad), out_size),
                     threadIdx.x, kThreads);
    }
    const long long write_end = n_write < n_bins ? base[n_write] : total;
    fill_minus_one(out, write_end, out_size,
                   static_cast<long long>(tile) * kThreads + threadIdx.x,
                   static_cast<long long>(gridDim.x) * kThreads);
  }

  // the listed ids' ranks among the earlier listed ids of their bin in the
  // warp: the earlier rounds' count (warp_cnt, bumped by one lane per group
  // of lanes that share an id) plus the lanes below it in its group
  int* my_cnt = warp_cnt + warp * n_bins;
  for (int e0 = 0; e0 < listed; e0 += 32) {
    const int e = e0 + lane;
    const int code = e < listed ? my_codes[e] : 0;
    const int lab = code & kLabelMask;
    const unsigned peers = __match_any_sync(0xffffffffu, lab);
    const int leader = __ffs(peers) - 1;
    int before = 0;
    if (lab > 0 && lane == leader) {
      before = my_cnt[lab - 1];
      my_cnt[lab - 1] = before + __popc(peers);
    }
    const int rank = __shfl_sync(0xffffffffu, before, leader) +
                     __popc(peers & below);
    if (e < listed) my_codes[e] = code | rank << kRankShift;
    __syncwarp();  // the next round's leader reads this one's count
  }
  __syncthreads();

  // per bin: each warp's first place among the tile's listed ids of the
  // bin (the counts of the warps before it), then the first place of each
  // written bin in the sorted tile
  int in_written = 0;
  int cnt[kBinsPerThread];
#pragma unroll
  for (int i = 0; i < kBinsPerThread; ++i) {
    const int b = lo + i;
    int c = 0;
    if (b < hi) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const int x = warp_cnt[w * n_bins + b];
        warp_cnt[w * n_bins + b] = c;
        c += x;
      }
    }
    cnt[i] = b < n_write ? c : 0;
    in_written += cnt[i];
  }
  int n_sorted;
  int place = block_exclusive_scan(in_written, warp_sums, n_sorted);
  // (from here on base[b] holds the slot of sorted place 0 of bin b,
  // base[b] + prefix[b] - start[b]: the fill above is done with it)
#pragma unroll
  for (int i = 0; i < kBinsPerThread; ++i) {
    const int b = lo + i;
    if (b < hi) {
      start[b] = place;
      base[b] += prefix[b] - place;
    }
    place += cnt[i];
  }
  __syncthreads();

  // ranks of the listed ids; each written one's place in the tile and bin
  // at its place in the sorted tile
  const int warp0 = warp * kWarpIds;
  for (int e = lane; e < listed; e += 32) {
    const int code = my_codes[e];
    const int b = (code & kLabelMask) - 1;
    const int in_tile = my_cnt[b] + (code >> kRankShift);
    const int j = warp0 + ((code >> kLabelBits) & ((1 << kPlaceBits) - 1));
    if (ranks != nullptr) ranks[tile0 + j] = prefix[b] + in_tile;
    if (b < n_write) sorted[start[b] + in_tile] = j | b << kTileBits;
  }
  if (out == nullptr) return;
  __syncthreads();

  // the sorted tile: each bin's run of slots by consecutive threads
  for (int p = threadIdx.x; p < n_sorted; p += kThreads) {
    const int entry = sorted[p];
    const long long slot = base[entry >> kTileBits] + p;
    if (slot < out_size) {
      out[slot] = static_cast<int>(tile0 + (entry & (kTile - 1))) / div;
    }
  }
}

}  // namespace

extern "C" {

// ids [n] i32; scratch [n_bins * ceil(n / 4096)] i32; counts [n_bins] i32
// (out); out [out_size] i32 (out: every slot is written) or null; ranks [n]
// i32 or null. Launches the three kernels on `stream` and returns
// cudaGetLastError() (0 on success).
int rt2_bin_scatter(const int* ids, int* scratch, int* counts, int* out,
                    int* ranks, long long n, int n_bins, int n_write, int pad,
                    int div, long long out_size, void* stream) {
  if (n < 0 || n >= (1LL << 31) || n_bins < 1 || n_bins > kMaxBins ||
      pad < 1 || div < 1 || n_write < 0 || n_write > n_bins ||
      out_size < 0 || out_size >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long tiles_ll = (n + kTile - 1) / kTile;
  if (tiles_ll > 0x7fffffffLL / kMaxBins) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles = static_cast<int>(tiles_ll);
  const bool vec = reinterpret_cast<std::uintptr_t>(ids) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tiles > 0) {
    count_kernel<<<tiles, kThreads, sizeof(int) * n_bins, s>>>(
        ids, scratch, n, n_bins, tiles, vec);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  scan_kernel<<<n_bins, kThreads, 0, s>>>(scratch, counts, tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || (tiles == 0 && out == nullptr)) {
    return static_cast<int>(err);
  }
  const size_t smem = scatter_smem(n_bins);
  err = cudaFuncSetAttribute(scatter_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  scatter_kernel<<<tiles > 0 ? tiles : 1, kThreads, smem, s>>>(
      ids, scratch, counts, out, ranks, n, n_bins, tiles, n_write, pad, div,
      out_size, vec);
  return static_cast<int>(cudaGetLastError());
}

// out[4]: resident blocks per SM of one of the three kernels (0 count,
// 1 scan, 2 scatter) at n_bins bins, threads per block, registers per
// thread, shared bytes per block. Returns a cudaError_t (0 on success).
int rt2_bin_scatter_occupancy(int kernel, int n_bins, int* out) {
  if (kernel < 0 || kernel > 2 || n_bins < 1 || n_bins > kMaxBins) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* fn = kernel == 0   ? reinterpret_cast<const void*>(count_kernel)
                   : kernel == 1 ? reinterpret_cast<const void*>(scan_kernel)
                                 : reinterpret_cast<const void*>(
                                       scatter_kernel);
  const size_t smem = kernel == 0   ? sizeof(int) * n_bins
                      : kernel == 1 ? 0
                                    : scatter_smem(n_bins);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (kernel == 2) {  // the one that may need more than 48 KB (set anew
    // at each launch; the other two keep the default limit)
    err = cudaFuncSetAttribute(fn,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads,
                                                      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = blocks;
  out[1] = kThreads;
  out[2] = attr.numRegs;
  out[3] = static_cast<int>(attr.sharedSizeBytes + smem);
  return 0;
}

}  // extern "C"
