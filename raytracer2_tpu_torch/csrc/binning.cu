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
// is the exclusive scan over bins of the bin counts rounded up to `pad`.
//
// A cursor bumped by an atomic would hand out slots in the order the threads
// happen to run, which changes from run to run. The rank is computed instead,
// so the output equals a stable sort's on every run:
// 1. count_kernel: one block per tile of kTile consecutive elements counts
//    its ids in a shared-memory histogram (atomic counts do not depend on
//    order) and writes counts[bin][tile];
// 2. scan_kernel: one block per bin turns its row into an exclusive scan
//    over tiles (the rank of the tile's first element of that bin) and
//    writes the bin's total;
// 3. scatter_kernel: one block per tile scans the padded totals into the
//    bin bases, then walks its tile in rounds of 256 elements (8 warps of
//    32): __match_any_sync gives the lanes of a warp that share an id,
//    __popc(peers & lanes below) the rank inside the warp, and per-warp
//    counts per bin in shared memory, summed over the round's earlier warps
//    and over the tile's earlier rounds, give the rest. It writes the
//    payload and, when asked, the rank itself (the probe's output).
// An id outside [0, n_bins) belongs to no bin: it is not counted, gets rank
// -1 and stores nothing.
//
// What bounds it: the bytes. The ids are read twice (count, scatter) and
// the payload written once to a data-dependent slot; the arithmetic is a
// few integer operations per element. The bound counts the ids read once
// and the output written once. The scatter's stores land in runs (the
// elements of one bin in one tile go to consecutive slots), so most are
// partly coalesced. Later work: fuse the count into the pass that makes the
// ids, and keep the tile's ids in shared memory between the passes.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 4096;     // elements per block (16 rounds of 256)
constexpr int kMaxBins = 1024;  // (2 + kWarps) * 4 KB of shared memory

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

// the range [lo, hi) of `count` items that thread threadIdx.x takes
__device__ __forceinline__ void thread_range(int count, int& lo, int& hi) {
  const int per = (count + kThreads - 1) / kThreads;
  lo = min(count, static_cast<int>(threadIdx.x) * per);
  hi = min(count, lo + per);
}

__global__ void __launch_bounds__(kThreads)
count_kernel(const int* __restrict__ ids, int* __restrict__ counts,
             long long n, int n_bins, int tiles) {
  extern __shared__ int hist[];  // [n_bins]
  for (int b = threadIdx.x; b < n_bins; b += kThreads) hist[b] = 0;
  __syncthreads();
  const long long t0 = static_cast<long long>(blockIdx.x) * kTile;
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const long long j = t0 + i;
    if (j >= n) break;
    const int id = ids[j];
    if (id >= 0 && id < n_bins) atomicAdd(&hist[id], 1);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < n_bins; b += kThreads) {
    counts[static_cast<long long>(b) * tiles + blockIdx.x] = hist[b];
  }
}

__global__ void __launch_bounds__(kThreads)
scan_kernel(int* __restrict__ counts, int* __restrict__ totals, int tiles) {
  __shared__ int warp_sums[kWarps];
  int* row = counts + static_cast<long long>(blockIdx.x) * tiles;
  int lo, hi;
  thread_range(tiles, lo, hi);
  int sum = 0;
  for (int t = lo; t < hi; ++t) sum += row[t];
  int total;
  int run = block_exclusive_scan(sum, warp_sums, total);
  for (int t = lo; t < hi; ++t) {
    const int c = row[t];
    row[t] = run;
    run += c;
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kThreads)
scatter_kernel(const int* __restrict__ ids, const int* __restrict__ offsets,
               const int* __restrict__ totals, int* __restrict__ out,
               int* __restrict__ ranks, long long n, int n_bins, int tiles,
               int n_write, int pad, int div, long long out_size) {
  extern __shared__ int smem[];
  int* base = smem;                      // [n_bins] padded bin bases
  int* running = base + n_bins;          // [n_bins] rank of the next element
  int* warp_cnt = running + n_bins;      // [kWarps][n_bins]
  __shared__ int warp_sums[kWarps];
  const int tile = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  int lo, hi;
  thread_range(n_bins, lo, hi);
  int sum = 0;
  for (int b = lo; b < hi; ++b) sum += (totals[b] + pad - 1) / pad * pad;
  int total;
  int run = block_exclusive_scan(sum, warp_sums, total);
  for (int b = lo; b < hi; ++b) {
    base[b] = run;
    run += (totals[b] + pad - 1) / pad * pad;
    running[b] = offsets[static_cast<long long>(b) * tiles + tile];
  }
  for (int i = threadIdx.x; i < kWarps * n_bins; i += kThreads) {
    warp_cnt[i] = 0;
  }
  __syncthreads();

  const unsigned below = (1u << lane) - 1u;
  for (int r0 = 0; r0 < kTile; r0 += kThreads) {
    const long long j = static_cast<long long>(tile) * kTile + r0 +
                        threadIdx.x;
    int id = -1;
    if (j < n) {
      id = ids[j];
      if (id < 0 || id >= n_bins) id = -1;
    }
    const unsigned peers = __match_any_sync(0xffffffffu, id);
    const int lane_rank = __popc(peers & below);
    const int cnt = __popc(peers);
    const bool leader = id >= 0 && lane_rank == 0;
    if (leader) warp_cnt[warp * n_bins + id] = cnt;
    __syncthreads();
    int rank = -1;
    if (id >= 0) {
      rank = running[id] + lane_rank;
      for (int w = 0; w < warp; ++w) rank += warp_cnt[w * n_bins + id];
    }
    __syncthreads();  // every read of running and warp_cnt is done
    if (leader) {
      atomicAdd(&running[id], cnt);
      warp_cnt[warp * n_bins + id] = 0;
    }
    if (j < n) {
      if (ranks != nullptr) ranks[j] = rank;
      if (out != nullptr && id >= 0 && id < n_write) {
        const long long slot = static_cast<long long>(base[id]) + rank;
        if (slot < out_size) out[slot] = static_cast<int>(j / div);
      }
    }
    __syncthreads();  // the next round's counts start from these
  }
}

}  // namespace

extern "C" {

// ids [n] i32; scratch [n_bins * ceil(n / 4096)] i32; counts [n_bins] i32
// (out); out [out_size] i32, filled with -1 by the caller, or null; ranks
// [n] i32 or null. Launches the three kernels on `stream` and returns
// cudaGetLastError() (0 on success).
int rt2_bin_scatter(const int* ids, int* scratch, int* counts, int* out,
                    int* ranks, long long n, int n_bins, int n_write, int pad,
                    int div, long long out_size, void* stream) {
  if (n < 0 || n_bins < 1 || n_bins > kMaxBins || pad < 1 || div < 1 ||
      n_write < 0 || n_write > n_bins || out_size < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long tiles_ll = (n + kTile - 1) / kTile;
  if (tiles_ll > 0x7fffffffLL / kMaxBins) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles = static_cast<int>(tiles_ll);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tiles > 0) {
    count_kernel<<<tiles, kThreads, sizeof(int) * n_bins, s>>>(
        ids, scratch, n, n_bins, tiles);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  scan_kernel<<<n_bins, kThreads, 0, s>>>(scratch, counts, tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || tiles == 0) return static_cast<int>(err);
  scatter_kernel<<<tiles, kThreads, sizeof(int) * (2 + kWarps) * n_bins,
                   s>>>(ids, scratch, counts, out, ranks, n, n_bins, tiles,
                        n_write, pad, div, out_size);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
