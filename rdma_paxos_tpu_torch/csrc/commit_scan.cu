// Quorum commit scan for Hopper (sm_90a), batched over scan instances.
//
// Replaces the TPU kernel rdma_paxos_tpu/ops/quorum.py:commit_scan_pallas
// (pl.pallas_call at quorum.py:144, body _kernel, math _scan_math): for
// each instance n, with ack[j, r] = ends[r] > commit + j, count each row
// under the u32 member bitmasks, take the contiguous prefix of rows with
// cnt_new >= maj_new, commit + j < my_end and (transit <= 0 or
// cnt_old >= maj_old), then apply the Raft current-term guard:
//   out[n] = commit + 1 + max{j < prefix : terms[j] == my_term}, else commit.
//
// Layout (all int32, row-major, contiguous):
//   ends  [N, ends_stride]  gathered ack offsets (R_PAD = 128 columns,
//                           padding columns 0)
//   terms [N, W]            terms of entries commit .. commit + W - 1
//   scal  [N, 8]            commit, my_term, my_end, bm_old, bm_new,
//                           transit, maj_old, maj_new (bitmasks as the
//                           u32 bit pattern)
//   out   [N]
//
// What bounds it: the work is tiny. At the main path's shapes (N = R = 3
// replicas, W = 2048) the inputs are N * (128 + 2048 + 8) * 4 bytes, about
// 26 KB, and the output 12 bytes, so the card's memory moves it in
// nanoseconds; the time is the launch. The design does the whole step's
// scan in ONE launch (every replica instance of the step, later G x R),
// one block per instance, no scratch in device memory and no second pass:
// threads stride over rows j, each row's counts are __popc of a 32-bit ack
// ballot built from the ends in shared memory, the prefix is a block-wide
// min, the term guard a block-wide max.
//
// Semantics held exactly against XLA:
//  * bm >> r for r >= 32 is 0 under XLA's u32 shift; here only the 32
//    columns a u32 bitmask can name are ever read, so no shift reaches 32.
//  * commit + j wraps in i32 under XLA; here the sum is taken in unsigned
//    arithmetic and cast back, never as signed overflow.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMemberBits = 32;  // a u32 bitmask names columns 0..31 only

__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) +
                          static_cast<unsigned>(b));
}

__device__ __forceinline__ int block_min(int v, int* red) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();  // red may still be read by an earlier reduction
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) v = min(v, red[i]);
  return v;
}

__device__ __forceinline__ int block_max(int v, int* red) {
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) v = max(v, red[i]);
  return v;
}

__global__ void __launch_bounds__(kThreads)
commit_scan_kernel(const int* __restrict__ ends, const int* __restrict__ terms,
                   const int* __restrict__ scal, int* __restrict__ out,
                   int w, int ends_stride) {
  __shared__ int s_ends[kMemberBits];
  __shared__ int s_red[kWarps];
  const int n = blockIdx.x;
  const int* s = scal + static_cast<size_t>(n) * 8;
  const int commit = s[0], my_term = s[1], my_end = s[2];
  const unsigned bm_old = static_cast<unsigned>(s[3]);
  const unsigned bm_new = static_cast<unsigned>(s[4]);
  const int transit = s[5], maj_old = s[6], maj_new = s[7];
  if (threadIdx.x < kMemberBits)
    s_ends[threadIdx.x] = ends[static_cast<size_t>(n) * ends_stride + threadIdx.x];
  __syncthreads();

  // pass 1: the committed prefix ends at the first failing row. Each
  // thread's rows ascend, so its first failure is its smallest one.
  int first_fail = w;
  for (int j = threadIdx.x; j < w; j += kThreads) {
    const int g = wrap_add(commit, j);
    unsigned ack = 0;
#pragma unroll
    for (int r = 0; r < kMemberBits; ++r)
      ack |= static_cast<unsigned>(s_ends[r] > g) << r;
    const int cnt_new = __popc(ack & bm_new);
    const int cnt_old = __popc(ack & bm_old);
    const bool ok = cnt_new >= maj_new && g < my_end &&
                    (transit <= 0 || cnt_old >= maj_old);
    if (!ok) {
      first_fail = j;
      break;
    }
  }
  const int prefix = block_min(first_fail, s_red);

  // pass 2: the term guard — last current-term row inside the prefix
  const int* t = terms + static_cast<size_t>(n) * w;
  int last = -1;
  for (int j = threadIdx.x; j < prefix; j += kThreads)
    if (t[j] == my_term) last = j;
  last = block_max(last, s_red);
  if (threadIdx.x == 0)
    out[n] = last >= 0 ? wrap_add(wrap_add(commit, last), 1) : commit;
}

}  // namespace

// Launch on `stream` (the caller's current stream). Returns the
// cudaGetLastError() code after the launch (0 = launched).
extern "C" int commit_scan_launch(const int* ends, const int* terms,
                                  const int* scal, int* out, int n, int w,
                                  int ends_stride, void* stream) {
  if (n <= 0) return 0;
  if (w <= 0 || ends_stride < kMemberBits)
    return static_cast<int>(cudaErrorInvalidValue);
  commit_scan_kernel<<<n, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      ends, terms, scal, out, w, ends_stride);
  return static_cast<int>(cudaGetLastError());
}
