// Quorum commit scan for Hopper (sm_90a), batched over scan instances.
// Two entry points share the scan's device code:
//
// commit_scan_launch — the one-to-one counterpart of the TPU kernel
// rdma_paxos_tpu/ops/quorum.py:commit_scan_pallas (pl.pallas_call at
// quorum.py:144, body _kernel, math _scan_math): for each instance n,
// with ack[j, r] = ends[r] > commit + j, count each row under the u32
// member bitmasks, take the contiguous prefix of rows with
// cnt_new >= maj_new, commit + j < my_end and (transit <= 0 or
// cnt_old >= maj_old), then apply the Raft current-term guard:
//   out[n] = commit + 1 + max{j < prefix : terms[j] == my_term}, else commit.
//
//   ends  [N, ends_stride] i32  gathered ack offsets (R_PAD = 128 columns,
//                               padding columns 0)
//   terms [N, W] i32            terms of entries commit .. commit + W - 1
//   scal  [N, 8] i32            commit, my_term, my_end, bm_old, bm_new,
//                               transit, maj_old, maj_new (bitmasks as the
//                               u32 bit pattern)
//   out   [N] i32
//
// commit_window_launch — what the replica step runs: commit_scan_pallas
// plus the JAX step's phase-F/G window code around it
// (rdma_paxos_tpu/consensus/step.py:744-803: the ack gather, the window's
// term column, the scan, the leader's commit select, and the
// commit-crossing CONFIG search `crossed` / `_lex_argmax`). Per instance n
// (N = G x R: G groups of R = n_rep replicas; or, with ack_rows set, N
// instances each holding its own row of R gathered acks: the one replica
// of a process-group step, or a device-list entry's rows of N groups):
//   acks[r]  = peer_acked[n, r] ? my_ack[(ack_rows ? n : n / R) * R + r]
//                               : 0
//   scanned  = the commit scan above over acks, with the terms read from
//              the ring rows commit + j, j < W
//   commit2  = i_lead[n] ? max(commit, scanned) : commit1[n]
//   xpos     = the j < W with the largest signed g = commit + j among rows
//              with type == CONFIG, gidx == g and g < commit2; else -1
//   out[0, n] = commit2, out[1, n] = xpos
//
//   buf  [N, n_slots, row_w] i32  the fused log ring, read in place: row
//        g sits at slot g & (n_slots - 1); its metadata words start at
//        column meta_off (M_TYPE, M_TERM, M_GIDX at +0, +1, +5)
//   peer_acked [N, R] bool, my_ack [N] i32 ([N * R] with ack_rows),
//   i_lead [N] bool,
//   commit/my_term/my_end/transit/maj_old/maj_new/commit1 [N] i32,
//   bm_old/bm_new [N] int64 holding a u32 (the low 32 bits are read)
//
// What bounds them: bytes, and at the main path's sizes the launch. The
// window kernel needs three words of each of W ring rows (one 32-byte
// sector per row, since a row's metadata is 32 bytes): at N = 3, W = 2048
// that is 74 KB, nanoseconds of the card's memory time, so one launch is
// the cost; at N = 192 (64 groups) it is 4.7 MB, about 1.4 us. The design
// is a single pass for that reason: one launch for every instance of the
// step, one block per instance, each ring row read once. Threads stride
// over rows; each row's counts are __popc of a 32-bit ack ballot built
// from the acks in shared memory, and warp ballots leave two bits per row
// in shared memory (term == my_term; a CONFIG row stamped with its own
// index). The prefix is a block-wide min, then the term guard and the
// crossing search read only those bits: no scratch in device memory, no
// second pass over the ring, and none of the PyTorch launches the same
// work costs around the scan (39 a step at the main path's shapes).
//
// Semantics held exactly against XLA:
//  * bm >> r for r >= 32 is 0 under XLA's u32 shift; here only the 32
//    columns a u32 bitmask can name are ever read, so no shift reaches 32.
//  * commit + j wraps in i32 under XLA; here the sum is taken in unsigned
//    arithmetic and cast back, never as signed overflow. Comparisons on
//    g are signed, as XLA's are; the ring slot is g's low bits.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMemberBits = 32;  // a u32 bitmask names columns 0..31 only
// metadata columns of a ring row, after meta_off (consensus/log.py)
constexpr int kMetaW = 8, kType = 0, kTerm = 1, kGidx = 5;
constexpr int kConfig = 5;       // EntryType.CONFIG
constexpr size_t kDefaultSmem = 48 * 1024;

// 32-bit words of one per-row bit array of the window kernel
__host__ __device__ __forceinline__ int window_words(int w) {
  return (w + kThreads - 1) / kThreads * kWarps;
}

__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) +
                          static_cast<unsigned>(b));
}

template <typename T, bool kMax>
__device__ __forceinline__ T block_reduce(T v, T* red) {
  for (int o = 16; o > 0; o >>= 1) {
    const T u = __shfl_xor_sync(0xffffffffu, v, o);
    v = kMax ? max(v, u) : min(v, u);
  }
  __syncthreads();  // red may still be read by an earlier reduction
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) v = kMax ? max(v, red[i]) : min(v, red[i]);
  return v;
}

struct Quorum {
  int commit, my_end, transit, maj_old, maj_new;
  unsigned bm_old, bm_new;
};

// Whether row j of the window is acked by both quorums and below my_end.
__device__ __forceinline__ bool row_ok(const Quorum& q, const int* s_ends,
                                       int g) {
  unsigned ack = 0;
#pragma unroll
  for (int r = 0; r < kMemberBits; ++r)
    ack |= static_cast<unsigned>(s_ends[r] > g) << r;
  return __popc(ack & q.bm_new) >= q.maj_new && g < q.my_end &&
         (q.transit <= 0 || __popc(ack & q.bm_old) >= q.maj_old);
}

__global__ void __launch_bounds__(kThreads)
commit_scan_kernel(const int* __restrict__ ends, const int* __restrict__ terms,
                   const int* __restrict__ scal, int* __restrict__ out,
                   int w, int ends_stride) {
  __shared__ int s_ends[kMemberBits];
  __shared__ int s_red[kWarps];
  const int n = blockIdx.x;
  const int* s = scal + static_cast<size_t>(n) * 8;
  const int my_term = s[1];
  const Quorum q{s[0], s[2], s[5], s[6], s[7], static_cast<unsigned>(s[3]),
                 static_cast<unsigned>(s[4])};
  if (threadIdx.x < kMemberBits)
    s_ends[threadIdx.x] = ends[static_cast<size_t>(n) * ends_stride + threadIdx.x];
  __syncthreads();

  // pass 1: the committed prefix ends at the first failing row. Each
  // thread's rows ascend, so its first failure is its smallest one.
  int first_fail = w;
  for (int j = threadIdx.x; j < w; j += kThreads) {
    if (!row_ok(q, s_ends, wrap_add(q.commit, j))) {
      first_fail = j;
      break;
    }
  }
  const int prefix = block_reduce<int, false>(first_fail, s_red);

  // pass 2: the term guard — last current-term row inside the prefix
  const int* t = terms + static_cast<size_t>(n) * w;
  int last = -1;
  for (int j = threadIdx.x; j < prefix; j += kThreads)
    if (t[j] == my_term) last = j;
  last = block_reduce<int, true>(last, s_red);
  if (threadIdx.x == 0)
    out[n] = last >= 0 ? wrap_add(wrap_add(q.commit, last), 1) : q.commit;
}

__global__ void __launch_bounds__(kThreads)
commit_window_kernel(const int* __restrict__ buf,
                     const bool* __restrict__ peer_acked,
                     const int* __restrict__ my_ack,
                     const int* __restrict__ commit_v,
                     const int* __restrict__ my_term_v,
                     const int* __restrict__ my_end_v,
                     const long long* __restrict__ bm_old_v,
                     const long long* __restrict__ bm_new_v,
                     const int* __restrict__ transit_v,
                     const int* __restrict__ maj_old_v,
                     const int* __restrict__ maj_new_v,
                     const bool* __restrict__ i_lead_v,
                     const int* __restrict__ commit1_v,
                     int* __restrict__ out, int n_inst, int n_rep, int w,
                     int n_slots, int row_w, int meta_off, int ack_rows) {
  // two bits per window row, one word per 32 rows: s_bits[k] holds
  // term == my_term, s_bits[n_words + k] "CONFIG stamped with its index"
  extern __shared__ unsigned s_bits[];
  __shared__ int s_ends[kMemberBits];
  __shared__ int s_red[kWarps];
  __shared__ long long s_red64[kWarps];
  const int n = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_words = window_words(w);
  unsigned* s_term = s_bits;
  unsigned* s_cfg = s_bits + n_words;
  const int my_term = my_term_v[n];
  const Quorum q{commit_v[n], my_end_v[n], transit_v[n], maj_old_v[n],
                 maj_new_v[n], static_cast<unsigned>(bm_old_v[n]),
                 static_cast<unsigned>(bm_new_v[n])};
  if (threadIdx.x < kMemberBits) {
    const int r = threadIdx.x;
    s_ends[r] = r < n_rep && peer_acked[static_cast<size_t>(n) * n_rep + r]
                    ? my_ack[(ack_rows ? n : n / n_rep) * n_rep + r]
                    : 0;
  }
  __syncthreads();

  // the one pass over the ring: every row's ack test, its metadata words
  // and the two ballots. Each thread's rows ascend, so its first failure
  // is its smallest one.
  const int* ring = buf + static_cast<size_t>(n) * n_slots * row_w + meta_off;
  const unsigned slot_mask = static_cast<unsigned>(n_slots) - 1u;
  int first_fail = w;
  for (int base = 0; base < w; base += kThreads) {
    const int j = base + threadIdx.x;
    bool term_hit = false, cfg_hit = false;
    if (j < w) {
      const int g = wrap_add(q.commit, j);
      if (first_fail == w && !row_ok(q, s_ends, g)) first_fail = j;
      const int* m = ring + static_cast<size_t>(static_cast<unsigned>(g) &
                                                slot_mask) * row_w;
      term_hit = __ldg(m + kTerm) == my_term;
      cfg_hit = __ldg(m + kType) == kConfig && __ldg(m + kGidx) == g;
    }
    const unsigned tb = __ballot_sync(0xffffffffu, term_hit);
    const unsigned cb = __ballot_sync(0xffffffffu, cfg_hit);
    if (lane == 0) {
      s_term[base / 32 + warp] = tb;
      s_cfg[base / 32 + warp] = cb;
    }
  }
  // (the reduction's barriers also publish the ballot words)
  const int prefix = block_reduce<int, false>(first_fail, s_red);

  // the term guard: last current-term row inside the prefix
  int last = -1;
  for (int k = threadIdx.x; k * 32 < prefix; k += kThreads) {
    unsigned b = s_term[k];
    const int rest = prefix - k * 32;
    if (rest < 32) b &= (1u << rest) - 1u;
    if (b) last = k * 32 + 31 - __clz(b);
  }
  last = block_reduce<int, true>(last, s_red);
  const int scanned =
      last >= 0 ? wrap_add(wrap_add(q.commit, last), 1) : q.commit;
  const int commit2 = i_lead_v[n] ? max(q.commit, scanned) : commit1_v[n];

  // the commit-crossing CONFIG: the largest signed g below commit2. The
  // W indices g are distinct, so the largest g names one row.
  long long best = LLONG_MIN;
  for (int k = threadIdx.x; k < n_words; k += kThreads) {
    for (unsigned b = s_cfg[k]; b; b &= b - 1u) {
      const int g = wrap_add(q.commit, k * 32 + __ffs(b) - 1);
      if (g < commit2) best = max(best, static_cast<long long>(g));
    }
  }
  best = block_reduce<long long, true>(best, s_red64);
  if (threadIdx.x == 0) {
    out[n] = commit2;
    out[n_inst + n] =
        best == LLONG_MIN
            ? -1
            : static_cast<int>(static_cast<unsigned>(best) -
                               static_cast<unsigned>(q.commit));
  }
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

// Same contract; out is [2, n]: commit2, then xpos.
extern "C" int commit_window_launch(
    const int* buf, const bool* peer_acked, const int* my_ack,
    const int* commit, const int* my_term, const int* my_end,
    const long long* bm_old, const long long* bm_new, const int* transit,
    const int* maj_old, const int* maj_new, const bool* i_lead,
    const int* commit1, int* out, int n, int n_rep, int w, int n_slots,
    int row_w, int meta_off, int ack_rows, void* stream) {
  if (n <= 0) return 0;
  if (w <= 0 || n_rep <= 0 || (n % n_rep != 0 && !ack_rows) ||
      n_slots <= 0 || (n_slots & (n_slots - 1)) != 0 || meta_off < 0 ||
      meta_off + kMetaW > row_w)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 2 * static_cast<size_t>(window_words(w)) *
                      sizeof(unsigned);
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        commit_window_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  commit_window_kernel<<<n, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      buf, peer_acked, my_ack, commit, my_term, my_end, bm_old, bm_new,
      transit, maj_old, maj_new, i_lead, commit1, out, n, n_rep, w, n_slots,
      row_w, meta_off, ack_rows);
  return static_cast<int>(cudaGetLastError());
}
