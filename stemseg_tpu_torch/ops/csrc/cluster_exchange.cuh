// The cross-block protocol of the persistent clustering kernels (cluster.cu):
// one block per SM, each owning a contiguous slice of the points, agree on
// every iteration's seed through one exchange of small records.
//
// A block's candidate for iteration s is the 64-bit first-occurrence key
// (order-preserving bits of the seediness) << 32 | (0xFFFFFFFF - index) of
// its best available point, 0 when it has none. Its record holds that key
// and the candidate's centre and bandwidth, which the owning block gathers
// after it has written the key. The max of the keys does not depend on the
// order of the records, so the seed is deterministic.
//
// Records are vectors of 16 bytes, two 8-byte words each, every word
// (32-bit payload << 32 | 32-bit tag); the tag is (nonce << 6 | s + 1) of
// the writing launch's nonce and iteration, never 0. A reader takes a
// vector when both its words carry the tag it expects, so a record needs
// no fence, no flag and no per-launch zeroing. This relies on the records'
// workspace holding nothing but zeros and words these kernels wrote: the
// caller zeroes it once when it allocates it and then passes it to these
// kernels alone, one launch after another. Zeros never match a tag, and
// words of earlier iterations or launches never match either (nonces are
// unique per launch until they wrap at 2^26 launches, and every launch
// rewrites the records it reads).
//
// The nonce lives on the device, so that a launch replayed from a CUDA graph
// gets a new one as a launch queued from the host does: the workspace starts
// with a 64-bit launch counter (kCounterBytes, then the records). Every
// thread reads it at the start of the launch and takes counter + 1; block 0
// writes that value back at the end of the launch. By then every block has
// read the counter: each read it before publishing its first record, and
// block 0 has read every block's record of the last iteration.
//   vector 0: key low, key high;  vector 1 + e: centre[e], bandwidth[e].
//
// The exchange has two hops. Block 0 is the leader: it polls every block's
// record, reduces the keys, polls the winner's data vectors and writes one
// decision record, which every other block polls. Only the leader reads the
// block records, and the other blocks read one record, so no L2 line is
// polled by more than one block per hop but the decision's.
// Records are double-buffered by the parity of s: a block overwrites buffer
// s & 1 only after it has read the decision of s - 1, which the leader
// wrote after reading every record of s - 1; and each block wrote its
// record of s - 1 after reading the decision of s - 2.

#pragma once

#include <cuda_runtime.h>

namespace stemseg {

constexpr int kThreads = 1024;      // threads of every block
constexpr int kMaxReadWarps = 8;    // records read one per thread: <= 256 blocks
constexpr int kFixedSmem = 4096;    // bytes of Fixed<E> reserved, E <= 8
constexpr int kPad = 32;            // meta rows
constexpr int kCounterBytes = 16;   // the launch counter, before the records

template <int E>
struct alignas(16) Record {
  unsigned long long w[2 * (E + 1)];
};

template <int E>
struct Winner {
  unsigned long long key;
  float c[E];
  float b[E];
};

// The fixed part of a block's shared memory.
template <int E>
struct Fixed {
  unsigned long long red[32];             // block reduction, one per warp
  unsigned long long wkey[kMaxReadWarps]; // exchange: best key per reading warp
  int wsrc[kMaxReadWarps];                //   and its record
  Winner<E> win;                          // the decided seed
  int cnt[2];                             // cluster.cu: lengths of the point lists
  float meta_c[kPad][E];                  // centre, bandwidth and seed
  float meta_b[kPad][E];                  // probability of every active
  float meta_s[kPad];                     // iteration, for the meta output
};
static_assert(sizeof(Fixed<8>) <= kFixedSmem, "kFixedSmem too small");

__device__ __forceinline__ unsigned int ordered_bits(float f) {
  const unsigned int u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_ordered(unsigned int o) {
  return __uint_as_float((o & 0x80000000u) ? (o ^ 0x80000000u) : ~o);
}

__device__ __forceinline__ unsigned long long point_key(float seed, unsigned int idx) {
  return ((unsigned long long)ordered_bits(seed) << 32) |
         (unsigned long long)(0xFFFFFFFFu - idx);
}

__device__ __forceinline__ unsigned int key_index(unsigned long long key) {
  return 0xFFFFFFFFu - (unsigned int)(key & 0xFFFFFFFFull);
}

__device__ __forceinline__ float key_score(unsigned long long key) {
  return from_ordered((unsigned int)(key >> 32));
}

// The records of a workspace (after its launch counter).
template <int E>
__device__ __forceinline__ Record<E>* exchange_records(void* workspace) {
  return reinterpret_cast<Record<E>*>(static_cast<unsigned char*>(workspace) + kCounterBytes);
}

// This launch's nonce: one more than the launches counted on the workspace.
__device__ __forceinline__ unsigned long long launch_nonce(const unsigned long long* counter) {
  unsigned long long c;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(c) : "l"(counter) : "memory");
  return c + 1;
}

// Block 0, once every exchange of the launch is done: counts the launch.
__device__ __forceinline__ void end_launch(unsigned long long* counter, unsigned long long nonce) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(counter), "l"(nonce) : "memory");
}

__device__ __forceinline__ unsigned int record_tag(unsigned long long nonce, int s) {
  return (unsigned int)((nonce << 6) | (unsigned long long)(s + 1));
}

__device__ __forceinline__ unsigned long long word(unsigned int payload, unsigned int tag) {
  return ((unsigned long long)payload << 32) | tag;
}

__device__ __forceinline__ unsigned int payload(unsigned long long w) {
  return (unsigned int)(w >> 32);
}

__device__ __forceinline__ void store_vec(unsigned long long* p, unsigned long long a,
                                          unsigned long long b) {
  asm volatile("st.relaxed.gpu.global.v2.u64 [%0], {%1, %2};" ::"l"(p), "l"(a), "l"(b)
               : "memory");
}

// Polls vector p until both words carry `tag`.
__device__ __forceinline__ void poll_vec(const unsigned long long* p, unsigned int tag,
                                         unsigned long long& a, unsigned long long& b) {
  do {
    asm volatile("ld.relaxed.gpu.global.v2.u64 {%0, %1}, [%2];"
                 : "=l"(a), "=l"(b)
                 : "l"(p)
                 : "memory");
  } while ((unsigned int)a != tag || (unsigned int)b != tag);
}

__device__ __forceinline__ void cp_async4(void* smem_dst, const void* gmem_src) {
  const unsigned int dst = static_cast<unsigned int>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst), "l"(gmem_src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ unsigned long long warp_max(unsigned long long v) {
  const unsigned int hi = __reduce_max_sync(0xffffffffu, (unsigned int)(v >> 32));
  const unsigned int lo =
      __reduce_max_sync(0xffffffffu, (unsigned int)(v >> 32) == hi ? (unsigned int)v : 0u);
  return ((unsigned long long)hi << 32) | lo;
}

// Max of v over the block; the result is valid in every lane of warp 0.
__device__ __forceinline__ unsigned long long block_max(unsigned long long v,
                                                        unsigned long long* red) {
  v = warp_max(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x < 32) {
    v = warp_max(threadIdx.x < (blockDim.x >> 5) ? red[threadIdx.x] : 0ull);
  }
  return v;
}

// Warp 0, after block_max: writes the block's record. Lane 0 writes the key
// at once; lanes 1..E fetch the candidate's centre and bandwidth through
// cand(e, &c, &b) and write them after.
template <int E, class Cand>
__device__ __forceinline__ void publish(Record<E>* rec, unsigned int tag,
                                        unsigned long long key, Cand cand) {
  const int lane = threadIdx.x & 31;
  if (lane == 0) {
    store_vec(rec->w, word((unsigned int)key, tag), word((unsigned int)(key >> 32), tag));
  } else if (lane <= E) {
    float c = 0.0f, b = 0.0f;
    if (key != 0ull) cand(lane - 1, &c, &b);
    store_vec(rec->w + 2 * lane, word(__float_as_uint(c), tag), word(__float_as_uint(b), tag));
  }
}

// The leader's threads i < nblocks read the key of record i; the best key
// and its record index land in fx->wkey / fx->wsrc (one per reading warp).
template <int E>
__device__ __forceinline__ int reduce_records(const Record<E>* recs, int nblocks,
                                              unsigned int tag, Fixed<E>* fx) {
  const int i = threadIdx.x;
  const int n_warps = (nblocks + 31) >> 5;
  if ((i >> 5) < n_warps) {
    unsigned long long key = 0ull;
    if (i < nblocks) {
      unsigned long long a, b;
      poll_vec(recs[i].w, tag, a, b);
      key = ((unsigned long long)payload(b) << 32) | payload(a);
    }
    const unsigned long long best = warp_max(key);
    // the keys are distinct unless 0, and the records of key 0 are equal
    const unsigned int hit = __ballot_sync(0xffffffffu, key == best);
    if ((i & 31) == 0) {
      fx->wkey[i >> 5] = best;
      fx->wsrc[i >> 5] = (i & ~31) + __ffs(hit) - 1;
    }
  }
  __syncthreads();
  int w = 0;
  for (int q = 1; q < n_warps; ++q)
    if (fx->wkey[q] > fx->wkey[w]) w = q;
  return fx->wsrc[w];
}

// Lanes 0..E of warp 0: vector `lane` of record `rec` into fx->win (and,
// for the leader, into the decision record).
template <int E>
__device__ __forceinline__ void take_vec(const Record<E>* rec, unsigned int tag,
                                         Fixed<E>* fx, Record<E>* forward) {
  const int lane = threadIdx.x & 31;
  if (lane > E) return;
  unsigned long long a, b;
  poll_vec(rec->w + 2 * lane, tag, a, b);
  if (forward != nullptr) store_vec(forward->w + 2 * lane, a, b);
  if (lane == 0) {
    fx->win.key = ((unsigned long long)payload(b) << 32) | payload(a);
  } else {
    fx->win.c[lane - 1] = __uint_as_float(payload(a));
    fx->win.b[lane - 1] = __uint_as_float(payload(b));
  }
}

// All threads of the block, after warp 0 has published its record into
// `recs` (this iteration's buffer; `decision` likewise). Returns with the
// winner in fx->win, the same in every block.
template <int E>
__device__ __forceinline__ void exchange(const Record<E>* recs, Record<E>* decision,
                                         int nblocks, unsigned int tag, Fixed<E>* fx) {
  if (blockIdx.x == 0) {
    const int src = reduce_records(recs, nblocks, tag, fx);
    if (threadIdx.x < 32) take_vec<E>(recs + src, tag, fx, decision);
  } else if (threadIdx.x < 32) {
    take_vec<E>(decision, tag, fx, nullptr);
  }
  __syncthreads();
}

}  // namespace stemseg
