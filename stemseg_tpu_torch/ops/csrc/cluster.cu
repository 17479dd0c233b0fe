// Sequential seeded clustering of one window's points, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of stemseg_tpu/ops/cluster_pallas.py:
//   * cluster_points_single <- _cluster_kernel (:103), the VMEM-resident
//     single-block kernel, chosen for windows whose state fits 14 MB
//     (207,360 points for a 480p 8-frame DAVIS window);
//   * cluster_points_tiled  <- _cluster_kernel_tiled (:300), the tiled
//     HBM-streaming kernel (878,592 points for the 704x1248 16-frame DAVIS
//     window of the CLI's default preset; any count up to 16 M).
// Both compute exactly clustering._cluster of the JAX package: K sequential
// iterations, each seeding at the first-occurrence argmax of seediness over
// the unassigned fg points (sticky stop below min_seediness), taking the
// seed pixel's own centre and bandwidth, assigning exp(-0.5 d) > primary
// with d = sqrt(sum_e (x_e - c_e)^2 bw_e), and keeping a running farthest
// ("reference") or nearest distance per point; then the secondary pass,
// gated by the availability mask of the last executed iteration.
//
// Bound on this card: memory. Per point the function reads E embedding
// floats, E bandwidth floats, the seediness and the fg byte, and writes one
// label: about 41 B per point at E = 4, against about 10 flops per point
// and iteration. What the design spends instead is latency: K sequential
// grid-wide decisions.
//
// Design: one persistent cooperative launch of kThreads-thread blocks, one
// per SM, each block owning a contiguous slice of the points; the blocks agree on each seed
// through the record exchange of cluster_exchange.cuh (one exchange per
// executed iteration, O(1) decoding: the decided loop state is carried in
// registers). Sweep s applies iteration s - 1 and accumulates the block's
// candidate for iteration s. A block keeps the list of its available points
// (fg, not yet assigned; double-buffered local indices, built by
// warp-aggregated appends in any order, which no result depends on), so a
// sweep visits only those, in coherent warps. Per listed point the state is
// its best distance (f32) and best cluster (int8); the best distance is only
// ever read for points that were available in every executed iteration, so
// it is only kept for listed points. A point's label is written when it is
// assigned (background at the start); the secondary pass needs only scalars
// known once the last executed iteration is decided, so it runs in the
// sweep after that decision, over the list of points available at its start
// (the stale mask), and needs no synchronisation. Block 0 writes meta.
//   cluster_points_single: the block's embeddings and seediness are copied
//     into shared memory once (cp.async), beside the state; bw is read only
//     at the seed point. Shared memory: 4 KB + (4E + 13) B per point.
//   cluster_points_tiled: embeddings and seediness of the listed points
//     stream from global memory on every sweep through a kStages-deep
//     cp.async ring (each thread copies and consumes its own points, so the
//     ring needs no block barrier); the state (9 B per point) stays in
//     shared memory when the block's share fits beside the ring, else it
//     lives in a global scratch buffer (13 B per point).
// Built with --fmad=false and without fast math, so that d2 rounds like the
// plain PyTorch version (one rounding per multiply and add, e = 0..E-1 in
// order), and sqrtf/expf are the IEEE / accurate versions.

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "cluster_exchange.cuh"

namespace stemseg {
namespace {

constexpr int kMetaCols = 128;
constexpr int kStages = 4;  // cp.async ring depth of the tiled kernel

// Where a kernel keeps a block's points and state.
enum Mode : int {
  kResident = 0,      // embeddings, seediness and state in shared memory
  kStreamOnChip = 1,  // inputs streamed, state in shared memory
  kStreamOffChip = 2  // inputs streamed, state in global memory
};

struct Args {
  const float* emb;           // [n, E]
  const float* bw;            // [n, E]
  const float* seed;          // [n]
  const unsigned char* fg;    // [n] 0/1
  int* labels;                // [n] out: slot or -1
  float* meta;                // [32, 128] out, written whole by block 0
  void* records;              // launch counter, then Record<E>: [2, gridDim.x] blocks',
                              // [2] decisions (cluster_exchange.cuh)
  unsigned char* state;       // kStreamOffChip: 2 x [n] u32 lists, [n] f32, [n] int8
  int n;
  int per;                    // points per block (the last block may own fewer)
  int k_max;
  float primary;
  float secondary;
  float min_seed;
  int reference_secondary;
};

// The decided loop state that the next sweep applies.
template <int E>
struct Step {
  bool init;    // sweep 0: set the state up, list the fg points
  bool apply;   // iteration k is active: assign it
  bool final;   // k is the last executed iteration: secondary pass
  bool do_sec;  // a cluster exists and points were left at the start of k
  int k;
  float c[E];
  float b[E];
};

template <class Idx>
struct State {
  float* bd;         // [per] best distance of a listed point
  signed char* bi;   // [per] its best cluster
  Idx* list[2];      // [per] local indices of the available points
};

// Appends j to list (at *count) for the lanes with keep; all lanes call.
template <class Idx>
__device__ __forceinline__ void append(bool keep, int j, Idx* list, int* count) {
  const unsigned int m = __ballot_sync(0xffffffffu, keep);
  if (m == 0u) return;
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(m) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(count, __popc(m));
  base = __shfl_sync(0xffffffffu, base, leader);
  if (keep) list[base + __popc(m & ((1u << lane) - 1u))] = (Idx)j;
}

// One sweep's work on local point j (global gi): set it up (init), or
// apply the decided iteration to it (it is listed, so available at the
// start of the sweep). emb_at(e) and seed_at() read its embedding and
// seediness; they are called only when needed. Returns whether the point
// is available for the next iteration (and then offers it as a candidate).
template <int E, class Idx, class EmbAt, class SeedAt>
__device__ __forceinline__ bool step_point(const Args& a, const Step<E>& st, int j,
                                           unsigned int gi, const State<Idx>& s,
                                           EmbAt emb_at, SeedAt seed_at,
                                           unsigned long long& best) {
  const bool ref = a.reference_secondary != 0;
  if (st.init) {
    if (!a.fg[gi]) {
      a.labels[gi] = -1;
      return false;
    }
    s.bd[j] = ref ? -INFINITY : INFINITY;
    s.bi[j] = 0;
  } else {
    int lab = -1;
    float bd = 0.0f;
    signed char bi = 0;
    if (st.apply || st.do_sec) {
      bd = s.bd[j];
      bi = s.bi[j];
    }
    if (st.apply) {
      float d2 = 0.0f;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float t = emb_at(e) - st.c[e];
        d2 = d2 + t * t * st.b[e];
      }
      const float dist = sqrtf(d2);
      if (expf(-0.5f * dist) > a.primary) lab = st.k;
      if (ref ? (dist > bd) : (dist < bd)) {
        bd = dist;
        bi = (signed char)st.k;
        if (!st.final) {
          s.bd[j] = bd;
          s.bi[j] = bi;
        }
      }
    }
    if (st.final) {
      // ref: gate = available at the start of the last executed iteration
      // (every listed point); nearest: still unassigned after it
      if (st.do_sec && (ref || lab == -1) && expf(-0.5f * bd) > a.secondary) lab = bi;
      a.labels[gi] = lab;
      return false;
    }
    if (lab >= 0) {
      a.labels[gi] = lab;
      return false;
    }
  }
  const unsigned long long key = point_key(seed_at(), gi);
  best = key > best ? key : best;
  return true;
}

template <int E, int kMode>
__global__ void __launch_bounds__(kThreads, 1) cluster_kernel(Args a) {
  using Idx = typename std::conditional<kMode == kStreamOffChip, unsigned int,
                                        unsigned short>::type;
  constexpr bool kRes = kMode == kResident;
  extern __shared__ __align__(16) unsigned char smem[];
  Fixed<E>* fx = reinterpret_cast<Fixed<E>*>(smem);
  const int tid = threadIdx.x, nt = kThreads, nb = gridDim.x;
  const int per = a.per;
  const int start = blockIdx.x * per;
  const int n_local = max(0, min(per, a.n - start));
  unsigned long long* counter = static_cast<unsigned long long*>(a.records);
  Record<E>* recs = exchange_records<E>(a.records);
  const unsigned long long nonce = launch_nonce(counter);

  float* emb_s = nullptr;  // kResident: [E][per] (SoA: conflict-free)
  float* seed_s = nullptr;
  float* ring = nullptr;   // streaming: [kStages][E + 1][nt]
  State<Idx> s;
  unsigned char* dyn = smem + kFixedSmem;
  if (kMode == kStreamOffChip) {
    ring = reinterpret_cast<float*>(dyn);
    s.list[0] = reinterpret_cast<Idx*>(a.state) + start;
    s.list[1] = reinterpret_cast<Idx*>(a.state) + (size_t)a.n + start;
    s.bd = reinterpret_cast<float*>(a.state + (size_t)8 * a.n) + start;
    s.bi = reinterpret_cast<signed char*>(a.state + (size_t)12 * a.n) + start;
  } else {
    float* f = reinterpret_cast<float*>(dyn);
    if (kRes) {
      emb_s = f;
      seed_s = emb_s + (size_t)E * per;
      f = seed_s + per;
    } else {
      ring = f;
      f = ring + (size_t)kStages * (E + 1) * nt;
    }
    s.bd = f;
    s.list[0] = reinterpret_cast<Idx*>(s.bd + per);
    s.list[1] = s.list[0] + per;
    s.bi = reinterpret_cast<signed char*>(s.list[1] + per);
  }
  if (kRes) {
    for (int q = tid; q < n_local * E; q += nt) {
      const int j = q / E, e = q - j * E;
      cp_async4(emb_s + (size_t)e * per + j, a.emb + (size_t)start * E + q);
    }
    for (int j = tid; j < n_local; j += nt) cp_async4(seed_s + j, a.seed + start + j);
    cp_async_commit();
    cp_async_wait<0>();
  }
  if (tid == 0) fx->cnt[0] = fx->cnt[1] = 0;
  __syncthreads();

  // streaming: item q of a sweep (a point of the block at init, else a listed
  // point) is taken by thread q % nt in chunk q / nt, through ring stage
  // (q / nt) % kStages; issue(c, ...) starts chunk c's copies
  auto issue = [&](int c, int n_items, const Idx* list, bool init, bool need_emb,
                   bool need_seed) {
    const int q = c * nt + tid;
    if (q < n_items && (need_emb || need_seed)) {
      const unsigned int gi = start + (init ? q : (int)list[q]);
      if (!init || a.fg[gi]) {
        float* stage = ring + (size_t)(c % kStages) * (E + 1) * nt + tid;
        if (need_emb) {
#pragma unroll
          for (int e = 0; e < E; ++e) cp_async4(stage + (size_t)e * nt, a.emb + (size_t)gi * E + e);
        }
        if (need_seed) cp_async4(stage + (size_t)E * nt, a.seed + gi);
      }
    }
    cp_async_commit();
  };

  Step<E> st;
  st.init = true;
  st.apply = st.final = st.do_sec = false;
  st.k = -1;
#pragma unroll
  for (int e = 0; e < E; ++e) st.c[e] = st.b[e] = 0.0f;
  bool active0 = false;
  int n_active = 0;

  for (int it = 0;; ++it) {
    // sweep `it`: the points of the block (init) or the listed ones
    const int cur = it & 1;
    const int n_items = st.init ? n_local : fx->cnt[cur];
    const Idx* list_in = s.list[cur];
    Idx* list_out = s.list[cur ^ 1];
    int* count_out = &fx->cnt[cur ^ 1];
    unsigned long long best = 0ull;
    if (kRes) {
      for (int base = 0; base < n_items; base += nt) {
        const int q = base + tid;
        const bool valid = q < n_items;
        const int j = valid ? (st.init ? q : (int)list_in[q]) : 0;
        const bool keep = valid && step_point<E>(
            a, st, j, start + j, s, [&](int e) { return emb_s[(size_t)e * per + j]; },
            [&]() { return seed_s[j]; }, best);
        if (!st.final) append(keep, j, list_out, count_out);
      }
    } else {
      const int n_chunks = (n_items + nt - 1) / nt;
      for (int c = 0; c < kStages - 1; ++c) issue(c, n_items, list_in, st.init, st.apply, !st.final);
      for (int c = 0; c < n_chunks; ++c) {
        issue(c + kStages - 1, n_items, list_in, st.init, st.apply, !st.final);
        cp_async_wait<kStages - 1>();
        const int q = c * nt + tid;
        const bool valid = q < n_items;
        const int j = valid ? (st.init ? q : (int)list_in[q]) : 0;
        const float* stage = ring + (size_t)(c % kStages) * (E + 1) * nt + tid;
        const bool keep = valid && step_point<E>(
            a, st, j, start + j, s, [&](int e) { return stage[(size_t)e * nt]; },
            [&]() { return stage[(size_t)E * nt]; }, best);
        if (!st.final) append(keep, j, list_out, count_out);
      }
      cp_async_wait<0>();
    }
    if (st.final) break;

    // the block's candidate for iteration `it`, then the exchange
    best = block_max(best, fx->red);
    if (tid == 0) fx->cnt[cur] = 0;  // read by all before block_max's barrier
    const unsigned int tag = record_tag(nonce, it);
    Record<E>* buf = recs + (size_t)(it & 1) * nb;
    Record<E>* decision = recs + (size_t)2 * nb + (it & 1);
    if (tid < 32) {
      const unsigned int gi = key_index(best);
      publish<E>(buf + blockIdx.x, tag, best, [&](int e, float* c, float* b) {
        *c = kRes ? emb_s[(size_t)e * per + (gi - start)] : a.emb[(size_t)gi * E + e];
        *b = a.bw[(size_t)gi * E + e];
      });
    }
    exchange<E>(buf, decision, nb, tag, fx);
    const Winner<E>& w = fx->win;

    // decode iteration `it` (the same in every thread of every block)
    const unsigned long long key = w.key;
    const bool active = key != 0ull && key_score(key) >= a.min_seed;
    if (it == 0) active0 = active;
    st.init = false;
    st.k = it;
    if (active) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        st.c[e] = w.c[e];
        st.b[e] = w.b[e];
      }
      if (tid == 0) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          fx->meta_c[it][e] = w.c[e];
          fx->meta_b[it][e] = w.b[e];
        }
        fx->meta_s[it] = key_score(key);
      }
      n_active = it + 1;
      st.apply = true;
      st.final = it == a.k_max - 1;
      st.do_sec = st.final;  // active0 holds and points were left
    } else {
      st.apply = false;
      st.final = true;
      st.do_sec = active0 && key != 0ull;
    }
  }

  if (blockIdx.x == 0) {
    __syncthreads();
    if (tid == 0) end_launch(counter, nonce);
    for (int q = tid; q < kPad * kMetaCols; q += nt) {
      const int r = q / kMetaCols, col = q - r * kMetaCols;
      float v = 0.0f;
      if (r < n_active) {
        if (col < E) v = fx->meta_c[r][col];
        else if (col < 2 * E) v = fx->meta_b[r][col - E];
        else if (col == kMetaCols - 2) v = fx->meta_s[r];
        else if (col == kMetaCols - 1) v = 1.0f;
      }
      a.meta[q] = v;
    }
  }
}

// The clustering kernels' synchronisation alone: per iteration one block
// reduction, one record published per block, the exchange and the decode,
// at E = 4, with no point work. `out` receives the last winning key.
__global__ void __launch_bounds__(kThreads, 1)
    sync_floor_kernel(void* records, unsigned long long* out, int iterations) {
  __shared__ Fixed<4> fx;
  const int nb = gridDim.x;
  unsigned long long* counter = static_cast<unsigned long long*>(records);
  Record<4>* recs = exchange_records<4>(records);
  const unsigned long long nonce = launch_nonce(counter);
  __syncthreads();
  for (int it = 0; it < iterations; ++it) {
    unsigned long long best =
        ((unsigned long long)(threadIdx.x + it) << 32) | (0xFFFFFFFFu - blockIdx.x);
    best = block_max(best, fx.red);
    const unsigned int tag = record_tag(nonce, it);
    Record<4>* buf = recs + (size_t)(it & 1) * nb;
    if (threadIdx.x < 32) {
      publish<4>(buf + blockIdx.x, tag, best, [](int e, float* c, float* b) {
        *c = (float)e;
        *b = 1.0f;
      });
    }
    exchange<4>(buf, recs + (size_t)2 * nb + (it & 1), nb, tag, &fx);
  }
  if (blockIdx.x == 0) {
    __syncthreads();
    if (threadIdx.x == 0) {
      end_launch(counter, nonce);
      *out = fx.win.key;
    }
  }
}

// Grid of one block per SM (fewer for small n), and the device's limits.
cudaError_t plan(int n, int* blocks, int* per, int* smem_optin) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const int needed = (n + kThreads - 1) / kThreads;
  *blocks = needed < sms ? needed : sms;
  if (*blocks > 32 * kMaxReadWarps) return cudaErrorInvalidConfiguration;
  *per = (n + *blocks - 1) / *blocks;
  return cudaSuccess;
}

// A block's dynamic shared memory is Fixed<E>, the streaming kernels'
// cp.async ring, and per point on chip: resident 4E + 13 B (E f32, f32
// seediness, f32 best distance, two u16 list entries, int8 best cluster),
// streaming 9 B (the state alone).
size_t ring_bytes(int e_dims, bool resident) {
  return resident ? 0 : (size_t)kStages * (e_dims + 1) * kThreads * 4;
}

size_t point_bytes(int e_dims, bool resident) { return resident ? 4 * e_dims + 13 : 9; }

// Most points a block keeps on chip with smem_optin bytes of shared memory.
long long block_capacity(int e_dims, bool resident, int smem_optin) {
  const long long room =
      (long long)smem_optin - kFixedSmem - (long long)ring_bytes(e_dims, resident);
  return room <= 0 ? 0 : room / (long long)point_bytes(e_dims, resident);
}

// A cooperative launch through cudaLaunchKernelExC, which a stream capture
// records as a cooperative kernel node; no call here synchronises.
cudaError_t launch_cooperative(const void* kernel, int blocks, size_t smem, void** params,
                               cudaStream_t stream) {
  // a grid that cannot be co-resident is refused by the cooperative launch
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelExC(&cfg, kernel, params);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int E, bool kRes>
cudaError_t launch(Args a, cudaStream_t stream) {
  int blocks = 0, smem_optin = 0;
  cudaError_t err = plan(a.n, &blocks, &a.per, &smem_optin);
  if (err != cudaSuccess) return err;
  const bool on_chip = a.per <= block_capacity(E, kRes, smem_optin);
  size_t smem = kFixedSmem + ring_bytes(E, kRes);
  if (on_chip) smem += (size_t)a.per * point_bytes(E, kRes);
  const void* kernel;
  if (kRes && on_chip) {
    kernel = reinterpret_cast<const void*>(&cluster_kernel<E, kResident>);
  } else if (on_chip) {
    kernel = reinterpret_cast<const void*>(&cluster_kernel<E, kStreamOnChip>);
  } else if (!kRes && a.state != nullptr) {
    kernel = reinterpret_cast<const void*>(&cluster_kernel<E, kStreamOffChip>);
  } else {
    return cudaErrorInvalidValue;
  }
  void* params[] = {&a};
  return launch_cooperative(kernel, blocks, smem, params, stream);
}

#define STEMSEG_DISPATCH_E(RESIDENT)                          \
  switch (e_dims) {                                           \
    case 1: return launch<1, RESIDENT>(a, stream);            \
    case 2: return launch<2, RESIDENT>(a, stream);            \
    case 3: return launch<3, RESIDENT>(a, stream);            \
    case 4: return launch<4, RESIDENT>(a, stream);            \
    case 5: return launch<5, RESIDENT>(a, stream);            \
    case 6: return launch<6, RESIDENT>(a, stream);            \
    case 7: return launch<7, RESIDENT>(a, stream);            \
    case 8: return launch<8, RESIDENT>(a, stream);            \
    default: return cudaErrorInvalidValue;                    \
  }

Args make_args(const void* emb, const void* bw, const void* seed, const void* fg,
               void* labels, void* meta, void* records, void* state, int n, int k_max,
               float primary, float secondary, float min_seed, int reference_secondary) {
  Args a;
  a.emb = static_cast<const float*>(emb);
  a.bw = static_cast<const float*>(bw);
  a.seed = static_cast<const float*>(seed);
  a.fg = static_cast<const unsigned char*>(fg);
  a.labels = static_cast<int*>(labels);
  a.meta = static_cast<float*>(meta);
  a.records = records;
  a.state = static_cast<unsigned char*>(state);
  a.n = n;
  a.per = 0;
  a.k_max = k_max;
  a.primary = primary;
  a.secondary = secondary;
  a.min_seed = min_seed;
  a.reference_secondary = reference_secondary;
  return a;
}

}  // namespace
}  // namespace stemseg

using namespace stemseg;

// Plain C interface for ctypes. Each returns a cudaError_t (0 = launched).
// `records` holds kCounterBytes + (2 * (SM count) + 2) * 16 (E + 1) bytes,
// 16-byte aligned, zeroed when allocated and written by nothing but these
// functions' kernels (cluster_exchange.cuh), which are launched on it one
// after another (one stream, or one graph replayed on one stream).

extern "C" int stemseg_cluster_limits(int* sms, int* smem_optin) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (int)err;
}

// Most points whose per-point shared-memory part fits on chip at E =
// e_dims on a card of `sms` SMs with `smem_optin` bytes a block: the
// single kernel's window (resident = 1) or the tiled kernel's state
// (resident = 0). Pure arithmetic; the launches decide with the same rule.
extern "C" long long stemseg_cluster_capacity(int e_dims, int resident, int sms,
                                              int smem_optin) {
  return (long long)sms * block_capacity(e_dims, resident != 0, smem_optin);
}

extern "C" int stemseg_cluster_single(
    const void* emb, const void* bw, const void* seed, const void* fg, void* labels,
    void* meta, void* records, int n, int e_dims, int k_max, float primary, float secondary,
    float min_seed, int reference_secondary, void* stream_ptr) {
  if (k_max < 1 || k_max > kPad || n < 1) return (int)cudaErrorInvalidValue;
  const Args a = make_args(emb, bw, seed, fg, labels, meta, records, nullptr, n, k_max,
                           primary, secondary, min_seed, reference_secondary);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  return (int)[&]() -> cudaError_t { STEMSEG_DISPATCH_E(true) }();
}

// `state` (13 n bytes, 4-byte aligned) is used only when a block's share of
// the state does not fit in shared memory beside the ring; it may be null
// otherwise.
extern "C" int stemseg_cluster_tiled(
    const void* emb, const void* bw, const void* seed, const void* fg, void* labels,
    void* meta, void* records, void* state, int n, int e_dims, int k_max, float primary,
    float secondary, float min_seed, int reference_secondary, void* stream_ptr) {
  if (k_max < 1 || k_max > kPad || n < 1) return (int)cudaErrorInvalidValue;
  const Args a = make_args(emb, bw, seed, fg, labels, meta, records, state, n, k_max, primary,
                           secondary, min_seed, reference_secondary);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  return (int)[&]() -> cudaError_t { STEMSEG_DISPATCH_E(false) }();
}

// The sync floor on the clustering kernels' grid for n points: `iterations`
// exchanges at E = 4.
extern "C" int stemseg_cluster_sync_floor(void* records, void* out, int n, int iterations,
                                          void* stream_ptr) {
  int blocks = 0, per = 0, smem_optin = 0;
  cudaError_t err = plan(n, &blocks, &per, &smem_optin);
  if (err != cudaSuccess) return (int)err;
  if (iterations < 1) return (int)cudaErrorInvalidValue;
  unsigned long long* o = static_cast<unsigned long long*>(out);
  void* params[] = {&records, &o, &iterations};
  return (int)launch_cooperative(reinterpret_cast<const void*>(&sync_floor_kernel), blocks, 0,
                                 params, static_cast<cudaStream_t>(stream_ptr));
}
