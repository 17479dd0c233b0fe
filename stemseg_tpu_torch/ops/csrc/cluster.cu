// Sequential seeded clustering of one window's points, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of stemseg_tpu/ops/cluster_pallas.py:
//   * cluster_points_single <- _cluster_kernel (:103), the VMEM-resident
//     single-block kernel, chosen for windows whose state fits 14 MB
//     (207,360 points for a 480p 8-frame DAVIS window);
//   * cluster_points_tiled  <- _cluster_kernel_tiled (:300), the tiled
//     HBM-streaming kernel (878,592 points for the 704x1248 16-frame DAVIS
//     window of the CLI's default preset).
// Both compute exactly clustering._cluster of the JAX package: K sequential
// iterations, each seeding at the first-occurrence argmax of seediness over
// the unassigned fg points (sticky stop below min_seediness), taking the
// seed pixel's own centre and bandwidth, assigning exp(-0.5 d) > primary
// with d = sqrt(sum_e (x_e - c_e)^2 bw_e), and keeping a running farthest
// ("reference") or nearest masked distance per point; then the secondary
// pass, gated by the availability mask of the last executed iteration.
//
// Bound on this card: memory. Per point the function reads E embedding
// floats, E bandwidth floats, the seediness and the fg byte, and writes one
// label: about 41 B per point at E = 4, against about 10 flops per point
// and iteration. So the least time is the bytes over 3.35 TB/s.
//
// Design. The TPU kernel keeps all state in 14 MB of VMEM; an SM has
// 227 KB of shared memory, so here the per-point state (labels, best_d,
// best_idx, avail_last) lives in global memory as SoA planes that the
// wrapper allocates; at DAVIS sizes they and the embeddings (~30 MB at
// 878,592 points) stay mostly in the 50 MB L2 across iterations. Every
// point is touched once per iteration, in a fused sweep: sweep s applies
// iteration s-1 (assignment, running best distance, stale mask) and, in
// the same pass over the same point, accumulates iteration s's argmax. The
// argmax is one 64-bit key per point, (order-preserving bits of the score)
// << 32 | (0xFFFFFFFF - index), so the max key is the max score with the
// smallest index among ties; it is reduced by warp shuffles within a block
// and by one atomicMax per block into keys[s]. keys[s] == 0 means that no
// point was available. Every block decodes keys[0..s-1] into the same
// decisions (seed index, active, executed, stopped), so no block needs
// another's state. The secondary pass needs only scalars known once the
// last executed iteration is decided (any cluster = iteration 0 active;
// points left = keys[last] != 0), so it runs in the sweep that applies that
// iteration, and later sweeps return at once.
//   cluster_points_single: one cooperative launch, grid = the co-resident
//     blocks, one grid-wide sync per sweep.
//   cluster_points_tiled: K+1 launches of the sweep kernel over all points
//     with all blocks in parallel; launch order replaces the grid sync.
// Built with --fmad=false and without fast math, so that d2 rounds like the
// plain PyTorch version (one rounding per multiply and add, e = 0..E-1 in
// order), and sqrtf/expf are the IEEE / accurate versions.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMetaCols = 128;

struct Args {
  const float* emb;            // [n, E]
  const float* bw;             // [n, E]
  const float* seed;           // [n]
  const unsigned char* fg;     // [n] 0/1
  int* labels;                 // [n] out: slot or -1
  float* best_d;               // [n] scratch
  int* best_idx;               // [n] scratch
  unsigned char* avail_last;   // [n] scratch
  unsigned long long* keys;    // [k_max] zeroed by the caller
  float* meta;                 // [32, 128] zeroed by the caller
  int n;
  int k_max;
  float primary;
  float secondary;
  float min_seed;
  int reference_secondary;
};

struct Decision {
  int exec;      // iteration k executed (the loop had not stopped before it)
  int active;    // iteration k made a cluster
  int last;      // k is the last executed iteration: run the secondary pass
  int do_sec;    // a cluster exists and points were left at the start of k
  int seed_next; // accumulate the argmax of iteration k + 1 in this sweep
  int k;
  float c[8];
  float b[8];
};

__device__ __forceinline__ unsigned int ordered_bits(float f) {
  const unsigned int u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_ordered(unsigned int o) {
  return __uint_as_float((o & 0x80000000u) ? (o ^ 0x80000000u) : ~o);
}

// Thread 0 only. Decodes iterations 0..s-1 from keys[] (s >= 1); sweep s
// applies iteration s - 1.
template <int E>
__device__ void decode(const Args& a, int s, Decision* d) {
  const volatile unsigned long long* keys = a.keys;
  bool stopped = false, active0 = false, exec = false, active = false;
  unsigned long long key = 0ull;
  for (int j = 0; j < s; ++j) {
    if (stopped) {
      exec = false;
      active = false;
      continue;
    }
    exec = true;
    key = keys[j];
    active = key != 0ull && from_ordered((unsigned int)(key >> 32)) >= a.min_seed;
    if (j == 0) active0 = active;
    stopped = !active;
  }
  const int k = s - 1;
  d->k = k;
  d->exec = exec;
  d->active = active;
  d->last = exec && (!active || k == a.k_max - 1);
  d->do_sec = active0 && key != 0ull;
  d->seed_next = exec && !d->last;
  if (exec && active) {
    const unsigned int idx = 0xFFFFFFFFu - (unsigned int)(key & 0xFFFFFFFFull);
    const float score = from_ordered((unsigned int)(key >> 32));
#pragma unroll
    for (int e = 0; e < E; ++e) {
      d->c[e] = a.emb[(size_t)idx * E + e];
      d->b[e] = a.bw[(size_t)idx * E + e];
    }
    if (blockIdx.x == 0) {
      float* row = a.meta + (size_t)k * kMetaCols;
      for (int e = 0; e < E; ++e) {
        row[e] = d->c[e];
        row[E + e] = d->b[e];
      }
      row[kMetaCols - 2] = score;
      row[kMetaCols - 1] = 1.0f;
    }
  }
}

__device__ __forceinline__ void init_decision(Decision* d) {
  d->k = -1;
  d->exec = 1;
  d->active = 0;
  d->last = 0;
  d->do_sec = 0;
  d->seed_next = 1;
}

// One fused sweep over all points (grid-stride), then the block's argmax
// key into keys[s]. Block-uniform control flow throughout.
template <int E>
__device__ void sweep(const Args& a, int s, const Decision& d,
                      unsigned long long* red) {
  const bool ref = a.reference_secondary != 0;
  unsigned long long best = 0ull;
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < a.n; i += stride) {
    const bool fgp = a.fg[i] != 0;
    int lab = -1;
    if (s == 0) {
      a.labels[i] = -1;
      a.best_d[i] = ref ? -INFINITY : INFINITY;
      a.best_idx[i] = 0;
      a.avail_last[i] = fgp ? 1 : 0;
    } else {
      lab = a.labels[i];
      const bool avail = lab == -1 && fgp;
      const unsigned char al = avail ? 1 : 0;  // iteration d.k executed
      float bd = a.best_d[i];
      int bi = a.best_idx[i];
      if (d.active) {
        float dm = 1e8f;
        if (avail) {
          float d2 = 0.0f;
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const float t = a.emb[(size_t)i * E + e] - d.c[e];
            d2 = d2 + t * t * d.b[e];
          }
          const float dist = sqrtf(d2);
          if (expf(-0.5f * dist) > a.primary) lab = d.k;
          dm = dist;
        }
        if (ref ? (dm > bd) : (dm < bd)) {
          bd = dm;
          bi = d.k;
        }
      }
      if (d.last) {
        if (d.do_sec) {
          const bool gate = ref ? (al != 0) : (lab == -1 && fgp);
          if (gate && expf(-0.5f * bd) > a.secondary) lab = bi;
        }
        a.labels[i] = lab;
        continue;
      }
      a.labels[i] = lab;
      a.best_d[i] = bd;
      a.best_idx[i] = bi;
      a.avail_last[i] = al;
    }
    if (lab == -1 && fgp) {
      const unsigned long long key =
          ((unsigned long long)ordered_bits(a.seed[i]) << 32) |
          (unsigned long long)(0xFFFFFFFFu - (unsigned int)i);
      best = key > best ? key : best;
    }
  }
  if (!d.seed_next) return;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(0xffffffffu, best, off);
    best = o > best ? o : best;
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = best;
  __syncthreads();
  if (threadIdx.x < 32) {
    best = threadIdx.x < (blockDim.x >> 5) ? red[threadIdx.x] : 0ull;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const unsigned long long o = __shfl_xor_sync(0xffffffffu, best, off);
      best = o > best ? o : best;
    }
    if (threadIdx.x == 0 && best != 0ull) atomicMax(a.keys + s, best);
  }
}

template <int E>
__global__ void __launch_bounds__(kThreads) cluster_sweep_kernel(Args a, int s) {
  __shared__ Decision d;
  __shared__ unsigned long long red[kThreads / 32];
  if (threadIdx.x == 0) {
    if (s == 0) init_decision(&d);
    else decode<E>(a, s, &d);
  }
  __syncthreads();
  if (!d.exec) return;
  sweep<E>(a, s, d, red);
}

template <int E>
__global__ void __launch_bounds__(kThreads) cluster_single_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ Decision d;
  __shared__ unsigned long long red[kThreads / 32];
  for (int s = 0; s <= a.k_max; ++s) {
    if (threadIdx.x == 0) {
      if (s == 0) init_decision(&d);
      else decode<E>(a, s, &d);
    }
    __syncthreads();
    // every block decodes the same keys, so these exits are grid-uniform
    if (!d.exec) return;
    sweep<E>(a, s, d, red);
    if (d.last) return;
    grid.sync();
  }
}

cudaError_t resident_grid(const void* kernel, int n, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int needed = (n + kThreads - 1) / kThreads;
  *grid = needed < per_sm * sms ? (needed > 0 ? needed : 1) : per_sm * sms;
  return cudaSuccess;
}

template <int E>
cudaError_t launch_single(const Args& a, cudaStream_t stream) {
  const void* kernel = reinterpret_cast<const void*>(&cluster_single_kernel<E>);
  int grid = 0;
  cudaError_t err = resident_grid(kernel, a.n, &grid);
  if (err != cudaSuccess) return err;
  Args args = a;
  void* params[] = {&args};
  err = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kThreads), params, 0, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int E>
cudaError_t launch_tiled(const Args& a, cudaStream_t stream) {
  int grid = 0;
  cudaError_t err = resident_grid(
      reinterpret_cast<const void*>(&cluster_sweep_kernel<E>), a.n, &grid);
  if (err != cudaSuccess) return err;
  for (int s = 0; s <= a.k_max; ++s) {
    cluster_sweep_kernel<E><<<grid, kThreads, 0, stream>>>(a, s);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

Args make_args(const void* emb, const void* bw, const void* seed, const void* fg,
               void* labels, void* best_d, void* best_idx, void* avail_last,
               void* keys, void* meta, int n, int k_max, float primary,
               float secondary, float min_seed, int reference_secondary) {
  Args a;
  a.emb = static_cast<const float*>(emb);
  a.bw = static_cast<const float*>(bw);
  a.seed = static_cast<const float*>(seed);
  a.fg = static_cast<const unsigned char*>(fg);
  a.labels = static_cast<int*>(labels);
  a.best_d = static_cast<float*>(best_d);
  a.best_idx = static_cast<int*>(best_idx);
  a.avail_last = static_cast<unsigned char*>(avail_last);
  a.keys = static_cast<unsigned long long*>(keys);
  a.meta = static_cast<float*>(meta);
  a.n = n;
  a.k_max = k_max;
  a.primary = primary;
  a.secondary = secondary;
  a.min_seed = min_seed;
  a.reference_secondary = reference_secondary;
  return a;
}

#define STEMSEG_DISPATCH_E(FN)                        \
  switch (e_dims) {                                   \
    case 1: return FN<1>(a, stream);                  \
    case 2: return FN<2>(a, stream);                  \
    case 3: return FN<3>(a, stream);                  \
    case 4: return FN<4>(a, stream);                  \
    case 5: return FN<5>(a, stream);                  \
    case 6: return FN<6>(a, stream);                  \
    case 7: return FN<7>(a, stream);                  \
    case 8: return FN<8>(a, stream);                  \
    default: return cudaErrorInvalidValue;            \
  }

}  // namespace

// Plain C interface for ctypes. Returns a cudaError_t (0 = launched).
extern "C" int stemseg_cluster_single(
    const void* emb, const void* bw, const void* seed, const void* fg,
    void* labels, void* best_d, void* best_idx, void* avail_last, void* keys,
    void* meta, int n, int e_dims, int k_max, float primary, float secondary,
    float min_seed, int reference_secondary, void* stream_ptr) {
  if (k_max < 1 || k_max > 32 || n < 1) return (int)cudaErrorInvalidValue;
  const Args a = make_args(emb, bw, seed, fg, labels, best_d, best_idx, avail_last,
                           keys, meta, n, k_max, primary, secondary, min_seed,
                           reference_secondary);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const cudaError_t err = [&]() -> cudaError_t { STEMSEG_DISPATCH_E(launch_single) }();
  return (int)err;
}

extern "C" int stemseg_cluster_tiled(
    const void* emb, const void* bw, const void* seed, const void* fg,
    void* labels, void* best_d, void* best_idx, void* avail_last, void* keys,
    void* meta, int n, int e_dims, int k_max, float primary, float secondary,
    float min_seed, int reference_secondary, void* stream_ptr) {
  if (k_max < 1 || k_max > 32 || n < 1) return (int)cudaErrorInvalidValue;
  const Args a = make_args(emb, bw, seed, fg, labels, best_d, best_idx, avail_last,
                           keys, meta, n, k_max, primary, secondary, min_seed,
                           reference_secondary);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const cudaError_t err = [&]() -> cudaError_t { STEMSEG_DISPATCH_E(launch_tiled) }();
  return (int)err;
}
