// Masked linear sum assignment for Hopper (sm_90a): scipy's
// linear_sum_assignment on the compacted (valid rows x valid columns) matrix,
// in the original index space, for matrices of at most 1024 x 1024.
//
// Replaces stemseg_tpu/inference/lsap.py:121 (lsa_masked, with _solve_square
// :164), which is plain XLA in the JAX package: a while loop that stays on
// the device. In PyTorch ops the same loop needs a host sync at every step;
// this kernel keeps the association of the fused sequence path on the card.
// Its matrices are the candidate band x K: 40 x 20 at the presets' own
// window overlaps, 80 x 20 for an 8-frame window with DAVIS's overlap of 6.
//
// The algorithm is scipy's shortest augmenting path (Crouse 2016,
// scipy/optimize/rectangular_lsap), step for step as the JAX replica and the
// plain PyTorch version (stemseg_tpu_torch/ops/lsap.py) run it, in float32:
//   * the remaining columns are visited in descending index order, with
//     swap-remove compaction;
//   * among the minimum reduced costs, the last unassigned column in
//     `remaining` order wins, else the first one seen;
//   * a matrix with fewer valid columns than valid rows is solved transposed.
// Every float operation is the plain version's, in its order (built with
// --fmad=false), so the same inputs give the same assignment.
//
// Design: one block of one warp. The solver's vectors sit in shared memory;
// the cost matrix stays where the caller put it and is read through the
// read-only cache (a few KB, one row a step). Lane l owns columns l, l + 32,
// ... The row loop and each augmenting path's steps are sequential; a step's
// minimum and tie-break are warp reductions. The augmentation (a walk along
// `path`) runs on lane 0.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxSide = 1024;
constexpr int kLanes = 32;
constexpr unsigned int kFull = 0xffffffffu;

__device__ __forceinline__ float warp_min(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float y = __shfl_xor_sync(kFull, x, o);
    x = y < x ? y : x;
  }
  return x;
}

// Number of nonzero entries of valid[0, n); every lane gets it.
__device__ __forceinline__ int count_valid(const unsigned char* valid, int n, int lane) {
  int total = 0;
  for (int base = 0; base < n; base += kLanes) {
    const int q = base + lane;
    total += __popc(__ballot_sync(kFull, q < n && valid[q] != 0));
  }
  return total;
}

__global__ void __launch_bounds__(kLanes, 1)
    lsa_kernel(const float* __restrict__ cost, const unsigned char* row_valid,
               const unsigned char* col_valid, int n_rows, int n_cols, int* col4row_out,
               int* row4col_out) {
  __shared__ float u[kMaxSide], v[kMaxSide], spc[kMaxSide];
  __shared__ int path[kMaxSide], c4r[kMaxSide], r4c[kMaxSide], desc[kMaxSide], rem[kMaxSide];
  __shared__ unsigned char rv[kMaxSide], cv[kMaxSide], sr[kMaxSide], sc[kMaxSide],
      inrem[kMaxSide];
  const int lane = threadIdx.x;
  const int b = n_rows > n_cols ? n_rows : n_cols;
  const bool transpose = count_valid(col_valid, n_cols, lane) < count_valid(row_valid, n_rows, lane);
  // entry (i, j) of the solver's matrix (the transpose when `transpose`);
  // slots outside the caller's matrix are never read (their masks are 0)
  auto at = [&](int i, int j) {
    return transpose ? __ldg(cost + (size_t)j * n_cols + i) : __ldg(cost + (size_t)i * n_cols + j);
  };

  for (int q = lane; q < b; q += kLanes) {
    const unsigned char r = q < n_rows ? row_valid[q] : 0;
    const unsigned char s = q < n_cols ? col_valid[q] : 0;
    rv[q] = transpose ? s : r;
    cv[q] = transpose ? r : s;
    u[q] = v[q] = 0.0f;
    path[q] = c4r[q] = r4c[q] = desc[q] = -1;
  }
  __syncwarp();
  // valid solver columns in descending order: column q's position is the
  // number of valid columns above it
  const int n_valid_cols = count_valid(cv, b, lane);
  for (int q = lane; q < b; q += kLanes) {
    if (cv[q]) {
      int above = 0;
      for (int j = q + 1; j < b; ++j) above += cv[j] != 0;
      desc[above] = q;
    }
  }
  __syncwarp();

  for (int cur = 0; cur < b; ++cur) {
    if (!rv[cur]) continue;
    for (int q = lane; q < b; q += kLanes) {
      sr[q] = sc[q] = 0;
      spc[q] = INFINITY;
      inrem[q] = cv[q];
      rem[q] = desc[q];
    }
    __syncwarp();
    float min_val = 0.0f;
    int i = cur, sink = -1, n_rem = n_valid_cols;
    while (sink == -1) {
      if (lane == 0) sr[i] = 1;
      const float ui = u[i];
      for (int j = lane; j < b; j += kLanes) {
        if (inrem[j]) {
          const float r = min_val + at(i, j) - ui - v[j];
          if (r < spc[j]) {
            spc[j] = r;
            path[j] = i;
          }
        }
      }
      __syncwarp();
      float lowest = INFINITY;
      for (int p = lane; p < n_rem; p += kLanes) {
        const float s = spc[rem[p]];
        lowest = s < lowest ? s : lowest;
      }
      lowest = warp_min(lowest);
      if (lowest == INFINITY) {  // no column left: cannot happen on finite costs
        sink = -2;
        break;
      }
      int last_unassigned = -1, first = kMaxSide;
      for (int p = lane; p < n_rem; p += kLanes) {
        if (spc[rem[p]] == lowest) {
          first = p < first ? p : first;
          if (r4c[rem[p]] == -1) last_unassigned = p;
        }
      }
      last_unassigned = __reduce_max_sync(kFull, last_unassigned);
      first = __reduce_min_sync(kFull, first);
      const int index = last_unassigned >= 0 ? last_unassigned : first;
      const int j = rem[index];
      const int row_j = r4c[j];
      min_val = lowest;
      __syncwarp();
      if (lane == 0) {
        sc[j] = 1;
        inrem[j] = 0;
        rem[index] = rem[n_rem - 1];
      }
      n_rem -= 1;
      if (row_j == -1) {
        sink = j;
      } else {
        i = row_j;
      }
      __syncwarp();
    }
    if (sink < 0) continue;

    // dual update: u, then u[cur] += min_val, then v
    for (int q = lane; q < b; q += kLanes) {
      const int col = c4r[q] < 0 ? 0 : c4r[q];
      u[q] = u[q] + ((sr[q] && q != cur) ? (min_val - spc[col]) : 0.0f);
      v[q] = v[q] - (sc[q] ? (min_val - spc[q]) : 0.0f);
    }
    __syncwarp();
    if (lane == 0) {
      u[cur] = u[cur] + min_val;
      int j = sink;
      for (int step = 0; step < b; ++step) {  // a path visits each row once
        const int r = path[j];
        r4c[j] = r;
        const int next = c4r[r];
        c4r[r] = j;
        j = next;
        if (r == cur) break;
      }
    }
    __syncwarp();
  }

  // solver rows are the original columns when transposed
  for (int q = lane; q < n_rows; q += kLanes) col4row_out[q] = transpose ? r4c[q] : c4r[q];
  for (int q = lane; q < n_cols; q += kLanes) row4col_out[q] = transpose ? c4r[q] : r4c[q];
}

}  // namespace

// Plain C interface for ctypes; returns a cudaError_t (0 = launched).
// cost [rows, cols] float32 (rows, cols <= 1024), row_valid [rows] and
// col_valid [cols] bool (one byte each), all contiguous on the device;
// col4row [rows] and row4col [cols] int32 out: the matched column of each
// valid row / row of each valid column, -1 where unmatched or invalid.
extern "C" int stemseg_lsa_masked(const void* cost, const void* row_valid, const void* col_valid,
                                  int rows, int cols, void* col4row, void* row4col,
                                  void* stream_ptr) {
  if (rows < 1 || cols < 1 || rows > kMaxSide || cols > kMaxSide)
    return (int)cudaErrorInvalidValue;
  const float* c = static_cast<const float*>(cost);
  const unsigned char* rv = static_cast<const unsigned char*>(row_valid);
  const unsigned char* cv = static_cast<const unsigned char*>(col_valid);
  int* c4r = static_cast<int*>(col4row);
  int* r4c = static_cast<int*>(row4col);
  void* params[] = {&c, &rv, &cv, &rows, &cols, &c4r, &r4c};
  const cudaError_t err = cudaLaunchKernel(reinterpret_cast<const void*>(&lsa_kernel), dim3(1),
                                           dim3(kLanes), params, 0,
                                           static_cast<cudaStream_t>(stream_ptr));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
