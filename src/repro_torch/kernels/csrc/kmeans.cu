// k-means kernels for Hopper (sm_90a): nearest-centre assignment and one
// fused Lloyd step.  Plain C entry points, bound with ctypes by
// repro_torch/kernels/kmeans.py.  Every pointer is device memory that the
// wrapper allocated; every launch goes to the caller's stream and nothing
// here synchronises or allocates.
//
// Replaces the TPU kernels of src/repro/kernels/kmeans.py:
//   kmeans_assign      <- kmeans_assign     (_assign_kernel)
//   kmeans_lloyd_step  <- kmeans_lloyd_step (_lloyd_kernel)
//
// What bounds them on the H100: bytes, at the shapes the grouping path
// gives them (f = 3 or 6 features, k <= 6 centres).  Per point the
// function reads 4f bytes and writes 8, and computes about k(2f + 3)
// flops, so below k ~ 10 the 3.35 TB/s of device memory is the limit.  At
// the envelope's corner (k = 64, f = 128) it turns to operations: about
// 32 flops per byte against the card's 20 for float32 outside the tensor
// cores.  One step at the fleet probe's shape (10^5 points, f = 3) moves
// about 2 MB, under a microsecond at full rate, so launch overhead
// dominates; a CUDA graph or one persistent kernel over all Lloyd
// iterations is the remedy, left for later.
//
// Design.  One thread per point.  The centres (k <= 64, f <= 128: at most
// 32 KB of float32) and their squared norms are staged in shared memory.
// Distances keep the reference's formula ||x||^2 + ||c||^2 - 2 x.c; the
// scan over centres is in ascending order with a strict <, so the first
// index wins ties, as jnp.argmin and torch.argmin do.  The ragged tail is
// masked: unlike the TPU kernel, N need not divide by a block size.
//
// The TPU kernel carried the per-cluster sums across its sequential grid.
// Blocks here run in no order, so the Lloyd step reduces in two passes,
// both in a fixed order: each block sums its own points into a
// (k, f + 1) partial (the extra column is the count), and a second small
// kernel adds the partials over blocks in block order.  No float atomics:
// their order changes from run to run and would move the grouping, which
// this repository keeps reproducible across processes.  As on the TPU,
// the (N, k) one-hot never reaches device memory.

#include <cuda_runtime.h>

#include <cmath>

#define TILE 256  // threads per block = points per block

namespace {

// Centres and their squared norms into shared memory.
__device__ void stage_centres(const float* __restrict__ c, int k, int f,
                              float* cs, float* c2) {
  for (int q = threadIdx.x; q < k * f; q += blockDim.x) cs[q] = c[q];
  __syncthreads();
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    float s = 0.0f;
    for (int d = 0; d < f; ++d) s += cs[j * f + d] * cs[j * f + d];
    c2[j] = s;
  }
  __syncthreads();
}

// Nearest centre of one point: first index of the minimum, and the
// (unclamped) squared distance to it.
__device__ void nearest(const float* __restrict__ xi, const float* cs,
                        const float* c2, int k, int f, int* lab,
                        float* dist) {
  float x2 = 0.0f;
  for (int d = 0; d < f; ++d) x2 += xi[d] * xi[d];
  float best = INFINITY;
  int bi = 0;
  for (int j = 0; j < k; ++j) {
    float dot = 0.0f;
    for (int d = 0; d < f; ++d) dot += xi[d] * cs[j * f + d];
    float dj = (x2 + c2[j]) - 2.0f * dot;
    if (dj < best) {
      best = dj;
      bi = j;
    }
  }
  *lab = bi;
  *dist = best;
}

__global__ void __launch_bounds__(TILE)
assign_kernel(const float* __restrict__ x, const float* __restrict__ c,
              int n, int k, int f, int* __restrict__ labels,
              float* __restrict__ dists) {
  extern __shared__ float smem[];
  float* cs = smem;      // (k, f)
  float* c2 = cs + k * f;  // (k,)
  stage_centres(c, k, f, cs, c2);
  int i = blockIdx.x * TILE + threadIdx.x;
  if (i >= n) return;
  int lab;
  float dist;
  nearest(x + (size_t)i * f, cs, c2, k, f, &lab, &dist);
  labels[i] = lab;
  dists[i] = dist;
}

// Assignment plus this block's per-cluster sums and counts:
// partial[blockIdx.x] is a (k, f + 1) row-major slab, column f the count.
__global__ void __launch_bounds__(TILE)
lloyd_partial_kernel(const float* __restrict__ x, const float* __restrict__ c,
                     int n, int k, int f, int* __restrict__ labels,
                     float* __restrict__ dists, float* __restrict__ partial) {
  extern __shared__ float smem[];
  float* cs = smem;             // (k, f)
  float* c2 = cs + k * f;       // (k,)
  float* red = c2 + k;          // (TILE,) segment partials
  int* lab_s = (int*)(red + TILE);  // (TILE,) labels of this block's points
  stage_centres(c, k, f, cs, c2);

  const int base = blockIdx.x * TILE;
  const int cnt = min(TILE, n - base);
  int i = base + threadIdx.x;
  int lab = -1;
  if (i < n) {
    float dist;
    nearest(x + (size_t)i * f, cs, c2, k, f, &lab, &dist);
    labels[i] = lab;
    dists[i] = dist;
  }
  lab_s[threadIdx.x] = lab;
  __syncthreads();

  // P outputs (cluster j, column d); column f adds 1 per point.  With few
  // outputs, each is split over S contiguous segments of the block's
  // points, and the segments are added in order afterwards.
  const int fc = f + 1;
  const int P = k * fc;
  const int S = P < TILE ? TILE / P : 1;
  const int seg = (cnt + S - 1) / S;
  float* out = partial + (size_t)blockIdx.x * P;
  for (int q = threadIdx.x; q < P * S; q += TILE) {
    const int p = q % P, s = q / P;
    const int j = p / fc, d = p % fc;
    const int t0 = s * seg, t1 = min(cnt, t0 + seg);
    float acc = 0.0f;
    for (int t = t0; t < t1; ++t) {
      if (lab_s[t] == j) acc += d < f ? x[(size_t)(base + t) * f + d] : 1.0f;
    }
    if (S > 1) red[q] = acc;
    else out[p] = acc;
  }
  if (S > 1) {
    __syncthreads();
    for (int p = threadIdx.x; p < P; p += TILE) {
      float acc = 0.0f;
      for (int s = 0; s < S; ++s) acc += red[s * P + p];
      out[p] = acc;
    }
  }
}

// Sum the per-block partials over blocks, in block order.
__global__ void lloyd_reduce_kernel(const float* __restrict__ partial,
                                    int n_blocks, int k, int f,
                                    float* __restrict__ sums,
                                    float* __restrict__ counts) {
  const int fc = f + 1;
  const int P = k * fc;
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  float acc = 0.0f;
  for (int b = 0; b < n_blocks; ++b) acc += partial[(size_t)b * P + p];
  const int j = p / fc, d = p % fc;
  if (d < f) sums[j * f + d] = acc;
  else counts[j] = acc;
}

}  // namespace

extern "C" {

// Points per block: the wrapper sizes the Lloyd partials with it.
int kmeans_tile() { return TILE; }

const char* kmeans_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// x (n, f), c (k, f) -> labels (n,) int32, dists (n,) float32.
int kmeans_assign(const float* x, const float* c, int n, int k, int f,
                  int* labels, float* dists, void* stream) {
  const int n_blocks = (n + TILE - 1) / TILE;
  const size_t smem = sizeof(float) * (size_t)(k * f + k);
  assign_kernel<<<n_blocks, TILE, smem, (cudaStream_t)stream>>>(
      x, c, n, k, f, labels, dists);
  return (int)cudaGetLastError();
}

// One Lloyd step: labels, dists as above, plus sums (k, f) and counts (k,)
// float32.  partial is scratch of ceil(n / TILE) * k * (f + 1) floats.
int kmeans_lloyd_step(const float* x, const float* c, int n, int k, int f,
                      int* labels, float* dists, float* partial, float* sums,
                      float* counts, void* stream) {
  const int n_blocks = (n + TILE - 1) / TILE;
  const size_t smem = sizeof(float) * (size_t)(k * f + k + TILE) +
                      sizeof(int) * TILE;
  cudaStream_t s = (cudaStream_t)stream;
  lloyd_partial_kernel<<<n_blocks, TILE, smem, s>>>(x, c, n, k, f, labels,
                                                    dists, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int P = k * (f + 1);
  lloyd_reduce_kernel<<<(P + 255) / 256, 256, 0, s>>>(partial, n_blocks, k, f,
                                                       sums, counts);
  return (int)cudaGetLastError();
}

}  // extern "C"
