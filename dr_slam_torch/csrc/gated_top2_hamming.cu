// Gated top-2 Hamming matcher for Hopper (sm_90a).
//
// Replaces the TPU kernel `gated_top2_hamming` of the JAX package's
// ops/match_pallas.py (body `_kernel`), which the projection
// matcher (slam/map_ops.py: match_points_projection, ORBmatcher::
// SearchByProjection) runs twice per frame. For K keypoints x NC candidate
// map points it computes the Hamming distance of the packed 256-bit
// descriptors, gated by the projection window |du|,|dv| < rad, by keypoint
// and candidate validity and by the octave band |oct - lvl| <= 1 (unless the
// candidate has no scale info, si = 0). It returns per keypoint the best and
// second-best distance and the argbest candidate, and per candidate the best
// keypoint (colk). Ties go to the lowest index on rows and on columns, as in
// the reference scan path (map_ops._match_scan_path), so the results are
// bit-exact against it.
//
// Design. The Pallas kernel keeps its running row state in output blocks
// that a sequential grid revisits. CUDA blocks run in parallel, so this is
// two launches:
//   1. tile_kernel: one block per TILE candidates. The tile's descriptors
//      and metadata sit in shared memory; each thread owns keypoint rows,
//      holds the row's 8 descriptor words in registers and scans the tile,
//      keeping (best, second, argbest) in registers; it writes them as the
//      tile's partials. Column winners are a shared-memory atomicMin over
//      the 64-bit key (distance bits << 32 | k): the least distance, then
//      the lowest k. Gated pairs never reach the popcount or the atomic.
//      A tile with no valid candidate writes colk = 0 and marks itself dead;
//      it does no distance work and writes no partials.
//   2. merge_kernel: per keypoint, 8 threads fold the live tiles' partials
//      and then each other's. The fold keeps the least distance and, among
//      equal distances, the lowest candidate index, and second = min(max(b1,
//      b2), min(s1, s2)): the scan path's merge (map_ops.py:279-282), made
//      order-free by comparing indices, so the folds may run in any order.
//      A row with no gated pair at all gets index 0, as in the scan path.
// The kernel reads the arrays the caller holds (packed int32 descriptors,
// float32 positions, int32 levels, bool flags): no per-call repacking.
// Distances are __popc(a ^ b) summed over 8 words: exact integers.
//
// Bound on this card at the main path's shapes (K = 1024, NC = 32768): the
// bytes are ~2 MB (~0.6 us at 3.35 TB/s); the dense work is K * NC * 8 =
// 268 M popcounts on the CUDA cores, or 2 * K * NC * 256 = 17.2 G int8
// operations (~8.7 us at 1,979 TOPS) as a +/-1 tensor-core product. So it
// is bound by operations, and only the live tiles need them. What this
// simple design leaves: it uses no tensor cores (an int8 +/-1 mma would do
// the distance arithmetic 32 pairs of bits at a time); every live tile
// re-reads the keypoints from L2; rows are scanned one candidate at a time
// with a branch per pair; the partials round-trip through device memory
// between the two launches; and at a few thousand live candidates only a
// few dozen of the 132 SMs get a live tile.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int TILE = 128;      // candidates per block
constexpr int THREADS = 256;   // threads per tile block
constexpr int MERGE_ROWS = 32; // keypoints per merge block
constexpr int MERGE_WAYS = 8;  // threads folding one keypoint's tiles

__global__ void __launch_bounds__(THREADS)
tile_kernel(const int4* __restrict__ kp_desc,     // (K, 2) int4 = (K, 8) int32
            const float2* __restrict__ kp_uv,     // (K,)
            const uint8_t* __restrict__ kp_ok,    // (K,) bool
            const int* __restrict__ kp_oct,       // (K,)
            const int4* __restrict__ pt_desc,     // (NC, 2) int4
            const float2* __restrict__ pt_uv,     // (NC,)
            const float* __restrict__ pt_rad,     // (NC,)
            const int* __restrict__ pt_lvl,       // (NC,)
            const uint8_t* __restrict__ pt_si,    // (NC,) bool
            const uint8_t* __restrict__ pt_ok,    // (NC,) bool
            int K,
            float* __restrict__ part_best,        // (NC / TILE, K)
            float* __restrict__ part_second,
            int* __restrict__ part_arg,
            int* __restrict__ tile_live,          // (NC / TILE,)
            int* __restrict__ colk) {             // (NC,)
  __shared__ int4 s_desc[TILE][2];
  __shared__ float2 s_uv[TILE];
  __shared__ float s_rad[TILE];
  __shared__ int s_lvl[TILE];
  __shared__ uint8_t s_si[TILE];
  __shared__ unsigned long long s_col[TILE];

  const int tile = blockIdx.x;
  const int c0 = tile * TILE;
  const int t = threadIdx.x;

  int live = 0;
  for (int c = t; c < TILE; c += THREADS) live |= pt_ok[c0 + c];
  live = __syncthreads_or(live);

  if (t == 0) tile_live[tile] = live;
  if (!live) {
    for (int c = t; c < TILE; c += THREADS) colk[c0 + c] = 0;
    return;
  }

  // An invalid candidate is stored with rad = -1: no |du| passes it.
  const unsigned long long no_winner =
      (unsigned long long)__float_as_uint(CUDART_INF_F) << 32;
  for (int c = t; c < TILE; c += THREADS) {
    s_desc[c][0] = pt_desc[2 * (c0 + c)];
    s_desc[c][1] = pt_desc[2 * (c0 + c) + 1];
    s_uv[c] = pt_uv[c0 + c];
    s_rad[c] = pt_ok[c0 + c] ? pt_rad[c0 + c] : -1.0f;
    s_lvl[c] = pt_lvl[c0 + c];
    s_si[c] = pt_si[c0 + c];
    s_col[c] = no_winner;
  }
  __syncthreads();

  const size_t row0 = (size_t)tile * K;
  for (int k = t; k < K; k += THREADS) {
    float best = CUDART_INF_F, second = CUDART_INF_F;
    int arg = 0;
    if (kp_ok[k]) {
      const float2 uv = kp_uv[k];
      const int oct = kp_oct[k];
      const int4 a0 = kp_desc[2 * k];
      const int4 a1 = kp_desc[2 * k + 1];
      for (int c = 0; c < TILE; ++c) {
        const float rad = s_rad[c];
        if (!(fabsf(uv.x - s_uv[c].x) < rad && fabsf(uv.y - s_uv[c].y) < rad))
          continue;
        if (s_si[c] && abs(oct - s_lvl[c]) > 1) continue;
        const int4 b0 = s_desc[c][0];
        const int4 b1 = s_desc[c][1];
        const int d = __popc(a0.x ^ b0.x) + __popc(a0.y ^ b0.y)
                    + __popc(a0.z ^ b0.z) + __popc(a0.w ^ b0.w)
                    + __popc(a1.x ^ b1.x) + __popc(a1.y ^ b1.y)
                    + __popc(a1.z ^ b1.z) + __popc(a1.w ^ b1.w);
        const float D = (float)d;
        if (D < best) {
          second = best;
          best = D;
          arg = c;
        } else if (D < second) {
          second = D;
        }
        atomicMin(&s_col[c],
                  ((unsigned long long)__float_as_uint(D) << 32) | (unsigned)k);
      }
    }
    part_best[row0 + k] = best;
    part_second[row0 + k] = second;
    part_arg[row0 + k] = arg + c0;
  }
  __syncthreads();
  for (int c = t; c < TILE; c += THREADS) {
    colk[c0 + c] = (int)(s_col[c] & 0xffffffffull);
  }
}

// Fold (b2, s2, i2) into (b1, s1, i1): least distance, then lowest index.
__device__ __forceinline__ void fold(float& b1, float& s1, int& i1,
                                     float b2, float s2, int i2) {
  const bool take = b2 < b1 || (b2 == b1 && i2 < i1);
  s1 = fminf(fmaxf(b1, b2), fminf(s1, s2));
  i1 = take ? i2 : i1;
  b1 = take ? b2 : b1;
}

__global__ void __launch_bounds__(MERGE_ROWS * MERGE_WAYS)
merge_kernel(const float* __restrict__ part_best,
             const float* __restrict__ part_second,
             const int* __restrict__ part_arg,
             const int* __restrict__ tile_live,
             int K, int n_tiles,
             float* __restrict__ best_out, float* __restrict__ second_out,
             int* __restrict__ idx_out) {
  __shared__ float s_best[MERGE_WAYS][MERGE_ROWS];
  __shared__ float s_second[MERGE_WAYS][MERGE_ROWS];
  __shared__ int s_idx[MERGE_WAYS][MERGE_ROWS];

  const int r = threadIdx.x;                 // keypoint within the block
  const int w = threadIdx.y;                 // which tiles this thread folds
  const int k = blockIdx.x * MERGE_ROWS + r;
  float best = CUDART_INF_F, second = CUDART_INF_F;
  int idx = 0x7fffffff;
  if (k < K) {
    for (int j = w; j < n_tiles; j += MERGE_WAYS) {
      if (!tile_live[j]) continue;
      const size_t o = (size_t)j * K + k;
      fold(best, second, idx, part_best[o], part_second[o], part_arg[o]);
    }
  }
  s_best[w][r] = best;
  s_second[w][r] = second;
  s_idx[w][r] = idx;
  __syncthreads();
  if (w == 0 && k < K) {
    for (int v = 1; v < MERGE_WAYS; ++v)
      fold(best, second, idx, s_best[v][r], s_second[v][r], s_idx[v][r]);
    best_out[k] = best;
    second_out[k] = second;
    idx_out[k] = best < CUDART_INF_F ? idx : 0;
  }
}

}  // namespace

extern "C" int gated_top2_hamming_tile() { return TILE; }

// Launches both kernels on `stream`; returns cudaGetLastError() (0 = ok).
// Arguments in the order of the Python wrapper's (and the matcher's).
// NC must be a multiple of TILE; descriptor pointers 16-byte aligned, the
// uv pointers 8-byte aligned.
extern "C" int gated_top2_hamming_launch(
    const void* kp_desc, const void* kp_uv, const void* kp_ok,
    const void* kp_oct, const void* pt_desc, const void* pt_uv,
    const void* pt_rad, const void* pt_lvl, const void* pt_si,
    const void* pt_ok, int K, int NC, void* part_best, void* part_second,
    void* part_arg, void* tile_live, void* best, void* second, void* idx,
    void* colk, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int n_tiles = NC / TILE;
  if (n_tiles > 0) {
    tile_kernel<<<n_tiles, THREADS, 0, s>>>(
        (const int4*)kp_desc, (const float2*)kp_uv, (const uint8_t*)kp_ok,
        (const int*)kp_oct, (const int4*)pt_desc, (const float2*)pt_uv,
        (const float*)pt_rad, (const int*)pt_lvl, (const uint8_t*)pt_si,
        (const uint8_t*)pt_ok, K, (float*)part_best, (float*)part_second,
        (int*)part_arg, (int*)tile_live, (int*)colk);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 block(MERGE_ROWS, MERGE_WAYS);
  merge_kernel<<<(K + MERGE_ROWS - 1) / MERGE_ROWS, block, 0, s>>>(
      (const float*)part_best, (const float*)part_second,
      (const int*)part_arg, (const int*)tile_live, K, n_tiles, (float*)best,
      (float*)second, (int*)idx);
  return (int)cudaGetLastError();
}
