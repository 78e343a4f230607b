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
// Bound on this card at the main path's shapes (K = 1024, NC = 32768 slots,
// about 1,000 of them valid): the bytes are ~0.3 MB (~0.08 us at 3.35 TB/s);
// the distance work is K * n_valid * 8 popcounts, or 2 * K * n_valid * 256
// int8 operations (~0.28 us at 1,979 TOPS) as a +/-1 tensor-core product.
// So it is bound by operations, and only valid candidates need them. At this
// size that work is a few microseconds on the CUDA cores of 132 SMs, and
// what sets the time is how many SMs get work and how many dependent trips
// to memory each launch makes. Three launches:
//   1. compact_tile_kernel (one block of 1024 threads): each thread reads 32
//      valid flags with two 16-byte loads; a block-wide prefix sum gives the
//      live slots' indices in ascending order, written a warp round at a
//      time (32 consecutive slots per store), with each live slot's column
//      key set to "none". The live count stays on the device, so the grid
//      does not depend on where the valid slots sit among the NC.
//   2. tile_kernel (two blocks per SM, walking work items up to the device
//      count): an item is 64 keypoints x 128 live candidates. Each lane
//      gathers 4 candidates through the slot list into registers and each
//      warp walks 8 keypoints held in shared memory, so the lanes of a warp
//      score different candidates; a pair outside the gate skips the
//      popcounts. Every gated pair is a 32-bit key (distance << 23 | index):
//      a row keeps a lane-local top-2 of (distance, slot) keys, folded over
//      the warp with two __reduce_min_sync and stored per (chunk, keypoint);
//      a column keeps the least (distance, keypoint) key in a register, then
//      one shared-memory atomicMin per lane and column (different addresses)
//      and one device-memory atomicMin per gated column and item. Keys order
//      by distance, then by index, so min is the tie rule (lowest index)
//      and no step depends on order.
//   3. merge_kernel: folds each keypoint's per-chunk keys; the best key's
//      low bits are the argbest slot (0 for a row with no gated pair, as in
//      the scan path). Writes colk for every slot from its column key (0 for
//      a dead slot or a candidate no gated keypoint reaches).
// The kernels read the arrays the caller holds (packed int32 descriptors,
// float32 positions, int32 levels, bool flags): no per-call repacking.
// No tensor cores: at ~1,000 live candidates the popcounts are not what sets
// the time. Near full occupancy (32768 live, 268 M popcounts) they are, and a
// b1 mma distance tile is the next step there.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int SCAN_THREADS = 1024;            // the compaction block
constexpr int SCAN_SPAN = SCAN_THREADS * 32;  // slots per pass of that block
constexpr int THREADS = 256;                  // threads per tile block
constexpr int KP_PER_WARP = 8;                // keypoints a warp walks
constexpr int KP_BLOCK = KP_PER_WARP * (THREADS / 32);  // keypoints per item
constexpr int PER_LANE = 4;                   // candidates a lane holds
constexpr int CHUNK = 32 * PER_LANE;          // compacted candidates per item
constexpr int MERGE_ROWS = 32;                // keypoints per merge block
constexpr int MERGE_WAYS = 8;                 // threads folding one keypoint
constexpr int INDEX_BITS = 23;                // key = distance << 23 | index
constexpr unsigned INDEX_MASK = (1u << INDEX_BITS) - 1;
constexpr unsigned NO_KEY = 0xffffffffu;      // gated out (above any key)
constexpr unsigned FULL = 0xffffffffu;

static_assert(KP_PER_WARP <= 32, "a lane keeps one keypoint's row keys");

__global__ void __launch_bounds__(SCAN_THREADS)
compact_tile_kernel(const uint8_t* __restrict__ pt_ok,  // (NC,) bool
                    int NC,
                    int* __restrict__ cand_slot,        // (NC,) live slots
                    unsigned* __restrict__ col_key,     // (NC,) per slot
                    int* __restrict__ n_live) {
  __shared__ int s_warp[SCAN_THREADS / 32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  int base = 0;  // live slots found by earlier passes
  for (int seg = 0; seg < NC; seg += SCAN_SPAN) {
    // Thread t reads the 32 flags of slots seg + 32 t .. + 31 as two 16-byte
    // loads (a warp reads 1 KB, coalesced) and packs them into bits.
    unsigned mask = 0;
    if (seg + 32 * t < NC) {
      const uint4* f = (const uint4*)(pt_ok + seg + 32 * t);
      const uint4 lo = f[0], hi = f[1];
      const unsigned w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)  // 4 bytes of 0/1 -> 4 bits, byte 0 lowest
        mask |= ((__vcmpne4(w[i], 0u) & 0x01010101u) * 0x01020408u >> 24)
                << (4 * i);
    }
    const int cnt = __popc(mask);
    int incl = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int w = s_warp[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(FULL, w, o);
        if (lane >= o) w += v;
      }
      s_warp[lane] = w;
    }
    __syncthreads();
    // Write the warp's live slots in 32 rounds, round r being lane r's 32
    // slots: lane l writes slot 32 r + l, so each round's stores are
    // consecutive.
    const int first = seg + 1024 * warp;
    const int wbase = base + (warp > 0 ? s_warp[warp - 1] : 0);
    const int excl = incl - cnt;
    if (__any_sync(FULL, mask != 0u)) {
      for (int r = 0; r < 32; ++r) {
        const unsigned m = __shfl_sync(FULL, mask, r);
        const int pre = __shfl_sync(FULL, excl, r);
        if ((m >> lane) & 1u) {
          const int s = first + 32 * r + lane;
          cand_slot[wbase + pre + __popc(m & ((1u << lane) - 1u))] = s;
          col_key[s] = NO_KEY;
        }
      }
    }
    base += s_warp[SCAN_THREADS / 32 - 1];
    __syncthreads();  // s_warp is rewritten by the next pass
  }
  if (t == 0) *n_live = base;
}

__global__ void __launch_bounds__(THREADS)
tile_kernel(const int4* __restrict__ kp_desc,    // (K, 2) int4 = (K, 8) int32
            const float2* __restrict__ kp_uv,    // (K,)
            const uint8_t* __restrict__ kp_ok,   // (K,) bool
            const int* __restrict__ kp_oct,      // (K,)
            const int4* __restrict__ pt_desc,    // (NC, 2) int4
            const float2* __restrict__ pt_uv,    // (NC,)
            const float* __restrict__ pt_rad,    // (NC,)
            const int* __restrict__ pt_lvl,      // (NC,)
            const uint8_t* __restrict__ pt_si,   // (NC,) bool
            const int* __restrict__ cand_slot,
            const int* __restrict__ n_live, int K,
            uint2* __restrict__ part,            // (NC / CHUNK, K) row keys
            unsigned* __restrict__ col_key) {
  __shared__ int4 s_kd[KP_BLOCK][2];
  __shared__ float2 s_kuv[KP_BLOCK];
  __shared__ int s_koct[KP_BLOCK];
  __shared__ int s_kok[KP_BLOCK];
  __shared__ int s_slot[CHUNK];
  __shared__ unsigned s_col[CHUNK];

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int live = *n_live;
  const int n_chunks = (live + CHUNK - 1) / CHUNK;
  const int n_items = n_chunks * ((K + KP_BLOCK - 1) / KP_BLOCK);
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int chunk = item % n_chunks;
    const int k0 = item / n_chunks * KP_BLOCK;
    const int c0 = chunk * CHUNK;
    if (t < KP_BLOCK) {
      const int k = k0 + t;
      const bool ok = k < K && kp_ok[k];
      s_kok[t] = ok;
      if (ok) {
        s_kd[t][0] = kp_desc[2 * k];
        s_kd[t][1] = kp_desc[2 * k + 1];
        s_kuv[t] = kp_uv[k];
        s_koct[t] = kp_oct[k];
      }
    }
    if (t < CHUNK) s_col[t] = NO_KEY;
    // This lane's candidates are c0 + lane + 32 q of the slot list, read
    // from the caller's arrays. The radius carries the scale flag in its
    // sign: r > 0 with the level gate, -r without it, 0 for a radius that
    // gates nothing (r <= 0 or NaN: no |du| < r holds), and 0 past the live
    // count.
    int4 d0[PER_LANE], d1[PER_LANE];
    float2 uv_c[PER_LANE];
    float rad[PER_LANE];
    int lvl[PER_LANE];
    unsigned slot[PER_LANE], col[PER_LANE];
#pragma unroll
    for (int q = 0; q < PER_LANE; ++q) {
      const int c = c0 + lane + 32 * q;
      slot[q] = c < live ? (unsigned)cand_slot[c] : 0u;
      col[q] = NO_KEY;
    }
#pragma unroll
    for (int q = 0; q < PER_LANE; ++q) {
      const int c = c0 + lane + 32 * q, sl = (int)slot[q];
      if (c < live) {
        d0[q] = pt_desc[2 * sl];
        d1[q] = pt_desc[2 * sl + 1];
        uv_c[q] = pt_uv[sl];
        const float r = pt_rad[sl];
        rad[q] = r > 0.0f ? (pt_si[sl] ? r : -r) : 0.0f;
        lvl[q] = pt_lvl[sl];
      } else {
        d0[q] = d1[q] = make_int4(0, 0, 0, 0);
        uv_c[q] = make_float2(0.0f, 0.0f);
        rad[q] = 0.0f;
        lvl[q] = 0;
      }
      if (warp == 0) s_slot[lane + 32 * q] = (int)slot[q];
    }
    __syncthreads();

    uint2 mine = make_uint2(NO_KEY, NO_KEY);  // row keys of keypoint `lane`
#pragma unroll 2
    for (int i = 0; i < KP_PER_WARP; ++i) {
      const int j = warp * KP_PER_WARP + i;
      if (!s_kok[j]) continue;  // the same for every lane of the warp
      const unsigned k = (unsigned)(k0 + j);
      const int4 a0 = s_kd[j][0], a1 = s_kd[j][1];
      const float2 uv = s_kuv[j];
      const unsigned oct = (unsigned)s_koct[j];
      unsigned b = NO_KEY, s = NO_KEY;
#pragma unroll
      for (int q = 0; q < PER_LANE; ++q) {
        const float r = fabsf(rad[q]);
        // |oct - lvl| <= 1 in wrapping int32 arithmetic, as the plain
        // version's int32 abs (which leaves INT_MIN negative) computes it
        const unsigned dl = oct - (unsigned)lvl[q];
        const bool gate = (fabsf(uv.x - uv_c[q].x) < r)
            & (fabsf(uv.y - uv_c[q].y) < r)
            & ((rad[q] < 0.0f) | (dl + 1u <= 2u) | (dl == 0x80000000u));
        if (!gate) continue;  // most pairs: no popcount, no key
        const unsigned d =
            __popc(a0.x ^ d0[q].x) + __popc(a0.y ^ d0[q].y)
            + __popc(a0.z ^ d0[q].z) + __popc(a0.w ^ d0[q].w)
            + __popc(a1.x ^ d1[q].x) + __popc(a1.y ^ d1[q].y)
            + __popc(a1.z ^ d1[q].z) + __popc(a1.w ^ d1[q].w);
        const unsigned rk = d << INDEX_BITS | slot[q];
        s = min(s, max(b, rk));
        b = min(b, rk);
        col[q] = min(col[q], d << INDEX_BITS | k);
      }
      // keys are unique, so exactly one lane holds the warp's best and
      // offers its second instead
      const unsigned wb = __reduce_min_sync(FULL, b);
      const unsigned ws = __reduce_min_sync(FULL, b == wb ? s : b);
      if (lane == i) mine = make_uint2(wb, ws);
    }
    if (lane < KP_PER_WARP) {
      const int k = k0 + warp * KP_PER_WARP + lane;
      if (k < K) part[(size_t)chunk * K + k] = mine;
    }
#pragma unroll
    for (int q = 0; q < PER_LANE; ++q)
      if (col[q] != NO_KEY) atomicMin(&s_col[lane + 32 * q], col[q]);
    __syncthreads();
    if (t < CHUNK && s_col[t] != NO_KEY)
      atomicMin(&col_key[s_slot[t]], s_col[t]);
    __syncthreads();  // shared memory is refilled by the next item
  }
}

// Fold the row keys p into (b, s): the two least keys of both.
__device__ __forceinline__ void fold(unsigned& b, unsigned& s, uint2 p) {
  s = min(max(b, p.x), min(s, p.y));
  b = min(b, p.x);
}

__device__ __forceinline__ float distance(unsigned key) {
  return key == NO_KEY ? CUDART_INF_F : (float)(key >> INDEX_BITS);
}

__global__ void __launch_bounds__(MERGE_ROWS * MERGE_WAYS)
merge_kernel(const uint2* __restrict__ part,
             const unsigned* __restrict__ col_key,
             const int* __restrict__ n_live,
             const uint8_t* __restrict__ pt_ok, int K, int NC,
             float* __restrict__ best_out, float* __restrict__ second_out,
             int* __restrict__ idx_out, int* __restrict__ colk) {
  __shared__ uint2 s_keys[MERGE_WAYS][MERGE_ROWS];

  const int r = threadIdx.x;  // keypoint within the block
  const int w = threadIdx.y;  // which chunks this thread folds
  const int k = blockIdx.x * MERGE_ROWS + r;
  const int n_chunks = (*n_live + CHUNK - 1) / CHUNK;
  unsigned b = NO_KEY, s = NO_KEY;
  if (k < K)
    for (int j = w; j < n_chunks; j += MERGE_WAYS)
      fold(b, s, part[(size_t)j * K + k]);
  s_keys[w][r] = make_uint2(b, s);
  __syncthreads();
  if (w == 0 && k < K) {
    for (int v = 1; v < MERGE_WAYS; ++v) fold(b, s, s_keys[v][r]);
    best_out[k] = distance(b);
    second_out[k] = distance(s);
    idx_out[k] = b == NO_KEY ? 0 : (int)(b & INDEX_MASK);
  }
  // colk: 0 for a dead slot or a candidate no gated keypoint reaches
  const int tid = (blockIdx.x * MERGE_WAYS + w) * MERGE_ROWS + r;
  for (int sl = tid; sl < NC; sl += gridDim.x * MERGE_WAYS * MERGE_ROWS) {
    const unsigned key = pt_ok[sl] ? col_key[sl] : NO_KEY;
    colk[sl] = key == NO_KEY ? 0 : (int)(key & INDEX_MASK);
  }
}

}  // namespace

extern "C" int gated_top2_hamming_chunk() { return CHUNK; }

// Launches the three kernels on `stream`; returns cudaGetLastError() (0 =
// ok) after the first that fails to launch. Arguments in the order of the
// Python wrapper's (the matcher's inputs, then kernel_buffers()). K and NC at
// most 2^23; descriptor and valid-flag pointers 16-byte aligned, uv pointers
// 8-byte aligned.
extern "C" int gated_top2_hamming_launch(
    const void* kp_desc, const void* kp_uv, const void* kp_ok,
    const void* kp_oct, const void* pt_desc, const void* pt_uv,
    const void* pt_rad, const void* pt_lvl, const void* pt_si,
    const void* pt_ok, int K, int NC, void* part, void* cand_slot,
    void* col_key, void* n_live, void* best, void* second, void* idx,
    void* colk, void* stream) {
  if (K <= 0 || K > (int)INDEX_MASK + 1 || NC < 0 || NC > (int)INDEX_MASK + 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  compact_tile_kernel<<<1, SCAN_THREADS, 0, s>>>(
      (const uint8_t*)pt_ok, NC, (int*)cand_slot, (unsigned*)col_key,
      (int*)n_live);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  // two blocks per SM walk the items
  int dev = 0, n_sm = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int max_items =
      (NC + CHUNK - 1) / CHUNK * ((K + KP_BLOCK - 1) / KP_BLOCK);
  const int grid = max_items < 2 * n_sm ? max_items : 2 * n_sm;
  if (grid > 0) {
    tile_kernel<<<grid, THREADS, 0, s>>>(
        (const int4*)kp_desc, (const float2*)kp_uv, (const uint8_t*)kp_ok,
        (const int*)kp_oct, (const int4*)pt_desc, (const float2*)pt_uv,
        (const float*)pt_rad, (const int*)pt_lvl, (const uint8_t*)pt_si,
        (const int*)cand_slot, (const int*)n_live, K, (uint2*)part,
        (unsigned*)col_key);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }

  const int row_blocks = (K + MERGE_ROWS - 1) / MERGE_ROWS;
  const int slot_blocks = (NC + 1023) / 1024;
  merge_kernel<<<row_blocks > slot_blocks ? row_blocks : slot_blocks,
                 dim3(MERGE_ROWS, MERGE_WAYS), 0, s>>>(
      (const uint2*)part, (const unsigned*)col_key, (const int*)n_live,
      (const uint8_t*)pt_ok, K, NC, (float*)best, (float*)second, (int*)idx,
      (int*)colk);
  return (int)cudaGetLastError();
}
