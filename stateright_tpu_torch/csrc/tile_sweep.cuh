// The ordered tile sweep shared by the visited-set insert
// (hashset_insert.cu) and the fused wave (fused_wave.cu), as the Pallas
// kernels share probe_claim (stateright_tpu/ops/pallas_hashset.py:68,
// imported by stateright_tpu/ops/pallas_wave.py).
//
// One persistent block walks the table tiles in order. For every tile of
// TILE_ROWS rows that some key homes into, the tile's window (the tile
// plus a MAX_PROBES-row apron) is loaded into shared memory, the tile's
// keys are resolved one at a time in key order, and the window is written
// back before the next tile is loaded. A key probes the MAX_PROBES rows at
// its home:
//   - a match before the first empty row -> found;
//   - otherwise it claims the first empty row -> fresh;
//   - otherwise (no empty row in the window) -> pending.
// Inactive keys report none of the three. An in-batch duplicate reports
// found (or pending, when its first copy was pending).
//
// Exactness. The table layout and the flags are bit-identical to the
// Pallas kernels' for every input. The hazard is the apron: tile t writes
// its claims in the first MAX_PROBES rows of tile t+1 before tile t+1 reads
// its window, because the Pallas grid runs in order. Blocks of a CUDA grid
// run in no order, so the sweep runs in ONE block that walks the tiles in
// order; each window goes back to device memory before the next is read,
// and __syncthreads makes the stores visible to the block. Within a tile
// one warp resolves the keys in order: each lane checks 4 of the 128 probe
// rows, and __ballot_sync gives the first empty and the first match; lane
// 0 writes the claim and __syncwarp orders it before the next key's probe.
//
// The batch is a class with three device members, so that each caller
// keeps its own key and flag layout:
//   uint2 key(int64_t i)          the (hi, lo) key at sorted position i;
//   uint8_t active(int64_t i)     nonzero when position i is to be resolved;
//   void store(int64_t i, f)      the outcome of position i (FLAG_* bits,
//                                 0 for an inactive key), called once for
//                                 every position of every non-empty tile.
// The block must have SWEEP_THREADS threads.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_PROBES 128
#define TILE_ROWS 2048
#define WINDOW_ROWS (TILE_ROWS + MAX_PROBES)
#define SWEEP_THREADS 256
#define KEY_CHUNK 1024
#define FULL_MASK 0xFFFFFFFFu

#define FLAG_FRESH 1
#define FLAG_FOUND 2
#define FLAG_PENDING 4

template <class Batch>
__device__ __forceinline__ void tile_sweep(
    uint2* __restrict__ table,  // (cap + MAX_PROBES) rows of (hi, lo)
    const Batch& batch,
    const int64_t* __restrict__ starts,  // (n_tiles + 1,) key-range bounds
    int n_tiles, int cap_bits) {
  __shared__ __align__(16) uint2 window[WINDOW_ROWS];
  __shared__ uint32_t s_hi[KEY_CHUNK];
  __shared__ uint32_t s_lo[KEY_CHUNK];
  __shared__ uint8_t s_act[KEY_CHUNK];
  __shared__ uint8_t s_flag[KEY_CHUNK];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned shift = 32u - (unsigned)cap_bits;
  uint4* win4 = reinterpret_cast<uint4*>(window);

  for (int t = 0; t < n_tiles; ++t) {
    const int64_t s = starts[t];
    const int64_t e = starts[t + 1];
    if (e <= s) continue;  // no key homes here: the tile moves no data
    const int64_t base = (int64_t)t * TILE_ROWS;
    // ld.global.cg: the apron rows were stored by the previous tile, so
    // the window must never come through the non-coherent read-only path.
    const uint4* tile4 = reinterpret_cast<const uint4*>(table + base);
    for (int i = tid; i < WINDOW_ROWS / 2; i += SWEEP_THREADS) win4[i] = __ldcg(tile4 + i);

    for (int64_t c = s; c < e; c += KEY_CHUNK) {
      const int n = (int)(e - c < KEY_CHUNK ? e - c : KEY_CHUNK);
      for (int i = tid; i < n; i += SWEEP_THREADS) {
        const uint2 k = batch.key(c + i);
        s_hi[i] = k.x;
        s_lo[i] = k.y;
        s_act[i] = batch.active(c + i);
      }
      __syncthreads();  // window and key chunk staged
      if (warp == 0) {
        for (int j0 = 0; j0 < n; j0 += 32) {
          const int j = j0 + lane;
          unsigned todo = __ballot_sync(FULL_MASK, j < n && s_act[j] != 0);
          uint8_t my_flag = 0;
          while (todo) {
            const int b = __ffs(todo) - 1;
            todo &= todo - 1;
            const uint32_t kh = s_hi[j0 + b];
            const uint32_t kl = s_lo[j0 + b];
            const int local = (int)((int64_t)(kh >> shift) - base);
            int first_empty = MAX_PROBES;
            int first_match = MAX_PROBES;
#pragma unroll
            for (int q = 3; q >= 0; --q) {
              const uint2 r = window[local + q * 32 + lane];
              const unsigned be =
                  __ballot_sync(FULL_MASK, r.x == 0u && r.y == 0u);
              const unsigned bm =
                  __ballot_sync(FULL_MASK, r.x == kh && r.y == kl);
              if (be) first_empty = q * 32 + __ffs(be) - 1;
              if (bm) first_match = q * 32 + __ffs(bm) - 1;
            }
            const bool is_found = first_match < first_empty;
            const bool can_claim = !is_found && first_empty < MAX_PROBES;
            if (can_claim && lane == 0) {
              window[local + first_empty] = make_uint2(kh, kl);
            }
            __syncwarp();
            if (lane == b) {
              my_flag = can_claim ? FLAG_FRESH
                                  : (is_found ? FLAG_FOUND : FLAG_PENDING);
            }
          }
          if (j < n) s_flag[j] = my_flag;
        }
      }
      __syncthreads();  // flags final
      for (int i = tid; i < n; i += SWEEP_THREADS) batch.store(c + i, s_flag[i]);
      __syncthreads();  // staging buffers free for the next chunk
    }

    uint4* out4 = reinterpret_cast<uint4*>(table + base);
    for (int i = tid; i < WINDOW_ROWS / 2; i += SWEEP_THREADS) out4[i] = win4[i];
    __syncthreads();  // window stored (and visible) before the next load
  }
}
