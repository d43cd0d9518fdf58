// The tile sweep shared by the visited-set insert (hashset_insert.cu) and
// the fused wave (fused_wave.cu), as the Pallas kernels share probe_claim
// (stateright_tpu/ops/pallas_hashset.py:68, imported by
// stateright_tpu/ops/pallas_wave.py).
//
// What it computes: the Pallas kernels' ordered sweep. The table is cut
// into tiles of TILE_ROWS rows; tile t owns the sorted keys whose home
// lies in it and resolves them in key order against its window, rows
// [base_t, base_t + TILE_ROWS + MAX_PROBES), after tile t - 1 has written
// its claims. A key probes the MAX_PROBES rows at its home:
//   - a match before the first empty row -> found;
//   - otherwise it claims the first empty row -> fresh;
//   - otherwise (no empty row in the window) -> pending.
// Inactive keys report none of the three. An in-batch duplicate reports
// found (or pending, when its first copy was pending).
//
// Why tiles may run in parallel. In the ordered sweep, tile t's outcome
// depends on two things only: the pre-call contents of its window, and
// the claims that tile t - 1 made in its apron, rows [base_t, base_t +
// MAX_PROBES). Tile t - 2's window ends at base_{t-1} + MAX_PROBES <=
// base_t, and tile t + 1 runs after tile t. So tile t's result computed
// from the pre-call table is exact whenever the final tile t - 1 claimed
// nothing at local row >= TILE_ROWS ("spilled").
//
// The sweep is four kernels on one stream, with no host sync:
//   0. extent, parallel over positions: ends[t] = 1 + the last active
//      position of tile t (0 when it has none). Positions past it need no
//      resolving; the (MAX, MAX) sentinels of invalid lanes, sorted last,
//      would otherwise make the last tile's warp walk most of the batch.
//   1. speculate, parallel over tiles: one warp a tile (SPEC_WARPS tiles a
//      block, on every SM) loads its window from the unmodified table into
//      shared memory, resolves its keys in order, and writes each
//      position's outcome byte and spill[t]. It writes no table row, so no
//      tile sees another's claims.
//   2. repair, one block: walks the tiles t whose predecessor spilled, in
//      increasing order (candidates compacted from the spill bytes, a
//      chunk of REPAIR_THREADS tiles at a time). When the final tile t - 1
//      spilled, tile t is redone on the pre-call window plus tile t - 1's
//      final apron claims (read back from its outcome bytes), which
//      overwrites t's outcomes and spill[t]. A redone tile that now spills
//      makes its successor a candidate, so chains of any length, up to
//      every tile, come out as the ordered sweep's. A tile never visited
//      keeps its speculative result, exact because its predecessor's
//      final spill bit is clear. (A redo only adds occupied rows before
//      each key, so a tile that spilled speculatively still spills when
//      redone: the walk can lengthen a chain, never cut one.)
//   3. commit, parallel over positions: table[home + offset] = key for
//      each final claim (final claims are distinct rows that were empty,
//      so the scatter has no race) and batch.store of every outcome.
//
// Within a tile one warp resolves the keys in order: each lane checks 4 of
// the 128 probe rows, and __ballot_sync gives the first empty and the
// first match; lane 0 writes the claim into the window and __syncwarp
// orders it before the next key's probe.
//
// Scratch (8 + 9 * n_tiles + B bytes, allocated by the caller): the count
// of tiles redone (an int32 and 4 bytes of padding, for measurement), ends
// (a u64 per tile), a spill byte per tile, and an outcome byte per
// position below its tile's end: 0..MAX_PROBES-1 claims the row at home +
// that offset, OUT_NONE / OUT_FOUND / OUT_PENDING otherwise.
//
// The batch is a class with three device members, so that each caller
// keeps its own key and flag layout:
//   uint2 key(int64_t i)          the (hi, lo) key at sorted position i;
//   uint8_t active(int64_t i)     nonzero when position i is to be resolved;
//   void store(int64_t i, f)      the outcome of position i (FLAG_* bits,
//                                 0 for an inactive key), called once for
//                                 every position.

#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_PROBES 128
#define TILE_ROWS 2048
#define WINDOW_ROWS (TILE_ROWS + MAX_PROBES)
#define FULL_MASK 0xFFFFFFFFu

#define FLAG_FRESH 1
#define FLAG_FOUND 2
#define FLAG_PENDING 4

#define OUT_NONE 0x80
#define OUT_FOUND (0x80 | FLAG_FOUND)
#define OUT_PENDING (0x80 | FLAG_PENDING)

#define SPEC_WARPS 4
#define SPEC_SMEM (SPEC_WARPS * WINDOW_ROWS * 8)  // 69,632 B of windows
#define REPAIR_THREADS 1024
#define COMMIT_THREADS 256

// Copies the WINDOW_ROWS rows at `rows` into shared memory, 16 bytes a
// copy, all in flight at once (cp.async); thread `me` of `n` copies every
// n-th piece and waits for its own copies.
__device__ __forceinline__ void load_window(uint2* window, const uint2* rows, int me, int n) {
  for (int i = me; i < WINDOW_ROWS / 2; i += n) {
    __pipeline_memcpy_async(reinterpret_cast<uint4*>(window) + i,
                            reinterpret_cast<const uint4*>(rows) + i, 16);
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
}

// One warp resolves positions [s, e) of the tile at row `base` in order
// against `window`, writing each position's outcome byte; returns (on
// every lane) whether it claimed a row at local row >= TILE_ROWS.
template <class Batch>
__device__ __forceinline__ bool resolve_tile(uint2* window, const Batch& batch,
                                             int64_t s, int64_t e, int64_t base,
                                             unsigned shift, uint8_t* out) {
  const int lane = threadIdx.x & 31;
  bool spill = false;
  // Each lane holds one position of the chunk; the next chunk's key and
  // active byte are loaded before this chunk is resolved.
  bool in = s + lane < e;
  uint2 k = in ? batch.key(s + lane) : make_uint2(0u, 0u);
  bool act = in && batch.active(s + lane) != 0;
  for (int64_t j0 = s; j0 < e; j0 += 32) {
    const int64_t j = j0 + lane;
    const int64_t jn = j + 32;
    const bool in_next = jn < e;
    const uint2 k_next = in_next ? batch.key(jn) : make_uint2(0u, 0u);
    const bool act_next = in_next && batch.active(jn) != 0;
    unsigned todo = __ballot_sync(FULL_MASK, act);
    uint8_t my = OUT_NONE;
    while (todo) {
      const int b = __ffs(todo) - 1;
      todo &= todo - 1;
      const uint32_t kh = __shfl_sync(FULL_MASK, k.x, b);
      const uint32_t kl = __shfl_sync(FULL_MASK, k.y, b);
      const int local = (int)((int64_t)(kh >> shift) - base);
      int first_empty = MAX_PROBES;
      int first_match = MAX_PROBES;
#pragma unroll
      for (int q = 3; q >= 0; --q) {
        const uint2 r = window[local + q * 32 + lane];
        const unsigned be = __ballot_sync(FULL_MASK, r.x == 0u && r.y == 0u);
        const unsigned bm = __ballot_sync(FULL_MASK, r.x == kh && r.y == kl);
        if (be) first_empty = q * 32 + __ffs(be) - 1;
        if (bm) first_match = q * 32 + __ffs(bm) - 1;
      }
      const bool is_found = first_match < first_empty;
      const bool can_claim = !is_found && first_empty < MAX_PROBES;
      if (can_claim) {
        if (lane == 0) window[local + first_empty] = make_uint2(kh, kl);
        spill |= local + first_empty >= TILE_ROWS;
      }
      __syncwarp();
      if (lane == b) {
        my = can_claim ? (uint8_t)first_empty : (is_found ? OUT_FOUND : OUT_PENDING);
      }
    }
    if (in) out[j] = my;
    in = in_next;
    k = k_next;
    act = act_next;
  }
  return spill;
}

// Pass 0: ends[t] (zeroed by the caller) = 1 + tile t's last active
// position. Positions grow with the lane, so the highest lane of each group
// of active lanes in one tile holds the group's last position.
template <class Batch>
__global__ void __launch_bounds__(COMMIT_THREADS) sweep_extent_kernel(
    Batch batch, int64_t B, int cap_bits, unsigned long long* __restrict__ ends) {
  const int64_t i = (int64_t)blockIdx.x * COMMIT_THREADS + threadIdx.x;
  const bool act = i < B && batch.active(i) != 0;
  const int tile = act ? (int)((batch.key(i).x >> (32u - (unsigned)cap_bits)) / TILE_ROWS) : -1;
  const unsigned peers = __match_any_sync(FULL_MASK, tile);
  if (act && (int)(threadIdx.x & 31) == 31 - __clz(peers)) {
    atomicMax(&ends[tile], (unsigned long long)(i + 1));
  }
}

// Pass 1: one warp a tile, on the pre-call table.
template <class Batch>
__global__ void __launch_bounds__(SPEC_WARPS * 32) sweep_speculate_kernel(
    const uint2* __restrict__ table, Batch batch, const int64_t* __restrict__ starts,
    const unsigned long long* __restrict__ ends, int n_tiles, int cap_bits,
    uint8_t* __restrict__ spill, uint8_t* out) {
  extern __shared__ __align__(16) uint2 windows[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * SPEC_WARPS + warp;
  if (t >= n_tiles) return;
  const int64_t s = starts[t];
  const int64_t e = (int64_t)ends[t];
  bool spilled = false;
  if (e > s) {  // a tile with no active key moves no data
    uint2* window = windows + warp * WINDOW_ROWS;
    const int64_t base = (int64_t)t * TILE_ROWS;
    load_window(window, table + base, lane, 32);
    __syncwarp();
    spilled = resolve_tile(window, batch, s, e, base, 32u - (unsigned)cap_bits, out);
  }
  if (lane == 0) spill[t] = spilled;
}

// Pass 2: one block redoes, in order, every tile whose final predecessor
// spilled. Its own stores (spill, outcomes) are read back by the block
// after __syncthreads, through L2 (__ldcg).
template <class Batch>
__global__ void __launch_bounds__(REPAIR_THREADS) sweep_repair_kernel(
    const uint2* __restrict__ table, Batch batch, const int64_t* __restrict__ starts,
    const unsigned long long* __restrict__ ends, int n_tiles, int cap_bits,
    uint8_t* spill, uint8_t* out, int* redone) {
  __shared__ __align__(16) uint2 window[WINDOW_ROWS];
  __shared__ int s_cand[REPAIR_THREADS];
  __shared__ int s_count[REPAIR_THREADS / 32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned shift = 32u - (unsigned)cap_bits;
  int n_redone = 0;

  for (int c0 = 1; c0 < n_tiles; c0 += REPAIR_THREADS) {
    const int c1 = n_tiles < c0 + REPAIR_THREADS ? n_tiles : c0 + REPAIR_THREADS;
    // Candidates of this chunk, in order: tiles with active keys whose
    // predecessor spilled (speculatively, or finally for t - 1 < c0).
    const int tc = c0 + tid;
    const bool cand = tc < c1 && __ldcg(spill + tc - 1) != 0 && (int64_t)ends[tc] > starts[tc];
    const unsigned m = __ballot_sync(FULL_MASK, cand);
    if (lane == 0) s_count[warp] = __popc(m);
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < REPAIR_THREADS / 32; ++w) {
      before += w < warp ? s_count[w] : 0;
      total += s_count[w];
    }
    if (cand) s_cand[before + __popc(m & ((1u << lane) - 1u))] = tc;
    __syncthreads();

    // The walk. `forced` is a successor of a tile that a redo made spill;
    // a forced tile past this chunk is the next chunk's candidate.
    int i = 0, forced = -1;
    for (;;) {
      const int a = i < total ? s_cand[i] : n_tiles;
      const int t = forced >= 0 && forced < a ? forced : a;
      if (t >= c1) break;
      if (t == a) ++i;
      forced = -1;
      if (__ldcg(spill + t - 1) == 0) continue;  // exact as speculated

      const int64_t base = (int64_t)t * TILE_ROWS;
      load_window(window, table + base, tid, REPAIR_THREADS);
      __syncthreads();
      // Tile t - 1's final claims that fall in this window.
      for (int64_t j = starts[t - 1] + tid; j < (int64_t)ends[t - 1]; j += REPAIR_THREADS) {
        const uint8_t o = __ldcg(out + j);
        if (o < MAX_PROBES) {
          const uint2 k = batch.key(j);
          const int64_t row = (int64_t)(k.x >> shift) + o;
          if (row >= base) window[row - base] = k;
        }
      }
      __syncthreads();
      if (warp == 0) {
        const bool sp = resolve_tile(window, batch, starts[t], (int64_t)ends[t], base, shift, out);
        if (lane == 0) spill[t] = sp;
      }
      __syncthreads();  // outcomes and spill[t] stored; window free
      ++n_redone;
      if (__ldcg(spill + t) != 0 && t + 1 < c1 && (int64_t)ends[t + 1] > starts[t + 1]) {
        forced = t + 1;
      }
    }
    __syncthreads();  // s_cand and s_count free for the next chunk
  }
  if (tid == 0) *redone = n_redone;
}

// Pass 3: every position's final outcome.
template <class Batch>
__global__ void __launch_bounds__(COMMIT_THREADS) sweep_commit_kernel(
    uint2* __restrict__ table, Batch batch, int64_t B, int cap_bits,
    const uint8_t* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * COMMIT_THREADS + threadIdx.x;
  if (i >= B) return;
  if (batch.active(i) == 0) {  // no outcome byte past the tile's end
    batch.store(i, 0);
    return;
  }
  const uint8_t o = out[i];
  if (o < MAX_PROBES) {
    const uint2 k = batch.key(i);
    table[(int64_t)(k.x >> (32u - (unsigned)cap_bits)) + o] = k;
    batch.store(i, FLAG_FRESH);
  } else {
    batch.store(i, (uint8_t)(o & ~OUT_NONE));
  }
}

// Launches the passes on `stream` over a batch of B sorted positions and
// the (n_tiles + 1,) tile bounds `starts` (starts[n_tiles] == B); returns
// the first CUDA error.
template <class Batch>
cudaError_t tile_sweep(uint2* table, const Batch& batch, const int64_t* starts, int64_t B,
                       int n_tiles, int cap_bits, void* scratch, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      sweep_speculate_kernel<Batch>, cudaFuncAttributeMaxDynamicSharedMemorySize, SPEC_SMEM);
  if (attr != cudaSuccess) return attr;
  int* redone = (int*)scratch;
  unsigned long long* ends = (unsigned long long*)((uint8_t*)scratch + 8);
  uint8_t* spill = (uint8_t*)(ends + n_tiles);
  uint8_t* out = spill + n_tiles;
  const int64_t pos_blocks = (B + COMMIT_THREADS - 1) / COMMIT_THREADS;
  cudaError_t e = cudaMemsetAsync(ends, 0, (size_t)n_tiles * sizeof(unsigned long long), stream);
  if (e != cudaSuccess) return e;
  if (pos_blocks > 0) {
    sweep_extent_kernel<Batch><<<(unsigned)pos_blocks, COMMIT_THREADS, 0, stream>>>(
        batch, B, cap_bits, ends);
  }
  const unsigned spec_blocks = (unsigned)((n_tiles + SPEC_WARPS - 1) / SPEC_WARPS);
  sweep_speculate_kernel<Batch><<<spec_blocks, SPEC_WARPS * 32, SPEC_SMEM, stream>>>(
      table, batch, starts, ends, n_tiles, cap_bits, spill, out);
  sweep_repair_kernel<Batch><<<1, REPAIR_THREADS, 0, stream>>>(
      table, batch, starts, ends, n_tiles, cap_bits, spill, out, redone);
  if (pos_blocks > 0) {
    sweep_commit_kernel<Batch><<<(unsigned)pos_blocks, COMMIT_THREADS, 0, stream>>>(
        table, batch, B, cap_bits, out);
  }
  return cudaGetLastError();
}
