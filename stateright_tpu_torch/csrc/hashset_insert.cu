// Tile-sweep visited-set insert for sorted (hi, lo) fingerprint batches.
//
// Replaces the TPU kernel stateright_tpu/ops/pallas_hashset.py::
// pallas_hashset_insert (kernel _insert_kernel, helper probe_claim), and
// computes exactly what it computes: for every table tile of TILE_ROWS
// rows that some key homes into, in tile order, the tile's window (the
// tile plus a MAX_PROBES-row apron) is loaded, the tile's keys are resolved
// one at a time in key order, and the window is written back before the
// next tile is loaded. A key probes the MAX_PROBES rows at its home:
//   - a match before the first empty row -> found;
//   - otherwise it claims the first empty row -> fresh;
//   - otherwise (no empty row in the window) -> pending.
// Inactive keys report none of the three. An in-batch duplicate reports
// found (or pending, when its first copy was pending).
//
// Exactness. The table layout and the flags are bit-identical to the
// Pallas kernel's for every input. The hazard is the apron: tile t writes
// its claims in the first MAX_PROBES rows of tile t+1 before tile t+1 reads
// its window, because the Pallas grid runs in order. Blocks of a CUDA grid
// run in no order, so this kernel runs ONE persistent block that walks the
// tiles in order (design (i)); each window goes back to device memory
// before the next is read, and __syncthreads makes the stores visible to
// the block. Within a tile one warp resolves the keys in order: each lane
// checks 4 of the 128 probe rows, and __ballot_sync gives the first empty
// and the first match; lane 0 writes the claim and __syncwarp orders it
// before the next key's probe.
//
// What bounds it on an H100. The bytes the insert must move are the
// distinct table rows its probes read (each from its home to its match,
// its claim, or the window's end), 8 B per claimed row written, and the
// keys and flags: B * 9 B (hi, lo, active) + B * 3 B. For a 2pc-8-sized
// batch (B = 344,064, about 100k distinct keys, a 2^22-row table at load
// 0.4) that is a few MB, a few us at 3.35 TB/s; chip_smoke.py computes it
// from its inputs. This kernel moves whole windows instead, in and out:
// touched_tiles * 2 * 17,408 B, about 71 MB when all 2,048 tiles are
// touched. The ordered claims make the kernel latency-bound far above
// both: one SM walks every tile, each tile pays a
// few dependent device-memory round trips (window in, keys in, flags out,
// window out), and each key pays ~8 ballots in shared memory. The design
// keeps every probe in shared memory, stages keys and flags through shared
// memory in coalesced chunks, and skips inactive keys 32 at a time with one
// ballot; it does not yet overlap one tile's loads with the previous tile's
// work, nor run independent tiles on other SMs (design (ii) in ROADMAP.md).

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_PROBES 128
#define TILE_ROWS 2048
#define WINDOW_ROWS (TILE_ROWS + MAX_PROBES)
#define THREADS 256
#define KEY_CHUNK 1024
#define FULL_MASK 0xFFFFFFFFu

#define FLAG_FRESH 1
#define FLAG_FOUND 2
#define FLAG_PENDING 4

__global__ void __launch_bounds__(THREADS, 1) hashset_insert_kernel(
    uint2* __restrict__ table,  // (cap + MAX_PROBES) rows of (hi, lo)
    const uint32_t* __restrict__ key_hi,  // (B,), sorted by (hi, lo)
    const uint32_t* __restrict__ key_lo,  // (B,)
    const uint8_t* __restrict__ active,   // (B,) 0/1
    const int64_t* __restrict__ starts,   // (n_tiles + 1,) key-range bounds
    int n_tiles, int cap_bits,
    uint8_t* __restrict__ fresh, uint8_t* __restrict__ found,
    uint8_t* __restrict__ pending) {
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
    for (int i = tid; i < WINDOW_ROWS / 2; i += THREADS) win4[i] = __ldcg(tile4 + i);

    for (int64_t c = s; c < e; c += KEY_CHUNK) {
      const int n = (int)(e - c < KEY_CHUNK ? e - c : KEY_CHUNK);
      for (int i = tid; i < n; i += THREADS) {
        s_hi[i] = key_hi[c + i];
        s_lo[i] = key_lo[c + i];
        s_act[i] = active[c + i];
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
      for (int i = tid; i < n; i += THREADS) {
        const uint8_t f = s_flag[i];
        fresh[c + i] = f & FLAG_FRESH ? 1 : 0;
        found[c + i] = f & FLAG_FOUND ? 1 : 0;
        pending[c + i] = f & FLAG_PENDING ? 1 : 0;
      }
      __syncthreads();  // staging buffers free for the next chunk
    }

    uint4* out4 = reinterpret_cast<uint4*>(table + base);
    for (int i = tid; i < WINDOW_ROWS / 2; i += THREADS) out4[i] = win4[i];
    __syncthreads();  // window stored (and visible) before the next load
  }
}

// Plain C entry point (loaded with ctypes). Launches on `stream` and
// returns cudaGetLastError(), so a refused launch is seen by the caller.
extern "C" int hashset_insert_launch(void* table, const void* key_hi,
                                     const void* key_lo, const void* active,
                                     const void* starts, int n_tiles,
                                     int cap_bits, void* fresh, void* found,
                                     void* pending, void* stream) {
  hashset_insert_kernel<<<1, THREADS, 0, (cudaStream_t)stream>>>(
      (uint2*)table, (const uint32_t*)key_hi, (const uint32_t*)key_lo,
      (const uint8_t*)active, (const int64_t*)starts, n_tiles, cap_bits,
      (uint8_t*)fresh, (uint8_t*)found, (uint8_t*)pending);
  return (int)cudaGetLastError();
}
