// Tile-sweep visited-set insert for sorted (hi, lo) fingerprint batches.
//
// Replaces the TPU kernel stateright_tpu/ops/pallas_hashset.py::
// pallas_hashset_insert (kernel _insert_kernel, helper probe_claim), and
// computes exactly what it computes: the ordered tile sweep of
// tile_sweep.cuh (which states the claim rules and why one block walking
// the tiles in order is exact) over a batch of u32 key pairs and an active
// mask, reporting fresh, found and pending as three byte flags.
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

#include "tile_sweep.cuh"

// The insert's batch: keys as two u32 arrays, three byte flags out.
struct InsertBatch {
  const uint32_t* key_hi;  // (B,), sorted by (hi, lo)
  const uint32_t* key_lo;  // (B,)
  const uint8_t* act;      // (B,) 0/1
  uint8_t* fresh;
  uint8_t* found;
  uint8_t* pending;

  __device__ __forceinline__ uint2 key(int64_t i) const {
    return make_uint2(key_hi[i], key_lo[i]);
  }
  __device__ __forceinline__ uint8_t active(int64_t i) const { return act[i]; }
  __device__ __forceinline__ void store(int64_t i, uint8_t f) const {
    fresh[i] = f & FLAG_FRESH ? 1 : 0;
    found[i] = f & FLAG_FOUND ? 1 : 0;
    pending[i] = f & FLAG_PENDING ? 1 : 0;
  }
};

__global__ void __launch_bounds__(SWEEP_THREADS, 1) hashset_insert_kernel(
    uint2* __restrict__ table, InsertBatch batch,
    const int64_t* __restrict__ starts, int n_tiles, int cap_bits) {
  tile_sweep(table, batch, starts, n_tiles, cap_bits);
}

// Plain C entry point (loaded with ctypes). Launches on `stream` and
// returns cudaGetLastError(), so a refused launch is seen by the caller.
extern "C" int hashset_insert_launch(void* table, const void* key_hi,
                                     const void* key_lo, const void* active,
                                     const void* starts, int n_tiles,
                                     int cap_bits, void* fresh, void* found,
                                     void* pending, void* stream) {
  InsertBatch batch{(const uint32_t*)key_hi, (const uint32_t*)key_lo,
                    (const uint8_t*)active, (uint8_t*)fresh,
                    (uint8_t*)found, (uint8_t*)pending};
  hashset_insert_kernel<<<1, SWEEP_THREADS, 0, (cudaStream_t)stream>>>(
      (uint2*)table, batch, (const int64_t*)starts, n_tiles, cap_bits);
  return (int)cudaGetLastError();
}
