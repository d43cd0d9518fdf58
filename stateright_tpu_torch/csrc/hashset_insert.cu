// Tile-sweep visited-set insert for sorted (hi, lo) fingerprint batches.
//
// Replaces the TPU kernel stateright_tpu/ops/pallas_hashset.py::
// pallas_hashset_insert (kernel _insert_kernel, helper probe_claim), and
// computes exactly what it computes: the tile sweep of tile_sweep.cuh
// (which states the claim rules and why its three passes are exact) over
// a batch of u32 key pairs and an active mask, reporting fresh, found and
// pending as three byte flags.
//
// What bounds it on an H100. The bytes the insert must move are the
// distinct table rows its probes read (each from its home to its match,
// its claim, or the window's end), 8 B per claimed row written, and the
// keys and flags: B * 9 B (hi, lo, active) + B * 3 B. For a 2pc-8-sized
// batch (B = 344,064, about 100k distinct keys, a 2^22-row table at load
// 0.4) that is a few MB, a few us at 3.35 TB/s; chip_smoke.py computes it
// from its inputs. The speculative pass moves whole windows in instead
// (touched_tiles * 17,408 B, about 36 MB when all 2,048 tiles are
// touched, by cp.async) plus an outcome byte a position out and back in;
// it runs one warp a tile on every SM, so its time is a few window loads
// and a few tiles' worth of ordered ballots (~8 a key, in shared memory).
// The ordered repair is serial: ~10 us for each tile whose predecessor
// spilled into its apron, so its cost grows with the table's load. What
// it does not yet do: overlap one redo's loads with the previous redo,
// or repair independent chains in parallel.

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

// Plain C entry point (loaded with ctypes). Launches the sweep's passes on
// `stream` over B sorted positions and returns the first CUDA error, so a
// refused launch is seen by the caller. `scratch` holds
// 8 + 9 * n_tiles + B bytes (tile_sweep.cuh).
extern "C" int hashset_insert_launch(void* table, const void* key_hi,
                                     const void* key_lo, const void* active,
                                     const void* starts, int64_t B, int n_tiles,
                                     int cap_bits, void* fresh, void* found,
                                     void* pending, void* scratch, void* stream) {
  InsertBatch batch{(const uint32_t*)key_hi, (const uint32_t*)key_lo,
                    (const uint8_t*)active, (uint8_t*)fresh,
                    (uint8_t*)found, (uint8_t*)pending};
  return (int)tile_sweep((uint2*)table, batch, (const int64_t*)starts, B, n_tiles,
                         cap_bits, scratch, (cudaStream_t)stream);
}
