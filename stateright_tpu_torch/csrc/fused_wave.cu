// The model-independent stages of one BFS wave, as a chain of kernels.
//
// Replaces the TPU kernel stateright_tpu/ops/pallas_wave.py::fused_wave
// (inner kernel, prologue, sweep and epilogue) and computes what its
// prologue, sweep and epilogue compute after the model's own code has run.
// A Pallas kernel traces the model's expand, boundary and conditions into
// its prologue; a CUDA kernel cannot hold another program's code, so the
// caller runs that stage in torch (ops/fused_wave.py::model_stage) and
// hands over the condition matrix, the candidates' valid bits and the
// candidate leaves. The stages here are launched back to back on one
// stream, each through its own C entry point:
//
//   fw_frontier  eval mask (a live lane under depth_cap; the frontier mask
//                is optional, and a masked lane may hold a stale row that
//                no stage reads unmasked), eventually bits cleared by their
//                conditions, terminal lanes, the first hit lane of every
//                property, the max depth of the live lanes (Pallas: the
//                prologue's pallas_wave.py:131-143 and the epilogue's
//                :470-489); a memset of the counters and one kernel whose
//                blocks take a span of candidate lanes each (below);
//   fw_keys      the (hi, lo) fingerprint of every candidate on the default
//                fold route, read in place from the candidate leaves of any
//                dtype ops/fingerprint.py::_leaf_words converts, bit-identical
//                to fingerprint_words(state_words(...)) (Pallas: the model's
//                fp_fn traced into the prologue, pallas_wave.py:180);
//                invalid lanes (and the lanes of masked frontier lanes)
//                sink to (MAX, MAX). Two variants take its place for a
//                model with its own fingerprint:
//   fw_comphash_keys  the component hash of a packed actor state
//                (actor/packed.py::PackedActorModel.packed_fingerprint),
//                a warp a valid lane, read straight from the candidate
//                leaves: each actor row and timer word hashed
//                multilinearly and seeded by its tag, the envelope table's
//                multiset digest (sum and xor of its active rows' hashes)
//                hashed as one row, the history row, then the sum/xor
//                combination and the shared finalizer;
//   fw_keys_pairs the (hi, lo) pairs a model's own packed_fingerprint
//                computed in torch, with fw_keys's validity and count;
//   fw_sort      a stable LSD radix sort of the 64-bit keys carrying the
//                lane index, over the keyed lanes only: a stable partition
//                (keyed lanes to a dense prefix, the ~0 sentinel lanes
//                straight to their final tail, in lane order; tile offsets
//                by decoupled look-back; the 8 digit histograms of the
//                keyed lanes on the way), then 8 onesweep passes of 8 bits
//                over the prefix, one launch each: a block ranks its tile's
//                digits in input order (warp match + per-warp counters),
//                finds its per-digit offsets by look-back over the tiles
//                before it, orders the tile by digit in shared memory and
//                writes each digit's keys out as one run;
//   fw_dedup     first occurrence of each key whose lane is valid (active),
//                and each table tile's key range from the run boundaries
//                of the monotone homes, in one pass over the positions;
//   fw_sweep     the tile sweep of tile_sweep.cuh, the one the insert
//                kernel runs (Pallas: probe_claim, shared the same way):
//                tiles speculated in parallel, an ordered repair of the
//                tiles whose predecessor spilled, a parallel commit;
//   fw_compact   one pass over the sorted positions: a block takes a
//                tile by ticket, counts its fresh flags, finds the fresh
//                keys before it by decoupled look-back, and writes hi, lo,
//                ebits, depth + 1, the parent's hi and lo and the lane of
//                each fresh key to its slot (its rank among the fresh keys);
//                its last tile also writes the wave's stats vector,
//                [generated, n_new, overflow, max_depth, any_hit] and
//                (hit, hi, lo) per property, as int64 (Pallas: the
//                epilogue's pallas_wave.py:470-489 and :510-514), from the
//                counters, which are final by then;
//   fw_gather    the candidate leaves of the fresh keys, as byte rows: a
//                group of lanes a row (a warp for a leaf row of 512 B or
//                more), coalesced 16-byte units where alignment allows,
//                over a persistent grid bounded by the device's n_new.
//
// Every output equals the plain torch twin's (ops/fused_wave.py::
// fused_wave_plain) bit for bit, and the per-lane outputs are B rows long
// with the first n_new rows defined, as the Pallas outputs are.
//
// What bounds it on an H100. The bytes a wave must move, u32 values at
// 4 B though the port carries them in int64: the candidates' words (B * W
// * 4 B), the valid bits, the frontier arrays and conditions, the distinct
// table rows the probes read, the claimed rows, the fresh rows' outputs and
// leaves.
// At 2pc-8's main-path shape (F = 8,192, A = 42, B = 344,064, W = 11) that
// is about 20 MB, about 6 us at 3.35 TB/s; chip_smoke.py computes it from
// its inputs. The sweep moves whole windows into shared memory (one warp a
// touched tile, on every SM) and then repairs, in one block, the few tiles
// whose predecessor spilled into their apron. The other stages are
// bandwidth-shaped passes over B lanes. The sort, as a function, must read
// each lane's key and idx once and write them once: n * 24 B, 8.3 MB on a
// 2pc-8 wave (344,064 lanes), 0.0025 ms at 3.35 TB/s. This design moves
// more: 12 B a lane in and out in the partition, then 12 B a keyed lane in
// and out in each of its 8 passes (82,156 keyed lanes at 2pc-8; 76-91% of
// the lanes are sentinels and never enter a pass). Its time is launch and
// latency: 10 device operations (a memset, the partition, 8 passes;
// the former sort took 24, three a pass, one of them a one-block scan),
// tickets so a block waits only on tiles whose owners run, look-backs
// that read 16 (a digit pass) or 32 (the partition) status words at once
// with relaxed loads, every key of a tile loaded before its first barrier,
// a ranking with no block barrier a round, and a tile's keys leaving in
// runs of one digit rather than one scattered store each.
// The gather is bound by n_new * (8 + 2 * row bytes); a group of lanes a
// row with 16-byte units makes its loads coalesce. The fold keys stage is
// bound by the valid lanes' words (an invalid lane's key does not depend on
// its row), every lane's valid byte and its 12 B a lane written (8.1 MB at
// 2pc-8, 82,156 of 344,064 lanes valid: 2.4 us); reading int64 leaves in
// place moves 8 B a word, which makes that 11.7 MB (3.5 us). It reads the
// leaves where the model
// stage left them, so no words matrix is built (that copy, a pass a leaf
// and a cat, moved several times the stage's bytes). A thread a lane
// reading its rows in place beat staging a block's rows through shared
// memory with coalesced 16-byte copies: the staging's barriers, unit
// bookkeeping and conversion cost more than the strided loads it saved
// (PERF.md, section 6). The frontier is bound by well under 1 MB a wave
// and by its launches and round trips: a memset and one kernel, every SM
// busy, one global atomic a block and quantity. The design keeps every
// stage off the host (no sync inside a wave; counters live in a small
// device vector that the host reads once) and the launches few (about 25
// a wave). What it does not yet do: prefetch the sweep's windows
// asynchronously, or sort with fewer, wider digit passes (each pass costs
// a launch and a chain of dependent round trips, 7-8 us even on a few
// tiles).
//
// The coverage epilogue of the same Pallas kernel (pallas_wave.py:152-177,
// the exercise masks in the prologue; :495-507, DeviceCoverage.wave_reduce
// in the epilogue; the cov output, :538-539, :554-555, :606-633) has no
// kernel of its own: with coverage on, fw_frontier and fw_compact add the
// wave's coverage vector (telemetry/coverage.py::DeviceCoverage's layout,
// int64: evaluated, terminal, two symmetry slots left 0, per-action fired
// and fresh counts, per-property exercise counts, the successors-per-state
// log2 bins, the fresh-per-depth bins) from what they read anyway. The
// vector follows the counters in acc, so fw_frontier's one memset zeroes
// both. fw_frontier adds the frontier half (evaluated, terminal, fired,
// exercised, successor bins: it already decides the eval mask and the
// terminal lanes and reads each block's cvalid span, the conditions and
// ebits), fw_compact the fresh half (a fresh row's action lane % A and its
// child's depth bin min(depth[parent] + 1, 63): it already loads both).
// Counters gather in shared memory and fold into the vector with integer
// atomics, so the result is exact in any order. Bound by bytes: the
// frontier's depth and mask, each evaluated lane's valid bytes and the
// condition, antecedent and ebits words its properties read, the outcome
// byte of each sorted position holding a key, 4 B of idx at each fresh
// position only, and the vector: about 0.65 MB, 0.2 us at 3.35 TB/s on a
// full 2pc-8 wave (B = 344,064). A kernel of its own (and its memset) took
// about 8 us in a graph, set by launch latency; inside the two kernels it
// costs their extra arithmetic and the antecedent bytes.
//
// fw_dedup (the Pallas prologue's uniq/active mask and per-tile starts,
// pallas_wave.py:189-206) is bound by bytes: each position's 8 B key read
// and 1 B active written, and the (n_tiles + 1) * 8 B of starts (3.1 MB,
// 0.93 us at 2pc-8). The starts come from the run boundaries of the sorted
// homes in the same pass, not from a binary search a tile (log2(B)
// dependent loads a thread, which bound the former stage by latency).
//
// fw_comphash_keys (the Pallas prologue's model fingerprint,
// pallas_wave.py:180, for a packed actor model) is bound by bytes too: each
// valid lane's actor rows, timers, envelope counts, active envelopes and
// history (538 u32 words a lane at paxos check 3) read once, 12 B a lane
// written; an invalid lane reads only its valid bit. Only 9-13% of the
// lanes are valid on the main paths, and a lane's words lie together, so a
// block first sorts out its span's valid lanes and then hands each to a
// whole warp: the warp's lanes take neighbouring words of a component (its
// loads coalesce), a group of components' loads are in flight together,
// and the coefficients sit in shared memory as u32 (a thread a lane would
// read 32 rows 4.3 KB apart in each load instruction). A warp takes its
// lanes one after another, a few round trips each (the actor sweeps, the
// envelope table, the history), so the stage waits on memory and its time
// follows the warps in flight: 64 registers a thread keep four blocks on
// an SM (loading all of a lane's words at once needs more and was slower).
//
// fw_compact (the Pallas epilogue's pos = cumsum(fresh) - 1 and its
// scatters, pallas_wave.py:444-463) is bound by bytes: the B outcome bytes
// and, at each fresh position, its key and lane and the parent's ebits,
// depth, hi and lo read and seven outputs written (56 B at u32 width). One
// kernel and a memset of its status words: tiles in ticket order publish
// their fresh counts, each finds its offset by look-back, 4 tiles' words a
// lane, 128 a round, while its fresh rows load, and writes them to
// consecutive slots; no block scans for the others.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_sweep.cuh"

#define THREADS 256
#define MAX_PROPS 64
#define MAX_LEAVES 16

#define KIND_ALWAYS 0
#define KIND_SOMETIMES 1
#define KIND_EVENTUALLY 2

// The wave's device counters (unsigned long long): written by the stages,
// read by fw_compact, which writes the stats vector.
#define ACC_GENERATED 0
#define ACC_N_NEW 1
#define ACC_OVERFLOW 2
#define ACC_MAX_DEPTH 3
#define ACC_FIRST_HIT 4  // + property index: ~(first hit lane), 0 while no lane hit

#define SEED_HI 0x9747B28Cu
#define SEED_LO 0x3C6EF372u
#define FP_CHUNKS 16

#define SORT_ROUNDS 8
#define SORT_TILE (THREADS * SORT_ROUNDS)
#define PART_ITEMS 8
#define PART_TILE (THREADS * PART_ITEMS)
#define COMPACT_ITEMS 8
#define COMPACT_TILE (THREADS * COMPACT_ITEMS)
#define CH_SPAN 128  // lanes a block of comphash_keys_kernel sorts out
#define CH_GROUP 4   // components a warp sums in one sweep
#define MAX_CH_CONSTS 8192  // u32 coefficients and seeds in shared memory
#define COV_DEPTH_BINS 64
#define MAX_COV_WORDS 12288  // 48 KB of u32 counters in shared memory

typedef unsigned long long ull;

struct Props {
  int n;
  int kind[MAX_PROPS];
  int ebit[MAX_PROPS];  // the eventually bit, -1 for other kinds
};

struct Leaves {
  int n;
  const uint8_t* src[MAX_LEAVES];
  uint8_t* dst[MAX_LEAVES];
  int64_t row_bytes[MAX_LEAVES];
  int unit[MAX_LEAVES];  // copy width in bytes: 16, 8, 4, 2 or 1
};

static unsigned blocks_for(int64_t n, int64_t per_block) {
  const int64_t g = (n + per_block - 1) / per_block;
  return g < 1 ? 1u : (unsigned)g;
}

// -- block-wide helpers ----------------------------------------------------

// Exclusive prefix of v over the block (NT threads, a multiple of 32, at
// most 1024); *total gets the block's sum. Every thread must call it.
template <int NT>
__device__ __forceinline__ uint32_t block_exclusive_scan(uint32_t v, uint32_t* total) {
  __shared__ uint32_t s_warp[NT / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint32_t x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(FULL_MASK, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    uint32_t w = lane < NT / 32 ? s_warp[lane] : 0u;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(FULL_MASK, w, o);
      if (lane >= o) w += y;
    }
    if (lane < NT / 32) s_warp[lane] = w;
  }
  __syncthreads();
  const uint32_t before = warp ? s_warp[warp - 1] : 0u;
  *total = s_warp[NT / 32 - 1];
  __syncthreads();  // s_warp free for the next call
  return before + x - v;
}

// -- (a) frontier lanes --------------------------------------------------

// A block takes FT consecutive frontier lanes (FT from the host: about
// FRONTIER_SPAN candidate lanes a block, at most FRONTIER_THREADS), so
// even a narrow frontier (2,048 lanes of 125 actions) fills the SMs. The
// terminal test (no valid candidate) reads the block's candidate bytes,
// one contiguous span of cvalid, in aligned 16-byte units spread over the
// block's threads, and only when an eventually property needs it
// (need_terminal). Each property's first hit lane and the max depth are
// reduced in the block, then one atomic each: the first hit is stored as
// ~lane under atomicMax, so the zeroed acc means "no hit" and one memset
// resets the whole vector.
//
// With COV (coverage on) the kernel also adds the frontier half of the
// wave's coverage vector (the layout of telemetry/coverage.py::
// DeviceCoverage; the vector follows acc in one buffer, so the same memset
// zeroes it): evaluated and terminal lanes, each evaluated lane's
// successor-count bin and each property's exercised count, and the fired
// count of every action over the valid candidates of evaluated lanes. It
// then always reads the block's cvalid span and keeps a copy of its
// 16-byte units in shared memory; in the same pass it counts each lane's
// valid candidates (a thread sums a unit's bytes of one lane in a register
// before one shared atomic). Then a thread an action sums its column of
// the copy over the evaluated lanes (the fired counts; a shared atomic a
// byte was slower), the lane counts gather in shared memory by warp sums
// and a warp match, and a block flushes each non-zero counter with one
// global atomic.
#define FRONTIER_THREADS 128
#define FRONTIER_SPAN 1024
#define COV_MAX_SUCC_BINS 33  // succ_bins = ceil(log2(A)) + 1 for any int A
// The frontier half's counters a block gathers: evaluated, terminal, the
// properties' exercised counts and the successor bins.
#define COV_FRONT_WORDS (2 + MAX_PROPS + COV_MAX_SUCC_BINS)

template <bool COV>
__global__ void __launch_bounds__(FRONTIER_THREADS) frontier_kernel(
    int64_t F, int A, int FT, int64_t depth_cap,
    const uint8_t* __restrict__ cond,    // (P, F) 0/1
    const uint8_t* __restrict__ cvalid,  // (F * A,) expand & boundary
    const int64_t* __restrict__ depth, const int64_t* __restrict__ ebits,
    const uint8_t* __restrict__ mask,  // (F,) live lanes, or null: all
    int64_t* __restrict__ ebits_after, Props props, int need_terminal,
    ull* __restrict__ acc,
    const uint8_t* __restrict__ ant,  // COV: (P, F) antecedents (all ones but `always`)
    int succ_bins, ull* __restrict__ cov) {
  __shared__ uint8_t s_any[FRONTIER_THREADS];
  __shared__ uint32_t s_first[MAX_PROPS];
  __shared__ ull s_depth;
  __shared__ uint32_t s_succ[COV ? FRONTIER_THREADS : 1];  // valid candidates a lane
  __shared__ uint8_t s_ev[COV ? FRONTIER_THREADS : 1];
  __shared__ uint32_t s_cov[COV ? COV_FRONT_WORDS : 1];
  extern __shared__ uint4 s_span[];  // COV: the block's cvalid units
  const int t = threadIdx.x;
  const int64_t f0 = (int64_t)blockIdx.x * FT;
  const int nf = (int)(F - f0 < FT ? F - f0 : FT);
  const int64_t f = f0 + t;
  const bool in = t < nf;
  int64_t dep = 0, eb = 0;
  bool live = false;
  uint64_t cbits = 0, abits = 0;
  if (in) {
    dep = depth[f];
    eb = ebits[f];
    live = mask == nullptr || mask[f] != 0;
#pragma unroll 4
    for (int i = 0; i < props.n; ++i) {
      if (cond[(int64_t)i * F + f]) cbits |= 1ull << i;
      if (COV && props.kind[i] == KIND_ALWAYS && ant[(int64_t)i * F + f]) abits |= 1ull << i;
    }
  }
  s_any[t] = 0;
  if (t < MAX_PROPS) s_first[t] = 0xFFFFFFFFu;
  if (t == 0) s_depth = 0;
  if constexpr (COV) {
    s_succ[t] = 0;
    s_ev[t] = in && live && dep < depth_cap;
    for (int j = t; j < COV_FRONT_WORDS; j += FRONTIER_THREADS) s_cov[j] = 0u;
  }
  __syncthreads();
  if (COV || need_terminal) {
    const uintptr_t s = (uintptr_t)(cvalid + f0 * A);
    const int n = nf * A;
    const uintptr_t a = s & ~(uintptr_t)15;
    const int units = n ? (int)((s + n - a + 15) >> 4) : 0;
    for (int u = t; u < units; u += FRONTIER_THREADS) {
      const uint4 v = __ldg((const uint4*)(a + ((uintptr_t)u << 4)));
      if (COV) s_span[u] = v;
      if ((v.x | v.y | v.z | v.w) == 0u) continue;
      const uint32_t q[4] = {v.x, v.y, v.z, v.w};
      const int o0 = (int)((int64_t)(a + ((uintptr_t)u << 4)) - (int64_t)s);
      if constexpr (COV) {
        // The unit's bytes in order: lane ln, action rem; one division.
        const int first = o0 > 0 ? o0 : 0;
        int ln = first / A, rem = first - ln * A;
        uint32_t run = 0;
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          const int o = o0 + k;
          if (o >= 0 && o < n) {
            if ((q[k >> 2] >> ((k & 3) * 8)) & 0xFFu) ++run;
            if (++rem == A) {
              if (run) atomicAdd(&s_succ[ln], run);
              run = 0;
              ++ln;
              rem = 0;
            }
          }
        }
        if (run) atomicAdd(&s_succ[ln], run);
      } else {
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          const int o = o0 + k;
          if (o >= 0 && o < n && ((q[k >> 2] >> ((k & 3) * 8)) & 0xFFu)) s_any[o / A] = 1;
        }
      }
    }
    __syncthreads();
  }
  if (in) {
    for (int i = 0; i < props.n; ++i) {
      if (props.ebit[i] >= 0 && ((cbits >> i) & 1)) eb &= ~(1LL << props.ebit[i]);
    }
    ebits_after[f] = eb;
  }
  const bool ev = in && live && dep < depth_cap;
  const bool terminal = ev && (COV ? s_succ[t] == 0u : !s_any[t]);
  if constexpr (COV) {
    const int lane = t & 31;
    const unsigned ne = __reduce_add_sync(FULL_MASK, ev ? 1u : 0u);
    const unsigned nterm = __reduce_add_sync(FULL_MASK, terminal ? 1u : 0u);
    if (lane == 0) {
      if (ne) atomicAdd(&s_cov[0], ne);
      if (nterm) atomicAdd(&s_cov[1], nterm);
    }
    // Bin of the successor count: 0 for <= 1, else ceil(log2(succ)).
    const uint32_t succ = s_succ[t];
    const int bin = succ <= 1u ? 0 : 32 - __clz(succ - 1u);
    const unsigned peers = __match_any_sync(FULL_MASK, ev ? bin : -1);
    if (ev && lane == __ffs(peers) - 1) atomicAdd(&s_cov[2 + MAX_PROPS + bin], __popc(peers));
    for (int i = 0; i < props.n; ++i) {
      bool ex;
      if (props.kind[i] == KIND_ALWAYS) {
        ex = (abits >> i) & 1;
      } else if (props.kind[i] == KIND_SOMETIMES) {
        ex = (cbits >> i) & 1;
      } else {  // eventually: met = the unmet bit already cleared
        ex = ((eb >> props.ebit[i]) & 1) == 0;
      }
      const unsigned nx = __reduce_add_sync(FULL_MASK, ev && ex ? 1u : 0u);
      if (lane == 0 && nx) atomicAdd(&s_cov[2 + i], nx);
    }
    // Fired: a thread an action sums its column of the span's copy.
    const uint8_t* span = (const uint8_t*)s_span + ((uintptr_t)(cvalid + f0 * A) & 15);
    for (int c = t; c < A; c += FRONTIER_THREADS) {
      uint32_t fired = 0;
#pragma unroll 8
      for (int j = 0; j < nf; ++j) fired += s_ev[j] & (span[j * A + c] != 0);
      if (fired) atomicAdd(&cov[4 + c], (ull)fired);
    }
  }
  for (int i = 0; i < props.n; ++i) {
    const bool c = (cbits >> i) & 1;
    bool hit;
    if (props.kind[i] == KIND_ALWAYS) {
      hit = ev && !c;
    } else if (props.kind[i] == KIND_SOMETIMES) {
      hit = ev && c;
    } else {  // eventually: unmet bit at a terminal state
      hit = terminal && ((eb >> props.ebit[i]) & 1);
    }
    const uint32_t m = __reduce_min_sync(FULL_MASK, hit ? (uint32_t)f : 0xFFFFFFFFu);
    if ((t & 31) == 0 && m != 0xFFFFFFFFu) atomicMin(&s_first[i], m);
  }
  ull d = in && live ? (ull)dep : 0ull;  // max(where(mask, depth, 0))
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    const ull y = __shfl_down_sync(FULL_MASK, d, o);
    d = y > d ? y : d;
  }
  if ((t & 31) == 0 && d) atomicMax(&s_depth, d);
  __syncthreads();
  if (t < props.n && s_first[t] != 0xFFFFFFFFu)
    atomicMax(&acc[ACC_FIRST_HIT + t], ~(ull)s_first[t]);
  if (t == 0 && s_depth) atomicMax(&acc[ACC_MAX_DEPTH], s_depth);
  if constexpr (COV) {
    const int o_props = 4 + 2 * A, o_succ = o_props + props.n;
    if (t < 2 && s_cov[t]) atomicAdd(&cov[t], (ull)s_cov[t]);
    if (t < props.n && s_cov[2 + t]) atomicAdd(&cov[o_props + t], (ull)s_cov[2 + t]);
    if (t < succ_bins && s_cov[2 + MAX_PROPS + t])
      atomicAdd(&cov[o_succ + t], (ull)s_cov[2 + MAX_PROPS + t]);
  }
}

// -- (b) keys --------------------------------------------------------------

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ uint32_t mm3_round(uint32_t h, uint32_t k) {
  k *= 0xCC9E2D51u;
  k = rotl32(k, 15);
  k *= 0x1B873593u;
  h = rotl32(h ^ k, 13);
  return h * 5u + 0xE6546B64u;
}

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// ops/fingerprint.py::fingerprint_words over one row of n u32 words fed
// in order (push): a serial fold up to 64 words; above that, FP_CHUNKS
// consecutive chunks of L words (zero past n), each folded from its own
// seeds and its digest folded in order; then the shared finalizer and the
// (0, 0) and (MAX, MAX) nudges (finish).
struct RowFold {
  uint32_t hi, lo, chi, clo;
  int n, L, j, k;

  __device__ explicit RowFold(int n_)
      : hi(SEED_HI), lo(SEED_LO), chi(0u), clo(0u), n(n_),
        L((n_ + FP_CHUNKS - 1) / FP_CHUNKS), j(0), k(0) {}

  __device__ __forceinline__ void push(uint32_t w) {
    if (n <= 64) {
      hi = mm3_round(hi, w);
      lo = mm3_round(lo, w ^ 0xA5A5A5A5u);
      return;
    }
    if (j == 0) {
      chi = SEED_HI ^ ((uint32_t)k * 0x9E3779B9u);
      clo = SEED_LO ^ ((uint32_t)k * 0x85EBCA6Bu);
    }
    chi = mm3_round(chi, w);
    clo = mm3_round(clo, w ^ 0xA5A5A5A5u);
    if (++j == L) {
      hi = mm3_round(hi, chi);
      lo = mm3_round(lo, clo);
      j = 0;
      ++k;
    }
  }

  __device__ uint2 finish() {
    if (n > 64) {
      while (k < FP_CHUNKS) push(0u);
    }
    uint32_t h = fmix32(hi ^ (uint32_t)(n * 4));
    uint32_t l = fmix32(lo ^ (uint32_t)(n * 4 + 1));
    if (h == 0u && l == 0u) l = 1u;
    if (h == 0xFFFFFFFFu && l == 0xFFFFFFFFu) l = 0xFFFFFFFEu;
    return make_uint2(h, l);
  }
};

// A candidate lane is valid when cvalid holds, its frontier lane is live
// (mask[b / A], when mask is given) and under depth_cap (when depth is).
__device__ __forceinline__ unsigned lane_valid(int64_t b, int A,
                                               const uint8_t* __restrict__ cvalid,
                                               const int64_t* __restrict__ depth,
                                               const uint8_t* __restrict__ mask,
                                               int64_t depth_cap) {
  const uint32_t f = (uint32_t)b / (uint32_t)A;  // lanes are u32, as idx is
  return cvalid[b] != 0 && (mask == nullptr || mask[f] != 0) &&
         (depth == nullptr || depth[f] < depth_cap);
}

// The candidate leaves of the fold route, in ops/fingerprint.py::_leaves
// order (dict keys sorted), so that word c of a row is word c of
// state_words: each leaf's base pointer (contiguous, one row a lane), its
// u32 words a row and its element kind. Each element becomes one word as
// _leaf_words converts it: bool and small ints widen (signed ones wrap),
// int32 and float32 keep their bits, int64 keeps its low 32 bits.
#define LEAF_U8 0   // bool, uint8
#define LEAF_I8 1   // int8
#define LEAF_U16 2  // uint16
#define LEAF_I16 3  // int16
#define LEAF_B32 4  // int32, float32
#define LEAF_I64 5  // int64
#define MAX_FOLD_LEAVES 64

struct FoldLeaves {
  int n;
  int words;  // W: u32 words a row over all leaves
  const uint8_t* ptr[MAX_FOLD_LEAVES];
  int width[MAX_FOLD_LEAVES];
  int kind[MAX_FOLD_LEAVES];
};

__device__ __forceinline__ int leaf_bytes(int kind) {
  return kind <= LEAF_I8 ? 1 : (kind <= LEAF_I16 ? 2 : (kind == LEAF_B32 ? 4 : 8));
}

// Folds the w elements of one leaf row at p, each as its u32 word.
template <int KIND>
__device__ __forceinline__ void fold_leaf_row(RowFold& fold, const uint8_t* __restrict__ p,
                                              int w) {
  for (int j = 0; j < w; ++j) {
    uint32_t x;
    if (KIND == LEAF_U8) {
      x = p[j];
    } else if (KIND == LEAF_I8) {
      x = (uint32_t)(int32_t)((const int8_t*)p)[j];
    } else if (KIND == LEAF_U16) {
      x = ((const uint16_t*)p)[j];
    } else if (KIND == LEAF_I16) {
      x = (uint32_t)(int32_t)((const int16_t*)p)[j];
    } else if (KIND == LEAF_B32) {
      x = ((const uint32_t*)p)[j];
    } else {
      x = ((const uint32_t*)p)[2 * j];  // the low half, little-endian
    }
    fold.push(x);
  }
}

// key[b] = (hi << 32) | lo of lane b, or all ones when the lane is not
// valid (cvalid, when mask is given mask[b / A], and when depth is given
// depth[b / A] < depth_cap); idx[b] = b. Counts the valid lanes into acc
// (when given). A thread a lane folds its row's words in place, leaf by
// leaf; an invalid lane reads no leaf.
__global__ void __launch_bounds__(THREADS) keys_kernel(
    int64_t B, int A, FoldLeaves leaves, const uint8_t* __restrict__ cvalid,
    const int64_t* __restrict__ depth, const uint8_t* __restrict__ mask, int64_t depth_cap,
    ull* __restrict__ key, uint32_t* __restrict__ idx, ull* __restrict__ acc) {
  const int64_t b = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  unsigned valid = 0;
  if (b < B) {
    valid = lane_valid(b, A, cvalid, depth, mask, depth_cap);
    ull k = ~0ull;
    if (valid) {
      RowFold fold(leaves.words);
      for (int l = 0; l < leaves.n; ++l) {
        const int w = leaves.width[l], kind = leaves.kind[l];
        const uint8_t* p = leaves.ptr[l] + b * w * leaf_bytes(kind);
        switch (kind) {
          case LEAF_U8: fold_leaf_row<LEAF_U8>(fold, p, w); break;
          case LEAF_I8: fold_leaf_row<LEAF_I8>(fold, p, w); break;
          case LEAF_U16: fold_leaf_row<LEAF_U16>(fold, p, w); break;
          case LEAF_I16: fold_leaf_row<LEAF_I16>(fold, p, w); break;
          case LEAF_B32: fold_leaf_row<LEAF_B32>(fold, p, w); break;
          default: fold_leaf_row<LEAF_I64>(fold, p, w);
        }
      }
      const uint2 fp = fold.finish();
      k = ((ull)fp.x << 32) | fp.y;
    }
    key[b] = k;
    idx[b] = (uint32_t)b;
  }
  const unsigned n = __reduce_add_sync(FULL_MASK, valid);
  if (acc != nullptr && (threadIdx.x & 31) == 0 && n) atomicAdd(&acc[ACC_GENERATED], (ull)n);
}

// key[b] = (chi << 32) | clo of a valid lane, all ones otherwise (as
// keys_kernel); chi and clo are the model's own fingerprints.
__global__ void __launch_bounds__(THREADS) keys_pairs_kernel(
    int64_t B, int A, const int64_t* __restrict__ chi, const int64_t* __restrict__ clo,
    const uint8_t* __restrict__ cvalid, const int64_t* __restrict__ depth,
    const uint8_t* __restrict__ mask, int64_t depth_cap, ull* __restrict__ key,
    uint32_t* __restrict__ idx, ull* __restrict__ acc) {
  const int64_t b = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  unsigned valid = 0;
  if (b < B) {
    valid = lane_valid(b, A, cvalid, depth, mask, depth_cap);
    key[b] = valid ? ((ull)(uint32_t)chi[b] << 32) | (uint32_t)clo[b] : ~0ull;
    idx[b] = (uint32_t)b;
  }
  const unsigned n = __reduce_add_sync(FULL_MASK, valid);
  if (acc != nullptr && (threadIdx.x & 31) == 0 && n) atomicAdd(&acc[ACC_GENERATED], (ull)n);
}

// The layout of a packed actor state's components, and the constants of
// its hash (int64 words carrying u32, made on the host once per device):
// the multilinear coefficients (hi lane, then lo lane) of an actor row
// with its timer word (R + 1); then, for an unordered network (P == 0),
// those of an envelope row [src, dst, msg, cnt] (3 + W) and of the 4-word
// digest, or, for an ordered one (P > 0), those of a flow row [queue
// (Q * W words), len] (Q * W + 1); then those of the history row (H); then
// the seeds (hi lane C words, then lo lane C words) of the component tags
// 0..C-1, C = N + (P > 0 ? P : 1) + (H > 0).
struct CompHash {
  int N, R, E, P, Q, W, H;
  const int64_t* k;
};

__device__ __forceinline__ void fold_pair(uint32_t h, uint32_t l, uint32_t* acc4) {
  acc4[0] += h;
  acc4[1] ^= h;
  acc4[2] += l;
  acc4[3] ^= l;
}

// The number of u32 coefficients and seeds of a layout, in CompHash order.
static int64_t comphash_consts(const CompHash& ch) {
  const int64_t QW = (int64_t)ch.Q * ch.W;
  const int64_t C = ch.N + (ch.P > 0 ? ch.P : 1) + (ch.H > 0 ? 1 : 0);
  return 2 * ((int64_t)ch.R + 1) + (ch.P > 0 ? 2 * (QW + 1) : 2 * (3 + (int64_t)ch.W) + 8) +
         2 * (int64_t)ch.H + 2 * C;
}

// n components of one lane, summed by the whole warp: component c is the L
// words rows[c * L, (c + 1) * L) followed, when tail is given, by tail[c],
// under the coefficients kh (hi lane) and kl (lo lane) of its L (+ 1)
// words. Each component's sums are finished with fmix32 of its tag's seeds
// (sh[c], sl[c]) and folded into acc4. The warp's lanes stride over a
// component's words, so one load instruction reads neighbouring words, and
// CH_GROUP components are swept together, so their loads are in flight at
// once. Every lane ends with the same acc4.
__device__ void warp_components(const int64_t* __restrict__ rows,
                                const int64_t* __restrict__ tail, int n, int L,
                                const uint32_t* kh, const uint32_t* kl, const uint32_t* sh,
                                const uint32_t* sl, uint32_t* acc4) {
  const int lane = threadIdx.x & 31;
  const int Lt = L + (tail != nullptr ? 1 : 0);
  for (int c0 = 0; c0 < n; c0 += CH_GROUP) {
    uint32_t ph[CH_GROUP], pl[CH_GROUP];
#pragma unroll
    for (int i = 0; i < CH_GROUP; ++i) ph[i] = pl[i] = 0u;
#pragma unroll 2
    for (int r = lane; r < Lt; r += 32) {
      const uint32_t ah = kh[r], al = kl[r];
#pragma unroll
      for (int i = 0; i < CH_GROUP; ++i) {
        const int c = c0 + i;
        if (c < n) {
          const uint32_t x = (uint32_t)(r < L ? rows[(int64_t)c * L + r] : tail[c]);
          ph[i] += x * ah;
          pl[i] += x * al;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < CH_GROUP; ++i) {
      if (c0 + i < n) {
        const uint32_t h = __reduce_add_sync(FULL_MASK, ph[i]);
        const uint32_t l = __reduce_add_sync(FULL_MASK, pl[i]);
        fold_pair(fmix32(h ^ sh[c0 + i]), fmix32(l ^ sl[c0 + i]), acc4);
      }
    }
  }
}

// The multiset digest of one lane's active envelope rows [src, dst, msg,
// cnt] by the whole warp, a lane an envelope (E may exceed 32): each active
// row hashed multilinearly under k_env (3 + W coefficients a lane of the
// hash) and finished with fmix32 of the row seeds, its (sum, xor, sum, xor)
// reduced over the warp into dig. Two envelopes a lane are in flight at
// once, every word of them loaded before the count decides whether the row
// counts, so a lane's envelope table costs one round trip a 64 slots.
__device__ void warp_envelopes(const int64_t* __restrict__ src, const int64_t* __restrict__ dst,
                               const int64_t* __restrict__ msg, const int64_t* __restrict__ cnt,
                               int E, int W, const uint32_t* k_env, uint32_t* dig) {
  const int lane = threadIdx.x & 31;
  const int M = 3 + W;
  uint32_t d[4] = {0u, 0u, 0u, 0u};
  for (int e0 = lane; e0 < E; e0 += 64) {
    uint32_t n[2], ah[2], al[2];
    const int64_t* m[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int e = e0 + 32 * u < E ? e0 + 32 * u : e0;
      n[u] = e0 + 32 * u < E ? (uint32_t)cnt[e] : 0u;
      const uint32_t s = (uint32_t)src[e], t = (uint32_t)dst[e];
      ah[u] = s * k_env[0] + t * k_env[1];
      al[u] = s * k_env[M] + t * k_env[M + 1];
      m[u] = msg + (int64_t)e * W;
    }
#pragma unroll 4
    for (int w = 0; w < W; ++w) {
      const uint32_t x0 = (uint32_t)m[0][w], x1 = (uint32_t)m[1][w];
      const uint32_t kh = k_env[2 + w], kl = k_env[M + 2 + w];
      ah[0] += x0 * kh;
      al[0] += x0 * kl;
      ah[1] += x1 * kh;
      al[1] += x1 * kl;
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (n[u] == 0u) continue;
      ah[u] += n[u] * k_env[2 + W];
      al[u] += n[u] * k_env[M + 2 + W];
      fold_pair(fmix32(ah[u] ^ SEED_HI), fmix32(al[u] ^ SEED_LO), d);
    }
  }
  dig[0] = __reduce_add_sync(FULL_MASK, d[0]);
  dig[1] = __reduce_xor_sync(FULL_MASK, d[1]);
  dig[2] = __reduce_add_sync(FULL_MASK, d[2]);
  dig[3] = __reduce_xor_sync(FULL_MASK, d[3]);
}

// ops/fingerprint.py::combine_pairs(*PackedActorModel.packed_component_pairs)
// of lane b, by the whole warp; k holds the layout's coefficients and seeds
// as u32 (shared memory). The network leaves are net_* (P == 0) or flow_*
// (P > 0); the others are not read.
//
// Every component's hash is a sum of u32 products mod 2^32 finished by one
// fmix32 of the whole sum, and fold_pair adds and xors: both associative
// and commutative. So the warp's order of words, envelopes and components
// gives the bits of the serial walk (actor/packed.py's order).
__device__ uint2 comphash_warp(int64_t b, const CompHash& ch, const uint32_t* k,
                               const int64_t* __restrict__ rows,
                               const int64_t* __restrict__ timers,
                               const int64_t* __restrict__ net_src,
                               const int64_t* __restrict__ net_dst,
                               const int64_t* __restrict__ net_msg,
                               const int64_t* __restrict__ net_cnt,
                               const int64_t* __restrict__ flow_msg,
                               const int64_t* __restrict__ flow_len,
                               const int64_t* __restrict__ hist) {
  const int N = ch.N, R = ch.R, E = ch.E, P = ch.P, W = ch.W, H = ch.H;
  const int QW = ch.Q * W;
  const int NC = P > 0 ? P : 1;  // network components
  const int C = N + NC + (H > 0 ? 1 : 0);
  const uint32_t* k_act = k;
  const uint32_t* k_net = k_act + 2 * (R + 1);
  const uint32_t* k_hist = k_net + (P > 0 ? 2 * (QW + 1) : 2 * (3 + W) + 8);
  const uint32_t* seed = k_hist + 2 * H;
  uint32_t acc4[4] = {0u, 0u, 0u, 0u};
  // Actor components 0..N-1: row ‖ timer word.
  warp_components(rows + b * N * R, timers + b * N, N, R, k_act, k_act + R + 1, seed, seed + C,
                  acc4);
  if (P > 0) {
    // An ordered network: flow components N..N+P-1, queue ‖ length.
    warp_components(flow_msg + b * P * QW, flow_len + b * P, P, QW, k_net, k_net + QW + 1,
                    seed + N, seed + C + N, acc4);
  } else {
    // An unordered network, tag N: the multiset digest of the active
    // envelope rows, hashed as one row.
    const int M = 3 + W;
    const uint32_t* k_dig = k_net + 2 * M;
    uint32_t dig[4];
    warp_envelopes(net_src + b * E, net_dst + b * E, net_msg + b * E * W, net_cnt + b * E, E, W,
                   k_net, dig);
    uint32_t ah = 0u, al = 0u;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      ah += dig[j] * k_dig[j];
      al += dig[j] * k_dig[4 + j];
    }
    fold_pair(fmix32(ah ^ seed[N]), fmix32(al ^ seed[C + N]), acc4);
  }
  // The history, tag N + NC.
  if (H > 0)
    warp_components(hist + b * H, nullptr, 1, H, k_hist, k_hist + H, seed + N + NC,
                    seed + C + N + NC, acc4);
  // acc_finalize(C), then the shared finalizer and its nudges.
  const uint32_t c = (uint32_t)C;
  uint32_t hi = fmix32(acc4[0] ^ rotl32(acc4[1], 16) ^ (c * 0x9E3779B9u));
  uint32_t lo = fmix32(acc4[2] ^ rotl32(acc4[3], 16) ^ (c * 0x85EBCA6Bu + 1u));
  hi = fmix32(hi ^ (c * 4u));
  lo = fmix32(lo ^ (c * 4u + 1u));
  if (hi == 0u && lo == 0u) lo = 1u;
  if (hi == 0xFFFFFFFFu && lo == 0xFFFFFFFFu) lo = 0xFFFFFFFEu;
  return make_uint2(hi, lo);
}

// keys_kernel with the component hash of each valid lane's packed actor
// state in place of the default fold. A block takes CH_SPAN lanes: a thread
// a lane writes idx, the sentinel key of an invalid lane and the valid
// count, and lists the valid lanes in shared memory; then its warps take
// the listed lanes one at a time (comphash_warp). The layout's n_consts
// coefficients and seeds are staged in shared memory as u32 while the
// valid bits load. At most 64 registers a thread (no spill at CH_GROUP 4)
// keep four blocks on an SM: the stage waits on memory, and more warps in
// flight hide more of it.
__global__ void __launch_bounds__(THREADS, 4) comphash_keys_kernel(
    int64_t B, int A, CompHash ch, int n_consts, const int64_t* __restrict__ rows,
    const int64_t* __restrict__ timers, const int64_t* __restrict__ net_src,
    const int64_t* __restrict__ net_dst, const int64_t* __restrict__ net_msg,
    const int64_t* __restrict__ net_cnt, const int64_t* __restrict__ flow_msg,
    const int64_t* __restrict__ flow_len, const int64_t* __restrict__ hist,
    const uint8_t* __restrict__ cvalid, const int64_t* __restrict__ depth,
    const uint8_t* __restrict__ mask, int64_t depth_cap, ull* __restrict__ key,
    uint32_t* __restrict__ idx, ull* __restrict__ acc) {
  extern __shared__ uint32_t s_k[];
  __shared__ uint32_t s_lane[CH_SPAN];
  __shared__ uint32_t s_n;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t base = (int64_t)blockIdx.x * CH_SPAN;
  const int64_t b = base + tid;
  // lane_valid's three reads, issued together.
  const bool in = tid < CH_SPAN && b < B;
  const uint8_t cv = in ? cvalid[b] : 0;
  const uint8_t mk = in && mask != nullptr ? mask[b / A] : 1;
  const int64_t dp = in && depth != nullptr ? depth[b / A] : 0;
  for (int i = tid; i < n_consts; i += THREADS) s_k[i] = (uint32_t)ch.k[i];
  if (tid == 0) s_n = 0u;
  const unsigned valid = cv != 0 && mk != 0 && (depth == nullptr || dp < depth_cap);
  if (in) {
    if (!valid) key[b] = ~0ull;
    idx[b] = (uint32_t)b;
  }
  __syncthreads();
  const unsigned bal = __ballot_sync(FULL_MASK, valid);
  uint32_t at = 0u;
  if (lane == 0 && bal) {
    at = atomicAdd(&s_n, (uint32_t)__popc(bal));
    if (acc != nullptr) atomicAdd(&acc[ACC_GENERATED], (ull)__popc(bal));
  }
  at = __shfl_sync(FULL_MASK, at, 0);
  if (valid) s_lane[at + __popc(bal & ((1u << lane) - 1u))] = (uint32_t)tid;
  __syncthreads();
  const int n = (int)s_n;
  for (int v = warp; v < n; v += THREADS / 32) {
    const int64_t lb = base + s_lane[v];
    const uint2 fp = comphash_warp(lb, ch, s_k, rows, timers, net_src, net_dst, net_msg, net_cnt,
                                   flow_msg, flow_len, hist);
    if (lane == 0) key[lb] = ((ull)fp.x << 32) | fp.y;
  }
}

// -- (c) stable LSD radix sort ----------------------------------------------
//
// Scratch (uint32 words, fw_sort): a ticket per launch, the
// keyed-lane count n_live, the 8 digit histograms of the keyed lanes, the
// partition's tile status words, and two arrays of per-tile, per-digit
// status words that the digit passes use in turn. A status word packs a
// flag (bits 30-31: ST_AGG, the tile's own count; ST_INC, the count of the
// tile and of every tile before it in the scan's order) and a count (bits
// 0-29); zero means not published yet.

#define SC_TICKET 0  // + launch: 0 the partition, 1 + p the digit pass p
#define SC_NLIVE 15
#define SC_HIST 16   // + 256 * p + digit
#define SC_PSTAT (SC_HIST + 8 * 256)
#define ST_AGG (1u << 30)
#define ST_INC (2u << 30)
#define ST_COUNT 0x3FFFFFFFu
#define LOOKBACK 16  // status words a thread reads at once in a pass's look-back

// Status words are read and written relaxed, at device scope: a word
// carries its own count, so a digit pass needs no other ordering, and an
// acquire load would hold back the loads after it (a look-back's window of
// words would be read one round trip at a time). The partition, whose
// sentinel lanes overwrite lanes other tiles have read, orders those
// reads before its writes with fences around the words.
__device__ __forceinline__ uint32_t ld_relaxed(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(uint32_t* p, uint32_t v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// The sum of the counts in the status words st[u] of the tiles u = from,
// from + step, from + 2 * step, ... (step +1 or -1) within [0, nt), by one
// warp: lane l reads the words of the WORDS tiles WORDS * l .. WORDS * l +
// WORDS - 1 steps away, 32 * WORDS tiles a round, until a tile's inclusive
// count ends the walk (the range's end counts 0). Those tiles took their
// tickets earlier, so every one of them publishes without waiting on the
// caller's.
template <int WORDS>
__device__ uint32_t warp_lookback(const uint32_t* st, int64_t from, int step, int64_t nt) {
  const int lane = threadIdx.x & 31;
  uint32_t sum = 0;
  for (int64_t u0 = from;; u0 += 32 * WORDS * step) {
    uint32_t s[WORDS];
    int64_t u[WORDS];
    bool wait = false;
#pragma unroll
    for (int q = 0; q < WORDS; ++q) {
      u[q] = u0 + (int64_t)step * (WORDS * lane + q);
      s[q] = u[q] >= 0 && u[q] < nt ? ld_relaxed(st + u[q]) : ST_INC;  // past the end: 0
      wait |= s[q] == 0u;
    }
    while (__any_sync(FULL_MASK, wait)) {
      wait = false;
#pragma unroll
      for (int q = 0; q < WORDS; ++q) {
        if (s[q] == 0u) s[q] = ld_relaxed(st + u[q]);
        wait |= s[q] == 0u;
      }
    }
    // The lane's counts up to its nearest inclusive word, if it has one.
    uint32_t part = 0u;
    bool has_inc = false;
#pragma unroll
    for (int q = 0; q < WORDS; ++q) {
      if (!has_inc) {
        part += s[q] & ST_COUNT;
        has_inc = (s[q] & ST_INC) != 0u;
      }
    }
    const unsigned inc = __ballot_sync(FULL_MASK, has_inc);
    const int stop = inc ? __ffs(inc) - 1 : 31;
    sum += __reduce_add_sync(FULL_MASK, lane <= stop ? part : 0u);
    if (inc) return sum;
  }
}

// The sum of the counts of the tiles before t at one digit (st[u * stride]
// for u < t), by one thread, LOOKBACK words at a time, until a tile's
// inclusive count ends the walk.
__device__ uint32_t lookback_before(const uint32_t* st, int64_t t, int stride) {
  uint32_t sum = 0;
  int64_t u = t - 1;
  while (true) {
    uint32_t s[LOOKBACK];
#pragma unroll
    for (int w = 0; w < LOOKBACK; ++w) s[w] = u - w >= 0 ? ld_relaxed(st + (u - w) * stride) : ST_INC;
    bool stop = false;
    int used = 0;
#pragma unroll
    for (int w = 0; w < LOOKBACK; ++w) {
      if (!stop) {
        if (s[w] == 0u) {
          stop = true;
        } else {
          sum += s[w] & ST_COUNT;
          ++used;
          if (s[w] & ST_INC) return sum;
        }
      }
    }
    u -= used;
  }
}

// The stable partition: every lane whose key is not ~0 goes, in lane
// order, to live_key/live_idx[n - n_live, n) (right-aligned: its slot is
// n minus the keyed lanes at or after it, known from the tiles after its
// own); every other lane goes, in lane order, to key/idx[n_live, n), its
// final place (n minus the sentinel lanes at or after it), in place.
// Tiles are taken from the last one down by ticket, so a tile's sentinel
// lanes, which only move up, land in its own tile or in tiles that have
// published their counts, and so have read their lanes already. Also
// counts the 8 digit histograms of the keyed lanes and, in the block of
// tile 0, n_live.
__global__ void __launch_bounds__(THREADS) sort_partition_kernel(
    ull* key, uint32_t* idx, int64_t n, ull* __restrict__ live_key,
    uint32_t* __restrict__ live_idx, uint32_t* __restrict__ sc, int64_t nt) {
  __shared__ uint32_t s_hist[8][256];
  __shared__ uint32_t s_tile, s_after;
  const int tid = threadIdx.x;
#pragma unroll
  for (int p = 0; p < 8; ++p) s_hist[p][tid] = 0u;
  if (tid == 0) s_tile = atomicAdd(&sc[SC_TICKET], 1u);
  __syncthreads();
  const int64_t t = nt - 1 - (int64_t)s_tile;
  const int64_t base = t * PART_TILE;
  const int64_t m = n - base < PART_TILE ? n - base : PART_TILE;
  const int first = tid * PART_ITEMS;
  // Every lane of the thread is loaded before the first shared-memory
  // atomic, so the loads are in flight together.
  ull k[PART_ITEMS];
  uint32_t v[PART_ITEMS];
#pragma unroll
  for (int j = 0; j < PART_ITEMS; ++j) {
    k[j] = first + j < m ? key[base + first + j] : ~0ull;
    v[j] = first + j < m ? idx[base + first + j] : 0u;
  }
  unsigned in = 0u, live = 0u;
#pragma unroll
  for (int j = 0; j < PART_ITEMS; ++j) {
    if (first + j < m) {
      in |= 1u << j;
      if (k[j] != ~0ull) {
        live |= 1u << j;
#pragma unroll
        for (int p = 0; p < 8; ++p) atomicAdd(&s_hist[p][(k[j] >> (8 * p)) & 255u], 1u);
      }
    }
  }
  uint32_t ltot;
  const uint32_t lpre = block_exclusive_scan<THREADS>(__popc(live), &ltot);
  if (tid < 32) {
    // The block's reads of its tile (before the scan's barriers) come
    // before its words; the words it reads come before its writes.
    uint32_t* my = sc + SC_PSTAT + t;
    uint32_t after = 0u;
    __threadfence();
    if (t == nt - 1) {
      if (tid == 0) st_relaxed(my, ST_INC | ltot);
    } else {
      if (tid == 0) st_relaxed(my, ST_AGG | ltot);
      after = warp_lookback<1>(sc + SC_PSTAT, t + 1, 1, nt);
      if (tid == 0) st_relaxed(my, ST_INC | (after + ltot));
    }
    if (tid == 0) {
      s_after = after;
      if (t == 0) sc[SC_NLIVE] = after + ltot;
    }
    __threadfence();
  }
  __syncthreads();
  const int64_t after = s_after;
  const int64_t dead_after = (n - base - m) - after;
  const int64_t dtot = m - ltot;
  const int64_t dpre = (first < m ? first : m) - lpre;
  int64_t lp = n - after - ltot + lpre;
  int64_t dp = n - dead_after - dtot + dpre;
#pragma unroll
  for (int j = 0; j < PART_ITEMS; ++j) {
    if (live >> j & 1u) {
      live_key[lp] = k[j];
      live_idx[lp] = v[j];
      ++lp;
    } else if (in >> j & 1u) {
      key[dp] = ~0ull;
      idx[dp] = v[j];
      ++dp;
    }
  }
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const uint32_t c = s_hist[p][tid];
    if (c) atomicAdd(&sc[SC_HIST + 256 * p + tid], c);
  }
}

// One digit pass of the onesweep LSD sort over the keyed prefix
// [0, n_live): a block takes a ticket for its tile (blocks past n_live
// exit) and loads it, each warp SORT_TILE / 8 neighbouring keys. A warp
// ranks its keys' digits in input order, 32 at a time, with no block
// barrier: equal digits find one another with a warp match, and the
// lowest of them adds their count to the warp's counter of that digit in
// shared memory. The warps' counters then give each digit's offset of a
// warp within the tile (lower warps first) and the tile's counts, which
// the block publishes before it reads the counts of the tiles before it by
// look-back. Each key's slot is its digit's global start (the exclusive
// scan of the pass's histogram, made here in shared memory) + the tiles
// before + the warps before + its rank in its warp; the block first orders
// its keys by digit in shared memory and then writes them out in that
// order, so a digit's keys leave as one run. The first pass reads the
// partition's right-aligned prefix. Each block also clears its tile's
// words in next_status, the array the next pass uses.
__global__ void __launch_bounds__(THREADS) sort_pass_kernel(
    const ull* __restrict__ kin, const uint32_t* __restrict__ vin, ull* __restrict__ kout,
    uint32_t* __restrict__ vout, int64_t n, int first_pass, int pass,
    uint32_t* __restrict__ sc, uint32_t* __restrict__ status,
    uint32_t* __restrict__ next_status) {
  __shared__ uint32_t s_cnt[THREADS / 32][256];  // per warp: counts, then offsets
  __shared__ uint32_t s_base[256];  // per digit: its first slot in kout for the tile
  __shared__ uint32_t s_first[256];  // per digit: its first slot in the tile's order
  __shared__ ull s_key[SORT_TILE];
  __shared__ uint32_t s_val[SORT_TILE];
  __shared__ uint32_t s_tile;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int shift = 8 * pass;
  // The ticket, n_live and the pass's histogram do not depend on one
  // another: their loads are in flight together.
  if (tid == 0) s_tile = atomicAdd(&sc[SC_TICKET + 1 + pass], 1u);
  const int64_t nl = sc[SC_NLIVE];
  const uint32_t hist = sc[SC_HIST + 256 * pass + tid];
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) s_cnt[w][tid] = 0u;
  __syncthreads();
  const int64_t tile = s_tile;
  const int64_t base = tile * SORT_TILE;
  if (base >= nl) return;
  if (first_pass) {
    kin += n - nl;
    vin += n - nl;
  }
  const int64_t wbase = base + (int64_t)warp * (SORT_TILE / (THREADS / 32));
  ull k[SORT_ROUNDS];
  uint32_t v[SORT_ROUNDS], off[SORT_ROUNDS];
#pragma unroll
  for (int r = 0; r < SORT_ROUNDS; ++r) {
    const int64_t i = wbase + r * 32 + lane;
    k[r] = i < nl ? kin[i] : 0ull;
    v[r] = i < nl ? vin[i] : 0u;
  }
  if (next_status != nullptr) next_status[tile * 256 + tid] = 0u;
  const unsigned lanes_below = (1u << lane) - 1u;
#pragma unroll
  for (int r = 0; r < SORT_ROUNDS; ++r) {
    const bool ok = wbase + r * 32 + lane < nl;
    const unsigned d = ok ? (unsigned)((k[r] >> shift) & 255u) : 256u;
    const unsigned peers = __match_any_sync(FULL_MASK, d);
    const int leader = __ffs(peers) - 1;
    uint32_t before_here = 0u;
    if (ok && lane == leader) {
      before_here = s_cnt[warp][d];
      s_cnt[warp][d] = before_here + __popc(peers);
    }
    off[r] = __shfl_sync(FULL_MASK, before_here, leader) + __popc(peers & lanes_below);
    __syncwarp();
  }
  uint32_t total;
  const uint32_t start = block_exclusive_scan<THREADS>(hist, &total);  // its barriers end the ranking
  uint32_t cnt = 0u;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) {
    const uint32_t c = s_cnt[w][tid];
    s_cnt[w][tid] = cnt;
    cnt += c;
  }
  uint32_t before = 0u;
  if (tile == 0) {
    st_relaxed(status + tid, ST_INC | cnt);
  } else {
    st_relaxed(status + tile * 256 + tid, ST_AGG | cnt);
    before = lookback_before(status + tid, tile, 256);
    st_relaxed(status + tile * 256 + tid, ST_INC | (before + cnt));
  }
  s_base[tid] = start + before;
  // The tile is sorted by digit in shared memory first, so that the keys
  // of one digit leave as a run of neighbouring slots.
  uint32_t tile_total;
  s_first[tid] = block_exclusive_scan<THREADS>(cnt, &tile_total);
  __syncthreads();
#pragma unroll
  for (int r = 0; r < SORT_ROUNDS; ++r) {
    if (wbase + r * 32 + lane < nl) {
      const unsigned d = (unsigned)((k[r] >> shift) & 255u);
      const uint32_t at = s_first[d] + s_cnt[warp][d] + off[r];
      s_key[at] = k[r];
      s_val[at] = v[r];
    }
  }
  __syncthreads();
  for (int i = tid; i < (int)tile_total; i += THREADS) {
    const ull key = s_key[i];
    const unsigned d = (unsigned)((key >> shift) & 255u);
    const uint32_t dst = s_base[d] + (uint32_t)i - s_first[d];
    kout[dst] = key;
    vout[dst] = s_val[i];
  }
}

// -- (d) dedup and tile ranges -----------------------------------------------

// active[i]: sorted position i holds the first occurrence of its key and
// its lane is valid (the reference's cvalid[sidx] & uniq). A key other than
// ~0 comes only from a valid lane; the first ~0 position may hold a valid
// lane whose fingerprint is (MAX, MAX) or an invalid lane, so its validity
// is recomputed as the keys stage computed it.
//
// starts[t] is the first sorted position whose home is at or past tile t's
// first row (the reference's searchsorted, side left; starts[0] = 0).
// Homes are monotone in the sorted keys (the (MAX, MAX) sentinels home
// into the last tile), so with tile(i) the tile of position i's home,
// starts[t] = i for every t in (tile(i - 1), tile(i)], 0 for t <= tile(0)
// and B for t > tile(B - 1): one pass over the positions writes every
// entry once, with no search, no race and no memset. A thread takes one
// position; its predecessor's key comes from a shuffle (a warp's first
// lane from shared memory, a block's first thread from one more load,
// issued beside its own). A run of at most DEDUP_RUN_ALONE tiles is filled
// by its thread; a longer one (a sparse wave: few keys over many tiles)
// goes to a list in shared memory, whose runs of fewer than DEDUP_RUN_BLOCK
// tiles the block's warps then fill, a run a warp in turn, and whose longer
// runs the whole block fills, run by run. A single SM writes most of a
// sparse wave's starts this way (128 KB at 2^25 rows), and each run in the
// list costs a round of shared loads, so the warps share the runs out
// rather than the block taking each in turn.
#define DEDUP_RUN_ALONE 64
#define DEDUP_RUN_BLOCK 2048

__global__ void __launch_bounds__(THREADS) dedup_kernel(
    const ull* __restrict__ skey, const uint32_t* __restrict__ sidx, int64_t B, int A,
    const uint8_t* __restrict__ cvalid, const int64_t* __restrict__ depth,
    const uint8_t* __restrict__ mask, int64_t depth_cap, uint8_t* __restrict__ active,
    int64_t* __restrict__ starts, int n_tiles, int cap_bits) {
  __shared__ ull s_last[THREADS / 32];
  // The block's long runs: tiles [from, to] start at val (a thread has at
  // most one, but for the last position's second).
  __shared__ uint32_t s_from[THREADS + 1], s_to[THREADS + 1], s_val[THREADS + 1];
  __shared__ uint32_t s_runs;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  const bool in = i < B;
  const ull k = in ? skey[i] : ~0ull;
  const ull k_block = threadIdx.x == 0 && in && i > 0 ? skey[i - 1] : 0ull;
  ull prev = __shfl_up_sync(FULL_MASK, k, 1);
  if (lane == 31) s_last[warp] = k;
  if (threadIdx.x == 0) s_runs = 0u;
  __syncthreads();
  if (lane == 0) prev = warp ? s_last[warp - 1] : k_block;
  const unsigned shift = 32u - (unsigned)cap_bits;
  // Run 1: tiles [from, to] start at i; run 2 (the last position, or
  // position 0 of an empty batch): tiles [from2, n_tiles] start at B.
  int64_t from = 0, to = -1, from2 = 0, to2 = -1;
  if (in) {
    bool a = i == 0 || k != prev;
    if (a && k == ~0ull) a = lane_valid(sidx[i], A, cvalid, depth, mask, depth_cap);
    active[i] = a;
    const int64_t tile = ((uint32_t)(k >> 32) >> shift) / TILE_ROWS;
    from = i == 0 ? 0 : (int64_t)(((uint32_t)(prev >> 32) >> shift) / TILE_ROWS) + 1;
    to = tile;
    if (i == B - 1) {
      from2 = tile + 1;
      to2 = n_tiles;
    }
  } else if (i == 0) {
    to2 = n_tiles;
  }
  if (to - from < DEDUP_RUN_ALONE) {
    for (int64_t t = from; t <= to; ++t) starts[t] = i;
  } else {
    const uint32_t r = atomicAdd(&s_runs, 1u);
    s_from[r] = (uint32_t)from;
    s_to[r] = (uint32_t)to;
    s_val[r] = (uint32_t)i;
  }
  if (to2 - from2 < DEDUP_RUN_ALONE) {
    for (int64_t t = from2; t <= to2; ++t) starts[t] = B;
  } else {
    const uint32_t r = atomicAdd(&s_runs, 1u);
    s_from[r] = (uint32_t)from2;
    s_to[r] = (uint32_t)to2;
    s_val[r] = (uint32_t)B;
  }
  __syncthreads();
  const uint32_t runs = s_runs;
  for (uint32_t r = 0; r < runs; ++r) {
    const int f = (int)s_from[r], e = (int)s_to[r];
    if (e - f < DEDUP_RUN_BLOCK) continue;
    const int64_t v = s_val[r];
    for (int t = f + (int)threadIdx.x; t <= e; t += THREADS) starts[t] = v;
  }
  for (uint32_t r = warp; r < runs; r += THREADS / 32) {
    const int f = (int)s_from[r], e = (int)s_to[r];
    if (e - f >= DEDUP_RUN_BLOCK) continue;
    const int64_t v = s_val[r];
    for (int t = f + lane; t <= e; t += 32) starts[t] = v;
  }
}

// -- (e) the sweep -----------------------------------------------------------

// The wave's batch: sorted u64 keys, the active mask, one flag byte out;
// pending keys are counted into the wave's overflow.
struct WaveBatch {
  const ull* skey;
  const uint8_t* act;
  uint8_t* flag;
  ull* acc;

  __device__ __forceinline__ uint2 key(int64_t i) const {
    const ull k = skey[i];
    return make_uint2((uint32_t)(k >> 32), (uint32_t)k);
  }
  __device__ __forceinline__ uint8_t active(int64_t i) const { return act[i]; }
  __device__ __forceinline__ void store(int64_t i, uint8_t f) const {
    flag[i] = f;
    if (f & FLAG_PENDING) atomicAdd(&acc[ACC_OVERFLOW], 1ull);
  }
};

// -- (f) compaction ------------------------------------------------------------

// One pass: a block takes the next tile of COMPACT_TILE sorted positions by
// ticket (sc[0]), reads its outcome bytes (COMPACT_ITEMS neighbouring ones
// a thread, one 8-byte load), publishes its fresh count in its status word
// sc[1 + t] and lists its fresh positions in order in shared memory. Then
// warp 0 adds up the fresh keys of the tiles before it by look-back, 128
// tiles' words a round, and publishes the inclusive count, while every
// thread loads the first fresh row it writes: the key and lane, then the
// parent's ebits, depth, hi and lo. Each fresh key's slot is its rank among
// the fresh keys in sorted order; the block writes its fresh rows to
// consecutive slots: the per-lane outputs of the slot and the key's lane
// for the leaf gather. The last tile writes n_new into acc and, with
// stats, the wave's stats vector: the counters (every stage before it has
// run), n_new, any_hit, and each property's hit with the (hi, lo) of its
// first hit lane (lane 0 when none hit, as jnp.argmax gives). There is
// always a last tile: a wave of no lanes runs one block.
//
// With COV (coverage on) each fresh row also counts into the fresh half of
// the wave's coverage vector, which fw_frontier zeroed: its action bin
// (lane % A) and the depth bin of its child (clamped to COV_DEPTH_BINS - 1).
// Rows group by a warp match before each shared atomic (a wave's parents
// mostly share one depth); a block flushes each non-zero bin with one
// global atomic.
template <bool COV>
__global__ void __launch_bounds__(THREADS) compact_kernel(
    const uint8_t* __restrict__ flag, int64_t B, int A, const ull* __restrict__ skey,
    const uint32_t* __restrict__ sidx, const int64_t* __restrict__ ebits_after,
    const int64_t* __restrict__ depth, const int64_t* __restrict__ hi,
    const int64_t* __restrict__ lo, int64_t* __restrict__ new_hi,
    int64_t* __restrict__ new_lo, int64_t* __restrict__ new_ebits,
    int64_t* __restrict__ new_depth, int64_t* __restrict__ parent_hi,
    int64_t* __restrict__ parent_lo, int64_t* __restrict__ src_out,
    uint32_t* __restrict__ sc, ull* __restrict__ acc, int64_t nt,
    int cov_size, ull* __restrict__ cov, int64_t* __restrict__ stats, int P) {
  __shared__ uint16_t s_pos[COMPACT_TILE];
  __shared__ uint32_t s_tile, s_before;
  extern __shared__ uint32_t s_hist[];  // COV: A action bins, then the depth bins
  const int tid = threadIdx.x;
  if (tid == 0) s_tile = atomicAdd(&sc[0], 1u);
  if constexpr (COV)
    for (int j = tid; j < A + COV_DEPTH_BINS; j += THREADS) s_hist[j] = 0u;
  __syncthreads();
  const int64_t t = s_tile;
  const int64_t base = t * COMPACT_TILE;
  const int64_t m = B - base < COMPACT_TILE ? B - base : COMPACT_TILE;
  const int first = tid * COMPACT_ITEMS;
  unsigned bits = 0u;
  if (first + COMPACT_ITEMS <= m && ((uintptr_t)(flag + base + first) & 7u) == 0) {
    const uint2 v = *(const uint2*)(flag + base + first);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bits |= (((v.x >> (8 * j)) & FLAG_FRESH) != 0u) << j;
      bits |= (((v.y >> (8 * j)) & FLAG_FRESH) != 0u) << (4 + j);
    }
  } else {
#pragma unroll
    for (int j = 0; j < COMPACT_ITEMS; ++j)
      if (first + j < m && (flag[base + first + j] & FLAG_FRESH)) bits |= 1u << j;
  }
  uint32_t tot;
  uint32_t pre = block_exclusive_scan<THREADS>(__popc(bits), &tot);
  if (tid == 0) st_relaxed(sc + 1 + t, (t == 0 ? ST_INC : ST_AGG) | tot);
  for (unsigned r = bits; r; r &= r - 1u) s_pos[pre++] = (uint16_t)(first + __ffs(r) - 1);
  __syncthreads();
  if (tid < 32) {
    uint32_t before = 0u;
    if (t > 0) {
      before = warp_lookback<4>(sc + 1, t - 1, -1, nt);
      if (tid == 0) st_relaxed(sc + 1 + t, ST_INC | (before + tot));
    }
    if (tid == 0) {
      s_before = before;
      if (t == nt - 1) acc[ACC_N_NEW] = (ull)before + tot;
    }
  }
  // The thread's first row loads while warp 0 looks back.
  ull k = 0ull;
  int64_t src = 0, eb = 0, dp = 0, ph = 0, pl = 0;
  uint32_t parent = 0;
  if (tid < (int)tot) {
    const int64_t i = base + s_pos[tid];
    k = skey[i];
    src = sidx[i];
    parent = (uint32_t)src / (uint32_t)A;
    eb = ebits_after[parent];
    dp = depth[parent];
    ph = hi[parent];
    pl = lo[parent];
  }
  __syncthreads();
  const int64_t before = s_before;
  if (stats != nullptr && t == nt - 1) {
    const int any = __syncthreads_or(tid < P && acc[ACC_FIRST_HIT + tid] != 0ull);
    const int64_t F = B / A;
    if (tid < P) {
      const ull first = ~acc[ACC_FIRST_HIT + tid];
      const bool hit = first != ~0ull;
      const int64_t f = hit ? (int64_t)first : 0;
      stats[5 + 3 * tid] = hit;
      stats[6 + 3 * tid] = F ? hi[f] : 0;
      stats[7 + 3 * tid] = F ? lo[f] : 0;
    }
    if (tid == 0) {
      stats[0] = (int64_t)acc[ACC_GENERATED];
      stats[1] = before + tot;
      stats[2] = (int64_t)acc[ACC_OVERFLOW];
      stats[3] = (int64_t)acc[ACC_MAX_DEPTH];
      stats[4] = any != 0;
    }
  }
  // Every thread runs every round (tot is the block's), so a round's
  // warp match sees the whole warp.
  for (int j0 = 0; j0 < (int)tot; j0 += THREADS) {
    const int j = j0 + tid;
    const bool has = j < (int)tot;
    if (has) {
      if (j != tid) {
        const int64_t i = base + s_pos[j];
        k = skey[i];
        src = sidx[i];
        parent = (uint32_t)src / (uint32_t)A;
        eb = ebits_after[parent];
        dp = depth[parent];
        ph = hi[parent];
        pl = lo[parent];
      }
      const int64_t pos = before + j;
      new_hi[pos] = (int64_t)(k >> 32);
      new_lo[pos] = (int64_t)(k & 0xFFFFFFFFull);
      new_ebits[pos] = eb;
      new_depth[pos] = dp + 1;
      parent_hi[pos] = ph;
      parent_lo[pos] = pl;
      src_out[pos] = src;
    }
    if constexpr (COV) {
      const int lane = tid & 31;
      const int act = (int)((uint32_t)src - parent * (uint32_t)A);
      const int64_t d = dp + 1;
      const int dbin = d < 0 ? 0 : (d > COV_DEPTH_BINS - 1 ? COV_DEPTH_BINS - 1 : (int)d);
      const unsigned pa = __match_any_sync(FULL_MASK, has ? act : -1);
      if (has && lane == __ffs(pa) - 1) atomicAdd(&s_hist[act], __popc(pa));
      const unsigned pd = __match_any_sync(FULL_MASK, has ? dbin : -1);
      if (has && lane == __ffs(pd) - 1) atomicAdd(&s_hist[A + dbin], __popc(pd));
    }
  }
  if constexpr (COV) {
    __syncthreads();
    const int o_fresh = 4 + A, o_depth = cov_size - COV_DEPTH_BINS;
    for (int j = tid; j < A + COV_DEPTH_BINS; j += THREADS) {
      const uint32_t v = s_hist[j];
      if (v) atomicAdd(&cov[j < A ? o_fresh + j : o_depth + (j - A)], (ull)v);
    }
  }
}

// Copies each leaf's row src_out[pos] to row pos, for pos < n_new (read
// on the device). A group of `group` lanes (a power of two, at most 32)
// copies one row of every leaf, its lanes on neighbouring units of the
// leaf's width (16 B when the row and both base pointers allow it), so a
// group's loads coalesce; a grid of GATHER_BLOCKS_PER_SM blocks an SM walks
// the rows grid-stride.
#define GATHER_BLOCKS_PER_SM 4

template <typename U>
__device__ __forceinline__ void copy_row(const uint8_t* __restrict__ src,
                                         uint8_t* __restrict__ dst, int64_t row_bytes,
                                         int lane, int group) {
  const U* s = (const U*)src;
  U* d = (U*)dst;
  const int64_t units = row_bytes / (int64_t)sizeof(U);
#pragma unroll 4
  for (int64_t o = lane; o < units; o += group) d[o] = s[o];
}

__global__ void __launch_bounds__(THREADS) gather_kernel(
    int64_t B, const int64_t* __restrict__ src_out, const ull* __restrict__ acc,
    Leaves leaves, int group) {
  const int64_t n_new = (int64_t)acc[ACC_N_NEW] < B ? (int64_t)acc[ACC_N_NEW] : B;
  const int lane = threadIdx.x & (group - 1);
  const int64_t groups = (int64_t)gridDim.x * (THREADS / group);
  for (int64_t pos = ((int64_t)blockIdx.x * THREADS + threadIdx.x) / group; pos < n_new;
       pos += groups) {
    const int64_t s = src_out[pos];
    for (int l = 0; l < leaves.n; ++l) {
      const int64_t rb = leaves.row_bytes[l];
      const uint8_t* src = leaves.src[l] + s * rb;
      uint8_t* dst = leaves.dst[l] + pos * rb;
      switch (leaves.unit[l]) {
        case 16: copy_row<uint4>(src, dst, rb, lane, group); break;
        case 8: copy_row<uint64_t>(src, dst, rb, lane, group); break;
        case 4: copy_row<uint32_t>(src, dst, rb, lane, group); break;
        case 2: copy_row<uint16_t>(src, dst, rb, lane, group); break;
        default: copy_row<uint8_t>(src, dst, rb, lane, group);
      }
    }
  }
}

// -- coverage -------------------------------------------------------------------

// The coverage vector's length for A actions and P properties (telemetry/
// coverage.py::DeviceCoverage.size): succ_bins = ceil(log2(A)) + 1.
static int cov_succ_bins(int A) {
  int b = 0;
  while (A > 1 && (1 << b) < A) ++b;
  return b + 1;
}

// -- C entry points (loaded with ctypes) ----------------------------------------
//
// Each launches on `stream`, does not synchronise, and returns the first
// CUDA error it met (cudaGetLastError() after its launches), so a refused
// launch is seen by the caller. Pointers are device pointers unless named
// *_host.

static int last_error(cudaError_t e) {
  const cudaError_t l = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : l);
}

// mask may be null (every lane live); acc is ACC_FIRST_HIT + P words,
// zeroed here, followed with coverage on (cov_size > 0) by the wave's
// coverage vector of cov_size = 4 + 2A + P + succ_bins + COV_DEPTH_BINS
// words, zeroed by the same memset, whose frontier half the kernel adds
// (ant is then the (P, F) antecedent bytes, the row of a property that is
// not `always`, or has no antecedent, all ones; null only when empty).
// *launches_host gets the device operations queued (the memset and the
// kernel).
extern "C" int fw_frontier(int64_t F, int A, int64_t depth_cap, const void* cond,
                           const void* cvalid, const void* depth, const void* ebits,
                           const void* mask, void* ebits_after, int P,
                           const void* kind_host, const void* ebit_host, void* acc,
                           const void* ant, int cov_size, int* launches_host, void* stream) {
  *launches_host = 0;
  const int succ_bins = cov_succ_bins(A);
  if (P < 0 || P > MAX_PROPS || A < 1 || F < 0 || F > (int64_t)0xFFFFFFFE ||
      (cov_size != 0 && ((ant == nullptr && P > 0 && F > 0) || A > MAX_COV_WORDS ||
                         cov_size != 4 + 2 * A + P + succ_bins + COV_DEPTH_BINS)))
    return (int)cudaErrorInvalidValue;
  Props props;
  props.n = P;
  int need_terminal = 0;
  for (int i = 0; i < P; ++i) {
    props.kind[i] = ((const int*)kind_host)[i];
    props.ebit[i] = ((const int*)ebit_host)[i];
    need_terminal |= props.kind[i] == KIND_EVENTUALLY;
  }
  // Without an eventually property or coverage no stage reads the
  // candidates' valid bytes here, and a block takes FRONTIER_THREADS lanes.
  int FT = FRONTIER_THREADS;
  if (need_terminal || cov_size)
    FT = FRONTIER_SPAN / A < 1 ? 1 : (FRONTIER_SPAN / A < FT ? FRONTIER_SPAN / A : FT);
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t e =
      cudaMemsetAsync(acc, 0, (size_t)(ACC_FIRST_HIT + P + cov_size) * sizeof(ull), s);
  if (e != cudaSuccess) return (int)e;
  ull* cov = cov_size ? (ull*)acc + ACC_FIRST_HIT + P : nullptr;
  if (cov_size)
    frontier_kernel<true><<<blocks_for(F, FT), FRONTIER_THREADS, ((size_t)FT * A + 47) / 16 * 16, s>>>(
        F, A, FT, depth_cap, (const uint8_t*)cond, (const uint8_t*)cvalid,
        (const int64_t*)depth, (const int64_t*)ebits, (const uint8_t*)mask,
        (int64_t*)ebits_after, props, need_terminal, (ull*)acc, (const uint8_t*)ant,
        succ_bins, cov);
  else
    frontier_kernel<false><<<blocks_for(F, FT), FRONTIER_THREADS, 0, s>>>(
        F, A, FT, depth_cap, (const uint8_t*)cond, (const uint8_t*)cvalid,
        (const int64_t*)depth, (const int64_t*)ebits, (const uint8_t*)mask,
        (int64_t*)ebits_after, props, need_terminal, (ull*)acc, nullptr, succ_bins, nullptr);
  *launches_host = 2;
  return last_error(cudaSuccess);
}

// The fold route's keys from the candidate leaves: n_leaves host entries
// each of ptr_host (device pointers), width_host (u32 words a row) and
// kind_host (LEAF_*), at most MAX_FOLD_LEAVES, every leaf contiguous with
// B rows. depth, mask and acc may be null.
extern "C" int fw_keys(int64_t B, int A, int n_leaves, const void* ptr_host,
                       const void* width_host, const void* kind_host, const void* cvalid,
                       const void* depth, const void* mask, int64_t depth_cap, void* key,
                       void* idx, void* acc, void* stream) {
  if (B < 0 || B > (int64_t)0xFFFFFFFF || A < 1 || n_leaves < 0 || n_leaves > MAX_FOLD_LEAVES)
    return (int)cudaErrorInvalidValue;
  FoldLeaves leaves;
  leaves.n = 0;
  leaves.words = 0;
  for (int l = 0; l < n_leaves; ++l) {
    const int w = ((const int*)width_host)[l], kind = ((const int*)kind_host)[l];
    if (w < 0 || kind < LEAF_U8 || kind > LEAF_I64) return (int)cudaErrorInvalidValue;
    if (w == 0) continue;
    leaves.ptr[leaves.n] = (const uint8_t*)((const uint64_t*)ptr_host)[l];
    leaves.width[leaves.n] = w;
    leaves.kind[leaves.n] = kind;
    leaves.words += w;
    ++leaves.n;
  }
  keys_kernel<<<blocks_for(B, THREADS), THREADS, 0, (cudaStream_t)stream>>>(
      B, A, leaves, (const uint8_t*)cvalid, (const int64_t*)depth, (const uint8_t*)mask,
      depth_cap, (ull*)key, (uint32_t*)idx, (ull*)acc);
  return last_error(cudaSuccess);
}

// depth, mask and acc may be null.
extern "C" int fw_keys_pairs(int64_t B, int A, const void* chi, const void* clo,
                             const void* cvalid, const void* depth, const void* mask,
                             int64_t depth_cap, void* key, void* idx, void* acc,
                             void* stream) {
  keys_pairs_kernel<<<blocks_for(B, THREADS), THREADS, 0, (cudaStream_t)stream>>>(
      B, A, (const int64_t*)chi, (const int64_t*)clo, (const uint8_t*)cvalid,
      (const int64_t*)depth, (const uint8_t*)mask, depth_cap, (ull*)key, (uint32_t*)idx,
      (ull*)acc);
  return last_error(cudaSuccess);
}

// The leaves are the candidates' int64 arrays: rows (B, N, R), timers
// (B, N); for an unordered network (P == 0) net_src, net_dst and net_cnt
// (B, E) and net_msg (B, E, W), for an ordered one (P > 0) flow_msg
// (B, P, Q, W) and flow_len (B, P), the other network leaves null; hist
// (B, H), null when H is 0; consts is laid out as CompHash says, at most
// MAX_CH_CONSTS words. depth, mask and acc may be null.
extern "C" int fw_comphash_keys(int64_t B, int A, int N, int R, int E, int P, int Q, int W,
                                int H, const void* rows, const void* timers,
                                const void* net_src, const void* net_dst,
                                const void* net_msg, const void* net_cnt,
                                const void* flow_msg, const void* flow_len, const void* hist,
                                const void* consts, const void* cvalid, const void* depth,
                                const void* mask, int64_t depth_cap, void* key, void* idx,
                                void* acc, void* stream) {
  const bool ordered = P > 0;
  if (N < 1 || R < 0 || E < 0 || P < 0 || Q < 0 || W < 0 || H < 0 ||
      (H > 0 && hist == nullptr) || (ordered && (flow_msg == nullptr || flow_len == nullptr)) ||
      (!ordered && E > 0 && (net_src == nullptr || net_dst == nullptr ||
                             net_msg == nullptr || net_cnt == nullptr)))
    return (int)cudaErrorInvalidValue;
  CompHash ch{N, R, ordered ? 0 : E, P, ordered ? Q : 0, W, H, (const int64_t*)consts};
  const int64_t n_consts = comphash_consts(ch);
  if (n_consts > MAX_CH_CONSTS) return (int)cudaErrorInvalidValue;
  comphash_keys_kernel<<<blocks_for(B, CH_SPAN), THREADS, (size_t)n_consts * sizeof(uint32_t),
                         (cudaStream_t)stream>>>(
      B, A, ch, (int)n_consts, (const int64_t*)rows, (const int64_t*)timers, (const int64_t*)net_src,
      (const int64_t*)net_dst, (const int64_t*)net_msg, (const int64_t*)net_cnt,
      (const int64_t*)flow_msg, (const int64_t*)flow_len, (const int64_t*)hist,
      (const uint8_t*)cvalid, (const int64_t*)depth, (const uint8_t*)mask, depth_cap,
      (ull*)key, (uint32_t*)idx, (ull*)acc);
  return last_error(cudaSuccess);
}

// Sorts key[0, n) (with idx) in place, stably, as unsigned values:
// key_tmp and idx_tmp are 2n long, scratch is SC_PSTAT + nt + 2 * nb * 256
// words (nt partition tiles of PART_TILE lanes, nb pass tiles of
// SORT_TILE). *launches_host gets the device operations queued (a memset,
// the partition and eight digit passes).
extern "C" int fw_sort(int64_t n, void* key, void* idx, void* key_tmp, void* idx_tmp,
                       void* scratch, int* launches_host, void* stream) {
  *launches_host = 0;
  if (n <= 0) return last_error(cudaSuccess);
  if (n > (int64_t)ST_COUNT) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t nt = (n + PART_TILE - 1) / PART_TILE;
  const int64_t nb = (n + SORT_TILE - 1) / SORT_TILE;
  uint32_t* sc = (uint32_t*)scratch;
  uint32_t* status[2] = {sc + SC_PSTAT + nt, sc + SC_PSTAT + nt + nb * 256};
  // Tickets, n_live, histograms, the partition's words and the first
  // pass's; each pass clears the next pass's words of its own tile.
  cudaError_t e = cudaMemsetAsync(sc, 0, (size_t)(SC_PSTAT + nt + nb * 256) * 4, s);
  if (e != cudaSuccess) return (int)e;
  ull* k[3] = {(ull*)key, (ull*)key_tmp, (ull*)key_tmp + n};
  uint32_t* v[3] = {(uint32_t*)idx, (uint32_t*)idx_tmp, (uint32_t*)idx_tmp + n};
  // The partition writes the keyed lanes to buffer 1 and the sentinel
  // tail into buffer 0; pass 0 goes 1 -> 2, then 2 -> 0, 0 -> 2, ...,
  // so the eighth pass ends in buffer 0.
  sort_partition_kernel<<<(unsigned)nt, THREADS, 0, s>>>(k[0], v[0], n, k[1], v[1], sc, nt);
  for (int p = 0; p < 8; ++p) {
    const int src = p == 0 ? 1 : (p & 1 ? 2 : 0);
    const int dst = p & 1 ? 0 : 2;
    sort_pass_kernel<<<(unsigned)nb, THREADS, 0, s>>>(
        k[src], v[src], k[dst], v[dst], n, p == 0, p, sc, status[p & 1],
        p < 7 ? status[(p + 1) & 1] : nullptr);
  }
  *launches_host = 10;
  return last_error(cudaSuccess);
}

// starts is n_tiles + 1 words; one thread a sorted position (one block
// for an empty batch), so the launch shape depends on B alone.
extern "C" int fw_dedup(int64_t B, const void* skey, const void* sidx, int A,
                        const void* cvalid, const void* depth, const void* mask,
                        int64_t depth_cap, void* active, void* starts, int n_tiles,
                        int cap_bits, void* stream) {
  if (B < 0 || B > (int64_t)0xFFFFFFFF || A < 1 || n_tiles < 1 || cap_bits < 1 || cap_bits > 32 ||
      (int64_t)n_tiles * TILE_ROWS != ((int64_t)1 << cap_bits))
    return (int)cudaErrorInvalidValue;
  dedup_kernel<<<blocks_for(B, THREADS), THREADS, 0, (cudaStream_t)stream>>>(
      (const ull*)skey, (const uint32_t*)sidx, B, A, (const uint8_t*)cvalid,
      (const int64_t*)depth, (const uint8_t*)mask, depth_cap, (uint8_t*)active,
      (int64_t*)starts, n_tiles, cap_bits);
  return last_error(cudaSuccess);
}
// scratch holds 8 + 9 * n_tiles + B bytes (tile_sweep.cuh).
extern "C" int fw_sweep(void* table, const void* skey, const void* active,
                        const void* starts, int64_t B, int n_tiles, int cap_bits,
                        void* flag, void* acc, void* scratch, void* stream) {
  WaveBatch batch{(const ull*)skey, (const uint8_t*)active, (uint8_t*)flag, (ull*)acc};
  return last_error(tile_sweep((uint2*)table, batch, (const int64_t*)starts, B, n_tiles,
                               cap_bits, scratch, (cudaStream_t)stream));
}

// scratch is 1 + ceil(B / COMPACT_TILE) words (at least 2): the ticket and
// the tiles' status words, zeroed here. With coverage on, cov is the
// wave's coverage vector of cov_size words (fw_frontier zeroed it), whose
// fresh half the kernel adds; null and 0 with it off. stats, when not
// null, gets the wave's (5 + 3P,) int64 stats vector (acc holds
// ACC_FIRST_HIT + P counters). *launches_host gets the device
// operations queued (the memset and the kernel).
extern "C" int fw_compact(int64_t B, int A, const void* flag, const void* skey,
                          const void* sidx, const void* ebits_after, const void* depth,
                          const void* hi, const void* lo, void* scratch, void* acc,
                          void* new_hi, void* new_lo, void* new_ebits, void* new_depth,
                          void* parent_hi, void* parent_lo, void* src_out, void* cov,
                          int cov_size, void* stats, int P, int* launches_host,
                          void* stream) {
  *launches_host = 0;
  if (B < 0 || B > (int64_t)ST_COUNT || A < 1 || P < 0 || P > MAX_PROPS ||
      (cov != nullptr && (cov_size < 4 + 2 * A + 1 + COV_DEPTH_BINS ||
                          A + COV_DEPTH_BINS > MAX_COV_WORDS)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned nt = blocks_for(B, COMPACT_TILE);
  const cudaError_t e = cudaMemsetAsync(scratch, 0, (size_t)(1 + nt) * sizeof(uint32_t), s);
  if (e != cudaSuccess) return (int)e;
  if (cov != nullptr)
    compact_kernel<true><<<nt, THREADS, (size_t)(A + COV_DEPTH_BINS) * sizeof(uint32_t), s>>>(
        (const uint8_t*)flag, B, A, (const ull*)skey, (const uint32_t*)sidx,
        (const int64_t*)ebits_after, (const int64_t*)depth, (const int64_t*)hi,
        (const int64_t*)lo, (int64_t*)new_hi, (int64_t*)new_lo, (int64_t*)new_ebits,
        (int64_t*)new_depth, (int64_t*)parent_hi, (int64_t*)parent_lo, (int64_t*)src_out,
        (uint32_t*)scratch, (ull*)acc, (int64_t)nt, cov_size, (ull*)cov, (int64_t*)stats, P);
  else
    compact_kernel<false><<<nt, THREADS, 0, s>>>(
        (const uint8_t*)flag, B, A, (const ull*)skey, (const uint32_t*)sidx,
        (const int64_t*)ebits_after, (const int64_t*)depth, (const int64_t*)hi,
        (const int64_t*)lo, (int64_t*)new_hi, (int64_t*)new_lo, (int64_t*)new_ebits,
        (int64_t*)new_depth, (int64_t*)parent_hi, (int64_t*)parent_lo, (int64_t*)src_out,
        (uint32_t*)scratch, (ull*)acc, (int64_t)nt, 0, nullptr, (int64_t*)stats, P);
  *launches_host = 2;
  return last_error(cudaSuccess);
}

// The leaf tables are host arrays of n_leaves entries each; group is the
// lanes a row (1, 2, 4, 8, 16 or 32). One launch for every MAX_LEAVES
// leaves; *launches_host gets their count.
extern "C" int fw_gather(int64_t B, const void* src_out, const void* acc, int n_leaves,
                         const void* src_host, const void* dst_host,
                         const void* row_bytes_host, const void* unit_host, int group,
                         int* launches_host, void* stream) {
  *launches_host = 0;
  if (group < 1 || group > 32 || (group & (group - 1))) return (int)cudaErrorInvalidValue;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  const int64_t rows_per_block = THREADS / group;
  const int64_t cap = (int64_t)sms * GATHER_BLOCKS_PER_SM;
  const int64_t want = (B + rows_per_block - 1) / rows_per_block;
  const unsigned grid = (unsigned)(want < 1 ? 1 : (want < cap ? want : cap));
  for (int l0 = 0; l0 < n_leaves; l0 += MAX_LEAVES) {
    Leaves leaves;
    leaves.n = n_leaves - l0 < MAX_LEAVES ? n_leaves - l0 : MAX_LEAVES;
    for (int l = 0; l < leaves.n; ++l) {
      leaves.src[l] = (const uint8_t*)((const uint64_t*)src_host)[l0 + l];
      leaves.dst[l] = (uint8_t*)((const uint64_t*)dst_host)[l0 + l];
      leaves.row_bytes[l] = ((const int64_t*)row_bytes_host)[l0 + l];
      leaves.unit[l] = ((const int*)unit_host)[l0 + l];
    }
    gather_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(B, (const int64_t*)src_out,
                                                             (const ull*)acc, leaves, group);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    ++*launches_host;
  }
  return last_error(cudaSuccess);
}
