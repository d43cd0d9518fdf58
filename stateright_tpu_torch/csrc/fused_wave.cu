// The model-independent stages of one BFS wave, as a chain of kernels.
//
// Replaces the TPU kernel stateright_tpu/ops/pallas_wave.py::fused_wave
// (inner kernel, prologue, sweep and epilogue) and computes what its
// prologue, sweep and epilogue compute after the model's own code has run.
// A Pallas kernel traces the model's expand, boundary and conditions into
// its prologue; a CUDA kernel cannot hold another program's code, so the
// caller runs that stage in torch (ops/fused_wave.py::model_stage) and
// hands over the condition matrix, the candidates' valid bits and their
// u32 words. The stages here are launched back to back on one stream,
// each through its own C entry point:
//
//   fw_frontier  eval mask (a live lane under depth_cap; the frontier mask
//                is optional, and a masked lane may hold a stale row that
//                no stage reads unmasked), eventually bits cleared by their
//                conditions, terminal lanes, the first hit lane of every
//                property, the max depth of the live lanes;
//   fw_keys      the (hi, lo) fingerprint of every candidate, one thread a
//                lane, bit-identical to ops/fingerprint.py::
//                fingerprint_words; invalid lanes (and the lanes of masked
//                frontier lanes) sink to (MAX, MAX). Two variants take its
//                place for a model with its own fingerprint (Pallas: the
//                model's fp_fn traced into the prologue, pallas_wave.py:180):
//   fw_comphash_keys  the component hash of a packed actor state
//                (actor/packed.py::PackedActorModel.packed_fingerprint),
//                one thread a lane, read straight from the candidate
//                leaves: each actor row and timer word hashed
//                multilinearly and seeded by its tag, the envelope table's
//                multiset digest (sum and xor of its active rows' hashes)
//                hashed as one row, the history row, then the sum/xor
//                combination and the shared finalizer;
//   fw_keys_pairs the (hi, lo) pairs a model's own packed_fingerprint
//                computed in torch, with fw_keys's validity and count;
//   fw_sort      a stable LSD radix sort of the 64-bit keys carrying the
//                lane index: per-block digit histograms, an exclusive scan
//                in digit-major, block-minor order, and a scatter that
//                ranks equal digits in input order (warp match + a prefix
//                over the block's warps), 8 passes of 8 bits;
//   fw_dedup     first occurrence of each valid key (active), and each
//                table tile's key range by binary search over the monotone
//                homes;
//   fw_sweep     the tile sweep of tile_sweep.cuh, the one the insert
//                kernel runs (Pallas: probe_claim, shared the same way):
//                tiles speculated in parallel, an ordered repair of the
//                tiles whose predecessor spilled, a parallel commit;
//   fw_compact   an exclusive scan of the fresh flags over the sorted
//                positions (block counts, one block scanning them, block
//                scans) and the scatter of hi, lo, ebits, depth + 1 and the
//                parent's hi and lo to each fresh key's slot;
//   fw_gather    the candidate leaves of the fresh keys, as byte rows;
//   fw_coverage  with coverage on only: the wave's coverage vector
//                (below);
//   fw_stats     one block: [generated, n_new, overflow, max_depth,
//                any_hit] and (hit, hi, lo) per property, as int64.
//
// Every output equals the plain torch twin's (ops/fused_wave.py::
// fused_wave_plain) bit for bit, and the per-lane outputs are B rows long
// with the first n_new rows defined, as the Pallas outputs are.
//
// What bounds it on an H100. The bytes a wave must move, u32 values at
// 4 B though the port carries them in int64: the words (B * W * 4 B), the
// valid bits, the frontier arrays and conditions, the distinct table rows
// the probes read, the claimed rows, the fresh rows' outputs and leaves.
// At 2pc-8's main-path shape (F = 8,192, A = 42, B = 344,064, W = 11) that
// is about 20 MB, about 6 us at 3.35 TB/s; chip_smoke.py computes it from
// its inputs. The sweep moves whole windows into shared memory (one warp a
// touched tile, on every SM) and then repairs, in one block, the few tiles
// whose predecessor spilled into their apron. The other stages are
// bandwidth-shaped passes over B lanes; the sort makes 8 passes over 12 B a
// lane. The design keeps every stage off the host (no sync inside a wave;
// counters live in a small device vector that the host reads once) and the
// launches few (about 35 a wave). What it does not yet do: prefetch the
// sweep's windows asynchronously, or sort only the valid lanes.
//
// fw_coverage replaces the coverage epilogue of the same Pallas kernel
// (pallas_wave.py:152-177, the exercise masks in the prologue; :495-507,
// DeviceCoverage.wave_reduce in the epilogue; the cov output, :538-539,
// :554-555, :606-633) and computes what telemetry/coverage.py::
// DeviceCoverage.wave_reduce computes, its plain twin: one int64 vector of
// 4 + 2A + P + succ_bins + 64 counters (evaluated, terminal, two symmetry
// slots left 0, per-action fired and fresh counts, per-property exercise
// counts, the successors-per-state log2 bins, the fresh-per-depth bins).
// It reads the chain's own scratch: the model stage's valid bits, the
// frontier's depth and mask (the eval mask and the masked valid bits are
// recomputed, as fw_frontier and the keys stage compute them, so a masked
// lane's stale row counts nowhere), the condition and antecedent matrices,
// ebits_after, the sweep's outcome bytes and the sorted lanes. One launch:
// the first blocks take one frontier lane a thread (eval, terminal,
// successor bin, exercise by property kind), the others COV_ITEMS sorted
// positions a thread (fired by lane % A over the masked valid bits; a fresh
// position's action idx % A and depth bin min(depth[idx / A] + 1, 63)).
// Counters gather in shared memory and fold into the zeroed vector with
// integer atomics, so the result is exact in any order. Bound by bytes:
// the frontier's depth and mask, each evaluated lane's valid bytes and the
// condition, antecedent and ebits words its properties read, the outcome
// byte of each sorted position holding a key, 4 B of idx at each fresh
// position only, and the vector: about 0.65 MB, 0.2 us at 3.35 TB/s on a
// full 2pc-8 wave (B = 344,064). It is a single small launch, so launch
// latency sets its time.
//
// fw_comphash_keys (the Pallas prologue's model fingerprint,
// pallas_wave.py:180, for a packed actor model) is bound by bytes too: each
// valid lane's actor rows, timers, envelope counts, active envelopes and
// history (538 u32 words a lane at paxos check 3) read once, 12 B a lane
// written; an invalid lane reads only its valid bit. One thread walks one
// lane, so a warp's loads hit 32 rows 4.3 KB apart and do not coalesce; a
// warp a lane would (a later change).

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
// read by fw_stats.
#define ACC_GENERATED 0
#define ACC_N_NEW 1
#define ACC_OVERFLOW 2
#define ACC_MAX_DEPTH 3
#define ACC_FIRST_HIT 4  // + property index; all ones while no lane hit

#define SEED_HI 0x9747B28Cu
#define SEED_LO 0x3C6EF372u
#define FP_CHUNKS 16

#define SORT_ROUNDS 8
#define SORT_TILE (THREADS * SORT_ROUNDS)
#define SCAN_THREADS 1024
#define SCAN_ITEMS 4
#define COMPACT_ITEMS 4
#define COMPACT_TILE (THREADS * COMPACT_ITEMS)
#define COV_ITEMS 4
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
  int unit[MAX_LEAVES];  // copy width in bytes: 8, 4, 2 or 1
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

// In-place exclusive scan of data[0, m) by one block of SCAN_THREADS
// threads; *total_out (when given) gets the sum.
__global__ void __launch_bounds__(SCAN_THREADS) scan_one_block_kernel(
    uint32_t* __restrict__ data, int64_t m, ull* __restrict__ total_out) {
  uint32_t carry = 0;
  for (int64_t base = 0; base < m; base += (int64_t)SCAN_THREADS * SCAN_ITEMS) {
    const int64_t i0 = base + (int64_t)threadIdx.x * SCAN_ITEMS;
    uint32_t v[SCAN_ITEMS];
    uint32_t sum = 0;
#pragma unroll
    for (int j = 0; j < SCAN_ITEMS; ++j) {
      v[j] = i0 + j < m ? data[i0 + j] : 0u;
      sum += v[j];
    }
    uint32_t tot;
    uint32_t run = carry + block_exclusive_scan<SCAN_THREADS>(sum, &tot);
#pragma unroll
    for (int j = 0; j < SCAN_ITEMS; ++j) {
      if (i0 + j < m) data[i0 + j] = run;
      run += v[j];
    }
    carry += tot;
  }
  if (threadIdx.x == 0 && total_out != nullptr) *total_out = carry;
}

// -- (a) frontier lanes --------------------------------------------------

__global__ void __launch_bounds__(THREADS) frontier_kernel(
    int64_t F, int A, int64_t depth_cap,
    const uint8_t* __restrict__ cond,    // (P, F) 0/1
    const uint8_t* __restrict__ cvalid,  // (F * A,) expand & boundary
    const int64_t* __restrict__ depth, const int64_t* __restrict__ ebits,
    const uint8_t* __restrict__ mask,  // (F,) live lanes, or null: all
    int64_t* __restrict__ ebits_after, Props props, ull* __restrict__ acc) {
  const int64_t f = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  ull d = 0;
  if (f < F) {
    const int64_t dep = depth[f];
    const bool live = mask == nullptr || mask[f] != 0;
    const bool ev = live && dep < depth_cap;
    int64_t eb = ebits[f];
    for (int i = 0; i < props.n; ++i) {
      if (props.ebit[i] >= 0 && cond[(int64_t)i * F + f]) eb &= ~(1LL << props.ebit[i]);
    }
    ebits_after[f] = eb;
    bool any = false;
    const uint8_t* row = cvalid + f * A;
    for (int a = 0; a < A; ++a) any |= row[a] != 0;
    const bool terminal = ev && !any;
    for (int i = 0; i < props.n; ++i) {
      const bool c = cond[(int64_t)i * F + f] != 0;
      bool hit;
      if (props.kind[i] == KIND_ALWAYS) {
        hit = ev && !c;
      } else if (props.kind[i] == KIND_SOMETIMES) {
        hit = ev && c;
      } else {  // eventually: unmet bit at a terminal state
        hit = terminal && ((eb >> props.ebit[i]) & 1);
      }
      if (hit) atomicMin(&acc[ACC_FIRST_HIT + i], (ull)f);
    }
    d = live ? (ull)dep : 0ull;  // max(where(mask, depth, 0))
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    const ull y = __shfl_down_sync(FULL_MASK, d, o);
    d = y > d ? y : d;
  }
  if ((threadIdx.x & 31) == 0 && d) atomicMax(&acc[ACC_MAX_DEPTH], d);
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

// ops/fingerprint.py::fingerprint_words for one row of n words (the low 32
// bits of each int64): a serial fold up to 64 words, FP_CHUNKS independent
// chunk digests folded in order above that, then the shared finalizer and
// the (0, 0) and (MAX, MAX) nudges.
__device__ uint2 fingerprint_row(const int64_t* __restrict__ row, int n) {
  uint32_t hi = SEED_HI;
  uint32_t lo = SEED_LO;
  if (n <= 64) {
    for (int i = 0; i < n; ++i) {
      const uint32_t w = (uint32_t)row[i];
      hi = mm3_round(hi, w);
      lo = mm3_round(lo, w ^ 0xA5A5A5A5u);
    }
  } else {
    const int L = (n + FP_CHUNKS - 1) / FP_CHUNKS;
    for (int k = 0; k < FP_CHUNKS; ++k) {
      uint32_t chi = SEED_HI ^ ((uint32_t)k * 0x9E3779B9u);
      uint32_t clo = SEED_LO ^ ((uint32_t)k * 0x85EBCA6Bu);
      for (int j = 0; j < L; ++j) {
        const int c = k * L + j;
        const uint32_t w = c < n ? (uint32_t)row[c] : 0u;
        chi = mm3_round(chi, w);
        clo = mm3_round(clo, w ^ 0xA5A5A5A5u);
      }
      hi = mm3_round(hi, chi);
      lo = mm3_round(lo, clo);
    }
  }
  hi = fmix32(hi ^ (uint32_t)(n * 4));
  lo = fmix32(lo ^ (uint32_t)(n * 4 + 1));
  if (hi == 0u && lo == 0u) lo = 1u;
  if (hi == 0xFFFFFFFFu && lo == 0xFFFFFFFFu) lo = 0xFFFFFFFEu;
  return make_uint2(hi, lo);
}

// A candidate lane is valid when cvalid holds, its frontier lane is live
// (mask[b / A], when mask is given) and under depth_cap (when depth is).
__device__ __forceinline__ unsigned lane_valid(int64_t b, int A,
                                               const uint8_t* __restrict__ cvalid,
                                               const int64_t* __restrict__ depth,
                                               const uint8_t* __restrict__ mask,
                                               int64_t depth_cap) {
  return cvalid[b] != 0 && (mask == nullptr || mask[b / A] != 0) &&
         (depth == nullptr || depth[b / A] < depth_cap);
}

// key[b] = (hi << 32) | lo of lane b, or all ones when the lane is not
// valid (cvalid, when mask is given mask[b / A], and when depth is given
// depth[b / A] < depth_cap); idx[b] = b. Counts the valid lanes into acc
// (when given).
__global__ void __launch_bounds__(THREADS) keys_kernel(
    int64_t B, int A, int W, const int64_t* __restrict__ words,
    const uint8_t* __restrict__ cvalid, const int64_t* __restrict__ depth,
    const uint8_t* __restrict__ mask, int64_t depth_cap, ull* __restrict__ key,
    uint32_t* __restrict__ idx, ull* __restrict__ acc) {
  const int64_t b = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  unsigned valid = 0;
  if (b < B) {
    valid = lane_valid(b, A, cvalid, depth, mask, depth_cap);
    ull k = ~0ull;
    if (valid) {
      const uint2 fp = fingerprint_row(words + b * W, W);
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

// The (hi, lo) multilinear sums of n words at stride 1 under the
// coefficient vectors k (hi) and k + stride_k (lo), added to (ah, al).
__device__ __forceinline__ void lin_row(const int64_t* __restrict__ w, int n,
                                        const int64_t* k, int stride_k, uint32_t& ah,
                                        uint32_t& al) {
  for (int j = 0; j < n; ++j) {
    const uint32_t x = (uint32_t)w[j];
    ah += x * (uint32_t)k[j];
    al += x * (uint32_t)k[stride_k + j];
  }
}

// ops/fingerprint.py::combine_pairs(*PackedActorModel.packed_component_pairs)
// of lane b. The network leaves are net_* (P == 0) or flow_* (P > 0); the
// others are not read.
__device__ uint2 comphash_lane(int64_t b, const CompHash& ch, const int64_t* __restrict__ rows,
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
  const int64_t* k_act = ch.k;
  const int64_t* k_net = k_act + 2 * (R + 1);
  const int64_t* k_hist = k_net + (P > 0 ? 2 * (QW + 1) : 2 * (3 + W) + 8);
  const int64_t* seed = k_hist + 2 * H;
  uint32_t acc4[4] = {0u, 0u, 0u, 0u};
  // Actor components 0..N-1: row ‖ timer word.
  for (int c = 0; c < N; ++c) {
    uint32_t ah = 0u, al = 0u;
    lin_row(rows + (b * N + c) * R, R, k_act, R + 1, ah, al);
    lin_row(timers + b * N + c, 1, k_act + R, R + 1, ah, al);
    fold_pair(fmix32(ah ^ (uint32_t)seed[c]), fmix32(al ^ (uint32_t)seed[C + c]), acc4);
  }
  if (P > 0) {
    // An ordered network: flow components N..N+P-1, queue ‖ length.
    for (int p = 0; p < P; ++p) {
      uint32_t ah = 0u, al = 0u;
      lin_row(flow_msg + (b * P + p) * QW, QW, k_net, QW + 1, ah, al);
      lin_row(flow_len + b * P + p, 1, k_net + QW, QW + 1, ah, al);
      fold_pair(fmix32(ah ^ (uint32_t)seed[N + p]), fmix32(al ^ (uint32_t)seed[C + N + p]),
                acc4);
    }
  } else {
    // An unordered network, tag N: the multiset digest of the active
    // envelope rows, hashed as one row.
    const int M = 3 + W;
    const int64_t* k_env = k_net;
    const int64_t* k_dig = k_net + 2 * M;
    uint32_t dig[4] = {0u, 0u, 0u, 0u};
    for (int e = 0; e < E; ++e) {
      const uint32_t cnt = (uint32_t)net_cnt[b * E + e];
      if (cnt == 0u) continue;
      const uint32_t src = (uint32_t)net_src[b * E + e];
      const uint32_t dst = (uint32_t)net_dst[b * E + e];
      uint32_t ah = src * (uint32_t)k_env[0] + dst * (uint32_t)k_env[1];
      uint32_t al = src * (uint32_t)k_env[M] + dst * (uint32_t)k_env[M + 1];
      lin_row(net_msg + (b * E + e) * W, W, k_env + 2, M, ah, al);
      ah += cnt * (uint32_t)k_env[2 + W];
      al += cnt * (uint32_t)k_env[M + 2 + W];
      fold_pair(fmix32(ah ^ SEED_HI), fmix32(al ^ SEED_LO), dig);
    }
    uint32_t ah = 0u, al = 0u;
    for (int j = 0; j < 4; ++j) {
      ah += dig[j] * (uint32_t)k_dig[j];
      al += dig[j] * (uint32_t)k_dig[4 + j];
    }
    fold_pair(fmix32(ah ^ (uint32_t)seed[N]), fmix32(al ^ (uint32_t)seed[C + N]), acc4);
  }
  // The history, tag N + NC.
  if (H > 0) {
    uint32_t ah = 0u, al = 0u;
    lin_row(hist + b * H, H, k_hist, H, ah, al);
    fold_pair(fmix32(ah ^ (uint32_t)seed[N + NC]), fmix32(al ^ (uint32_t)seed[C + N + NC]),
              acc4);
  }
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
// state in place of the default fold.
__global__ void __launch_bounds__(THREADS) comphash_keys_kernel(
    int64_t B, int A, CompHash ch, const int64_t* __restrict__ rows,
    const int64_t* __restrict__ timers, const int64_t* __restrict__ net_src,
    const int64_t* __restrict__ net_dst, const int64_t* __restrict__ net_msg,
    const int64_t* __restrict__ net_cnt, const int64_t* __restrict__ flow_msg,
    const int64_t* __restrict__ flow_len, const int64_t* __restrict__ hist,
    const uint8_t* __restrict__ cvalid, const int64_t* __restrict__ depth,
    const uint8_t* __restrict__ mask, int64_t depth_cap, ull* __restrict__ key,
    uint32_t* __restrict__ idx, ull* __restrict__ acc) {
  const int64_t b = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  unsigned valid = 0;
  if (b < B) {
    valid = lane_valid(b, A, cvalid, depth, mask, depth_cap);
    ull k = ~0ull;
    if (valid) {
      const uint2 fp = comphash_lane(b, ch, rows, timers, net_src, net_dst, net_msg,
                                     net_cnt, flow_msg, flow_len, hist);
      k = ((ull)fp.x << 32) | fp.y;
    }
    key[b] = k;
    idx[b] = (uint32_t)b;
  }
  const unsigned n = __reduce_add_sync(FULL_MASK, valid);
  if (acc != nullptr && (threadIdx.x & 31) == 0 && n) atomicAdd(&acc[ACC_GENERATED], (ull)n);
}

// -- (c) stable LSD radix sort ----------------------------------------------

// hist[digit * nb + block] = count of the digit among the block's keys.
__global__ void __launch_bounds__(THREADS) radix_hist_kernel(
    const ull* __restrict__ key, int64_t n, int shift, uint32_t* __restrict__ hist,
    int64_t nb) {
  __shared__ uint32_t h[256];
  h[threadIdx.x] = 0;
  __syncthreads();
  const int64_t base = (int64_t)blockIdx.x * SORT_TILE;
#pragma unroll
  for (int r = 0; r < SORT_ROUNDS; ++r) {
    const int64_t i = base + r * THREADS + threadIdx.x;
    if (i < n) atomicAdd(&h[(key[i] >> shift) & 255u], 1u);
  }
  __syncthreads();
  hist[(int64_t)threadIdx.x * nb + blockIdx.x] = h[threadIdx.x];
}

// Moves each key (and its value) to its slot for this digit: the scanned
// histogram gives the block's first slot for each digit; within the block,
// rounds of THREADS keys go in order, and within a round a key's rank is
// the count of equal digits before it (lower warps, then lower lanes).
__global__ void __launch_bounds__(THREADS) radix_scatter_kernel(
    const ull* __restrict__ key_in, const uint32_t* __restrict__ val_in,
    ull* __restrict__ key_out, uint32_t* __restrict__ val_out, int64_t n,
    int shift, const uint32_t* __restrict__ hist, int64_t nb) {
  __shared__ uint32_t s_base[256];
  __shared__ uint32_t s_warp[THREADS / 32][256];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;
  s_base[tid] = hist[(int64_t)tid * nb + blockIdx.x];
  const int64_t base = (int64_t)blockIdx.x * SORT_TILE;
  for (int r = 0; r < SORT_ROUNDS; ++r) {
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) s_warp[w][tid] = 0;
    __syncthreads();
    const int64_t i = base + r * THREADS + tid;
    const bool ok = i < n;
    const ull k = ok ? key_in[i] : 0ull;
    const uint32_t v = ok ? val_in[i] : 0u;
    const unsigned d = ok ? (unsigned)((k >> shift) & 255u) : 256u;
    const unsigned peers = __match_any_sync(FULL_MASK, d);
    const unsigned rank = __popc(peers & lanes_below);
    if (ok && rank == 0) s_warp[warp][d] = __popc(peers);
    __syncthreads();
    uint32_t run = 0;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) {
      const uint32_t c = s_warp[w][tid];
      s_warp[w][tid] = run;
      run += c;
    }
    __syncthreads();
    if (ok) {
      const uint32_t dst = s_base[d] + s_warp[warp][d] + rank;
      key_out[dst] = k;
      val_out[dst] = v;
    }
    __syncthreads();
    s_base[tid] += run;
  }
}

// -- (d) dedup and tile ranges -----------------------------------------------

__global__ void __launch_bounds__(THREADS) dedup_kernel(
    const ull* __restrict__ skey, int64_t B, uint8_t* __restrict__ active,
    int64_t* __restrict__ starts, int n_tiles, int cap_bits) {
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (i < B) {
    const ull k = skey[i];
    active[i] = k != ~0ull && (i == 0 || k != skey[i - 1]);
  }
  if (i <= n_tiles) {
    // starts[t] = the first sorted position whose home is at or past the
    // tile's first row (searchsorted, side left); starts[0] = 0.
    const int64_t bound = i * TILE_ROWS;
    const unsigned shift = 32u - (unsigned)cap_bits;
    int64_t lo = 0, hi = i == 0 ? 0 : B;
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      const int64_t home = (int64_t)((uint32_t)(skey[mid] >> 32) >> shift);
      if (home < bound) lo = mid + 1; else hi = mid;
    }
    starts[i] = lo;
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

// bsum[block] = fresh keys among the block's COMPACT_TILE positions.
__global__ void __launch_bounds__(THREADS) fresh_count_kernel(
    const uint8_t* __restrict__ flag, int64_t B, uint32_t* __restrict__ bsum) {
  const int64_t i0 = (int64_t)blockIdx.x * COMPACT_TILE + (int64_t)threadIdx.x * COMPACT_ITEMS;
  uint32_t c = 0;
#pragma unroll
  for (int j = 0; j < COMPACT_ITEMS; ++j) c += i0 + j < B && (flag[i0 + j] & FLAG_FRESH);
  uint32_t tot;
  block_exclusive_scan<THREADS>(c, &tot);
  if (threadIdx.x == 0) bsum[blockIdx.x] = tot;
}

// Each fresh key's slot is its rank among the fresh keys in sorted order
// (bsum holds the blocks' exclusive offsets); writes the per-lane outputs
// of the slot and the key's lane for the leaf gather.
__global__ void __launch_bounds__(THREADS) compact_kernel(
    const uint8_t* __restrict__ flag, int64_t B, int A,
    const uint32_t* __restrict__ bsum, const ull* __restrict__ skey,
    const uint32_t* __restrict__ sidx, const int64_t* __restrict__ ebits_after,
    const int64_t* __restrict__ depth, const int64_t* __restrict__ hi,
    const int64_t* __restrict__ lo, int64_t* __restrict__ new_hi,
    int64_t* __restrict__ new_lo, int64_t* __restrict__ new_ebits,
    int64_t* __restrict__ new_depth, int64_t* __restrict__ parent_hi,
    int64_t* __restrict__ parent_lo, int64_t* __restrict__ src_out) {
  const int64_t i0 = (int64_t)blockIdx.x * COMPACT_TILE + (int64_t)threadIdx.x * COMPACT_ITEMS;
  uint8_t fresh[COMPACT_ITEMS];
  uint32_t c = 0;
#pragma unroll
  for (int j = 0; j < COMPACT_ITEMS; ++j) {
    fresh[j] = i0 + j < B && (flag[i0 + j] & FLAG_FRESH);
    c += fresh[j];
  }
  uint32_t tot;
  int64_t pos = (int64_t)bsum[blockIdx.x] + block_exclusive_scan<THREADS>(c, &tot);
#pragma unroll
  for (int j = 0; j < COMPACT_ITEMS; ++j) {
    if (!fresh[j]) continue;
    const int64_t i = i0 + j;
    const ull k = skey[i];
    const int64_t src = sidx[i];
    const int64_t parent = src / A;
    new_hi[pos] = (int64_t)(k >> 32);
    new_lo[pos] = (int64_t)(k & 0xFFFFFFFFull);
    new_ebits[pos] = ebits_after[parent];
    new_depth[pos] = depth[parent] + 1;
    parent_hi[pos] = hi[parent];
    parent_lo[pos] = lo[parent];
    src_out[pos] = src;
    ++pos;
  }
}

// Copies each leaf's row src_out[pos] to row pos, for pos < n_new.
__global__ void __launch_bounds__(THREADS) gather_kernel(
    int64_t B, const int64_t* __restrict__ src_out, const ull* __restrict__ acc,
    Leaves leaves) {
  const int64_t pos = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (pos >= B || pos >= (int64_t)acc[ACC_N_NEW]) return;
  const int64_t s = src_out[pos];
  for (int l = 0; l < leaves.n; ++l) {
    const int64_t rb = leaves.row_bytes[l];
    const uint8_t* src = leaves.src[l] + s * rb;
    uint8_t* dst = leaves.dst[l] + pos * rb;
    switch (leaves.unit[l]) {
      case 8:
        for (int64_t o = 0; o < rb; o += 8) *(uint64_t*)(dst + o) = *(const uint64_t*)(src + o);
        break;
      case 4:
        for (int64_t o = 0; o < rb; o += 4) *(uint32_t*)(dst + o) = *(const uint32_t*)(src + o);
        break;
      case 2:
        for (int64_t o = 0; o < rb; o += 2) *(uint16_t*)(dst + o) = *(const uint16_t*)(src + o);
        break;
      default:
        for (int64_t o = 0; o < rb; ++o) dst[o] = src[o];
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

__global__ void __launch_bounds__(THREADS) coverage_kernel(
    int64_t F, int A, int64_t depth_cap, const uint8_t* __restrict__ cvalid,
    const int64_t* __restrict__ depth, const uint8_t* __restrict__ mask,
    const uint8_t* __restrict__ cond,  // (P, F)
    const uint8_t* __restrict__ ant,   // (P, F): the antecedent, or all ones
    const int64_t* __restrict__ ebits_after, Props props,
    const uint8_t* __restrict__ flag, const uint32_t* __restrict__ sidx, int succ_bins,
    int size, unsigned f_blocks, ull* __restrict__ cov) {
  extern __shared__ uint32_t h[];
  for (int i = threadIdx.x; i < size; i += THREADS) h[i] = 0u;
  __syncthreads();
  const int P = props.n;
  const int o_fresh = 4 + A, o_props = 4 + 2 * A;
  const int o_succ = o_props + P, o_depth = o_succ + succ_bins;
  if (blockIdx.x < f_blocks) {
    // One frontier lane a thread.
    const int64_t f = (int64_t)blockIdx.x * THREADS + threadIdx.x;
    unsigned ev = 0, term = 0;
    if (f < F) {
      ev = (mask == nullptr || mask[f] != 0) && depth[f] < depth_cap;
      if (ev) {
        int succ = 0;
        const uint8_t* row = cvalid + f * A;
        for (int a = 0; a < A; ++a) succ += row[a] != 0;
        term = succ == 0;
        // Bin of the successor count: 0 for <= 1, else ceil(log2(succ)).
        atomicAdd(&h[o_succ + (succ <= 1 ? 0 : 32 - __clz(succ - 1))], 1u);
        const int64_t eb = ebits_after[f];
        for (int i = 0; i < P; ++i) {
          bool ex;
          if (props.kind[i] == KIND_ALWAYS) {
            ex = ant[(int64_t)i * F + f] != 0;
          } else if (props.kind[i] == KIND_SOMETIMES) {
            ex = cond[(int64_t)i * F + f] != 0;
          } else {  // eventually: met = the unmet bit already cleared
            ex = ((eb >> props.ebit[i]) & 1) == 0;
          }
          if (ex) atomicAdd(&h[o_props + i], 1u);
        }
      }
    }
    const unsigned ne = __reduce_add_sync(FULL_MASK, ev);
    const unsigned nt = __reduce_add_sync(FULL_MASK, term);
    if ((threadIdx.x & 31) == 0) {
      if (ne) atomicAdd(&h[0], ne);
      if (nt) atomicAdd(&h[1], nt);
    }
  } else {
    // COV_ITEMS sorted positions a thread, THREADS apart.
    const int64_t B = F * A;
    const int64_t base = (int64_t)(blockIdx.x - f_blocks) * THREADS * COV_ITEMS + threadIdx.x;
#pragma unroll
    for (int r = 0; r < COV_ITEMS; ++r) {
      const int64_t i = base + (int64_t)r * THREADS;
      if (i >= B) break;
      // Fired: lane i is valid under the eval mask of its frontier lane.
      const int64_t fl = i / A;
      if (cvalid[i] != 0 && (mask == nullptr || mask[fl] != 0) && depth[fl] < depth_cap)
        atomicAdd(&h[4 + (int)(i - fl * A)], 1u);
      // Fresh: the claim winner at sorted position i, its lane sidx[i].
      if (flag[i] & FLAG_FRESH) {
        const int64_t s = sidx[i];
        const int64_t p = s / A;
        int64_t d = depth[p] + 1;
        d = d < 0 ? 0 : (d > COV_DEPTH_BINS - 1 ? COV_DEPTH_BINS - 1 : d);
        atomicAdd(&h[o_fresh + (int)(s - p * A)], 1u);
        atomicAdd(&h[o_depth + (int)d], 1u);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < size; i += THREADS)
    if (h[i]) atomicAdd(&cov[i], (ull)h[i]);
}

// -- stats -------------------------------------------------------------------

__global__ void stats_kernel(const ull* __restrict__ acc, int P, int64_t F,
                             const int64_t* __restrict__ hi,
                             const int64_t* __restrict__ lo,
                             int64_t* __restrict__ stats) {
  const int t = threadIdx.x;
  if (t < P) {
    const ull first = acc[ACC_FIRST_HIT + t];
    const bool hit = first != ~0ull;
    // The first hit lane, or lane 0 when there is none (jnp.argmax).
    const int64_t f = hit ? (int64_t)first : 0;
    stats[5 + 3 * t] = hit;
    stats[6 + 3 * t] = F ? hi[f] : 0;
    stats[7 + 3 * t] = F ? lo[f] : 0;
  }
  if (t == 0) {
    bool any = false;
    for (int i = 0; i < P; ++i) any |= acc[ACC_FIRST_HIT + i] != ~0ull;
    for (int i = 0; i < 4; ++i) stats[i] = (int64_t)acc[i];
    stats[4] = any;
  }
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

// mask may be null (every lane live).
extern "C" int fw_frontier(int64_t F, int A, int64_t depth_cap, const void* cond,
                           const void* cvalid, const void* depth, const void* ebits,
                           const void* mask, void* ebits_after, int P,
                           const void* kind_host, const void* ebit_host, void* acc,
                           void* stream) {
  if (P < 0 || P > MAX_PROPS) return (int)cudaErrorInvalidValue;
  Props props;
  props.n = P;
  for (int i = 0; i < P; ++i) {
    props.kind[i] = ((const int*)kind_host)[i];
    props.ebit[i] = ((const int*)ebit_host)[i];
  }
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(acc, 0, ACC_FIRST_HIT * sizeof(ull), s);
  if (e == cudaSuccess && P)
    e = cudaMemsetAsync((ull*)acc + ACC_FIRST_HIT, 0xFF, P * sizeof(ull), s);
  if (e != cudaSuccess) return (int)e;
  frontier_kernel<<<blocks_for(F, THREADS), THREADS, 0, s>>>(
      F, A, depth_cap, (const uint8_t*)cond, (const uint8_t*)cvalid,
      (const int64_t*)depth, (const int64_t*)ebits, (const uint8_t*)mask,
      (int64_t*)ebits_after, props, (ull*)acc);
  return last_error(cudaSuccess);
}

// depth, mask and acc may be null.
extern "C" int fw_keys(int64_t B, int A, int W, const void* words, const void* cvalid,
                       const void* depth, const void* mask, int64_t depth_cap,
                       void* key, void* idx, void* acc, void* stream) {
  keys_kernel<<<blocks_for(B, THREADS), THREADS, 0, (cudaStream_t)stream>>>(
      B, A, W, (const int64_t*)words, (const uint8_t*)cvalid, (const int64_t*)depth,
      (const uint8_t*)mask, depth_cap, (ull*)key, (uint32_t*)idx, (ull*)acc);
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
// (B, H), null when H is 0; consts is laid out as CompHash says. depth,
// mask and acc may be null.
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
  comphash_keys_kernel<<<blocks_for(B, THREADS), THREADS, 0, (cudaStream_t)stream>>>(
      B, A, ch, (const int64_t*)rows, (const int64_t*)timers, (const int64_t*)net_src,
      (const int64_t*)net_dst, (const int64_t*)net_msg, (const int64_t*)net_cnt,
      (const int64_t*)flow_msg, (const int64_t*)flow_len, (const int64_t*)hist,
      (const uint8_t*)cvalid, (const int64_t*)depth, (const uint8_t*)mask, depth_cap,
      (ull*)key, (uint32_t*)idx, (ull*)acc);
  return last_error(cudaSuccess);
}

// Sorts key[0, n) (with idx) in place; key_tmp, idx_tmp are n long and
// hist is 256 * ceil(n / SORT_TILE) long.
extern "C" int fw_sort(int64_t n, void* key, void* idx, void* key_tmp, void* idx_tmp,
                       void* hist, void* stream) {
  if (n <= 0) return last_error(cudaSuccess);
  if (n > 0xFFFFFFFFll) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t nb = (n + SORT_TILE - 1) / SORT_TILE;
  ull* kin = (ull*)key;
  ull* kout = (ull*)key_tmp;
  uint32_t* vin = (uint32_t*)idx;
  uint32_t* vout = (uint32_t*)idx_tmp;
  for (int shift = 0; shift < 64; shift += 8) {
    radix_hist_kernel<<<(unsigned)nb, THREADS, 0, s>>>(kin, n, shift, (uint32_t*)hist, nb);
    scan_one_block_kernel<<<1, SCAN_THREADS, 0, s>>>((uint32_t*)hist, 256 * nb, nullptr);
    radix_scatter_kernel<<<(unsigned)nb, THREADS, 0, s>>>(kin, vin, kout, vout, n, shift,
                                                          (uint32_t*)hist, nb);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    ull* kt = kin; kin = kout; kout = kt;
    uint32_t* vt = vin; vin = vout; vout = vt;
  }
  return last_error(cudaSuccess);  // 8 passes: the result is back in key, idx
}

extern "C" int fw_dedup(int64_t B, const void* skey, void* active, void* starts,
                        int n_tiles, int cap_bits, void* stream) {
  const int64_t n = B > n_tiles + 1 ? B : n_tiles + 1;
  dedup_kernel<<<blocks_for(n, THREADS), THREADS, 0, (cudaStream_t)stream>>>(
      (const ull*)skey, B, (uint8_t*)active, (int64_t*)starts, n_tiles, cap_bits);
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

// bsum is ceil(B / COMPACT_TILE) long (at least 1).
extern "C" int fw_compact(int64_t B, int A, const void* flag, const void* skey,
                          const void* sidx, const void* ebits_after, const void* depth,
                          const void* hi, const void* lo, void* bsum, void* acc,
                          void* new_hi, void* new_lo, void* new_ebits, void* new_depth,
                          void* parent_hi, void* parent_lo, void* src_out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned nb = blocks_for(B, COMPACT_TILE);
  fresh_count_kernel<<<nb, THREADS, 0, s>>>((const uint8_t*)flag, B, (uint32_t*)bsum);
  scan_one_block_kernel<<<1, SCAN_THREADS, 0, s>>>((uint32_t*)bsum, nb,
                                                   (ull*)acc + ACC_N_NEW);
  compact_kernel<<<nb, THREADS, 0, s>>>(
      (const uint8_t*)flag, B, A, (const uint32_t*)bsum, (const ull*)skey,
      (const uint32_t*)sidx, (const int64_t*)ebits_after, (const int64_t*)depth,
      (const int64_t*)hi, (const int64_t*)lo, (int64_t*)new_hi, (int64_t*)new_lo,
      (int64_t*)new_ebits, (int64_t*)new_depth, (int64_t*)parent_hi,
      (int64_t*)parent_lo, (int64_t*)src_out);
  return last_error(cudaSuccess);
}

// The leaf tables are host arrays of n_leaves entries each.
extern "C" int fw_gather(int64_t B, const void* src_out, const void* acc, int n_leaves,
                         const void* src_host, const void* dst_host,
                         const void* row_bytes_host, const void* unit_host,
                         void* stream) {
  for (int l0 = 0; l0 < n_leaves; l0 += MAX_LEAVES) {
    Leaves leaves;
    leaves.n = n_leaves - l0 < MAX_LEAVES ? n_leaves - l0 : MAX_LEAVES;
    for (int l = 0; l < leaves.n; ++l) {
      leaves.src[l] = (const uint8_t*)((const uint64_t*)src_host)[l0 + l];
      leaves.dst[l] = (uint8_t*)((const uint64_t*)dst_host)[l0 + l];
      leaves.row_bytes[l] = ((const int64_t*)row_bytes_host)[l0 + l];
      leaves.unit[l] = ((const int*)unit_host)[l0 + l];
    }
    gather_kernel<<<blocks_for(B, THREADS), THREADS, 0, (cudaStream_t)stream>>>(
        B, (const int64_t*)src_out, (const ull*)acc, leaves);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return last_error(cudaSuccess);
}

extern "C" int fw_stats(int P, int64_t F, const void* acc, const void* hi, const void* lo,
                        void* stats, void* stream) {
  if (P < 0 || P > MAX_PROPS) return (int)cudaErrorInvalidValue;
  stats_kernel<<<1, MAX_PROPS, 0, (cudaStream_t)stream>>>((const ull*)acc, P, F,
                                                          (const int64_t*)hi,
                                                          (const int64_t*)lo,
                                                          (int64_t*)stats);
  return last_error(cudaSuccess);
}

// cov is size = 4 + 2A + P + succ_bins + 64 int64 words, zeroed here; mask
// may be null (every lane live); cond and ant are (P, F) bytes, ant's row of
// a property that is not `always` (or has no antecedent) all ones.
extern "C" int fw_coverage(int64_t F, int A, int64_t depth_cap, const void* cvalid,
                           const void* depth, const void* mask, const void* cond,
                           const void* ant, const void* ebits_after, int P,
                           const void* kind_host, const void* ebit_host, const void* flag,
                           const void* sidx, int size, void* cov, void* stream) {
  const int succ_bins = cov_succ_bins(A);
  if (P < 0 || P > MAX_PROPS || A < 1 || F < 0 ||
      size != 4 + 2 * A + P + succ_bins + COV_DEPTH_BINS || size > MAX_COV_WORDS)
    return (int)cudaErrorInvalidValue;
  Props props;
  props.n = P;
  for (int i = 0; i < P; ++i) {
    props.kind[i] = ((const int*)kind_host)[i];
    props.ebit[i] = ((const int*)ebit_host)[i];
  }
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t e = cudaMemsetAsync(cov, 0, (size_t)size * sizeof(ull), s);
  if (e != cudaSuccess) return (int)e;
  const unsigned f_blocks = blocks_for(F, THREADS);
  const unsigned b_blocks = blocks_for(F * (int64_t)A, (int64_t)THREADS * COV_ITEMS);
  coverage_kernel<<<f_blocks + b_blocks, THREADS, (size_t)size * sizeof(uint32_t), s>>>(
      F, A, depth_cap, (const uint8_t*)cvalid, (const int64_t*)depth, (const uint8_t*)mask,
      (const uint8_t*)cond, (const uint8_t*)ant, (const int64_t*)ebits_after, props,
      (const uint8_t*)flag, (const uint32_t*)sidx, succ_bins, size, f_blocks, (ull*)cov);
  return last_error(cudaSuccess);
}
