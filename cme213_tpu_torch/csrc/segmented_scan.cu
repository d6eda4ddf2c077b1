// segmented_scan.cu -- inclusive segmented sum scan of a 1-D f32 array
// with int32 head flags, optionally with the hw_final multiply fused into
// the load (a <- segscan(a * xx)), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of cme213_tpu/ops/segmented_pallas.py:
//   segmented_scan_pallas (pallas_call at :140)  -> FUSED = false  (B6)
//   spmv_scan_pallas      (pallas_call at :182)  -> FUSED = true   (B7)
// Both compute out[i] = w[i] + (head[i] ? 0 : out[i-1]) with
// w = v (B6) or w = v * xx (B7).
//
// What bounds it.  The scan does one add per element, so it is bound by
// device memory.  The useful bytes of one scan are 12 n for B6 (read the
// values and the flags, write the values) and 16 n for B7 (xx as well):
// 0.056 ms an iteration for B7 at the suite's largest instance
// (n = 11.6 M) at the H100 SXM's 3.35 TB/s.  One launch a scan reads each
// input once and writes the output once, so it moves only those bytes.
//
// What must change from the TPU design.  The TPU kernel carries a scalar
// from one tile to the next in an SMEM buffer, which is valid only because
// Pallas TPU grid steps run in order.  CUDA blocks run concurrently and in
// no order, so the carry crosses tiles by a single-pass decoupled
// look-back with a fixed association:
//   1. The grid is the blocks that fit on the card at once.  Each block
//      takes tiles t (kTile = kTileThreads x kTileItems consecutive
//      elements) one after another from an atomic ticket, so a tile waits
//      only on tiles whose blocks are running: no deadlock, whether or not
//      every block is resident.  The last block to finish resets the
//      counters for the next call on the workspace.
//   2. A tile is scanned locally -- a thread-serial scan of its items, a
//      __shfl_up_sync segmented Hillis-Steele over the warp's thread
//      summaries (the idiom of the reference's fp.cu:28-59 warp scan), a
//      scan of the warp summaries by warp 0 through shared memory -- which
//      gives its summary A[t] = (v, head): the sum of its open segment and
//      whether it holds a head.  Warp 0 publishes A[t] at once.
//   3. Warp 0 looks back for the tile's incoming carry E[t] = P[t-1], where
//      P is the serial left fold of the summaries in tile order:
//      P[-1] = 0, P[t] = A[t].head ? A[t].v : P[t-1] + A[t].v.  It reads
//      32 predecessors' status words at a time, waits until every one up
//      to the nearest stop is published, and stops at the nearest tile j
//      that has published P[j] or whose A[j] holds a head (then
//      P[j] = A[j].v).  From there one serial fold, one __fadd_rn a tile,
//      gives P[t-1].  Every P is the same fold, so the bits do not depend on
//      where the walk stopped, nor on which blocks finished first.  The
//      block publishes P[t] and applies E[t] level by level: tile -> warp
//      -> thread -> element.  P[t] is the fold of the summaries, not the
//      tile's last output element, which the warp levels associate
//      differently.
//   4. A block pipelines its tiles, three to a step: it draws a ticket and
//      issues that tile's loads, scans the tile it loaded a step before and
//      publishes its A, and looks back for, finishes and stores the tile it
//      scanned a step before.  So the loads are in flight during the
//      look-back, and a tile's A is out as soon as its data is in, not
//      after its block's previous look-back; a look-back comes a step after
//      the tile's own A, when its predecessors' are most likely out too.
//      (B7 at pwtk on the H100: a block a tile ran 15% slower than the
//      same kernel without any look-back, the pipeline 5%; PERF.md
//      section 5.)
//
// Status words.  One 64-bit word a tile: the f32 value in bits 0-31, bit 32
// set for an inclusive prefix P (clear: an aggregate A), bit 33 the
// summary's head, bits 34-63 the call's epoch.  A word of another epoch is
// not yet published in this call.  Value and state travel in one word, so a
// reader never pairs a new state with an old value, and no other memory is
// published through it: relaxed gpu-scope stores and loads suffice (a
// later read of a word never sees an older value), and release/acquire,
// which fence and invalidate the L1, cost 12-16% (PERF.md section 5).  The
// host passes a new epoch each call, so one zeroed workspace serves call
// after call (B7's iterations, and every later scan on the stream) with no
// memset.
//
// Rounding.  Every multiply and add is __fmul_rn/__fadd_rn, which the
// compiler never contracts, and the library is built with --fmad=false.
// The order of the additions is fixed by the decomposition above, and
// ops/segmented_pallas.py's plain version repeats it step for step, so the
// two agree bit for bit.
//
// Memory.  The kernel masks the ragged last tile itself (no padding copy).
// The caller gives one 8-byte aligned workspace of 2 + 2 * ntiles 32-bit
// words: the ticket and the count of finished blocks, then the status
// words, all zero before the first call.  The scan may write in place
// (out == v): tile t's elements are read and written by tile t's block
// only.
//
// PageRank's pull (pagerank_pull_f32) is a third use of the look-back: a
// segmented sum over the CSR's neighbour slots whose load gathers
// contrib[nbr], in float64, writing only each row's total; the per-vertex
// update after it (pagerank_update_f32) is an ordinary grid-stride kernel.
// Their note is before their code, below B6/B7's, which they do not touch.
//
// Host interface: plain C, loaded with ctypes by ops/_kernels.py.  One call
// enqueues the one launch of one scan on the given stream, does not
// synchronise, and returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
// 256 x 8: no tile of 128 to 1024 threads x 8, nor 256 x 16, was faster at
// pwtk on the H100 (PERF.md section 5)
constexpr int kTileThreads = 256;
constexpr int kTileItems = 8;
constexpr int kTile = kTileThreads * kTileItems;
constexpr int kTileWarps = kTileThreads / kWarp;
constexpr unsigned kFullMask = 0xffffffffu;

constexpr unsigned long long kInclusive = 1ull << 32;
constexpr unsigned long long kHead = 1ull << 33;
constexpr int kEpochShift = 34;
constexpr unsigned long long kEpochMask = ~((1ull << kEpochShift) - 1);
constexpr unsigned kMaxEpoch = (1u << (64 - kEpochShift)) - 1;

static_assert(kTileItems % 4 == 0, "the vector loads move 4 elements each");
static_assert(kTileThreads % kWarp == 0 && kTileWarps <= kWarp,
              "whole warps; warp 0 scans the warp summaries");

// inclusive segmented Hillis-Steele over the lanes of a warp: at stride d,
// lane l >= d takes v[l] = f[l] ? v[l] : v[l-d] + v[l], f[l] |= f[l-d]
__device__ __forceinline__ void warp_scan(float& v, int& f, int lane) {
#pragma unroll
  for (int d = 1; d < kWarp; d <<= 1) {
    const float pv = __shfl_up_sync(kFullMask, v, d);
    const int pf = __shfl_up_sync(kFullMask, f, d);
    if (lane >= d) {
      v = f ? v : __fadd_rn(pv, v);
      f |= pf;
    }
  }
}

// this thread's kTileItems elements as loaded: values, head flags and (when
// FUSED) xx; elements at or past n read as 0.  Kept raw, so the loads stay
// in flight until scan_chunk uses them.
struct Raw {
  float a[kTileItems];
  int g[kTileItems];
  float x[kTileItems];
};

template <bool FUSED>
__device__ __forceinline__ void load_raw(const float* v,
                                         const float* __restrict__ xx,
                                         const int* __restrict__ flags,
                                         long long base, long long n,
                                         bool vec, Raw& r) {
  if (vec && base + kTileItems <= n) {
#pragma unroll
    for (int h = 0; h < kTileItems / 4; ++h) {
      const float4 a = reinterpret_cast<const float4*>(v + base)[h];
      const int4 g = reinterpret_cast<const int4*>(flags + base)[h];
      r.a[4 * h + 0] = a.x;
      r.a[4 * h + 1] = a.y;
      r.a[4 * h + 2] = a.z;
      r.a[4 * h + 3] = a.w;
      r.g[4 * h + 0] = g.x;
      r.g[4 * h + 1] = g.y;
      r.g[4 * h + 2] = g.z;
      r.g[4 * h + 3] = g.w;
      if (FUSED) {
        const float4 x = reinterpret_cast<const float4*>(xx + base)[h];
        r.x[4 * h + 0] = x.x;
        r.x[4 * h + 1] = x.y;
        r.x[4 * h + 2] = x.z;
        r.x[4 * h + 3] = x.w;
      }
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < kTileItems; ++j) {
    const long long i = base + j;
    r.a[j] = i < n ? v[i] : 0.0f;
    r.g[j] = i < n ? flags[i] : 0;
    if (FUSED) r.x[j] = i < n ? xx[i] : 0.0f;
  }
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

__device__ __forceinline__ void store_status(unsigned long long* p,
                                              unsigned long long word) {
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(word)
               : "memory");
}

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  unsigned long long word;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];"
               : "=l"(word)
               : "l"(p)
               : "memory");
  return word;
}

__device__ __forceinline__ unsigned long long pack(float v, int head,
                                                   unsigned long long state,
                                                   unsigned long long mark) {
  return static_cast<unsigned long long>(__float_as_uint(v)) | state |
         (head ? kHead : 0ull) | mark;
}

// the fold over the status words w that lanes hi, hi-1, .., 0 of the warp
// hold (lane l: the tile l before lane 0's), from e: a stop (P, or A with a
// head) restarts it from its value, any other word adds to it.  Every lane
// returns the same value.
__device__ __forceinline__ float fold_window(unsigned long long w, float e,
                                             int hi) {
  const float v = __uint_as_float(static_cast<unsigned>(w));
  const int stop = (w & (kInclusive | kHead)) != 0;
#pragma unroll
  for (int l = kWarp - 1; l >= 0; --l) {
    const float vl = __shfl_sync(kFullMask, v, l);
    const int sl = __shfl_sync(kFullMask, stop, l);
    if (l <= hi) e = sl ? vl : __fadd_rn(e, vl);
  }
  return e;
}

// E[t] = P[t-1], the serial left fold of the summaries of tiles 0 .. t-1;
// called by all of warp 0, every lane returns it.  Lane l reads the word of
// tile top - l; tile -1 reads as a published P = 0.
__device__ float look_back(const unsigned long long* status, int t,
                           unsigned long long mark, int lane) {
  int top = t - 1;
  unsigned long long w;
  unsigned stops;
  for (;;) {  // back a window at a time until one holds a stop
    unsigned pending;
    do {
      const int i = top - lane;
      w = i >= 0 ? load_status(status + i) : (mark | kInclusive);
      const bool ready = (w & kEpochMask) == mark;
      stops = __ballot_sync(kFullMask, ready && (w & (kInclusive | kHead)));
      // lanes up to the nearest stop (all lanes if there is none) must be
      // published before the walk may use the window
      const unsigned upto =
          stops ? ((stops & (0u - stops)) << 1) - 1u : kFullMask;
      pending = __ballot_sync(kFullMask, !ready) & upto;
    } while (pending);
    if (stops) break;
    top -= kWarp;
  }
  // forward from the nearest stop, a window at a time; the nearer windows
  // are read again (each was seen published; a word that has become P
  // since restarts the fold with the same bits)
  float e = fold_window(w, 0.0f, __ffs(stops) - 1);
  while (top < t - 1) {
    top += kWarp;
    e = fold_window(load_status(status + top - lane), e, kWarp - 1);
  }
  return e;
}

// this thread's share of a tile after the tile-local scan: the
// thread-serial scan loc, seen (bit j: a head at or before element j of the
// chunk) and the warp scan's exclusive value (xv, xf)
struct Chunk {
  float loc[kTileItems];
  unsigned seen;
  float xv;
  int xf;
};

// the tile-local scan of this thread's chunk as loaded; lane 31 leaves the
// warp's summary in (wv, wf)[warp]
template <bool FUSED>
__device__ __forceinline__ void scan_chunk(const Raw& r, int lane, int warp,
                                           float* wv, int* wf, Chunk& c) {
  int any = 0;
  c.seen = 0;
#pragma unroll
  for (int j = 0; j < kTileItems; ++j) {
    const float w = FUSED ? __fmul_rn(r.a[j], r.x[j]) : r.a[j];
    const int f = r.g[j] != 0;
    if (j == 0)
      c.loc[j] = w;
    else
      c.loc[j] = f ? w : __fadd_rn(c.loc[j - 1], w);
    any |= f;
    c.seen |= static_cast<unsigned>(any) << j;
  }
  float tv = c.loc[kTileItems - 1];
  int tf = any;
  warp_scan(tv, tf, lane);
  // exclusive within the warp: the inclusive value of the lane before
  c.xv = __shfl_up_sync(kFullMask, tv, 1);
  c.xf = __shfl_up_sync(kFullMask, tf, 1);
  if (lane == kWarp - 1) {
    wv[warp] = tv;
    wf[warp] = tf;
  }
}

// A grid of the blocks that fit on the card at once; each block takes
// tiles by ticket, one after another, in a pipeline of three stages a
// step, each on another tile:
//   - the tile drawn last: its ticket is drawn and its loads issued;
//   - the tile before (nxt), loaded during the last step: scanned locally,
//     A[nxt] published;
//   - the tile before that (cur): look-back, P[cur] published, down-sweep,
//     stored.
// So a tile publishes A as soon as its data is in, whatever look-back its
// block waits on, and looks back a step later, when its predecessors have
// most likely published theirs.  counters[0] is the ticket, counters[1]
// counts the blocks that have finished: the last resets both for the next
// call.
template <bool FUSED>
__global__ void __launch_bounds__(kTileThreads)
    segscan_tiles(const float* v, const float* __restrict__ xx,
                  const int* __restrict__ flags, long long n, int ntiles,
                  unsigned* __restrict__ counters,
                  unsigned long long* status, unsigned long long mark,
                  float* out) {
  // the warp summaries of three steps in turn: a step's tile is scanned
  // into one buffer while warps may still read the buffer of the step
  // before (the down-sweep of cur) and the other holds cur's
  __shared__ float wv_s[3][kTileWarps];
  __shared__ int wf_s[3][kTileWarps];
  __shared__ int tile_s[2];
  __shared__ float carry_s;
  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
  const bool vec = aligned16(v) && aligned16(flags) && aligned16(out) &&
                   (!FUSED || aligned16(xx));
  if (tid == 0) tile_s[0] = static_cast<int>(atomicAdd(counters, 1u));
  __syncthreads();
  int nxt = tile_s[0];
  int cur = ntiles;  // none yet
  Raw r;
  if (nxt < ntiles)
    load_raw<FUSED>(v, xx, flags,
                    static_cast<long long>(nxt) * kTile + tid * kTileItems,
                    n, vec, r);
  Chunk cc;                 // cur's share
  float cur_v = 0.0f;       // A[cur], in warp 0
  int cur_f = 0;
  for (int it = 1; cur < ntiles || nxt < ntiles; ++it) {
    const int bn = it % 3, bc = (it + 2) % 3;
    if (tid == 0 && nxt < ntiles)
      tile_s[it & 1] = static_cast<int>(atomicAdd(counters, 1u));
    Chunk cn;
    if (nxt < ntiles) scan_chunk<FUSED>(r, lane, warp, wv_s[bn], wf_s[bn], cn);
    __syncthreads();
    const int after = nxt < ntiles ? tile_s[it & 1] : ntiles;
    if (after < ntiles)  // in flight during this step
      load_raw<FUSED>(
          v, xx, flags,
          static_cast<long long>(after) * kTile + tid * kTileItems, n, vec,
          r);
    if (warp == 0) {
      float av = 0.0f;
      int af = 0;
      if (nxt < ntiles) {
        // the warp summaries become their inclusive scan; the last is A
        float sv = lane < kTileWarps ? wv_s[bn][lane] : 0.0f;
        int sf = lane < kTileWarps ? wf_s[bn][lane] : 0;
        warp_scan(sv, sf, lane);
        if (lane < kTileWarps) {
          wv_s[bn][lane] = sv;
          wf_s[bn][lane] = sf;
        }
        av = __shfl_sync(kFullMask, sv, kTileWarps - 1);
        af = __shfl_sync(kFullMask, sf, kTileWarps - 1);
        if (lane == 0) store_status(status + nxt, pack(av, af, 0ull, mark));
      }
      if (cur < ntiles) {
        const float e = look_back(status, cur, mark, lane);
        if (lane == 0) {
          store_status(status + cur,
                       pack(cur_f ? cur_v : __fadd_rn(e, cur_v), cur_f,
                            kInclusive, mark));
          carry_s = e;
        }
      }
      cur_v = av;
      cur_f = af;
    }
    __syncthreads();
    if (cur < ntiles) {
      const float* wv = wv_s[bc];
      const int* wf = wf_s[bc];
      const float carry = carry_s;
      const float win =
          warp == 0 ? carry
                    : (wf[warp - 1] ? wv[warp - 1]
                                    : __fadd_rn(carry, wv[warp - 1]));
      const float tin =
          lane == 0 ? win : (cc.xf ? cc.xv : __fadd_rn(win, cc.xv));
      float o[kTileItems];
#pragma unroll
      for (int j = 0; j < kTileItems; ++j)
        o[j] = (cc.seen >> j) & 1u ? cc.loc[j] : __fadd_rn(tin, cc.loc[j]);
      const long long base =
          static_cast<long long>(cur) * kTile + tid * kTileItems;
      if (vec && base + kTileItems <= n) {
        float4* o4 = reinterpret_cast<float4*>(out + base);
#pragma unroll
        for (int h = 0; h < kTileItems / 4; ++h)
          o4[h] = make_float4(o[4 * h], o[4 * h + 1], o[4 * h + 2],
                              o[4 * h + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < kTileItems; ++j)
          if (base + j < n) out[base + j] = o[j];
      }
    }
    cur = nxt;
    cc = cn;
    nxt = after;
  }
  // every block draws its last ticket before it counts itself out
  if (tid == 0 && atomicAdd(counters + 1, 1u) == gridDim.x - 1) {
    counters[0] = 0;
    counters[1] = 0;
  }
}

// blocks of the kernel that fit on the current device at once (cached a
// device), or 0 on an error
template <bool FUSED>
int resident_blocks() {
  static int cached[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cached[dev] == 0) {
    int per_sm = 0, sms = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, segscan_tiles<FUSED>, kTileThreads, 0) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return 0;
    cached[dev] = per_sm * sms;
  }
  return cached[dev];
}

template <bool FUSED>
int launch(const float* v, const float* xx, const int* flags, float* out,
           long long n, int ntiles, unsigned* counters,
           unsigned long long* status, unsigned long long mark,
           cudaStream_t stream) {
  const int resident = resident_blocks<FUSED>();
  if (resident < 1) {
    const cudaError_t err = cudaGetLastError();
    return err != cudaSuccess ? err : cudaErrorInvalidConfiguration;
  }
  const int grid = resident < ntiles ? resident : ntiles;
  segscan_tiles<FUSED><<<grid, kTileThreads, 0, stream>>>(
      v, xx, flags, n, ntiles, counters, status, mark, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// items per thread, threads per tile block, warp width: the geometry the
// plain version must be given to repeat the kernel's order of additions
// (ops/segmented_pallas.py checks it before a launch)
void segmented_scan_geometry(int* out3) {
  out3[0] = kTileItems;
  out3[1] = kTileThreads;
  out3[2] = kWarp;
}

// out = segscan(v) (xx == NULL, B6) or segscan(v * xx) (B7) over n f32
// elements with int32 head flags (nonzero = head); out may equal v.
// workspace: 8-byte aligned, workspace_words >= 2 + 2 * ceil(n / tile)
// 32-bit words, zero before its first call; epoch in [1, 2^30): a number no
// earlier call on this workspace used since it was zeroed.
int segmented_scan_f32(const void* v, const void* xx, const void* flags,
                       void* out, long long n, void* workspace,
                       long long workspace_words, unsigned epoch,
                       void* stream) {
  if (n < 1 || v == nullptr || flags == nullptr || out == nullptr ||
      workspace == nullptr || epoch < 1 || epoch > kMaxEpoch ||
      (reinterpret_cast<uintptr_t>(workspace) & 7u) != 0)
    return cudaErrorInvalidValue;
  const long long nt = (n + kTile - 1) / kTile;
  if (nt > 0x7fffffffLL || workspace_words < 2 + 2 * nt)
    return cudaErrorInvalidValue;
  const int ntiles = static_cast<int>(nt);
  const float* vf = static_cast<const float*>(v);
  const int* fl = static_cast<const int*>(flags);
  float* o = static_cast<float*>(out);
  unsigned* counters = static_cast<unsigned*>(workspace);
  unsigned long long* status = static_cast<unsigned long long*>(workspace) + 1;
  const unsigned long long mark =
      static_cast<unsigned long long>(epoch) << kEpochShift;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (xx == nullptr)
    return launch<false>(vf, nullptr, fl, o, n, ntiles, counters, status,
                         mark, st);
  return launch<true>(vf, static_cast<const float*>(xx), fl, o, n, ntiles,
                      counters, status, mark, st);
}

const char* segmented_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// ------------------------------------------------------------------ pull
//
// out[row] = sum over the row's slots i of contrib[nbrs[i]], for every
// non-empty row of a CSR graph (GAP pr_spmv's incoming_total), in float64.
//
// Load balance.  A tile is kPullTile consecutive slots, whatever rows they
// hold, so a hub of 10^6 neighbours spans hundreds of tiles and a tile may
// hold a thousand short rows: the work is balanced over slots, not rows.
// The rows run over the slots as segments, so a row's total is the value
// of the inclusive segmented scan at the row's last slot, and the scan's
// carry across tiles is B6's: the same single-pass look-back, tickets and
// fold, on float64 summaries.  Only the row ends are stored.
//
// Rows.  The caller compacts the empty rows away (off: the offsets of the
// R non-empty rows, int64, R + 1 of them; rowmap: each one's vertex) and
// gives tile_row[t], the compacted row holding slot t * kPullTile (and
// tile_row[ntiles] = R - 1).  A tile's rows are tile_row[t] ..
// tile_row[t + 1], at most kPullTile + 1 of them; their offsets go to
// shared memory in one coalesced read, and each thread finds the row of its
// first slot by a binary search there.  A slot is a head where a row
// starts, and a row end where the next row starts, so no per-slot flag is
// read: a sweep reads 4 bytes a slot (its neighbour id), the gathered
// contribution, and 12 bytes a row.
//
// Status words.  A float64 summary does not fit B6's word beside its
// state, so a tile has two: the value's high and low 32 bits, each beside
// the same state bits and epoch as B6's word.  A reader takes the pair only
// when both halves carry the call's epoch and the same state, so it never
// pairs a half of a tile's aggregate with a half of its inclusive prefix;
// otherwise it reads again.  A tile whose first slot is a head publishes
// its prefix at once (it needs no carry); any other publishes its
// aggregate, looks back, then publishes its prefix.
//
// Rounding.  Every add is __dadd_rn in the fixed order of the
// decomposition (thread, warp, tile, the serial fold of tile summaries), so
// the totals do not depend on which block took which tile; each is rounded
// to float32 once, when stored.  The update rounds score = base + d * sum
// to float32 once, sums |score - old| in float64 per block and then over
// the blocks in block order (the last block to finish), and writes
// contrib = score / degree (0 for an isolated vertex).

namespace {

constexpr int kPullThreads = 256;
constexpr int kPullItems = 8;
constexpr int kPullTile = kPullThreads * kPullItems;
constexpr int kPullWarps = kPullThreads / kWarp;
constexpr int kUpdateThreads = 256;
constexpr int kUpdateMaxBlocks = 1024;

static_assert(kPullItems % 4 == 0, "the vector loads move 4 ids each");
static_assert(kPullWarps <= kWarp, "warp 0 scans the warp summaries");

__device__ __forceinline__ void warp_scan_f64(double& v, int& f, int lane) {
#pragma unroll
  for (int d = 1; d < kWarp; d <<= 1) {
    const double pv = __shfl_up_sync(kFullMask, v, d);
    const int pf = __shfl_up_sync(kFullMask, f, d);
    if (lane >= d) {
      v = f ? v : __dadd_rn(pv, v);
      f |= pf;
    }
  }
}

__device__ __forceinline__ void publish_f64(unsigned long long* status,
                                            int t, double v, int head,
                                            unsigned long long state,
                                            unsigned long long mark) {
  const unsigned long long bits =
      static_cast<unsigned long long>(__double_as_longlong(v));
  const unsigned long long tag = state | (head ? kHead : 0ull) | mark;
  store_status(status + 2 * t, (bits >> 32) | tag);
  store_status(status + 2 * t + 1, (bits & 0xffffffffull) | tag);
}

// the pair of tile i: true once both halves carry mark and one state
__device__ __forceinline__ bool read_f64(const unsigned long long* status,
                                         int i, unsigned long long mark,
                                         double& v, int& stop) {
  const unsigned long long hi = load_status(status + 2 * i);
  const unsigned long long lo = load_status(status + 2 * i + 1);
  v = __longlong_as_double(static_cast<long long>(
      (hi << 32) | (lo & 0xffffffffull)));
  stop = (hi & (kInclusive | kHead)) != 0;
  return (hi & kEpochMask) == mark && (lo & kEpochMask) == mark &&
         ((hi ^ lo) & (kInclusive | kHead)) == 0;
}

__device__ __forceinline__ double fold_window_f64(double v, int stop,
                                                  double e, int hi) {
#pragma unroll
  for (int l = kWarp - 1; l >= 0; --l) {
    const double vl = __shfl_sync(kFullMask, v, l);
    const int sl = __shfl_sync(kFullMask, stop, l);
    if (l <= hi) e = sl ? vl : __dadd_rn(e, vl);
  }
  return e;
}

// look_back on the float64 pairs; called by all of warp 0
__device__ double look_back_f64(const unsigned long long* status, int t,
                                unsigned long long mark, int lane) {
  int top = t - 1;
  double v = 0.0;
  int stop = 1;
  unsigned stops;
  for (;;) {
    unsigned pending;
    do {
      const int i = top - lane;
      bool ready = true;
      if (i >= 0) {
        ready = read_f64(status, i, mark, v, stop);
      } else {
        v = 0.0;
        stop = 1;
      }
      stops = __ballot_sync(kFullMask, ready && stop);
      const unsigned upto =
          stops ? ((stops & (0u - stops)) << 1) - 1u : kFullMask;
      pending = __ballot_sync(kFullMask, !ready) & upto;
    } while (pending);
    if (stops) break;
    top -= kWarp;
  }
  double e = fold_window_f64(v, stop, 0.0, __ffs(stops) - 1);
  while (top < t - 1) {
    top += kWarp;
    // every pair here was seen published; one caught between its
    // aggregate and its prefix is read again
    bool torn;
    do {
      torn = !read_f64(status, top - lane, mark, v, stop);
    } while (__any_sync(kFullMask, torn));
    e = fold_window_f64(v, stop, e, kWarp - 1);
  }
  return e;
}

__global__ void __launch_bounds__(kPullThreads)
    pull_tiles(const int* __restrict__ nbrs, const float* __restrict__ contrib,
               const long long* __restrict__ off,
               const int* __restrict__ rowmap,
               const int* __restrict__ tile_row, long long nnz, int ntiles,
               unsigned* __restrict__ counters, unsigned long long* status,
               unsigned long long mark, float* __restrict__ sums) {
  __shared__ long long off_s[kPullTile + 2];
  __shared__ double wv_s[kPullWarps];
  __shared__ int wf_s[kPullWarps];
  __shared__ int tile_s;
  __shared__ double carry_s;
  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
  const bool vec = (reinterpret_cast<uintptr_t>(nbrs) & 15u) == 0;
  for (;;) {
    if (tid == 0) tile_s = static_cast<int>(atomicAdd(counters, 1u));
    __syncthreads();
    const int t = tile_s;
    if (t >= ntiles) break;
    const long long e0 = static_cast<long long>(t) * kPullTile;
    const long long e1 = e0 + kPullTile < nnz ? e0 + kPullTile : nnz;
    const int r0 = tile_row[t];
    const int cnt = tile_row[t + 1] - r0 + 2;
    for (int k = tid; k < cnt; k += kPullThreads) off_s[k] = off[r0 + k];
    __syncthreads();
    const long long base = e0 + static_cast<long long>(tid) * kPullItems;
    int ids[kPullItems];
    if (vec && base + kPullItems <= e1) {
#pragma unroll
      for (int h = 0; h < kPullItems / 4; ++h) {
        const int4 q = reinterpret_cast<const int4*>(nbrs + base)[h];
        ids[4 * h + 0] = q.x;
        ids[4 * h + 1] = q.y;
        ids[4 * h + 2] = q.z;
        ids[4 * h + 3] = q.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < kPullItems; ++j)
        ids[j] = base + j < e1 ? nbrs[base + j] : -1;
    }
    float x[kPullItems];
#pragma unroll
    for (int j = 0; j < kPullItems; ++j)
      x[j] = ids[j] >= 0 ? contrib[ids[j]] : 0.0f;
    // the row of the first slot: the last k with off_s[k] <= base
    int k = 0;
    if (base < e1) {
      int hi = cnt - 1;
      while (hi - k > 1) {
        const int mid = (k + hi) / 2;
        if (off_s[mid] <= base)
          k = mid;
        else
          hi = mid;
      }
    }
    double loc[kPullItems];
    int rk[kPullItems];
    unsigned seen = 0, ends = 0;
    int any = 0;
#pragma unroll
    for (int j = 0; j < kPullItems; ++j) {
      const long long i = base + j;
      const bool in = i < e1;
      if (in && j > 0 && off_s[k + 1] <= i) ++k;
      const int head = in && off_s[k] == i;
      const double w = static_cast<double>(x[j]);
      loc[j] = (j == 0 || head) ? w : __dadd_rn(loc[j - 1], w);
      any |= head;
      seen |= static_cast<unsigned>(any) << j;
      if (in && off_s[k + 1] == i + 1) ends |= 1u << j;
      rk[j] = k;
    }
    double tv = loc[kPullItems - 1];
    int tf = any;
    warp_scan_f64(tv, tf, lane);
    const double xv = __shfl_up_sync(kFullMask, tv, 1);
    const int xf = __shfl_up_sync(kFullMask, tf, 1);
    if (lane == kWarp - 1) {
      wv_s[warp] = tv;
      wf_s[warp] = tf;
    }
    __syncthreads();
    if (warp == 0) {
      double sv = lane < kPullWarps ? wv_s[lane] : 0.0;
      int sf = lane < kPullWarps ? wf_s[lane] : 0;
      warp_scan_f64(sv, sf, lane);
      if (lane < kPullWarps) {
        wv_s[lane] = sv;
        wf_s[lane] = sf;
      }
      const double av = __shfl_sync(kFullMask, sv, kPullWarps - 1);
      const int af = __shfl_sync(kFullMask, sf, kPullWarps - 1);
      double e = 0.0;
      if (off_s[0] == e0) {  // a row starts the tile: no carry in
        if (lane == 0) publish_f64(status, t, av, 1, kInclusive, mark);
      } else {
        if (lane == 0) publish_f64(status, t, av, af, 0ull, mark);
        e = look_back_f64(status, t, mark, lane);
        if (lane == 0)
          publish_f64(status, t, af ? av : __dadd_rn(e, av), af, kInclusive,
                      mark);
      }
      if (lane == 0) carry_s = e;
    }
    __syncthreads();
    if (ends) {
      const double carry = carry_s;
      const double win =
          warp == 0 ? carry
                    : (wf_s[warp - 1] ? wv_s[warp - 1]
                                      : __dadd_rn(carry, wv_s[warp - 1]));
      const double tin = lane == 0 ? win : (xf ? xv : __dadd_rn(win, xv));
#pragma unroll
      for (int j = 0; j < kPullItems; ++j)
        if ((ends >> j) & 1u)
          sums[rowmap[r0 + rk[j]]] = __double2float_rn(
              (seen >> j) & 1u ? loc[j] : __dadd_rn(tin, loc[j]));
    }
    __syncthreads();  // off_s, the summaries and tile_s are reused
  }
  if (tid == 0 && atomicAdd(counters + 1, 1u) == gridDim.x - 1) {
    counters[0] = 0;
    counters[1] = 0;
  }
}

__global__ void __launch_bounds__(kUpdateThreads)
    update_scores(const float* __restrict__ sums,
                  const int* __restrict__ deg, float* score, float* contrib,
                  long long n, double base, double damp, double* partials,
                  unsigned* counter, double* err) {
  __shared__ double red_s[kUpdateThreads / kWarp];
  __shared__ bool last_s;
  double acc = 0.0;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long v = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       v < n; v += stride) {
    const float s = __double2float_rn(
        __dadd_rn(base, __dmul_rn(damp, static_cast<double>(sums[v]))));
    const float old = score[v];
    acc = __dadd_rn(acc, fabs(__dsub_rn(static_cast<double>(s),
                                        static_cast<double>(old))));
    score[v] = s;
    const int d = deg[v];
    contrib[v] = d > 0 ? __fdiv_rn(s, static_cast<float>(d)) : 0.0f;
  }
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
#pragma unroll
  for (int d = kWarp / 2; d > 0; d >>= 1)
    acc = __dadd_rn(acc, __shfl_down_sync(kFullMask, acc, d));
  if (lane == 0) red_s[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    double b = 0.0;
    for (int w = 0; w < kUpdateThreads / kWarp; ++w)
      b = __dadd_rn(b, red_s[w]);
    partials[blockIdx.x] = b;
    __threadfence();
    last_s = atomicAdd(counter, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (last_s) {  // the whole last block sums the partials in a fixed order
    __threadfence();
    const volatile double* p = partials;
    double b = 0.0;
    for (unsigned i = threadIdx.x; i < gridDim.x; i += blockDim.x)
      b = __dadd_rn(b, p[i]);
#pragma unroll
    for (int d = kWarp / 2; d > 0; d >>= 1)
      b = __dadd_rn(b, __shfl_down_sync(kFullMask, b, d));
    if (lane == 0) red_s[warp] = b;
    __syncthreads();
    if (threadIdx.x == 0) {
      double total = 0.0;
      for (int w = 0; w < kUpdateThreads / kWarp; ++w)
        total = __dadd_rn(total, red_s[w]);
      *err = total;
      *counter = 0;
    }
  }
}

int pull_resident_blocks() {
  static int cached[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cached[dev] == 0) {
    int per_sm = 0, sms = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, pull_tiles, kPullThreads, 0) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return 0;
    cached[dev] = per_sm * sms;
  }
  return cached[dev];
}

}  // namespace

extern "C" {

// slots per thread, threads per tile, the update's most blocks (its
// partials buffer holds that many doubles)
void pagerank_pull_geometry(int* out3) {
  out3[0] = kPullItems;
  out3[1] = kPullThreads;
  out3[2] = kUpdateMaxBlocks;
}

// sums[rowmap[r]] = sum of contrib[nbrs[i]] over off[r] <= i < off[r + 1],
// for r < rows (each row non-empty), rounded to float32 once.  nbrs: nnz
// int32 ids; off: rows + 1 int64 offsets, off[0] = 0, off[rows] = nnz;
// tile_row: ntiles + 1 int32, ntiles = ceil(nnz / tile), tile_row[t] the
// row holding slot t * tile, tile_row[ntiles] = rows - 1.  workspace: 8-byte
// aligned, workspace_words >= 2 + 4 * ntiles 32-bit words, zero before its
// first call; epoch as segmented_scan_f32's.
int pagerank_pull_f32(const void* nbrs, const void* contrib, const void* off,
                      const void* rowmap, const void* tile_row, void* sums,
                      long long nnz, long long rows, void* workspace,
                      long long workspace_words, unsigned epoch,
                      void* stream) {
  if (nnz < 1 || rows < 1 || nbrs == nullptr || contrib == nullptr ||
      off == nullptr || rowmap == nullptr || tile_row == nullptr ||
      sums == nullptr || workspace == nullptr || epoch < 1 ||
      epoch > kMaxEpoch || (reinterpret_cast<uintptr_t>(workspace) & 7u) != 0)
    return cudaErrorInvalidValue;
  const long long nt = (nnz + kPullTile - 1) / kPullTile;
  if (nt > 0x7fffffffLL || rows > 0x7fffffffLL ||
      workspace_words < 2 + 4 * nt)
    return cudaErrorInvalidValue;
  const int resident = pull_resident_blocks();
  if (resident < 1) {
    const cudaError_t err = cudaGetLastError();
    return err != cudaSuccess ? err : cudaErrorInvalidConfiguration;
  }
  const int ntiles = static_cast<int>(nt);
  const int grid = resident < ntiles ? resident : ntiles;
  pull_tiles<<<grid, kPullThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(nbrs), static_cast<const float*>(contrib),
      static_cast<const long long*>(off), static_cast<const int*>(rowmap),
      static_cast<const int*>(tile_row), nnz, ntiles,
      static_cast<unsigned*>(workspace),
      static_cast<unsigned long long*>(workspace) + 1,
      static_cast<unsigned long long>(epoch) << kEpochShift,
      static_cast<float*>(sums));
  return cudaGetLastError();
}

// score = float32(base + damp * sums); *err = sum of |score - old| in
// float64; contrib = score / deg (0 where deg is 0).  partials: at least
// min(ceil(n / 256), 1024) doubles; counter: one 32-bit word, zero before
// the first call (the last block resets it).
int pagerank_update_f32(const void* sums, const void* deg, void* score,
                        void* contrib, long long n, double base, double damp,
                        void* partials, void* counter, void* err,
                        void* stream) {
  if (n < 1 || sums == nullptr || deg == nullptr || score == nullptr ||
      contrib == nullptr || partials == nullptr || counter == nullptr ||
      err == nullptr)
    return cudaErrorInvalidValue;
  const long long want = (n + kUpdateThreads - 1) / kUpdateThreads;
  const int grid =
      static_cast<int>(want < kUpdateMaxBlocks ? want : kUpdateMaxBlocks);
  update_scores<<<grid, kUpdateThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sums), static_cast<const int*>(deg),
      static_cast<float*>(score), static_cast<float*>(contrib), n, base, damp,
      static_cast<double*>(partials), static_cast<unsigned*>(counter),
      static_cast<double*>(err));
  return cudaGetLastError();
}

}  // extern "C"
