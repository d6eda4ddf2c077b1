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
