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
// (n = 11.6 M) at the H100 SXM's 3.35 TB/s.
//
// What must change from the TPU design.  The TPU kernel carries a scalar
// from one tile to the next in an SMEM buffer, which is valid only because
// Pallas TPU grid steps run in order.  CUDA blocks run concurrently and in
// no order, so the carry is computed in three passes (reduce, then scan):
//   1. reduce_tiles: each block takes a tile of kTile = 256 threads x 8
//      consecutive elements, scans it locally and writes the tile's
//      summary: the sum of its open segment (the tile-local scanned value
//      of its last element) and whether it holds a head;
//   2. scan_carries: one block scans the tile summaries with the segmented
//      operator (va, fa) + (vb, fb) = (fb ? vb : va + vb, fa | fb), 1024 at
//      a time, looping over chunks, and writes each tile's exclusive
//      incoming carry;
//   3. scan_tiles: each block scans its tile again -- a thread-serial scan
//      of its 8 elements, a __shfl_up_sync segmented Hillis-Steele over the
//      warp's thread summaries (the idiom of the reference's fp.cu:28-59
//      warp scan), a scan of the 8 warp summaries by warp 0 through shared
//      memory -- and adds the incoming carry to the elements before the
//      first head it has seen, then writes the tile.
// The cost of this form: the reduce pass reads the inputs a second time,
// so an iteration moves about 28 n bytes for B7 (20 n for B6) against the
// 16 n (12 n) that are useful.  A single-pass decoupled look-back scan
// would move only the useful bytes, but its association depends on which
// blocks finish first, so it could not be held bit for bit to a plain
// version; it is the later redesign.
//
// Rounding.  Every multiply and add is __fmul_rn/__fadd_rn, which the
// compiler never contracts, and the library is built with --fmad=false.
// The order of the additions is fixed by the decomposition above, and
// ops/segmented_pallas.py's plain version repeats it step for step in
// PyTorch, so the two agree bit for bit.
//
// Memory.  The kernel masks the ragged last tile itself (no padding copy).
// The caller gives one workspace buffer of 3 * ntiles 32-bit words: tile
// values, incoming carries, tile head flags.  The down-sweep may write in
// place (out == v): each element is read and written by one thread only,
// after the reduce pass of the same call has finished on the stream.
//
// Host interface: plain C, loaded with ctypes by ops/_kernels.py.  One call
// enqueues the three launches of one scan on the given stream, does not
// synchronise, and returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kTileThreads = 256;
constexpr int kTileItems = 8;
constexpr int kTile = kTileThreads * kTileItems;
constexpr int kTileWarps = kTileThreads / kWarp;
constexpr int kCarryThreads = 1024;
constexpr int kCarryWarps = kCarryThreads / kWarp;
constexpr unsigned kFullMask = 0xffffffffu;

static_assert(kTileItems == 8, "the vector loads move 8 elements a thread");
static_assert(kTileWarps <= kWarp && kCarryWarps <= kWarp,
              "warp 0 scans the warp summaries");

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

// the warp summaries (wv, wf)[0..nwarps) in shared memory become their
// inclusive scan; called by every thread of the block, between barriers
__device__ __forceinline__ void scan_warp_summaries(float* wv, int* wf,
                                                    int nwarps, int warp,
                                                    int lane) {
  if (warp == 0) {
    float v = lane < nwarps ? wv[lane] : 0.0f;
    int f = lane < nwarps ? wf[lane] : 0;
    warp_scan(v, f, lane);
    if (lane < nwarps) {
      wv[lane] = v;
      wf[lane] = f;
    }
  }
}

// this thread's 8 elements w (v, or v * xx when FUSED) and their head flags
// (0/1); elements at or past n read as (0, 0)
template <bool FUSED>
__device__ __forceinline__ void load_chunk(const float* v,
                                           const float* __restrict__ xx,
                                           const int* __restrict__ flags,
                                           long long base, long long n,
                                           bool vec, float (&w)[kTileItems],
                                           int (&f)[kTileItems]) {
  if (vec && base + kTileItems <= n) {
    const float4* v4 = reinterpret_cast<const float4*>(v + base);
    const int4* f4 = reinterpret_cast<const int4*>(flags + base);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 a = v4[h];
      const int4 g = f4[h];
      w[4 * h + 0] = a.x;
      w[4 * h + 1] = a.y;
      w[4 * h + 2] = a.z;
      w[4 * h + 3] = a.w;
      f[4 * h + 0] = g.x != 0;
      f[4 * h + 1] = g.y != 0;
      f[4 * h + 2] = g.z != 0;
      f[4 * h + 3] = g.w != 0;
      if (FUSED) {
        const float4 x = reinterpret_cast<const float4*>(xx + base)[h];
        w[4 * h + 0] = __fmul_rn(w[4 * h + 0], x.x);
        w[4 * h + 1] = __fmul_rn(w[4 * h + 1], x.y);
        w[4 * h + 2] = __fmul_rn(w[4 * h + 2], x.z);
        w[4 * h + 3] = __fmul_rn(w[4 * h + 3], x.w);
      }
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < kTileItems; ++j) {
    const long long i = base + j;
    if (i < n) {
      w[j] = FUSED ? __fmul_rn(v[i], xx[i]) : v[i];
      f[j] = flags[i] != 0;
    } else {
      w[j] = 0.0f;
      f[j] = 0;
    }
  }
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// pass 1: one tile per block -> its summary (open-segment sum, has head)
template <bool FUSED>
__global__ void __launch_bounds__(kTileThreads)
    reduce_tiles(const float* v, const float* __restrict__ xx,
                 const int* __restrict__ flags, long long n,
                 float* __restrict__ tile_v, int* __restrict__ tile_f) {
  __shared__ float wv[kTileWarps];
  __shared__ int wf[kTileWarps];
  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
  const long long base =
      static_cast<long long>(blockIdx.x) * kTile + tid * kTileItems;
  const bool vec = aligned16(v) && aligned16(flags) && (!FUSED || aligned16(xx));

  float w[kTileItems];
  int f[kTileItems];
  load_chunk<FUSED>(v, xx, flags, base, n, vec, w, f);
  float tv = w[0];
  int tf = f[0];
#pragma unroll
  for (int j = 1; j < kTileItems; ++j) {
    tv = f[j] ? w[j] : __fadd_rn(tv, w[j]);
    tf |= f[j];
  }
  warp_scan(tv, tf, lane);
  if (lane == kWarp - 1) {
    wv[warp] = tv;
    wf[warp] = tf;
  }
  __syncthreads();
  scan_warp_summaries(wv, wf, kTileWarps, warp, lane);
  __syncthreads();
  if (tid == 0) {
    tile_v[blockIdx.x] = wv[kTileWarps - 1];
    tile_f[blockIdx.x] = wf[kTileWarps - 1];
  }
}

// pass 2: one block; carry[t] = inclusive scan of the summaries through
// tile t-1, carry[0] = 0.  Chunks of kCarryThreads summaries in order, a
// running carry between them.
__global__ void __launch_bounds__(kCarryThreads)
    scan_carries(const float* __restrict__ tile_v,
                 const int* __restrict__ tile_f, int ntiles,
                 float* __restrict__ carry) {
  __shared__ float wv[kCarryWarps];
  __shared__ int wf[kCarryWarps];
  __shared__ float run;
  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
  if (tid == 0) {
    run = 0.0f;
    carry[0] = 0.0f;
  }
  for (int c0 = 0; c0 < ntiles - 1; c0 += kCarryThreads) {
    const int i = c0 + tid;
    float v = i < ntiles ? tile_v[i] : 0.0f;
    int f = i < ntiles ? tile_f[i] : 0;
    warp_scan(v, f, lane);
    if (lane == kWarp - 1) {
      wv[warp] = v;
      wf[warp] = f;
    }
    __syncthreads();
    scan_warp_summaries(wv, wf, kCarryWarps, warp, lane);
    __syncthreads();
    const float r = run;
    const float win =
        warp == 0 ? r : (wf[warp - 1] ? wv[warp - 1] : __fadd_rn(r, wv[warp - 1]));
    const float incl = f ? v : __fadd_rn(win, v);
    if (i + 1 < ntiles) carry[i + 1] = incl;
    __syncthreads();  // every thread has read run, wv and wf
    if (tid == kCarryThreads - 1) run = incl;
  }
}

// pass 3: one tile per block, scanned again with its incoming carry
template <bool FUSED>
__global__ void __launch_bounds__(kTileThreads)
    scan_tiles(const float* v, const float* __restrict__ xx,
               const int* __restrict__ flags, long long n,
               const float* __restrict__ carry, float* out) {
  __shared__ float wv[kTileWarps];
  __shared__ int wf[kTileWarps];
  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
  const long long base =
      static_cast<long long>(blockIdx.x) * kTile + tid * kTileItems;
  const bool vec = aligned16(v) && aligned16(flags) && aligned16(out) &&
                   (!FUSED || aligned16(xx));

  float w[kTileItems];
  int f[kTileItems];
  load_chunk<FUSED>(v, xx, flags, base, n, vec, w, f);
  // thread-serial scan; seen[j]: a head at or before j in this chunk
  float loc[kTileItems];
  int seen[kTileItems];
  loc[0] = w[0];
  seen[0] = f[0];
#pragma unroll
  for (int j = 1; j < kTileItems; ++j) {
    loc[j] = f[j] ? w[j] : __fadd_rn(loc[j - 1], w[j]);
    seen[j] = seen[j - 1] | f[j];
  }
  float tv = loc[kTileItems - 1];
  int tf = seen[kTileItems - 1];
  warp_scan(tv, tf, lane);
  // exclusive within the warp: the inclusive value of the lane before
  const float xv = __shfl_up_sync(kFullMask, tv, 1);
  const int xf = __shfl_up_sync(kFullMask, tf, 1);
  if (lane == kWarp - 1) {
    wv[warp] = tv;
    wf[warp] = tf;
  }
  __syncthreads();
  scan_warp_summaries(wv, wf, kTileWarps, warp, lane);
  __syncthreads();
  const float c = carry[blockIdx.x];
  const float win =
      warp == 0 ? c : (wf[warp - 1] ? wv[warp - 1] : __fadd_rn(c, wv[warp - 1]));
  const float tin = lane == 0 ? win : (xf ? xv : __fadd_rn(win, xv));
  float o[kTileItems];
#pragma unroll
  for (int j = 0; j < kTileItems; ++j)
    o[j] = seen[j] ? loc[j] : __fadd_rn(tin, loc[j]);

  if (vec && base + kTileItems <= n) {
    float4* o4 = reinterpret_cast<float4*>(out + base);
    o4[0] = make_float4(o[0], o[1], o[2], o[3]);
    o4[1] = make_float4(o[4], o[5], o[6], o[7]);
  } else {
#pragma unroll
    for (int j = 0; j < kTileItems; ++j)
      if (base + j < n) out[base + j] = o[j];
  }
}

template <bool FUSED>
int launch(const float* v, const float* xx, const int* flags, float* out,
           long long n, float* workspace, cudaStream_t stream) {
  const long long nt = (n + kTile - 1) / kTile;
  const int ntiles = static_cast<int>(nt);
  float* tile_v = workspace;
  float* carry = workspace + ntiles;
  int* tile_f = reinterpret_cast<int*>(workspace + 2 * static_cast<long long>(ntiles));
  reduce_tiles<FUSED><<<ntiles, kTileThreads, 0, stream>>>(v, xx, flags, n,
                                                          tile_v, tile_f);
  scan_carries<<<1, kCarryThreads, 0, stream>>>(tile_v, tile_f, ntiles, carry);
  scan_tiles<FUSED><<<ntiles, kTileThreads, 0, stream>>>(v, xx, flags, n,
                                                        carry, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// items per thread, threads per tile block, warp width, carry-pass threads:
// the geometry the plain version must be given to repeat the kernel's
// order of additions (ops/segmented_pallas.py checks it at load)
void segmented_scan_geometry(int* out4) {
  out4[0] = kTileItems;
  out4[1] = kTileThreads;
  out4[2] = kWarp;
  out4[3] = kCarryThreads;
}

// out = segscan(v) (xx == NULL, B6) or segscan(v * xx) (B7) over n f32
// elements with int32 head flags (nonzero = head); out may equal v.
// workspace holds workspace_words >= 3 * ceil(n / tile) 32-bit words.
int segmented_scan_f32(const void* v, const void* xx, const void* flags,
                       void* out, long long n, void* workspace,
                       long long workspace_words, void* stream) {
  if (n < 1 || v == nullptr || flags == nullptr || out == nullptr ||
      workspace == nullptr)
    return cudaErrorInvalidValue;
  const long long ntiles = (n + kTile - 1) / kTile;
  if (ntiles > 0x7fffffffLL || workspace_words < 3 * ntiles)
    return cudaErrorInvalidValue;
  const float* vf = static_cast<const float*>(v);
  const int* fl = static_cast<const int*>(flags);
  float* o = static_cast<float*>(out);
  float* s = static_cast<float*>(workspace);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (xx == nullptr) return launch<false>(vf, nullptr, fl, o, n, s, st);
  return launch<true>(vf, static_cast<const float*>(xx), fl, o, n, s, st);
}

const char* segmented_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
