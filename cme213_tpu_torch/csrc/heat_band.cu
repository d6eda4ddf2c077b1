// heat_band.cu -- band-staged 2-D heat steps (orders 2/4/8) for Hopper
// (sm_90a): register-blocked micro-tiles over windows of the caller's tile
// height, staged with cp.async.
//
// Replaces the Pallas TPU kernels of cme213_tpu/ops/stencil_pallas.py:
//   _stencil_full        (pallas_call :115, body _make_kernel, staging
//                         _stage_band): one step per call, k = 1 (B4)
//   run_heat_multistep   (pallas_call :241, body _make_multistep_kernel):
//                         k fused steps per call, k > 1 (B5)
// Every output cell is
//   accx = sum_kk c_kk * u[y][x+kk-b],  accy = sum_kk c_kk * u[y+kk-b][x]
//   u'   = (u + xcfl*accx) + ycfl*accy
// rounded as heat_tile.cuh describes, so the kernel equals the plain
// PyTorch versions (ops/stencil.py run_heat, run_heat_roll) bit for bit.
//
// What it writes.  Only the interior [b, b+ny) x [b, b+nx) of the grid,
// through an output pointer at interior cell (0, 0) with its own row
// stride: the wrapper (ops/stencil_pallas.py) points it into a full grid
// whose halo it set once (k = 1: the input's halo, which passes through
// unchanged and need not hold the boundary values -- B4 imposes none;
// k > 1: the Dirichlet values), or at a bare (ny, nx) array
// (stencil_interior_pallas).  For k > 1 the Dirichlet bands are re-imposed
// on global coordinates after every sub-step but the last, in the JAX
// kernel's order (bottom, top, then left, right over the corners); the last
// sub-step writes interior cells only, which no band covers.
//
// What bounds it.  At k = 1 one order-8 f32 step of a 4000^2 grid moves
// 128 MB (one read, one write), more than the 50 MB L2: ~38 us at the H100
// SXM's 3.35 TB/s; the 38 separately rounded operations a point take ~18
// us at the FP32 issue rate.  From k = 2 the bytes per step halve and the
// operations, plus the halo that neighbouring strips recompute, bound it.
//
// The design (the tile body is heat_stencil.cu's, from heat_tile.cuh).
//  * The tile.  The JAX kernel stages full-width row bands of tile_y rows
//    in VMEM; a Hopper block has 227 KB, so the grid is cut into strips of
//    TX columns too.  A block owns one strip and walks a run of consecutive
//    tiles of TY interior rows down it; TY is the caller's tile_y, so
//    pallas_tile_sweep still sweeps the staging granularity.  Each tile's
//    window, the tile plus K = k*b rows above and below and KA = ceil4(K)
//    columns left and right, is staged into shared memory.
//  * Aligned strips.  Strips start at grid column 0 (not interior column
//    0), so a window starts at a multiple of 4 columns: 16-byte cp.async.cg
//    chunks where the grid's rows are 16-byte aligned, per-cell copies
//    otherwise, and aligned quads in shared memory.  The first and last
//    strips write only their interior cells; 16-byte stores go out where
//    the output rows are aligned (a bare array at orders 2 and 4 is not),
//    per-cell stores otherwise.  The window has no margin columns: the
//    side loads of a region's outermost quads wrap into the neighbouring
//    row, and what they read feeds only cells outside the validity cone.
//  * Compile-time geometry.  The kernel is a template on the scalar type,
//    the order and the k class (1, 2, or 3 = "k >= 3", k a run-time loop
//    count); the class fixes the strip width TX, the threads NT and the
//    micro-tile height R (Menu below, mirrored by ops/stencil_pallas.
//    DESIGNS).  A tile of TY rows is computed as ceil(TY / R) row chunks;
//    the rows of the last, ragged chunk past the tile are dropped.
//  * Register blocking.  A thread computes micro-tiles of 4 columns x R
//    rows (heat_tile.cuh micro_tile): 3R + 2b 16-byte shared loads for 4R
//    points, 1 a point at order 8, R = 8.
//  * Buffers.  nbuf = 2 staging windows prefetch the next tile's window
//    while the current one is computed; nbuf = 1 stages each tile after the
//    previous one.  For k > 1 one scratch window takes the sub-steps'
//    ping-pong (at k = 8, tile_y 200 three 264-row windows fit at no TX).
//    The wrapper's launch plan (ops/stencil_pallas.band_geometry) takes
//    nbuf = 2 at k = 1 where it fits, and otherwise one window and one tile
//    a block, so that the blocks an SM overlap each other's staging.
//  * Bands only where they fall.  At k = 1 no band code is compiled.  For
//    k > 1 a tile's computation is compiled twice: a tile whose buffers lie
//    wholly inside the interior runs the copy without band code, and in the
//    other copy a micro-tile tests once whether it holds a band cell.  The
//    test is made a tile, not a block: a block whose run spans the grid's
//    height computes only its first and last tiles with the band code
//    (taking the whole run as banded cost 1.5x at k = 4 on the H100).
//
// Window cells outside the grid hold 0, slack rows and wrapped side loads
// whatever an earlier tile left there; all of them feed only cells outside
// the validity cone (after sub-step s only cells at least s*b from the
// window's edge are valid) or cells that the bands overwrite.  tests/
// test_torch_stencil_pallas.py models this decomposition in numpy, stale
// buffers included, and holds it bit for bit to the plain version.
//
// The kernel reads src and writes a separate dst: neighbouring blocks read
// each other's halo, so a launch never updates in place.
//
// Host interface: plain C, loaded with ctypes by ops/_kernels.py.  The
// launch entry enqueues one launch on the given stream and returns
// cudaGetLastError() (0 on success).

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "heat_tile.cuh"

// The menu: TX, NT, R, and the blocks an SM the register budget is sized
// for (__launch_bounds__), per scalar type and k class, timed against
// variants on the H100 with bench/band_menu.py (PERF.md).  k = 1: a
// 96-column strip of 256 threads and R = 8; the plan prefetches where two
// windows fit (at tile_y 200 one such block an SM beat two blocks an SM
// of one window each).  k = 2: a 48-column strip, R = 4.  k >= 3: 32
// columns, the widest whose window and scratch (264 rows) fit at k = 8,
// tile_y 200; 256 threads beat 128 by 1.2-1.4x.  For k >= 2 the plan
// stages one window and gives each block one tile: blocks walking runs
// of tiles took up to 1.7x as long (k = 8), prefetching or not.  An entry
// defined before this file is read (bench/band_menu.py builds variants
// so) replaces the shipped one.
#ifndef HEAT_BAND_F32_K1
#define HEAT_BAND_F32_K1 96, 256, 8, 2
#endif
#ifndef HEAT_BAND_F32_K2
#define HEAT_BAND_F32_K2 48, 256, 4, 2
#endif
#ifndef HEAT_BAND_F32_K3
#define HEAT_BAND_F32_K3 32, 256, 4, 2
#endif
#ifndef HEAT_BAND_F64_K1
#define HEAT_BAND_F64_K1 64, 128, 4, 2
#endif
#ifndef HEAT_BAND_F64_K2
#define HEAT_BAND_F64_K2 32, 128, 4, 2
#endif
#ifndef HEAT_BAND_F64_K3
#define HEAT_BAND_F64_K3 32, 128, 4, 1
#endif

namespace {

constexpr int kSmemOptIn = 232448;  // a block's dynamic shared memory ceiling
constexpr int kMaxDevices = 64;

template <int TX_, int NT_, int R_, int MINB_>
struct Menu {
  static constexpr int TX = TX_, NT = NT_, R = R_, MINB = MINB_;
  static_assert(TX % 4 == 0 && NT % 32 == 0 && R >= 1, "a menu entry");
};

template <typename T, int KC>
struct Design;
template <>
struct Design<float, 1> : Menu<HEAT_BAND_F32_K1> {};
template <>
struct Design<float, 2> : Menu<HEAT_BAND_F32_K2> {};
template <>
struct Design<float, 3> : Menu<HEAT_BAND_F32_K3> {};
template <>
struct Design<double, 1> : Menu<HEAT_BAND_F64_K1> {};
template <>
struct Design<double, 2> : Menu<HEAT_BAND_F64_K2> {};
template <>
struct Design<double, 3> : Menu<HEAT_BAND_F64_K3> {};

template <typename T>
struct Band {
  const T* src;  // the (H, W) halo grid
  T* dst;        // interior cell (0, 0) of the output, row stride ldd
  int H, W, ldd;
  int ny, nx;    // interior extents
  int k, TY;     // sub-steps, tile rows
  int run;       // tiles a block walks
  int tiles;     // tiles a strip: ceil(ny / TY)
  int nbuf;      // staging windows (2: prefetch the next tile's)
  T xcfl, ycfl;
  T top, left, bottom, right;
};

// Grid: (strips, runs).  Block (x, y) owns grid columns [x*TX, x*TX + TX)
// and walks the tiles [y*run, y*run + run) of TY interior rows.  Shared
// memory: nbuf staging windows and, for k > 1, one scratch window, each
// (TYp + 2K + SLACK) rows x (TX + 2KA) columns.
template <typename T, int ORDER, int KC>
__global__ void __launch_bounds__(Design<T, KC>::NT, Design<T, KC>::MINB)
heat_band(const __grid_constant__ Band<T> p) {
  using D = Design<T, KC>;
  constexpr int B = ORDER / 2;
  constexpr int TX = D::TX;
  constexpr int NT = D::NT;
  constexpr int R = D::R;
  // rows past the staged window that the last row chunk of a sub-step may
  // read when its region is not a whole number of chunks
  constexpr int SLACK = (2 * B) % R == 0 ? 0 : R;
  constexpr int CH = 16 / static_cast<int>(sizeof(T));  // a 16-byte chunk
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int k = KC < 3 ? KC : p.k;
  const int K = k * B;
  const int KA = (K + 3) & ~3;  // column halo, a whole number of quads
  const int TYp = (p.TY + R - 1) / R * R;
  const int WY = TYp + 2 * K;   // staged rows
  const int WB = TX + 2 * KA;   // staged (and buffer) columns
  const int cells = (WY + SLACK) * WB;

  const int tc = blockIdx.x * TX;  // grid column of the strip's column 0
  const int t0 = blockIdx.y * p.run;
  const int t1 = min(t0 + p.run, p.tiles);
  if (t0 >= t1) return;  // uniform over the block

  T* const base = reinterpret_cast<T*>(smem_raw);
  T* const scratch = base + p.nbuf * cells;  // present only when k > 1
  const T* __restrict__ src = p.src;
  T* __restrict__ dst = p.dst;
  // 16-byte staging needs 16-byte aligned grid rows; 16-byte stores need
  // the quad at grid column g (a multiple of 4), output address dst +
  // r*ldd + g - B, aligned
  const bool vec_in =
      (reinterpret_cast<uintptr_t>(src) & 15) == 0 &&
      (p.W * static_cast<int>(sizeof(T))) % 16 == 0;
  const bool vec_out =
      ((reinterpret_cast<uintptr_t>(dst) - B * sizeof(T)) & 15) == 0 &&
      (p.ldd * static_cast<int>(sizeof(T))) % 16 == 0;
  // buffer (row 0, column 0) of tile t sits at grid row B + t*TY - K,
  // column tc - KA; a tile whose buffers lie inside the interior holds no
  // band cell (uniform over the block)
  const int gcol0 = tc - KA;
  auto inside = [&](int t) {
    return t * p.TY - K >= 0 && t * p.TY - K + WY + SLACK <= p.ny &&
           gcol0 >= B && gcol0 + WB <= B + p.nx;
  };

  auto stage = [&](int t, T* buf) {
    const int row0 = B + t * p.TY - K;
    if (vec_in) {
      // W is a multiple of CH, so a chunk lies wholly in or out of the grid
      const int per_row = WB / CH;
      for (int i = threadIdx.x; i < WY * per_row; i += NT) {
        const int wy = i / per_row;
        const int cx = i - wy * per_row;
        const int r = row0 + wy;
        const int c = gcol0 + cx * CH;
        const bool in = r >= 0 && r < p.H && c >= 0 && c < p.W;
        cp_async16(buf + wy * WB + cx * CH,
                   in ? src + static_cast<size_t>(r) * p.W + c : src,
                   in ? 16 : 0);
      }
    } else {
      for (int i = threadIdx.x; i < WY * WB; i += NT) {
        const int wy = i / WB;
        const int wx = i - wy * WB;
        const int r = row0 + wy;
        const int c = gcol0 + wx;
        T* d = buf + wy * WB + wx;
        if (r >= 0 && r < p.H && c >= 0 && c < p.W) {
          cp_async_elem(d, src + static_cast<size_t>(r) * p.W + c);
        } else {
          *d = T(0);
        }
      }
    }
    cp_async_commit();
  };

  // one staged tile: sub-steps 1 .. k-1 window to window, then sub-step k
  // to device memory; compiled twice for k > 1, with and without the band
  // code
  auto compute = [&](auto edge_tag, int t, T* in) {
    constexpr bool EDGE = decltype(edge_tag)::value;
    // whether the R x 4 cells at global (grow, gcol) hold a band cell
    auto banded = [&](int grow, int gcol) {
      return EDGE && !(grow >= B && grow + R <= B + p.ny && gcol >= B &&
                       gcol + 4 <= B + p.nx);
    };
    const int grow0 = B + t * p.TY - K;  // grid row of buffer row 0

    // sub-steps 1 .. k-1: the quads covering the cells within (k-s)*B of
    // the tile, each followed by the bands
    T* next = scratch;
    for (int s = 1; s < k; ++s) {
      const int E = ((k - s) * B + 3) & ~3;
      const int nq = (TX + 2 * E) / 4;
      const int nc = (TYp + 2 * (k - s) * B + R - 1) / R;
      for (int m = threadIdx.x; m < nq * nc; m += NT) {
        const int qy = m / nq;
        const int row = s * B + qy * R;
        const int col = KA - E + 4 * (m - qy * nq);
        const bool band = banded(grow0 + row, gcol0 + col);
        micro_tile<T, ORDER, R>(
            in, WB, row, col, p.xcfl, p.ycfl, [&](int i, const T(&v)[4]) {
              T w[4] = {v[0], v[1], v[2], v[3]};
              if (band) {
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                  w[j] = dirichlet(v[j], grow0 + row + i, gcol0 + col + j,
                                   B, p);
                }
              }
              st4(next + (row + i) * WB + col, w);
            });
      }
      __syncthreads();
      T* swap = in;
      in = next;
      next = swap;
    }

    // sub-step k: the tile's interior cells, straight to device memory
    for (int m = threadIdx.x; m < (TX / 4) * (TYp / R); m += NT) {
      const int qy = m / (TX / 4);
      const int qx = m - qy * (TX / 4);
      const int g = tc + 4 * qx;  // grid column of the quad
      if (g + 4 <= B || g >= B + p.nx) continue;  // no interior cell
      const int c = g - B;        // its interior column
      micro_tile<T, ORDER, R>(
          in, WB, K + qy * R, KA + 4 * qx, p.xcfl, p.ycfl,
          [&](int i, const T(&v)[4]) {
            const int ti = qy * R + i;  // row within the tile
            const int r = t * p.TY + ti;
            if (ti >= p.TY || r >= p.ny) return;
            const size_t at = static_cast<size_t>(r) * p.ldd;
            if (vec_out && c >= 0 && c + 4 <= p.nx) {
              st4(dst + at + c, v);
            } else {
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                if (c + j >= 0 && c + j < p.nx) dst[at + c + j] = v[j];
              }
            }
          });
    }
  };

  const int second = p.nbuf == 2 ? cells : 0;
  stage(t0, base);
  for (int t = t0; t < t1; ++t) {
    T* in = base + ((t - t0) & 1) * second;
    if (p.nbuf == 2) {
      if (t + 1 < t1) {
        stage(t + 1, base + ((t + 1 - t0) & 1) * second);  // prefetch
      } else {
        cp_async_commit();  // an empty group: one pending group either way
      }
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (KC == 1) {
      compute(std::false_type{}, t, in);  // no band at k = 1
    } else if (inside(t)) {
      compute(std::false_type{}, t, in);
    } else {
      compute(std::true_type{}, t, in);
    }
    // every read of this tile's buffers is done before the next iteration
    // (or, with one buffer, the next stage) writes them
    __syncthreads();
    if (p.nbuf == 1 && t + 1 < t1) stage(t + 1, base);
  }
}

// shared memory of one block (ops/stencil_pallas.band_smem_bytes)
template <typename T, int KC>
long long smem_need(int order, int k, int tile_y, int nbuf) {
  using D = Design<T, KC>;
  const int B = order / 2;
  const int K = k * B;
  const int KA = (K + 3) & ~3;
  const long long typ = (tile_y + D::R - 1) / D::R * D::R;
  const int slack = (2 * B) % D::R == 0 ? 0 : D::R;
  const long long cells = (typ + 2 * K + slack) * (D::TX + 2 * KA);
  return (nbuf + (KC == 1 ? 0 : 1)) * cells *
         static_cast<long long>(sizeof(T));
}

// Lift the instance's dynamic shared memory ceiling to the block maximum
// and prefer the largest shared-memory carveout, once per device: a launch
// refused for shared memory never runs and shows only in cudaGetLastError()
template <typename T, int ORDER, int KC>
cudaError_t opt_in() {
  static bool done[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(heat_band<T, ORDER, KC>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kSmemOptIn);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(heat_band<T, ORDER, KC>,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices) done[dev] = true;
  return cudaSuccess;
}

template <typename T, int ORDER, int KC>
struct Launch {
  static cudaError_t run(const Band<T>& p, int smem, cudaStream_t stream) {
    using D = Design<T, KC>;
    const cudaError_t e = opt_in<T, ORDER, KC>();
    if (e != cudaSuccess) return e;
    const int strips = (p.nx + ORDER / 2 + D::TX - 1) / D::TX;
    const dim3 grid(strips, (p.tiles + p.run - 1) / p.run);
    heat_band<T, ORDER, KC><<<grid, D::NT, smem, stream>>>(p);
    return cudaGetLastError();
  }
};

// (blocks an SM, registers a thread, local memory bytes a thread) of one
// instance at `smem` bytes of shared memory a block
template <typename T, int ORDER, int KC>
struct Occupancy {
  static cudaError_t run(int smem, int* out) {
    cudaError_t e = opt_in<T, ORDER, KC>();
    if (e != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[0], heat_band<T, ORDER, KC>, Design<T, KC>::NT, smem);
    if (e != cudaSuccess) return e;
    cudaFuncAttributes attr;
    e = cudaFuncGetAttributes(&attr, heat_band<T, ORDER, KC>);
    if (e != cudaSuccess) return e;
    out[1] = attr.numRegs;
    out[2] = static_cast<int>(attr.localSizeBytes);
    return cudaSuccess;
  }
};

// dispatch on (order, k class): F<T, ORDER, KC>::run(args...)
template <typename T, template <typename, int, int> class F, typename... A>
cudaError_t by_order_and_class(int order, int k, A&&... args) {
  const int kc = k < 3 ? k : 3;
#define BAND_CASE(O, C) \
  if (order == O && kc == C) return F<T, O, C>::run(args...);
  BAND_CASE(2, 1) BAND_CASE(2, 2) BAND_CASE(2, 3)
  BAND_CASE(4, 1) BAND_CASE(4, 2) BAND_CASE(4, 3)
  BAND_CASE(8, 1) BAND_CASE(8, 2) BAND_CASE(8, 3)
#undef BAND_CASE
  return cudaErrorInvalidValue;
}

template <typename T>
long long need_for(int order, int k, int tile_y, int nbuf) {
  return k == 1   ? smem_need<T, 1>(order, k, tile_y, nbuf)
         : k == 2 ? smem_need<T, 2>(order, k, tile_y, nbuf)
                  : smem_need<T, 3>(order, k, tile_y, nbuf);
}

template <typename T, int KC>
void design(int* out) {
  out[0] = Design<T, KC>::TX;
  out[1] = Design<T, KC>::NT;
  out[2] = Design<T, KC>::R;
  out[3] = Design<T, KC>::MINB;
}

template <typename T>
int dispatch(const void* src, void* dst, int H, int W, int ldd, int order,
             int k, int tile_y, int run, int nbuf, int smem_bytes, T xcfl,
             T ycfl, T bc_top, T bc_left, T bc_bottom, T bc_right,
             void* stream) {
  if (order != 2 && order != 4 && order != 8) return cudaErrorInvalidValue;
  const int ny = H - order;
  const int nx = W - order;
  if (src == nullptr || dst == nullptr || ny < 1 || nx < 1 || ldd < nx ||
      k < 1 || tile_y < 1 || run < 1 || (nbuf != 1 && nbuf != 2))
    return cudaErrorInvalidValue;
  const int tiles = (ny + tile_y - 1) / tile_y;
  if ((tiles + run - 1) / run > 65535 ||
      smem_bytes != need_for<T>(order, k, tile_y, nbuf) ||
      smem_bytes > kSmemOptIn)
    return cudaErrorInvalidValue;
  const Band<T> p{static_cast<const T*>(src), static_cast<T*>(dst), H, W,
                  ldd, ny, nx, k, tile_y, run, tiles, nbuf, xcfl, ycfl,
                  bc_top, bc_left, bc_bottom, bc_right};
  return by_order_and_class<T, Launch>(order, k, p, smem_bytes,
                                       static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

// src: the (H, W) = (ny + order, nx + order) row-major halo grid; dst:
// interior cell (0, 0) of the output, row stride ldd; tile_y the tile
// height, `run` the tiles a block walks, `nbuf` its staging windows (2:
// prefetch the next), smem_bytes the block's dynamic shared memory, which
// the caller sizes (ops/stencil_pallas.band_smem_bytes) and this entry
// checks
int heat_band_f32(const void* src, void* dst, int H, int W, int ldd,
                  int order, int k, int tile_y, int run, int nbuf,
                  int smem_bytes, float xcfl, float ycfl, float bc_top,
                  float bc_left, float bc_bottom, float bc_right,
                  void* stream) {
  return dispatch<float>(src, dst, H, W, ldd, order, k, tile_y, run, nbuf,
                         smem_bytes, xcfl, ycfl, bc_top, bc_left, bc_bottom,
                         bc_right, stream);
}

int heat_band_f64(const void* src, void* dst, int H, int W, int ldd,
                  int order, int k, int tile_y, int run, int nbuf,
                  int smem_bytes, double xcfl, double ycfl, double bc_top,
                  double bc_left, double bc_bottom, double bc_right,
                  void* stream) {
  return dispatch<double>(src, dst, H, W, ldd, order, k, tile_y, run, nbuf,
                          smem_bytes, xcfl, ycfl, bc_top, bc_left, bc_bottom,
                          bc_right, stream);
}

// out = (blocks an SM, registers a thread, local memory bytes a thread) of
// the instance for (dtype_bytes, order, k) at smem_bytes a block, on the
// current device
int heat_band_occupancy(int dtype_bytes, int order, int k, int smem_bytes,
                        int* out) {
  if (k < 1 || smem_bytes < 0) return cudaErrorInvalidValue;
  if (dtype_bytes == 4)
    return by_order_and_class<float, Occupancy>(order, k, smem_bytes, out);
  if (dtype_bytes == 8)
    return by_order_and_class<double, Occupancy>(order, k, smem_bytes, out);
  return cudaErrorInvalidValue;
}

// out = (TX, threads, R, blocks an SM of the register budget) of the k
// class's design for dtype_bytes
int heat_band_design(int dtype_bytes, int k, int* out) {
  if (k < 1 || (dtype_bytes != 4 && dtype_bytes != 8))
    return cudaErrorInvalidValue;
  const int kc = k < 3 ? k : 3;
  if (dtype_bytes == 4) {
    kc == 1 ? design<float, 1>(out)
            : (kc == 2 ? design<float, 2>(out) : design<float, 3>(out));
  } else {
    kc == 1 ? design<double, 1>(out)
            : (kc == 2 ? design<double, 2>(out) : design<double, 3>(out));
  }
  return cudaSuccess;
}

const char* heat_band_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
