// heat_stencil.cu -- k fused 2-D heat steps (orders 2/4/8) for Hopper
// (sm_90a): register-blocked micro-tiles, a cp.async-prefetched strip walk,
// and one launch for every shard a device holds.
//
// Replaces the Pallas TPU kernels of cme213_tpu/ops/stencil_pipeline.py:
//   _make_local_kernel  (pallas_call in run_heat_pipeline, B1, and in
//                        stencil_local_multistep with global offsets, B3)
//   _make_tiled_kernel  (pallas_call in run_heat_pipeline2d, B2)
// All compute _apply_substeps: k sub-steps of
//   accx = sum_kk c_kk * u[y][x+kk-b],  accy = sum_kk c_kk * u[y+kk-b][x]
//   u'   = (u + xcfl*accx) + ycfl*accy
// each followed by the Dirichlet bands on global coordinates (rows first,
// then columns over the corners).  A launch takes a table of up to
// kMaxShards (src, dst, gy0, gx0) descriptors of one (H, W) shape, passed by
// value in the parameter block; blockIdx.z picks one.  The single-grid
// entry points (B1, B2) are a table of one with offsets (0, 0); the
// distributed solve (B3) passes every K-padded shard block of a device, so
// the JAX package's one pallas_call per device under shard_map stays one
// launch per device here.  (gy0, gx0) place each block on the global grid
// and (ny, nx) is the global interior, so a shard's bands fall where the
// whole grid's would.
//
// What bounds it.  One order-8 f32 step of a 4000^2 grid moves 128 MB (one
// read and one write of every point), more than the 50 MB L2, so at k = 1
// the kernel is bound by device memory (~38 us a step at 3.35 TB/s).  The
// arithmetic has no FMA (see Rounding): 40 separately rounded operations a
// point, ~19 us a step at the FP32 issue rate.  From k = 2 on the bytes per
// step halve and the operations, plus the halo that neighbouring tiles
// recompute, bound it.  Shared-memory loads are the third limit: a scalar
// body reads 2(2b+1) taps a point from shared memory, which at order 8
// costs as much as the device memory itself.
//
// The design.
//  * Compile-time geometry.  The kernel is a template on the scalar type,
//    the order and the k class (1, 2, or 3 = "k >= 3", where k is a run-time
//    loop count); the class fixes the strip width TX, the threads NT and
//    the micro-tile height R (Design below, mirrored by ops/
//    stencil_pipeline.DESIGNS).  The tile height TY and the tiles a block
//    walks stay launch arguments.
//  * Register blocking.  A thread computes a micro-tile of 4 adjacent
//    columns x R rows.  The y taps come from a ring of R + 2b column quads
//    held in registers, each loaded once with one 16-byte shared load; the
//    x taps of an output row come from the row's centre quad and the quads
//    to its left and right (3 aligned 16-byte loads cover columns c-4 ..
//    c+7).  That is 3R + 2b shared loads for 4R points: 1 a point at order
//    8 (R = 8), against 18 scalar loads a point for a scalar body.
//  * Aligned windows.  A tile's window is staged with KA = ceil4(K) columns
//    of halo on each side (K = k*b rows above and below), so every quad and
//    every 16-byte staging chunk is aligned; four unstaged margin columns on
//    each side take the side loads of the outermost quads.
//  * Overlapped staging.  A block owns a strip of TX columns and walks a run
//    of consecutive TY-row tiles down it.  While it computes tile i, the
//    window of tile i+1 is on its way into a second buffer with cp.async:
//    16-byte cp.async.cg where the grid's rows are 16-byte aligned (zero-fill
//    for chunks outside the grid), 4/8-byte copies and plain stores of 0
//    otherwise.  Strips are split into runs so that about one wave of
//    resident blocks covers every shard of the launch.
//  * Sub-steps.  Sub-steps 1 .. k-1 ping-pong between the staged window and
//    a scratch window; sub-step s computes the quads that cover the cells
//    within (k-s)*b of the tile (the valid region after s steps), and the
//    last sub-step writes the tile straight to device memory, 16 bytes a
//    row of a quad where the output rows are aligned.
//  * Bands only where they fall.  The tile walk is compiled twice: a block
//    whose buffers lie wholly inside the global interior (the test is made
//    once a block, uniform over it) runs the copy without band code, and
//    in the other copy each micro-tile tests once whether it holds a band
//    cell and calls dirichlet() only if it does.  With the bands inlined
//    into every cell, the edge blocks ran much slower than the interior
//    ones, and a one-wave launch waits for its slowest block.
//
// Window cells outside the grid hold 0, margin and slack cells hold
// whatever an earlier tile left there; both feed only cells outside the
// validity cone (after sub-step s only cells at least s*b from the staged
// window's edge are valid) or cells that the bands overwrite.  tests/
// test_torch_pipeline.py models this decomposition in numpy, stale buffers
// included, and holds it bit for bit to the plain version.
//
// Rounding.  Every product and sum is __fmul_rn/__fadd_rn (__dmul_rn/
// __dadd_rn), which the compiler never contracts, and the library is built
// with --fmad=false; each point's accx and accy accumulate in coefficient
// order and combine as (u + xcfl*accx) + ycfl*accy, so the kernel rounds
// exactly as the plain PyTorch version does and agrees with it bit for bit.
//
// The micro-tile, the staging helpers and the bands live in heat_tile.cuh,
// which heat_band.cu (B4, B5) builds on too.
//
// The kernel reads src and writes a separate dst: neighbouring blocks read
// each other's halo, so a launch never updates in place.
//
// Host interface: plain C, loaded with ctypes by ops/_kernels.py.  The
// launch entry enqueues one launch on the given stream and returns
// cudaGetLastError() (0 on success).  The loop entry enqueues a single-grid
// solve's every launch, ping-ponging between two buffers, so the host
// checks its arguments once a solve rather than once a launch.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "heat_tile.cuh"

namespace {

constexpr int kMaxShards = 32;      // ops/stencil_pipeline.MAX_SHARDS
constexpr int kSmemOptIn = 232448;  // a block's dynamic shared memory ceiling
constexpr int kMaxDevices = 64;

// The tile menu: (TX, NT, R) per scalar type and k class, and the blocks an
// SM the register budget is sized for (__launch_bounds__).  Chosen by
// measurement on the H100 (PERF.md): at k = 1 a 256-thread block over a
// 64 x 128 tile (two an SM) beat 128 threads over 32 x 128 (four an SM);
// at k = 2, R = 2 keeps 24 warps an SM in registers, and a 48-row tile
// gives both sub-steps whole rounds of micro-tiles; at k >= 3 a
// 64-column strip of 256 threads (two blocks an SM up to k = 4, at the
// default tile) beat a 32-column one, whose halo recompute grows with k.
template <typename T, int KC>
struct Design;
template <>
struct Design<float, 1> {
  static constexpr int TX = 128, NT = 256, R = 8, MINB = 2;
};
template <>
struct Design<float, 2> {
  static constexpr int TX = 64, NT = 256, R = 2, MINB = 3;
};
template <>
struct Design<float, 3> {
  static constexpr int TX = 64, NT = 256, R = 4, MINB = 2;
};
template <>
struct Design<double, 1> {
  static constexpr int TX = 64, NT = 128, R = 4, MINB = 2;
};
template <>
struct Design<double, 2> {
  static constexpr int TX = 32, NT = 128, R = 4, MINB = 2;
};
template <>
struct Design<double, 3> {
  static constexpr int TX = 32, NT = 128, R = 4, MINB = 1;
};

}  // namespace

extern "C" {
// one shard of a launch: its (H, W) block, its output, and the global
// halo-grid coordinates of element [0, 0]
struct HeatShard {
  const void* src;
  void* dst;
  int gy0, gx0;
};
}

namespace {

struct ShardTable {
  HeatShard s[kMaxShards];
};

template <typename T>
struct Step {
  int H, W;      // every shard's block
  int ny, nx;    // global interior extents
  int k, TY;     // sub-steps, tile rows
  int run;       // tiles a block walks
  int tiles;     // tiles a strip: ceil(H / TY)
  T xcfl, ycfl;
  T top, left, bottom, right;
};

// Grid: (strips, runs, shards).  Block (x, y, z) owns columns [x*TX, x*TX +
// TX) of shard z's block and walks its tiles [y*run, y*run + run) of TY
// rows.  Shared memory: two staging windows and, for k > 1, one scratch
// window, each (TYp + 2K + SLACK) rows x (TX + 2KA + 8) columns.
template <typename T, int ORDER, int KC>
__global__ void __launch_bounds__(Design<T, KC>::NT, Design<T, KC>::MINB)
heat_ksteps(const __grid_constant__ ShardTable table,
            const __grid_constant__ Step<T> p) {
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
  const int WS = TX + 2 * KA;   // staged columns
  const int WB = WS + 8;        // buffer columns: 4 margin columns a side
  const int cells = (WY + SLACK) * WB;

  const HeatShard& sh = table.s[blockIdx.z];
  const T* __restrict__ src = static_cast<const T*>(sh.src);
  T* __restrict__ dst = static_cast<T*>(sh.dst);
  const int tc = blockIdx.x * TX;  // the strip's first column
  const int t0 = blockIdx.y * p.run;
  const int t1 = min(t0 + p.run, p.tiles);
  if (t0 >= t1) return;  // uniform over the block

  T* const base = reinterpret_cast<T*>(smem_raw);
  T* const scratch = base + 2 * cells;  // present only when k > 1
  // 16-byte staging and stores need 16-byte aligned rows
  const bool vec = ((reinterpret_cast<uintptr_t>(src) |
                     reinterpret_cast<uintptr_t>(dst)) & 15) == 0 &&
                   (p.W * static_cast<int>(sizeof(T))) % 16 == 0;
  // buffer (row 0, column 0) of tile t sits at grid row t*TY - K, column
  // tc - KA - 4; the bands are skipped when every buffer cell of every tile
  // of the run lies inside the global interior
  const int gcol0 = tc - KA - 4 + sh.gx0;
  const bool edge = !(t0 * p.TY - K + sh.gy0 >= B &&
                      (t1 - 1) * p.TY - K + WY + SLACK + sh.gy0 <= B + p.ny &&
                      gcol0 >= B && gcol0 + WB <= B + p.nx);

  auto stage = [&](int t, T* buf) {
    const int row0 = t * p.TY - K;
    const int col0 = tc - KA;
    if (vec) {
      // W is a multiple of CH, so a chunk lies wholly in or out of the grid
      const int per_row = WS / CH;
      for (int i = threadIdx.x; i < WY * per_row; i += NT) {
        const int wy = i / per_row;
        const int cx = i - wy * per_row;
        const int r = row0 + wy;
        const int c = col0 + cx * CH;
        const bool in = r >= 0 && r < p.H && c >= 0 && c < p.W;
        cp_async16(buf + wy * WB + 4 + cx * CH,
                   in ? src + static_cast<size_t>(r) * p.W + c : src,
                   in ? 16 : 0);
      }
    } else {
      for (int i = threadIdx.x; i < WY * WS; i += NT) {
        const int wy = i / WS;
        const int wx = i - wy * WS;
        const int r = row0 + wy;
        const int c = col0 + wx;
        T* d = buf + wy * WB + 4 + wx;
        if (r >= 0 && r < p.H && c >= 0 && c < p.W) {
          cp_async_elem(d, src + static_cast<size_t>(r) * p.W + c);
        } else {
          *d = T(0);
        }
      }
    }
    cp_async_commit();
  };

  // the tile walk, compiled twice: blocks that hold no band cell never see
  // the band code, and in the others a micro-tile tests once whether it
  // holds one
  auto walk = [&](auto edge_tag) {
    constexpr bool EDGE = decltype(edge_tag)::value;
    // whether the R x 4 cells at global (grow, gcol) hold a band cell
    auto banded = [&](int grow, int gcol) {
      return EDGE && !(grow >= B && grow + R <= B + p.ny && gcol >= B &&
                       gcol + 4 <= B + p.nx);
    };
    stage(t0, base);
    for (int t = t0; t < t1; ++t) {
      T* in = base + ((t - t0) & 1) * cells;
      if (t + 1 < t1) {
        stage(t + 1, base + ((t + 1 - t0) & 1) * cells);  // prefetch
      } else {
        cp_async_commit();  // an empty group: one pending group either way
      }
      cp_async_wait<1>();
      __syncthreads();
      const int grow0 = t * p.TY - K + sh.gy0;  // global row of buffer row 0

      // sub-steps 1 .. k-1: the quads covering the cells within (k-s)*B of
      // the tile, window to window
      T* next = scratch;
      for (int s = 1; s < k; ++s) {
        const int E = ((k - s) * B + 3) & ~3;
        const int nq = (TX + 2 * E) / 4;
        const int nc = (TYp + 2 * (k - s) * B + R - 1) / R;
        for (int m = threadIdx.x; m < nq * nc; m += NT) {
          const int qy = m / nq;
          const int row = s * B + qy * R;
          const int col = 4 + KA - E + 4 * (m - qy * nq);
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

      // sub-step k: the tile's own cells, straight to device memory
      const int tile_r = t * p.TY;
      for (int m = threadIdx.x; m < (TX / 4) * (TYp / R); m += NT) {
        const int qy = m / (TX / 4);
        const int qx = m - qy * (TX / 4);
        const int row = K + qy * R;
        const int col = 4 + KA + 4 * qx;
        const int c = tc + 4 * qx;
        const bool band = banded(grow0 + row, gcol0 + col);
        micro_tile<T, ORDER, R>(
            in, WB, row, col, p.xcfl, p.ycfl, [&](int i, const T(&v)[4]) {
              const int ti = qy * R + i;  // row within the tile
              const int r = tile_r + ti;
              if (ti >= p.TY || r >= p.H) return;
              T w[4] = {v[0], v[1], v[2], v[3]};
              if (band) {
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                  w[j] = dirichlet(v[j], r + sh.gy0, c + j + sh.gx0, B, p);
                }
              }
              T* d = dst + static_cast<size_t>(r) * p.W + c;
              if (vec && c + 3 < p.W) {
                st4(d, w);
              } else {
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                  if (c + j < p.W) d[j] = w[j];
                }
              }
            });
      }
      // every read of this tile's buffers is done before the next
      // iteration stages into them
      __syncthreads();
    }
  };
  if (edge) {
    walk(std::true_type{});
  } else {
    walk(std::false_type{});
  }
}

// shared memory of one block (ops/stencil_pipeline.smem_bytes)
template <typename T, int KC>
long long smem_need(int order, int k, int tile_y) {
  using D = Design<T, KC>;
  const int B = order / 2;
  const int K = k * B;
  const int KA = (K + 3) & ~3;
  const long long typ = (tile_y + D::R - 1) / D::R * D::R;
  const int slack = (2 * B) % D::R == 0 ? 0 : D::R;
  const long long cells = (typ + 2 * K + slack) * (D::TX + 2 * KA + 8);
  return (KC == 1 ? 2 : 3) * cells * static_cast<long long>(sizeof(T));
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
  e = cudaFuncSetAttribute(heat_ksteps<T, ORDER, KC>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kSmemOptIn);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(heat_ksteps<T, ORDER, KC>,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices) done[dev] = true;
  return cudaSuccess;
}

template <typename T, int ORDER, int KC>
cudaError_t launch(const HeatShard* shards, int n, const Step<T>& p,
                   int smem, cudaStream_t stream) {
  using D = Design<T, KC>;
  const cudaError_t e = opt_in<T, ORDER, KC>();
  if (e != cudaSuccess) return e;
  ShardTable table{};
  for (int i = 0; i < n; ++i) table.s[i] = shards[i];
  const dim3 grid((p.W + D::TX - 1) / D::TX, (p.tiles + p.run - 1) / p.run,
                  n);
  heat_ksteps<T, ORDER, KC><<<grid, D::NT, smem, stream>>>(table, p);
  return cudaGetLastError();
}

// `launches` launches over one grid: launch i reads the previous launch's
// output (src for the first) and writes bufs[i % 2]; stops at the first
// launch whose cudaGetLastError() is not cudaSuccess.  *launched counts
// the launches enqueued.
template <typename T, int ORDER, int KC>
cudaError_t launch_loop(const void* src, void* const* bufs, int launches,
                        const Step<T>& p, int smem, cudaStream_t stream,
                        int* launched) {
  using D = Design<T, KC>;
  cudaError_t e = opt_in<T, ORDER, KC>();
  if (e != cudaSuccess) return e;
  ShardTable table{};
  table.s[0] = HeatShard{src, nullptr, 0, 0};
  const dim3 grid((p.W + D::TX - 1) / D::TX, (p.tiles + p.run - 1) / p.run,
                  1);
  for (int i = 0; i < launches; ++i) {
    table.s[0].dst = bufs[i % 2];
    heat_ksteps<T, ORDER, KC><<<grid, D::NT, smem, stream>>>(table, p);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    *launched = i + 1;
    table.s[0].src = table.s[0].dst;
  }
  return cudaSuccess;
}

// (blocks an SM, registers a thread, local memory bytes a thread) of one
// instance at `smem` bytes of shared memory a block
template <typename T, int ORDER, int KC>
cudaError_t occupancy(int smem, int* out) {
  cudaError_t e = opt_in<T, ORDER, KC>();
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[0], heat_ksteps<T, ORDER, KC>, Design<T, KC>::NT, smem);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, heat_ksteps<T, ORDER, KC>);
  if (e != cudaSuccess) return e;
  out[1] = attr.numRegs;
  out[2] = static_cast<int>(attr.localSizeBytes);
  return cudaSuccess;
}

template <typename T, int KC>
void design(int* out) {
  out[0] = Design<T, KC>::TX;
  out[1] = Design<T, KC>::NT;
  out[2] = Design<T, KC>::R;
}

// dispatch on (order, k class): F<ORDER, KC>::run(args...)
template <typename T, template <typename, int, int> class F, typename... A>
cudaError_t by_order_and_class(int order, int k, A... args) {
  const int kc = k < 3 ? k : 3;
#define HEAT_CASE(O, C) \
  if (order == O && kc == C) return F<T, O, C>::run(args...);
  HEAT_CASE(2, 1) HEAT_CASE(2, 2) HEAT_CASE(2, 3)
  HEAT_CASE(4, 1) HEAT_CASE(4, 2) HEAT_CASE(4, 3)
  HEAT_CASE(8, 1) HEAT_CASE(8, 2) HEAT_CASE(8, 3)
#undef HEAT_CASE
  return cudaErrorInvalidValue;
}

template <typename T, int ORDER, int KC>
struct Launch {
  static cudaError_t run(const HeatShard* shards, int n, Step<T> p, int smem,
                         cudaStream_t stream) {
    return launch<T, ORDER, KC>(shards, n, p, smem, stream);
  }
};

template <typename T, int ORDER, int KC>
struct LaunchLoop {
  static cudaError_t run(const void* src, void* const* bufs, int launches,
                         Step<T> p, int smem, cudaStream_t stream,
                         int* launched) {
    return launch_loop<T, ORDER, KC>(src, bufs, launches, p, smem, stream,
                                     launched);
  }
};

template <typename T, int ORDER, int KC>
struct Occupancy {
  static cudaError_t run(int smem, int* out) {
    return occupancy<T, ORDER, KC>(smem, out);
  }
};

template <typename T>
long long need_for(int order, int k, int tile_y) {
  return k == 1   ? smem_need<T, 1>(order, k, tile_y)
         : k == 2 ? smem_need<T, 2>(order, k, tile_y)
                  : smem_need<T, 3>(order, k, tile_y);
}

template <typename T>
int tx_for(int k) {
  return k == 1 ? Design<T, 1>::TX
       : k == 2 ? Design<T, 2>::TX
                : Design<T, 3>::TX;
}

// the checks of a launch's geometry; on success *p holds its step
template <typename T>
cudaError_t make_step(int H, int W, int ny, int nx, int order, int k,
                      int tile_y, int tile_x, int run, int smem_bytes,
                      T xcfl, T ycfl, T bc_top, T bc_left, T bc_bottom,
                      T bc_right, Step<T>* p) {
  if (order != 2 && order != 4 && order != 8) return cudaErrorInvalidValue;
  if (H < 1 || W < 1 || k < 1 || tile_y < 1 || run < 1 ||
      tile_x != tx_for<T>(k))
    return cudaErrorInvalidValue;
  const int tiles = (H + tile_y - 1) / tile_y;
  if ((tiles + run - 1) / run > 65535 ||
      smem_bytes != need_for<T>(order, k, tile_y) || smem_bytes > kSmemOptIn)
    return cudaErrorInvalidValue;
  *p = Step<T>{H,     W,    ny,   nx,     k,       tile_y,    run,
               tiles, xcfl, ycfl, bc_top, bc_left, bc_bottom, bc_right};
  return cudaSuccess;
}

template <typename T>
int dispatch(const HeatShard* shards, int n, int H, int W, int ny, int nx,
             int order, int k, int tile_y, int tile_x, int run,
             int smem_bytes, T xcfl, T ycfl, T bc_top, T bc_left,
             T bc_bottom, T bc_right, void* stream) {
  if (shards == nullptr || n < 1 || n > kMaxShards)
    return cudaErrorInvalidValue;
  Step<T> p;
  const cudaError_t e =
      make_step<T>(H, W, ny, nx, order, k, tile_y, tile_x, run, smem_bytes,
                   xcfl, ycfl, bc_top, bc_left, bc_bottom, bc_right, &p);
  if (e != cudaSuccess) return e;
  return by_order_and_class<T, Launch>(order, k, shards, n, p, smem_bytes,
                                       static_cast<cudaStream_t>(stream));
}

template <typename T>
int dispatch_loop(const void* src, void* buf0, void* buf1, int launches,
                  int H, int W, int ny, int nx, int order, int k, int tile_y,
                  int tile_x, int run, int smem_bytes, T xcfl, T ycfl,
                  T bc_top, T bc_left, T bc_bottom, T bc_right, void* stream,
                  int* launched) {
  if (launched == nullptr) return cudaErrorInvalidValue;
  *launched = 0;
  if (src == nullptr || buf0 == nullptr || buf1 == nullptr || launches < 1 ||
      buf0 == buf1 || buf0 == src || buf1 == src)
    return cudaErrorInvalidValue;
  Step<T> p;
  const cudaError_t e =
      make_step<T>(H, W, ny, nx, order, k, tile_y, tile_x, run, smem_bytes,
                   xcfl, ycfl, bc_top, bc_left, bc_bottom, bc_right, &p);
  if (e != cudaSuccess) return e;
  void* const bufs[2] = {buf0, buf1};
  return by_order_and_class<T, LaunchLoop>(
      order, k, src, static_cast<void* const*>(bufs), launches, p,
      smem_bytes, static_cast<cudaStream_t>(stream), launched);
}

}  // namespace

extern "C" {

// One launch over `n` shards (1 <= n <= 32) of one (H, W) row-major shape:
// shards[i].src -> shards[i].dst, (gy0, gx0) the global halo-grid
// coordinates of the block's element [0, 0]; (ny, nx) the global interior
// extents; (tile_y, tile_x) the tile, tile_x the k class's TX; `run` the
// tiles a block walks; smem_bytes the block's dynamic shared memory, which
// the caller sizes (ops/stencil_pipeline.smem_bytes) and this entry checks.
int heat_ksteps_f32(const HeatShard* shards, int n, int H, int W, int ny,
                    int nx, int order, int k, int tile_y, int tile_x,
                    int run, int smem_bytes, float xcfl, float ycfl,
                    float bc_top, float bc_left, float bc_bottom,
                    float bc_right, void* stream) {
  return dispatch<float>(shards, n, H, W, ny, nx, order, k, tile_y, tile_x,
                         run, smem_bytes, xcfl, ycfl, bc_top, bc_left,
                         bc_bottom, bc_right, stream);
}

int heat_ksteps_f64(const HeatShard* shards, int n, int H, int W, int ny,
                    int nx, int order, int k, int tile_y, int tile_x,
                    int run, int smem_bytes, double xcfl, double ycfl,
                    double bc_top, double bc_left, double bc_bottom,
                    double bc_right, void* stream) {
  return dispatch<double>(shards, n, H, W, ny, nx, order, k, tile_y, tile_x,
                          run, smem_bytes, xcfl, ycfl, bc_top, bc_left,
                          bc_bottom, bc_right, stream);
}

// A single-grid solve's `launches` launches (offsets (0, 0), (ny, nx) its
// interior) in one call: src -> buf0 -> buf1 -> buf0 ..., the geometry as
// heat_ksteps_f32's, checked once.  Returns 0, or the first error, after
// *launched launches were enqueued; the last output is bufs[(launches - 1)
// % 2].  src, buf0 and buf1 are three distinct grids.
int heat_ksteps_loop_f32(const void* src, void* buf0, void* buf1,
                         int launches, int H, int W, int ny, int nx,
                         int order, int k, int tile_y, int tile_x, int run,
                         int smem_bytes, float xcfl, float ycfl,
                         float bc_top, float bc_left, float bc_bottom,
                         float bc_right, void* stream, int* launched) {
  return dispatch_loop<float>(src, buf0, buf1, launches, H, W, ny, nx, order,
                              k, tile_y, tile_x, run, smem_bytes, xcfl, ycfl,
                              bc_top, bc_left, bc_bottom, bc_right, stream,
                              launched);
}

int heat_ksteps_loop_f64(const void* src, void* buf0, void* buf1,
                         int launches, int H, int W, int ny, int nx,
                         int order, int k, int tile_y, int tile_x, int run,
                         int smem_bytes, double xcfl, double ycfl,
                         double bc_top, double bc_left, double bc_bottom,
                         double bc_right, void* stream, int* launched) {
  return dispatch_loop<double>(src, buf0, buf1, launches, H, W, ny, nx,
                               order, k, tile_y, tile_x, run, smem_bytes,
                               xcfl, ycfl, bc_top, bc_left, bc_bottom,
                               bc_right, stream, launched);
}

// out = (blocks an SM, registers a thread, local memory bytes a thread) of
// the instance for (dtype_bytes, order, k) at smem_bytes a block, on the
// current device
int heat_ksteps_occupancy(int dtype_bytes, int order, int k, int smem_bytes,
                          int* out) {
  if (k < 1 || smem_bytes < 0) return cudaErrorInvalidValue;
  if (dtype_bytes == 4)
    return by_order_and_class<float, Occupancy>(order, k, smem_bytes, out);
  if (dtype_bytes == 8)
    return by_order_and_class<double, Occupancy>(order, k, smem_bytes, out);
  return cudaErrorInvalidValue;
}

// out = (TX, threads, R) of the k class's design for dtype_bytes; returns
// cudaErrorInvalidValue for another dtype size or k < 1
int heat_ksteps_design(int dtype_bytes, int k, int* out) {
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

const char* heat_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
