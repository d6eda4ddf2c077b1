// heat_band.cu -- band-staged 2-D heat steps (orders 2/4/8) with cp.async
// double buffering, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of cme213_tpu/ops/stencil_pallas.py:
//   _stencil_full        (pallas_call :115, body _make_kernel, staging
//                         _stage_band): one step per call, k = 1
//   run_heat_multistep   (pallas_call :241, body _make_multistep_kernel):
//                         k fused steps per call, k > 1
// One kernel serves both; k is a launch argument.  Every output cell is
//   accx = sum_kk c_kk * u[y][x+kk-b],  accy = sum_kk c_kk * u[y+kk-b][x]
//   u'   = (u + xcfl*accx) + ycfl*accy
// with every product and sum __fmul_rn/__fadd_rn (__dmul_rn/__dadd_rn) and
// the library built with --fmad=false, so the kernel rounds exactly as the
// plain PyTorch versions do (ops/stencil.py run_heat, run_heat_roll).
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
// The staging, which is what makes this B4/B5 and not heat_stencil.cu.  The
// TPU kernel streams full-width row bands through VMEM with a hand-written
// double-buffered DMA (_stage_band: start the copy of band i+1, wait for
// band i, compute band i).  On Hopper a full-width band does not fit (one
// 4008-wide f32 row is 16 KB; a block has 227 KB), so the grid is cut into
// strips of TX columns.  A block owns one strip and walks down a run of
// consecutive (TY x TX) output tiles; for each it stages the (TY+2K) x
// (TX+2K) window (K = k*b) from device memory into shared memory with
// cp.async, and while it computes tile i the copy of tile i+1's window is in
// flight into a second buffer (nbuf = 2).  For k > 1 the sub-steps
// ping-pong between the tile's staging buffer and one scratch buffer, so a
// double-buffered block holds three windows.  Where three windows (or two,
// at k = 1) do not fit even at TX = 32, the block stages one window at a
// time without prefetch (nbuf = 1).  TY is the caller's knob (the tile
// height pallas_tile_sweep sweeps); TX, nbuf and the run length are chosen
// by ops/stencil_pallas.band_geometry from the 227 KB budget and the SM
// count: at the sweeps' cells (f32, order 8)
//   TY = 40, 80, 200 at k = 1        TX = 128, double-buffered
//   TY = 400 at k = 1 (2000^2)       TX = 32, double-buffered
//   TY = 200, k = 2                  TX = 64, double-buffered (3 windows)
//   TY = 200, k = 4                  TX = 32, double-buffered (3 windows)
//   TY = 200, k = 8                  TX = 32, one window, no prefetch
// A strip's tiles are split over several blocks so that about one wave of
// resident blocks covers the grid (a strip walk alone gives gx/TX blocks,
// ~32 at 4000^2 for 132 SMs).
//
// Window cells outside the grid (k > 1: the window reaches K - b rows and
// columns past the halo) hold 0.  The JAX kernel pads K - b replicated
// boundary rows instead.  Either way such cells feed only band cells, which
// the masks overwrite after every sub-step, and cells outside the validity
// region (after sub-step s only cells at least s*b from the window's edge
// are valid); no interior cell ever reads them.  tests/test_torch_
// stencil_pallas.py models this decomposition in numpy, stale buffers
// included, and holds it bit for bit to the plain version.
//
// What bounds it.  At k = 1 one order-8 f32 step of a 4000^2 grid moves
// 128 MB (one read, one write), more than the 50 MB L2: ~38 us at the H100
// SXM's 3.35 TB/s.  The 38 separately rounded operations a point take ~18
// us at half the 67 TFLOP/s FP32 peak, and the 17 shared-memory loads a
// point are of the same order as the device-memory time; the prefetch hides
// the staging latency behind them.  From k = 2 the bytes per step halve and
// the operations (plus the halo recomputed by neighbouring tiles) bound it.
//
// Host interface: plain C, loaded with ctypes by ops/_kernels.py.  The
// entry enqueues one launch on the given stream and returns
// cudaGetLastError() (0 on success).

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreadsX = 32;
constexpr int kThreadsY = 16;
constexpr int kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// coefficient kk of the order's 1-D second difference over offsets [-b..b]
// (ops/stencil.py STENCIL_COEFFS); symmetric about the centre
template <int ORDER>
__device__ __forceinline__ double tap(int kk) {
  constexpr int B = ORDER / 2;
  const int d = kk < B ? B - kk : kk - B;
  if (ORDER == 2) return d == 0 ? -2.0 : 1.0;
  if (ORDER == 4) return d == 0 ? -30.0 : (d == 1 ? 16.0 : -1.0);
  return d == 0 ? -14350.0
       : d == 1 ? 8064.0
       : d == 2 ? -1008.0
       : d == 3 ? 128.0
                : -9.0;
}

// one stencil update of shared-memory cell idx (row stride `stride`), taps
// in coefficient order, every operation rounded on its own
template <typename T, int ORDER>
__device__ __forceinline__ T update(const T* in, int idx, int stride, T xcfl,
                                    T ycfl) {
  constexpr int B = ORDER / 2;
  T accx = T(0);
  T accy = T(0);
#pragma unroll
  for (int kk = 0; kk <= 2 * B; ++kk) {
    const T c = static_cast<T>(tap<ORDER>(kk));
    accx = add_rn(accx, mul_rn(c, in[idx + kk - B]));
    accy = add_rn(accy, mul_rn(c, in[idx + (kk - B) * stride]));
  }
  return add_rn(add_rn(in[idx], mul_rn(xcfl, accx)), mul_rn(ycfl, accy));
}

template <typename T>
struct Bands {
  int ny, nx;  // interior extents
  T top, left, bottom, right;
};

// Dirichlet bands on global halo-grid coordinates: bottom, top, then left
// and right, so the columns win over the corners (the JAX kernel's order)
template <typename T>
__device__ __forceinline__ T dirichlet(T v, int grow, int gcol, int B,
                                       const Bands<T>& bc) {
  if (gcol < B) return bc.left;
  if (gcol >= B + bc.nx) return bc.right;
  if (grow < B) return bc.bottom;
  if (grow >= B + bc.ny) return bc.top;
  return v;
}

// asynchronous 4- or 8-byte copy device memory -> shared memory (cp.async;
// the copy bypasses the registers and is waited for with cp_async_wait)
template <typename T>
__device__ __forceinline__ void cp_async(T* smem, const T* gmem) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(addr),
               "l"(gmem), "n"(sizeof(T))
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed copy groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage the window of output tile `t` (grid rows row0 .. row0+WY, columns
// col0 .. col0+WX) into `win`; cells outside the (H, W) grid get 0.  Commits
// one copy group.
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ src, int H, int W,
                                      int row0, int col0, int WY, int WX,
                                      T* win) {
  for (int wy = threadIdx.y; wy < WY; wy += blockDim.y) {
    const int r = row0 + wy;
    const bool row_in = r >= 0 && r < H;
    for (int wx = threadIdx.x; wx < WX; wx += blockDim.x) {
      const int c = col0 + wx;
      T* d = win + wy * WX + wx;
      if (row_in && c >= 0 && c < W) {
        cp_async(d, src + static_cast<size_t>(r) * W + c);
      } else {
        *d = T(0);
      }
    }
  }
  cp_async_commit();
}

// Grid: (strips, splits).  Block (s, p) owns the output columns
// [s*TX, s*TX + TX) of the interior and the tiles [p*run, p*run + run) of
// TY rows each.  src is the (H, W) halo grid; dst points at interior cell
// (0, 0) of the output, row stride ldd.
template <typename T, int ORDER>
__global__ void __launch_bounds__(kThreadsX * kThreadsY)
heat_band(const T* __restrict__ src, T* __restrict__ dst, int H, int W,
          int ldd, int k, int TY, int TX, int run, int nbuf, T xcfl, T ycfl,
          Bands<T> bc) {
  constexpr int B = ORDER / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int K = k * B;
  const int WY = TY + 2 * K;
  const int WX = TX + 2 * K;
  const size_t cells = static_cast<size_t>(WY) * WX;
  T* base = reinterpret_cast<T*>(smem_raw);
  // staging buffer i (i = 0, 1; one buffer serves both when nbuf = 1)
  const size_t second = nbuf == 2 ? cells : 0;
  auto staged = [=](int i) { return base + (i & 1) * second; };
  T* scratch = base + nbuf * cells;  // present only when k > 1

  const int ntiles = (bc.ny + TY - 1) / TY;
  const int t0 = blockIdx.y * run;
  const int t1 = min(t0 + run, ntiles);
  const int c_out = blockIdx.x * TX;  // first interior column of the strip
  const int col0 = c_out + B - K;     // grid column of window column 0

  if (nbuf == 2 && t0 < t1) {
    stage(src, H, W, t0 * TY + B - K, col0, WY, WX, staged(0));
  }
  for (int t = t0; t < t1; ++t) {
    const int row0 = t * TY + B - K;  // grid row of window row 0
    T* in = staged(t - t0);
    if (nbuf == 2) {
      // prefetch the next tile's window while this one is computed
      if (t + 1 < t1) {
        stage(src, H, W, row0 + TY, col0, WY, WX, staged(t + 1 - t0));
      } else {
        cp_async_commit();  // an empty group: one pending group either way
      }
      cp_async_wait<1>();
    } else {
      stage(src, H, W, row0, col0, WY, WX, in);
      cp_async_wait<0>();
    }
    __syncthreads();

    // sub-steps 1 .. k-1 in shared memory, each followed by the bands; after
    // sub-step s the cells at least s*B from the window's edge are valid
    T* out = scratch;
    for (int s = 1; s < k; ++s) {
      const int lo = s * B;
      for (int wy = lo + threadIdx.y; wy < WY - lo; wy += blockDim.y) {
        for (int wx = lo + threadIdx.x; wx < WX - lo; wx += blockDim.x) {
          const int idx = wy * WX + wx;
          out[idx] = dirichlet(update<T, ORDER>(in, idx, WX, xcfl, ycfl),
                               row0 + wy, col0 + wx, B, bc);
        }
      }
      __syncthreads();
      T* swap = in;
      in = out;
      out = swap;
    }

    // sub-step k: the tile's interior cells, straight to device memory
    for (int i = threadIdx.y; i < TY; i += blockDim.y) {
      const int r = t * TY + i;
      if (r >= bc.ny) break;
      for (int j = threadIdx.x; j < TX; j += blockDim.x) {
        const int c = c_out + j;
        if (c >= bc.nx) break;
        dst[static_cast<size_t>(r) * ldd + c] =
            update<T, ORDER>(in, (i + K) * WX + (j + K), WX, xcfl, ycfl);
      }
    }
    // every read of this tile's buffers is done before the next iteration
    // stages into them
    __syncthreads();
  }
}

template <typename T, int ORDER>
cudaError_t launch(const T* src, T* dst, int H, int W, int ldd, int k,
                   int TY, int TX, int run, int nbuf, size_t smem, T xcfl,
                   T ycfl, Bands<T> bc, cudaStream_t stream) {
  if (smem > kDefaultSmem) {
    // above 48 KB a block must opt in; a launch refused for shared memory
    // never runs and shows only in cudaGetLastError()
    const cudaError_t e = cudaFuncSetAttribute(
        heat_band<T, ORDER>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int ntiles = (bc.ny + TY - 1) / TY;
  const dim3 block(kThreadsX, kThreadsY);
  const dim3 grid((bc.nx + TX - 1) / TX, (ntiles + run - 1) / run);
  heat_band<T, ORDER><<<grid, block, smem, stream>>>(
      src, dst, H, W, ldd, k, TY, TX, run, nbuf, xcfl, ycfl, bc);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* src, void* dst, int H, int W, int ldd, int ny,
             int nx, int order, int k, int tile_y, int tile_x, int run,
             int nbuf, int smem_bytes, T xcfl, T ycfl, T bc_top, T bc_left,
             T bc_bottom, T bc_right, void* stream) {
  if (order != 2 && order != 4 && order != 8) return cudaErrorInvalidValue;
  if (ny < 1 || nx < 1 || H != ny + order || W != nx + order || ldd < nx ||
      k < 1 || tile_y < 1 || tile_x < 1 || run < 1 ||
      (nbuf != 1 && nbuf != 2) || smem_bytes < 1 ||
      (ny + tile_y - 1) / tile_y > run * 65535)
    return cudaErrorInvalidValue;
  const Bands<T> bc{ny, nx, bc_top, bc_left, bc_bottom, bc_right};
  const T* s = static_cast<const T*>(src);
  T* d = static_cast<T*>(dst);
  const size_t smem = static_cast<size_t>(smem_bytes);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (order) {
    case 2:
      return launch<T, 2>(s, d, H, W, ldd, k, tile_y, tile_x, run, nbuf,
                          smem, xcfl, ycfl, bc, st);
    case 4:
      return launch<T, 4>(s, d, H, W, ldd, k, tile_y, tile_x, run, nbuf,
                          smem, xcfl, ycfl, bc, st);
    default:
      return launch<T, 8>(s, d, H, W, ldd, k, tile_y, tile_x, run, nbuf,
                          smem, xcfl, ycfl, bc, st);
  }
}

}  // namespace

extern "C" {

// src: the (H, W) = (ny + 2b, nx + 2b) row-major halo grid; dst: interior
// cell (0, 0) of the output, row stride ldd; (tile_y, tile_x) the output
// tile, `run` tiles a block, `nbuf` staging buffers (2: prefetch the next
// window), smem_bytes the block's dynamic shared memory, which the caller
// sizes for those buffers (ops/stencil_pallas.band_smem_bytes)
int heat_band_f32(const void* src, void* dst, int H, int W, int ldd, int ny,
                  int nx, int order, int k, int tile_y, int tile_x, int run,
                  int nbuf, int smem_bytes, float xcfl, float ycfl,
                  float bc_top, float bc_left, float bc_bottom,
                  float bc_right, void* stream) {
  return dispatch<float>(src, dst, H, W, ldd, ny, nx, order, k, tile_y,
                         tile_x, run, nbuf, smem_bytes, xcfl, ycfl, bc_top,
                         bc_left, bc_bottom, bc_right, stream);
}

int heat_band_f64(const void* src, void* dst, int H, int W, int ldd, int ny,
                  int nx, int order, int k, int tile_y, int tile_x, int run,
                  int nbuf, int smem_bytes, double xcfl, double ycfl,
                  double bc_top, double bc_left, double bc_bottom,
                  double bc_right, void* stream) {
  return dispatch<double>(src, dst, H, W, ldd, ny, nx, order, k, tile_y,
                          tile_x, run, nbuf, smem_bytes, xcfl, ycfl, bc_top,
                          bc_left, bc_bottom, bc_right, stream);
}

const char* heat_band_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
