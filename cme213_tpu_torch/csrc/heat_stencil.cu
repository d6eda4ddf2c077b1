// heat_stencil.cu -- k fused 2-D heat steps (orders 2/4/8) on (TY x TX)
// output tiles, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of cme213_tpu/ops/stencil_pipeline.py:
//   _make_local_kernel  (pallas_call in run_heat_pipeline, and in
//                        stencil_local_multistep with global offsets)
//   _make_tiled_kernel  (pallas_call in run_heat_pipeline2d)
// Both compute _apply_substeps: k sub-steps of
//   accx = sum_kk c_kk * u[y][x+kk-b],  accy = sum_kk c_kk * u[y+kk-b][x]
//   u'   = (u + xcfl*accx) + ycfl*accy
// each followed by the Dirichlet bands on global coordinates (rows first,
// then columns over the corners).  One kernel serves all three: the two
// single-grid entry points differ only in the tile width, and the
// distributed solve (ops/stencil_pipeline.py:stencil_local_multistep)
// launches it on one shard's K-padded block, with (gy0, gx0) the shard's
// global offsets and (ny, nx) the global interior, so a shard's bands fall
// where the whole grid's would and interior shards mask nothing.
//
// What bounds it.  One order-8 f32 step of a 4000^2 grid moves 128 MB
// (one read and one write of every point), more than the 50 MB L2, so at
// k = 1 the kernel is bound by device memory (~38 us a step at the H100
// SXM's 3.35 TB/s).  The arithmetic has no FMA (see below): 38 separately
// rounded operations a point, ~18 us a step at half the 67 TFLOP/s FP32
// peak (the data sheet counts an FMA as two).  From k = 2 on the bytes per
// step halve and the kernel becomes bound by operations.
//
// What the design does about it.  A block stages its (TY+2K) x (TX+2K)
// source window (K = k*b halo on every side, corners included) from device
// memory into shared memory once, runs k sub-steps there, ping-ponging
// between two shared buffers while the valid region shrinks by b a
// sub-step, and writes its TY x TX tile straight from the last sub-step.
// So device memory sees one read and one write per k steps; the price is
// the halo recomputed by neighbouring blocks, which grows with k.  A tile
// is not a full-width band as on the TPU: one row of a 4008-wide f32 grid
// is 16 KB, and a block has at most 227 KB of shared memory.
//
// Rounding.  Every product and sum is __fmul_rn/__fadd_rn (__dmul_rn/
// __dadd_rn), which the compiler never contracts, and the library is built
// with --fmad=false; so the kernel rounds exactly as the plain PyTorch
// version does, and agrees with it bit for bit.
//
// The kernel reads src and writes a separate dst: neighbouring blocks read
// each other's halo, so a launch never updates in place.  Window positions
// outside the array hold 0; they feed only cells that the Dirichlet bands
// overwrite or that lie outside the validity cone.
//
// Host interface: plain C, loaded with ctypes by ops/_kernels.py.  Each
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
  int ny, nx;  // global interior extents
  T top, left, bottom, right;
};

// Dirichlet bands on global coordinates; columns take precedence over rows
// (stencil_pipeline.py _apply_substeps re-imposes rows, then columns)
template <typename T>
__device__ __forceinline__ T dirichlet(T v, int grow, int gcol, int B,
                                       const Bands<T>& bc) {
  if (gcol < B) return bc.left;
  if (gcol >= B + bc.nx) return bc.right;
  if (grow < B) return bc.bottom;
  if (grow >= B + bc.ny) return bc.top;
  return v;
}

template <typename T, int ORDER>
__global__ void __launch_bounds__(kThreadsX * kThreadsY)
heat_ksteps(const T* __restrict__ src, T* __restrict__ dst, int H, int W,
            int gy0, int gx0, int k, int TY, int TX, T xcfl, T ycfl,
            Bands<T> bc) {
  constexpr int B = ORDER / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int K = k * B;
  const int WY = TY + 2 * K;
  const int WX = TX + 2 * K;
  T* in = reinterpret_cast<T*>(smem_raw);
  T* out = in + WY * WX;  // second buffer, present only when k > 1
  const int tile_r = blockIdx.y * TY;
  const int tile_c = blockIdx.x * TX;
  const int row0 = tile_r - K;  // array row of window row 0
  const int col0 = tile_c - K;

  for (int wy = threadIdx.y; wy < WY; wy += blockDim.y) {
    const int r = row0 + wy;
    const bool row_in = r >= 0 && r < H;
    for (int wx = threadIdx.x; wx < WX; wx += blockDim.x) {
      const int c = col0 + wx;
      in[wy * WX + wx] = (row_in && c >= 0 && c < W)
                             ? src[static_cast<size_t>(r) * W + c]
                             : T(0);
    }
  }
  __syncthreads();

  // sub-steps 1 .. k-1 inside shared memory; after sub-step s the cells at
  // least s*B from the window's edge are valid
  for (int s = 1; s < k; ++s) {
    const int lo = s * B;
    for (int wy = lo + threadIdx.y; wy < WY - lo; wy += blockDim.y) {
      for (int wx = lo + threadIdx.x; wx < WX - lo; wx += blockDim.x) {
        const int idx = wy * WX + wx;
        out[idx] = dirichlet(update<T, ORDER>(in, idx, WX, xcfl, ycfl),
                             row0 + wy + gy0, col0 + wx + gx0, B, bc);
      }
    }
    __syncthreads();
    T* t = in;
    in = out;
    out = t;
  }

  // sub-step k: the tile's own cells, straight to device memory
  for (int i = threadIdx.y; i < TY; i += blockDim.y) {
    const int r = tile_r + i;
    if (r >= H) break;
    for (int j = threadIdx.x; j < TX; j += blockDim.x) {
      const int c = tile_c + j;
      if (c >= W) break;
      const int idx = (i + K) * WX + (j + K);
      dst[static_cast<size_t>(r) * W + c] =
          dirichlet(update<T, ORDER>(in, idx, WX, xcfl, ycfl), r + gy0,
                    c + gx0, B, bc);
    }
  }
}

template <typename T, int ORDER>
cudaError_t launch(const T* src, T* dst, int H, int W, int gy0, int gx0,
                   int k, int TY, int TX, size_t smem, T xcfl, T ycfl,
                   Bands<T> bc, cudaStream_t stream) {
  if (smem > kDefaultSmem) {
    // above 48 KB a block must opt in; a launch refused for shared memory
    // never runs and shows only in cudaGetLastError()
    const cudaError_t e = cudaFuncSetAttribute(
        heat_ksteps<T, ORDER>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 block(kThreadsX, kThreadsY);
  const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY);
  heat_ksteps<T, ORDER><<<grid, block, smem, stream>>>(
      src, dst, H, W, gy0, gx0, k, TY, TX, xcfl, ycfl, bc);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* src, void* dst, int H, int W, int gy0, int gx0,
             int ny, int nx, int order, int k, int tile_y, int tile_x,
             int smem_bytes, T xcfl, T ycfl, T bc_top, T bc_left,
             T bc_bottom, T bc_right, void* stream) {
  if (H < 1 || W < 1 || k < 1 || tile_y < 1 || tile_x < 1 || smem_bytes < 1)
    return cudaErrorInvalidValue;
  const Bands<T> bc{ny, nx, bc_top, bc_left, bc_bottom, bc_right};
  const T* s = static_cast<const T*>(src);
  T* d = static_cast<T*>(dst);
  const size_t smem = static_cast<size_t>(smem_bytes);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (order) {
    case 2:
      return launch<T, 2>(s, d, H, W, gy0, gx0, k, tile_y, tile_x, smem,
                          xcfl, ycfl, bc, st);
    case 4:
      return launch<T, 4>(s, d, H, W, gy0, gx0, k, tile_y, tile_x, smem,
                          xcfl, ycfl, bc, st);
    case 8:
      return launch<T, 8>(s, d, H, W, gy0, gx0, k, tile_y, tile_x, smem,
                          xcfl, ycfl, bc, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// (H, W) row-major grids src -> dst; (gy0, gx0) are the global halo-grid
// coordinates of element [0, 0]; (ny, nx) the global interior extents;
// smem_bytes the block's dynamic shared memory, which the caller sizes for
// the kernel's window buffers (ops/stencil_pipeline.smem_bytes)
int heat_ksteps_f32(const void* src, void* dst, int H, int W, int gy0,
                    int gx0, int ny, int nx, int order, int k, int tile_y,
                    int tile_x, int smem_bytes, float xcfl, float ycfl,
                    float bc_top, float bc_left, float bc_bottom,
                    float bc_right, void* stream) {
  return dispatch<float>(src, dst, H, W, gy0, gx0, ny, nx, order, k, tile_y,
                         tile_x, smem_bytes, xcfl, ycfl, bc_top, bc_left,
                         bc_bottom, bc_right, stream);
}

int heat_ksteps_f64(const void* src, void* dst, int H, int W, int gy0,
                    int gx0, int ny, int nx, int order, int k, int tile_y,
                    int tile_x, int smem_bytes, double xcfl, double ycfl,
                    double bc_top, double bc_left, double bc_bottom,
                    double bc_right, void* stream) {
  return dispatch<double>(src, dst, H, W, gy0, gx0, ny, nx, order, k,
                          tile_y, tile_x, smem_bytes, xcfl, ycfl, bc_top,
                          bc_left, bc_bottom, bc_right, stream);
}

const char* heat_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
