// heat_tile.cuh -- the register-blocked tile body of the port's heat
// kernels, shared by heat_stencil.cu (B1, B2, B3) and heat_band.cu (B4,
// B5): round-to-nearest arithmetic, the stencil's taps, 16-byte shared and
// device-memory moves, cp.async staging, the Dirichlet bands and the 4 x R
// micro-tile.
//
// Rounding.  Every product and sum is __fmul_rn/__fadd_rn (__dmul_rn/
// __dadd_rn), which the compiler never contracts (the libraries are also
// built with --fmad=false); each point's accx and accy accumulate in
// coefficient order and combine as (u + xcfl*accx) + ycfl*accy, so a kernel
// built on micro_tile rounds exactly as the plain PyTorch versions do
// (ops/stencil.py run_heat, run_heat_roll) and agrees with them bit for bit.
//
// Everything here has internal linkage: each library that includes the
// header gets its own inlined copy.

#ifndef CME213_TPU_TORCH_HEAT_TILE_CUH_
#define CME213_TPU_TORCH_HEAT_TILE_CUH_

#include <cuda_runtime.h>

namespace {

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

// four consecutive values at a 16-byte aligned address (shared or global)
__device__ __forceinline__ void ld4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void ld4(const double* p, double (&v)[4]) {
  const double2 a = reinterpret_cast<const double2*>(p)[0];
  const double2 b = reinterpret_cast<const double2*>(p)[1];
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}
__device__ __forceinline__ void st4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void st4(double* p, const double (&v)[4]) {
  reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
  reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
}

// 16-byte asynchronous copy device memory -> shared memory; `bytes` < 16
// fills the rest of the chunk with zeros (0: nothing is read)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int bytes) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr),
               "l"(gmem), "r"(bytes)
               : "memory");
}

// one 4- or 8-byte asynchronous copy
template <typename T>
__device__ __forceinline__ void cp_async_elem(T* smem, const T* gmem) {
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

// Dirichlet bands on global halo-grid coordinates, for any launch
// parameters `p` with the interior extents ny, nx and the values top,
// left, bottom, right: bottom, top, then left and right, so the columns
// win over the corners (the JAX kernels re-impose rows, then columns)
template <typename T, typename P>
__device__ __forceinline__ T dirichlet(T v, int grow, int gcol, int B,
                                       const P& p) {
  if (gcol < B) return p.left;
  if (gcol >= B + p.nx) return p.right;
  if (grow < B) return p.bottom;
  if (grow >= B + p.ny) return p.top;
  return v;
}

// One micro-tile: rows row .. row+R-1, columns col .. col+3 of the window
// `in` (row stride WB; col a multiple of 4).  Each output row goes to
// sink(i, values) as soon as it is computed.
template <typename T, int ORDER, int R, typename Sink>
__device__ __forceinline__ void micro_tile(const T* __restrict__ in, int WB,
                                           int row, int col, T xcfl, T ycfl,
                                           Sink&& sink) {
  constexpr int B = ORDER / 2;
  T ring[R + 2 * B][4];  // the column quad of rows row-B .. row+R-1+B
#pragma unroll
  for (int m = 0; m < R + 2 * B; ++m) {
    ld4(in + (row - B + m) * WB + col, ring[m]);
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    T lq[4], rq[4];  // the quads left and right of the row's own
    ld4(in + (row + i) * WB + col - 4, lq);
    ld4(in + (row + i) * WB + col + 4, rq);
    T out[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      T accx = T(0);
      T accy = T(0);
#pragma unroll
      for (int kk = 0; kk <= 2 * B; ++kk) {
        const T c = static_cast<T>(tap<ORDER>(kk));
        const int x = j + kk - B;  // -4 .. 7
        const T vx = x < 0 ? lq[x + 4] : (x < 4 ? ring[i + B][x] : rq[x - 4]);
        accx = add_rn(accx, mul_rn(c, vx));
        accy = add_rn(accy, mul_rn(c, ring[i + kk][j]));
      }
      out[j] = add_rn(add_rn(ring[i + B][j], mul_rn(xcfl, accx)),
                      mul_rn(ycfl, accy));
    }
    sink(i, out);
  }
}

}  // namespace

#endif  // CME213_TPU_TORCH_HEAT_TILE_CUH_
