// transpose.cu -- tiled matrix transpose through shared memory, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel of cme213_tpu/ops/transpose.py:
//   transpose_pallas (pallas_call :34, body _kernel :23): (M, N) -> (N, M)
//   through (tile x tile) VMEM blocks.
// The classic shared-memory transpose (the reference's
// my-refs/MatrixTranspose.pdf): a block of 32 x 8 threads moves one 32 x 32
// tile.  Each thread reads four elements of the input tile, row by row, so a
// warp reads 32 consecutive elements of one input row; after a barrier it
// writes four elements of the output tile, so a warp writes 32 consecutive
// elements of one output row.  Both sides are coalesced.  The tile is padded
// to 32 x 33: the column walk of the write phase then touches 32 different
// banks for 4-byte elements (bank (tx*33 + j) mod 32 = (tx + j) mod 32).
// The TPU kernel's `tile` (256 in bench/sweeps.py) is not this tile: a
// 256^2 f32 tile is 256 KB and a block has 227 KB; the wrapper keeps the
// reference's divisibility contract on it and the kernel tiles by 32.
//
// A transpose moves bits, so the kernel is templated on the element size (1,
// 2, 4 or 8 bytes) and serves every dtype of that size; its output is
// bitwise x.t().contiguous().  Ragged edges (M or N not a multiple of 32)
// are masked.
//
// What bounds it: bytes.  One read and one write of each element, no
// arithmetic: 134 MB for a 4096^2 f32 matrix, ~40 us at the H100 SXM's
// 3.35 TB/s.
//
// Host interface: plain C, loaded with ctypes by ops/_kernels.py.  The entry
// enqueues one launch on the given stream and returns cudaGetLastError()
// (0 on success).

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kTile = 32;
constexpr int kRows = 8;  // thread rows: each thread moves kTile / kRows

template <typename T>
__global__ void __launch_bounds__(kTile * kRows)
transpose_kernel(const T* __restrict__ in, T* __restrict__ out, long long M,
                 long long N) {
  __shared__ T tile[kTile][kTile + 1];
  const long long r0 = static_cast<long long>(blockIdx.y) * kTile;
  const long long c0 = static_cast<long long>(blockIdx.x) * kTile;
  const long long c = c0 + threadIdx.x;
  for (int j = threadIdx.y; j < kTile; j += kRows) {
    const long long r = r0 + j;
    if (r < M && c < N) tile[j][threadIdx.x] = in[r * N + c];
  }
  __syncthreads();
  // output row = input column c0 + j, output column = input row r0 + tx
  const long long oc = r0 + threadIdx.x;
  for (int j = threadIdx.y; j < kTile; j += kRows) {
    const long long orow = c0 + j;
    if (orow < N && oc < M) out[orow * M + oc] = tile[threadIdx.x][j];
  }
}

template <typename T>
cudaError_t launch(const void* in, void* out, long long M, long long N,
                   cudaStream_t stream) {
  const dim3 block(kTile, kRows);
  const dim3 grid(static_cast<unsigned>((N + kTile - 1) / kTile),
                  static_cast<unsigned>((M + kTile - 1) / kTile));
  transpose_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(in), static_cast<T*>(out), M, N);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// in: (M, N) row-major; out: (N, M) row-major; elem_bytes 1, 2, 4 or 8
int transpose_tiles(const void* in, void* out, long long M, long long N,
                    int elem_bytes, void* stream) {
  if (M < 1 || N < 1 || (M + kTile - 1) / kTile > 65535 ||
      (N + kTile - 1) / kTile > 2147483647LL)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (elem_bytes) {
    case 1:
      return launch<uint8_t>(in, out, M, N, st);
    case 2:
      return launch<uint16_t>(in, out, M, N, st);
    case 4:
      return launch<uint32_t>(in, out, M, N, st);
    case 8:
      return launch<uint64_t>(in, out, M, N, st);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* transpose_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
