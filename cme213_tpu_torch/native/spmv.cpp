// Host-native OpenMP SpMV-scan — the hw_final CPU axis.
//
// The reference's final project carries a CPU reference path measured
// alongside the GPU kernel (4-thread suite table in data.ods): per
// iteration, an OpenMP parallel elementwise multiply followed by a
// one-segment-per-thread serial inclusive scan
// (cf. hw/hw_final/programming/fp.cu:130-152).  This is that component,
// rebuilt for the framework's C ABI: float accumulation (matching the
// device pipeline's checked precision), explicit ping-pong buffers, and
// the segment list passed WITHOUT the terminal sentinel (segment i spans
// [s[i], s[i+1]) with an implicit end at n).

#include <cstdint>
#include <cstring>
#include <vector>

#include <omp.h>

extern "C" {

// a <- segscan(a * xx) iterated `iters` times; result lands back in `a`.
// s holds `p` segment starts (no sentinel), strictly increasing, s[0]==0.
void spmv_scan_omp(float* a, const float* xx, const int32_t* s, long p,
                   long n, int iters) {
  std::vector<float> tmp(n);
  float* src = a;
  float* dst = tmp.data();
  for (int it = 0; it < iters; ++it) {
#pragma omp parallel
    {
#pragma omp for schedule(static)
      for (long l = 0; l < n; ++l) dst[l] = src[l] * xx[l];
      // one segment per thread, serial scan inside — segment lengths are
      // skewed in the SuiteSparse instances, so dynamic scheduling keeps
      // threads busy (the reference's plain `omp for` equivalent)
#pragma omp for schedule(dynamic, 16)
      for (long i = 0; i < p; ++i) {
        long lo = s[i];
        long hi = (i + 1 < p) ? s[i + 1] : n;
        float acc = 0.0f;
        for (long j = lo; j < hi; ++j) {
          acc += dst[j];
          dst[j] = acc;
        }
      }
    }
    std::swap(src, dst);
  }
  if (src != a) std::memcpy(a, src, n * sizeof(float));
}

}  // extern "C"
