// Host-native multicore sorts — the hw4 parity component.
//
// The reference's hw4 workloads are host-CPU-native OpenMP programs
// (mergesort.cpp, radixsort.cpp); this library provides freshly-designed
// equivalents with the same algorithmic structure and tuning knobs:
//
//  - merge_sort_omp: recursive fork-join task tree (omp task/taskwait) with
//    a serial std::sort leaf below `sort_threshold`, and a parallel merge
//    that splits the larger run at its median and binary-searches the split
//    point in the other run (cf. hw/hw4/programming/mergesort.cpp:31-144 —
//    same strategy, clean two-buffer alternation instead of the reference's
//    parity bookkeeping).
//  - radix_sort_omp: LSD radix sort, `num_bits` per pass, with the classic
//    4-phase block-decomposed pass: parallel per-block histograms, a
//    bucket-major exclusive scan producing per-block scatter bases, and a
//    parallel stable scatter (cf. hw/hw4/programming/radixsort.cpp:22-121).
//  - radix_sort_serial: the serial histogram/scan/scatter baseline
//    (radixsort.cpp:123-161 analog).
//
// Exposed as a C ABI for ctypes (no pybind11 in this environment).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

#include <omp.h>

extern "C" {

int omp_thread_count() { return omp_get_max_threads(); }
void set_omp_threads(int n) { omp_set_num_threads(n); }
double wtime_now() { return omp_get_wtime(); }

// Host-CPU baselines: OpenMP reduction sum and SAXPY (the canonical
// parallel-for kernels; CPU counterpart of ops/elementwise.py's device ops).
double parallel_sum_omp(const float* x, long n) {
  double acc = 0.0;
#pragma omp parallel for reduction(+ : acc) schedule(static)
  for (long i = 0; i < n; ++i) acc += x[i];
  return acc;
}

void saxpy_omp(float alpha, const float* x, float* y, long n) {
#pragma omp parallel for schedule(static)
  for (long i = 0; i < n; ++i) y[i] = alpha * x[i] + y[i];
}

}  // extern "C"

namespace {

// ---------------------------------------------------------------- merge sort

void parallel_merge(const int32_t* a, long na, const int32_t* b, long nb,
                    int32_t* out, long merge_threshold) {
  if (na + nb <= merge_threshold) {
    std::merge(a, a + na, b, b + nb, out);
    return;
  }
  // split the larger run at its midpoint; binary-search the matching split
  // point in the smaller run so both halves merge independently
  if (na < nb) {
    std::swap(a, b);
    std::swap(na, nb);
  }
  long ma = na / 2;
  long mb = std::upper_bound(b, b + nb, a[ma]) - b;
#pragma omp task
  parallel_merge(a, ma, b, mb, out, merge_threshold);
#pragma omp task
  parallel_merge(a + ma, na - ma, b + mb, nb - mb, out + ma + mb,
                 merge_threshold);
#pragma omp taskwait
}

// Sorts a[0..n); result lands in `a` if !into_tmp, else in `tmp`.
void msort_rec(int32_t* a, int32_t* tmp, long n, bool into_tmp,
               long sort_threshold, long merge_threshold) {
  if (n <= sort_threshold) {
    std::sort(a, a + n);
    if (into_tmp) std::memcpy(tmp, a, n * sizeof(int32_t));
    return;
  }
  long mid = n / 2;
  // halves must land in the buffer we merge FROM, i.e. the other one
#pragma omp task
  msort_rec(a, tmp, mid, !into_tmp, sort_threshold, merge_threshold);
#pragma omp task
  msort_rec(a + mid, tmp + mid, n - mid, !into_tmp, sort_threshold,
            merge_threshold);
#pragma omp taskwait
  if (into_tmp) {
    parallel_merge(a, mid, a + mid, n - mid, tmp, merge_threshold);
  } else {
    parallel_merge(tmp, mid, tmp + mid, n - mid, a, merge_threshold);
  }
}

// ---------------------------------------------------------------- radix sort

void radix_pass_parallel(const uint32_t* in, uint32_t* out, long n, int shift,
                         int num_bits, long block_size) {
  const long nbuckets = 1L << num_bits;
  const uint32_t mask = static_cast<uint32_t>(nbuckets - 1);
  const long nblocks = (n + block_size - 1) / block_size;

  // phase 1: per-block histograms (hist[block][bucket])
  std::vector<long> hist(nblocks * nbuckets, 0);
#pragma omp parallel for schedule(static)
  for (long blk = 0; blk < nblocks; ++blk) {
    long lo = blk * block_size;
    long hi = std::min(n, lo + block_size);
    long* h = &hist[blk * nbuckets];
    for (long i = lo; i < hi; ++i) h[(in[i] >> shift) & mask]++;
  }

  // phases 2+3: bucket-major exclusive scan over (bucket, block) — the
  // cross-block reduction + downsweep producing per-block scatter bases
  std::vector<long> base(nblocks * nbuckets);
  long running = 0;
  for (long d = 0; d < nbuckets; ++d) {
    for (long blk = 0; blk < nblocks; ++blk) {
      base[blk * nbuckets + d] = running;
      running += hist[blk * nbuckets + d];
    }
  }

  // phase 4: parallel stable scatter — each block owns its `base` slice,
  // which is dead after this phase, so it doubles as the scatter cursor
  // (no per-thread 2^num_bits stack/heap copy)
#pragma omp parallel for schedule(static)
  for (long blk = 0; blk < nblocks; ++blk) {
    long lo = blk * block_size;
    long hi = std::min(n, lo + block_size);
    long* cursor = &base[blk * nbuckets];
    for (long i = lo; i < hi; ++i) {
      uint32_t d = (in[i] >> shift) & mask;
      out[cursor[d]++] = in[i];
    }
  }
}

void radix_pass_serial(const uint32_t* in, uint32_t* out, long n, int shift,
                       int num_bits) {
  const long nbuckets = 1L << num_bits;
  const uint32_t mask = static_cast<uint32_t>(nbuckets - 1);
  std::vector<long> count(nbuckets, 0);
  for (long i = 0; i < n; ++i) count[(in[i] >> shift) & mask]++;
  long running = 0;
  for (long d = 0; d < nbuckets; ++d) {
    long c = count[d];
    count[d] = running;
    running += c;
  }
  for (long i = 0; i < n; ++i) {
    uint32_t d = (in[i] >> shift) & mask;
    out[count[d]++] = in[i];
  }
}

}  // namespace

extern "C" {

void merge_sort_omp(int32_t* data, int32_t* scratch, long n,
                    long sort_threshold, long merge_threshold) {
  if (sort_threshold < 32) sort_threshold = 32;
  if (merge_threshold < 32) merge_threshold = 32;
#pragma omp parallel
#pragma omp single
  msort_rec(data, scratch, n, /*into_tmp=*/false, sort_threshold,
            merge_threshold);
}

void radix_sort_omp(uint32_t* data, uint32_t* scratch, long n, int num_bits,
                    long block_size) {
  if (num_bits < 1) num_bits = 8;
  if (num_bits > 16) num_bits = 16;
  if (block_size < 1) block_size = 8192;
  uint32_t* src = data;
  uint32_t* dst = scratch;
  for (int shift = 0; shift < 32; shift += num_bits) {
    radix_pass_parallel(src, dst, n, shift, num_bits, block_size);
    std::swap(src, dst);
  }
  if (src != data) std::memcpy(data, src, n * sizeof(uint32_t));
}

void radix_sort_serial(uint32_t* data, uint32_t* scratch, long n,
                       int num_bits) {
  if (num_bits < 1) num_bits = 8;
  if (num_bits > 16) num_bits = 16;
  uint32_t* src = data;
  uint32_t* dst = scratch;
  for (int shift = 0; shift < 32; shift += num_bits) {
    radix_pass_serial(src, dst, n, shift, num_bits);
    std::swap(src, dst);
  }
  if (src != data) std::memcpy(data, src, n * sizeof(uint32_t));
}

}  // extern "C"
