// Native data-plane kernels for the host side of the shuffle pipeline,
// the port's copy of ray_shuffling_data_loader_tpu/native/kernels.cc with
// the same C ABI and rsdl_abi_version (diff the two files to compare).
//
// The hot host-side work of a per-epoch shuffle -- row gathers applying a
// permutation, the fused concat+gather of the reduce stage, the map's
// stable group-by scatter and the dtype narrowing before staging -- as
// standalone, multi-threaded C++ (the original Ray loader pays
// DataFrame.sample / pd.concat copies instead).
//
// All functions operate on raw contiguous buffers with an element size,
// so a single entry point serves every column dtype. Parallelism is plain
// std::thread over row ranges: gathers are memory-bound, so a few threads
// saturate DRAM bandwidth; thread count is chosen by the Python caller.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -pthread, at first use, by
// ray_shuffling_data_loader_tpu_torch/native/__init__.py, which loads it
// with ctypes and keeps a plain numpy version beside every wrapper.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <algorithm>
#include <climits>
#include <thread>
#include <vector>

namespace {

// Run fn(begin, end) over [0, n) split across up to n_threads threads.
// Threads are capped so each slice is worth a spawn: std::thread startup
// is ~100 µs-class, and a sub-512k-row slice of a memory-bound loop
// finishes in that order — threading it is a measured LOSS (the r7
// sweep at 372k rows ran 0.6-0.9x serial before this cap).
template <typename Fn>
void parallel_for(int64_t n, int n_threads, Fn fn) {
  int64_t max_useful = n >> 19;  // one thread per ~524k rows
  if (max_useful < n_threads) n_threads = static_cast<int>(max_useful);
  if (n_threads <= 1 || n < (1 << 14)) {
    fn(0, n);
    return;
  }
  int64_t chunk = (n + n_threads - 1) / n_threads;
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) {
    int64_t begin = t * chunk;
    if (begin >= n) break;
    int64_t end = std::min(n, begin + chunk);
    threads.emplace_back([=] { fn(begin, end); });
  }
  for (auto& th : threads) th.join();
}

// Typed gather: dst[i] = src[idx[i]], specialized per element width so
// the inner loop is a plain indexed load/store instead of memcpy. Bounds
// are checked INLINE against n_src (one well-predicted compare per row,
// invisible next to the random-access load): the old Python-side
// idx.min()/idx.max() pre-scan cost two full single-threaded passes
// over the index array per call — a fixed cost that measurably diluted
// the kernel's multi-core scaling (r7 sweep: 1.5x -> 2.0x at 2 threads
// with the scan gone). On any out-of-range index the shared flag is
// raised and every thread bails; the wrapper re-derives exact numpy
// semantics (negative-index fallback / IndexError) off the hot path.
template <typename T>
void gather_typed(const T* src, T* dst, const int64_t* idx, int64_t n,
                  int64_t n_src, int n_threads, std::atomic<int>* err) {
  parallel_for(n, n_threads, [=](int64_t begin, int64_t end) {
    for (int64_t i = begin; i < end; ++i) {
      int64_t j = idx[i];
      if (static_cast<uint64_t>(j) >= static_cast<uint64_t>(n_src)) {
        err->store(1, std::memory_order_relaxed);
        return;
      }
      dst[i] = src[j];
    }
  });
}

void gather_bytes(const uint8_t* src, uint8_t* dst, const int64_t* idx,
                  int64_t n, int64_t itemsize, int64_t n_src, int n_threads,
                  std::atomic<int>* err) {
  parallel_for(n, n_threads, [=](int64_t begin, int64_t end) {
    for (int64_t i = begin; i < end; ++i) {
      int64_t j = idx[i];
      if (static_cast<uint64_t>(j) >= static_cast<uint64_t>(n_src)) {
        err->store(1, std::memory_order_relaxed);
        return;
      }
      std::memcpy(dst + i * itemsize, src + j * itemsize, itemsize);
    }
  });
}

// Which part of a concat logical row j lives in, for rsdl_take_multi.
// The part of each 1024-row block's first row is tabled once per call; a
// row's part is its block's, or past a part boundary inside the block one
// of the next (empty parts are stepped over). Per row that is a table
// load and a compare that is almost never taken, where a binary search
// over the part offsets mispredicts its compares on a random permutation
// (on the 8-core host of an H100 machine it made the fused gather twice as
// slow as numpy's concat and take, at the Quick-start reducer's 8 parts
// and 125,000 rows).
class PartIndex {
 public:
  PartIndex(const int64_t* row_offsets, int64_t n_parts)
      : offsets_(row_offsets) {
    int64_t n_total = row_offsets[n_parts];
    block_part_.resize((n_total >> kBlockShift) + 1);
    int64_t p = 0;
    for (size_t b = 0; b < block_part_.size(); ++b) {
      int64_t row = static_cast<int64_t>(b) << kBlockShift;
      while (p + 1 < n_parts && row_offsets[p + 1] <= row) ++p;
      block_part_[b] = p;
    }
  }
  // j must lie in [0, row_offsets[n_parts]).
  int64_t operator()(int64_t j) const {
    int64_t p = block_part_[j >> kBlockShift];
    while (j >= offsets_[p + 1]) ++p;
    return p;
  }

 private:
  static constexpr int kBlockShift = 10;
  const int64_t* offsets_;
  std::vector<int64_t> block_part_;
};

// Typed concat+gather inner loop for rsdl_take_multi (plain indexed
// load/store instead of a per-row variable-size memcpy). Bounds are
// checked INLINE against the concat's total row count — like
// gather_typed, the compare is well-predicted and free next to the
// random part lookup, where the old Python idx.min()/idx.max() pre-scan
// cost two full single-threaded passes per call.
template <typename T>
void take_multi_typed(const void** parts, const int64_t* row_offsets,
                      int64_t n_parts, T* out, const int64_t* idx,
                      int64_t n, int n_threads, std::atomic<int>* err) {
  int64_t n_total = row_offsets[n_parts];
  PartIndex index(row_offsets, n_parts);
  const PartIndex* part_of = &index;
  parallel_for(n, n_threads, [=](int64_t begin, int64_t end) {
    for (int64_t i = begin; i < end; ++i) {
      int64_t j = idx[i];
      if (static_cast<uint64_t>(j) >= static_cast<uint64_t>(n_total)) {
        err->store(1, std::memory_order_relaxed);
        return;
      }
      int64_t p = (*part_of)(j);
      out[i] = static_cast<const T*>(parts[p])[j - row_offsets[p]];
    }
  });
}

// Typed scatter inner loop for rsdl_scatter (dst[idx[i]] = src[i]),
// bounds-checked inline like gather_typed.
template <typename T>
void scatter_typed(const T* src, T* dst, const int64_t* idx, int64_t n,
                   int64_t n_dst, int n_threads, std::atomic<int>* err) {
  parallel_for(n, n_threads, [=](int64_t begin, int64_t end) {
    for (int64_t i = begin; i < end; ++i) {
      int64_t j = idx[i];
      if (static_cast<uint64_t>(j) >= static_cast<uint64_t>(n_dst)) {
        err->store(1, std::memory_order_relaxed);
        return;
      }
      dst[j] = src[i];
    }
  });
}

// Thread-range decomposition shared by the group plan and scatter
// passes; must be identical in both or cursors and ranges disagree.
inline int64_t group_chunk(int64_t n, int n_threads) {
  return (n + n_threads - 1) / n_threads;
}

// Typed per-range stable group scatter (pass 2 inner loop).
template <typename T>
void group_scatter_typed(const T* in, T* out, const int32_t* assignment,
                         int64_t begin, int64_t end, int64_t* cur) {
  for (int64_t i = begin; i < end; ++i) out[cur[assignment[i]]++] = in[i];
}

}  // namespace

extern "C" {

// dst[i] = src[idx[i]] for n rows of `itemsize` bytes each; `n_src` is
// the source row count for the inline bounds check. Returns 0, or 1 if
// any index fell outside [0, n_src) — dst contents are then unspecified
// and the caller must re-derive numpy semantics (raise / negative-index
// fallback).
int rsdl_take(const void* src, void* dst, const int64_t* idx, int64_t n,
              int64_t itemsize, int64_t n_src, int n_threads) {
  std::atomic<int> err{0};
  switch (itemsize) {
    case 1:
      gather_typed(static_cast<const uint8_t*>(src),
                   static_cast<uint8_t*>(dst), idx, n, n_src, n_threads,
                   &err);
      break;
    case 2:
      gather_typed(static_cast<const uint16_t*>(src),
                   static_cast<uint16_t*>(dst), idx, n, n_src, n_threads,
                   &err);
      break;
    case 4:
      gather_typed(static_cast<const uint32_t*>(src),
                   static_cast<uint32_t*>(dst), idx, n, n_src, n_threads,
                   &err);
      break;
    case 8:
      gather_typed(static_cast<const uint64_t*>(src),
                   static_cast<uint64_t*>(dst), idx, n, n_src, n_threads,
                   &err);
      break;
    default:
      gather_bytes(static_cast<const uint8_t*>(src),
                   static_cast<uint8_t*>(dst), idx, n, itemsize, n_src,
                   n_threads, &err);
  }
  return err.load();
}

// Fused concat + gather across parts: logical row j lives in part p where
// row_offsets[p] <= j < row_offsets[p+1]; dst[i] = parts[p(idx[i])][...].
// This is the reduce-stage hot path — the reference materializes
// pd.concat(parts) first and then permutes (shuffle.py:192-194); fusing
// halves the memory traffic. Element widths 1/2/4/8 get a typed inner
// loop (a plain indexed load/store — take_multi_typed above); after
// 32-bit decode narrowing EVERY column is 4 bytes wide, and the per-row
// variable-size memcpy was the measured hot spot of the whole reduce
// stage (BENCHLOG 2026-08-03). Returns 0, or 1 if any index fell
// outside [0, row_offsets[n_parts]) — dst contents are then unspecified
// and the wrapper re-derives exact numpy semantics off the hot path
// (the same contract as rsdl_take/rsdl_scatter).
int rsdl_take_multi(const void** parts, const int64_t* row_offsets,
                    int64_t n_parts, void* dst, const int64_t* idx,
                    int64_t n, int64_t itemsize, int n_threads) {
  std::atomic<int> err{0};
  switch (itemsize) {
    case 1:
      take_multi_typed(parts, row_offsets, n_parts,
                       static_cast<uint8_t*>(dst), idx, n, n_threads, &err);
      return err.load();
    case 2:
      take_multi_typed(parts, row_offsets, n_parts,
                       static_cast<uint16_t*>(dst), idx, n, n_threads, &err);
      return err.load();
    case 4:
      take_multi_typed(parts, row_offsets, n_parts,
                       static_cast<uint32_t*>(dst), idx, n, n_threads, &err);
      return err.load();
    case 8:
      take_multi_typed(parts, row_offsets, n_parts,
                       static_cast<uint64_t*>(dst), idx, n, n_threads, &err);
      return err.load();
  }
  int64_t n_total = row_offsets[n_parts];
  PartIndex index(row_offsets, n_parts);
  const PartIndex* part_of = &index;
  parallel_for(n, n_threads, [=, &err](int64_t begin, int64_t end) {
    uint8_t* out = static_cast<uint8_t*>(dst);
    for (int64_t i = begin; i < end; ++i) {
      int64_t j = idx[i];
      if (static_cast<uint64_t>(j) >= static_cast<uint64_t>(n_total)) {
        err.store(1, std::memory_order_relaxed);
        return;
      }
      int64_t p = (*part_of)(j);
      const uint8_t* src = static_cast<const uint8_t*>(parts[p]);
      std::memcpy(out + i * itemsize,
                  src + (j - row_offsets[p]) * itemsize, itemsize);
    }
  });
  return err.load();
}

// Narrowing casts used at staging time (the device batch is 32-bit; the
// disk schema is 64-bit).
void rsdl_cast_i64_i32(const int64_t* src, int32_t* dst, int64_t n,
                       int n_threads) {
  parallel_for(n, n_threads, [=](int64_t begin, int64_t end) {
    for (int64_t i = begin; i < end; ++i)
      dst[i] = static_cast<int32_t>(src[i]);
  });
}

void rsdl_cast_f64_f32(const double* src, float* dst, int64_t n,
                       int n_threads) {
  parallel_for(n, n_threads, [=](int64_t begin, int64_t end) {
    for (int64_t i = begin; i < end; ++i)
      dst[i] = static_cast<float>(src[i]);
  });
}

// Range-checked narrowing cast for the decode-time narrow_to_32 path:
// one fused pass instead of numpy's three (max scan, min scan, astype).
// Returns 1 when every value fit int32, 0 if any overflowed (dst contents
// are then unspecified and the caller must raise instead of using them).
int rsdl_cast_i64_i32_checked(const int64_t* src, int32_t* dst, int64_t n,
                              int n_threads) {
  std::atomic<int> ok{1};
  parallel_for(n, n_threads, [=, &ok](int64_t begin, int64_t end) {
    for (int64_t i = begin; i < end; ++i) {
      int64_t v = src[i];
      if (v > INT32_MAX || v < INT32_MIN) {
        ok.store(0, std::memory_order_relaxed);
        return;  // this thread's remaining range is moot
      }
      dst[i] = static_cast<int32_t>(v);
    }
  });
  return ok.load();
}

// Scatter: dst[idx[i]] = src[i] — the write-side inverse of rsdl_take.
// The reduce stage's overlapped path lands each arriving partition window
// at its permuted output rows through this (idx = inv_perm[lo:hi]), so
// the per-window placement uses every core while later windows are still
// in flight over DCN. idx values MUST be unique (a permutation slice):
// duplicate destinations would race across threads — the Python wrapper
// only routes permutation-derived indices here. Bounds checked inline
// against n_dst like rsdl_take; returns 0 ok / 1 out-of-range.
int rsdl_scatter(const void* src, void* dst, const int64_t* idx, int64_t n,
                 int64_t itemsize, int64_t n_dst, int n_threads) {
  std::atomic<int> err{0};
  switch (itemsize) {
    case 1:
      scatter_typed(static_cast<const uint8_t*>(src),
                    static_cast<uint8_t*>(dst), idx, n, n_dst, n_threads,
                    &err);
      return err.load();
    case 2:
      scatter_typed(static_cast<const uint16_t*>(src),
                    static_cast<uint16_t*>(dst), idx, n, n_dst, n_threads,
                    &err);
      return err.load();
    case 4:
      scatter_typed(static_cast<const uint32_t*>(src),
                    static_cast<uint32_t*>(dst), idx, n, n_dst, n_threads,
                    &err);
      return err.load();
    case 8:
      scatter_typed(static_cast<const uint64_t*>(src),
                    static_cast<uint64_t*>(dst), idx, n, n_dst, n_threads,
                    &err);
      return err.load();
  }
  const uint8_t* in = static_cast<const uint8_t*>(src);
  uint8_t* out = static_cast<uint8_t*>(dst);
  parallel_for(n, n_threads, [=, &err](int64_t begin, int64_t end) {
    for (int64_t i = begin; i < end; ++i) {
      int64_t j = idx[i];
      if (static_cast<uint64_t>(j) >= static_cast<uint64_t>(n_dst)) {
        err.store(1, std::memory_order_relaxed);
        return;
      }
      std::memcpy(out + j * itemsize, in + i * itemsize, itemsize);
    }
  });
  return err.load();
}

// ---------------------------------------------------------------------------
// Parallel stable group-by scatter (two-pass).
//
// The serial rsdl_group_rows below is inherently sequential — the running
// cursors define the stable order — so the classic parallelization is:
//
//   pass 1: split [0, n) into n_threads CONTIGUOUS ranges; each thread
//           histograms its range's group counts;
//   plan:   an exclusive prefix-sum over (thread, group) — thread t's
//           write cursor for group g starts at
//           group_start[g] + sum_{t' < t} hist[t'][g],
//           giving every (thread, group) pair a disjoint output span;
//   pass 2: each thread scatters its contiguous input range through its
//           own cursors — no atomics, no sharing.
//
// Stability is preserved because thread ranges are contiguous in input
// order and the prefix-sum orders their spans by thread id: within any
// group, rows from range t precede rows from range t+1, and within one
// range the serial loop keeps input order. The output is therefore
// BIT-IDENTICAL to the serial kernel (tested).
//
// The plan is computed ONCE per batch (rsdl_group_plan) and reused for
// every column (rsdl_group_rows_mt copies the cursor table per call —
// n_threads * n_groups int64s, trivial next to the row data).

// cursors: caller-allocated [n_threads * n_groups] int64. group_starts:
// each group's first output row (the Python-side cumsum of the bincount).
void rsdl_group_plan(const int32_t* assignment, int64_t n, int64_t n_groups,
                     int n_threads, const int64_t* group_starts,
                     int64_t* cursors) {
  int64_t chunk = group_chunk(n, n_threads);
  // Pass 1: per-thread-range histograms. Counted in a THREAD-LOCAL
  // buffer and copied out once: adjacent threads' rows of `cursors` can
  // share cache lines (8 groups x 8 B is exactly one line), and counting
  // directly into them ping-pongs those lines between cores badly enough
  // to erase the whole parallel win (measured 0.78x at the bench shape).
  {
    std::vector<std::thread> threads;
    threads.reserve(n_threads);
    for (int t = 0; t < n_threads; ++t) {
      int64_t begin = std::min<int64_t>(n, t * chunk);
      int64_t end = std::min<int64_t>(n, begin + chunk);
      int64_t* hist = cursors + int64_t(t) * n_groups;
      threads.emplace_back([=] {
        std::vector<int64_t> local(n_groups, 0);
        for (int64_t i = begin; i < end; ++i) ++local[assignment[i]];
        std::memcpy(hist, local.data(), sizeof(int64_t) * n_groups);
      });
    }
    for (auto& th : threads) th.join();
  }
  // Plan: exclusive prefix-sum down each group's column of the
  // (thread, group) histogram, offset by the group's global start.
  for (int64_t g = 0; g < n_groups; ++g) {
    int64_t run = group_starts[g];
    for (int t = 0; t < n_threads; ++t) {
      int64_t count = cursors[int64_t(t) * n_groups + g];
      cursors[int64_t(t) * n_groups + g] = run;
      run += count;
    }
  }
}

// Pass 2: the parallel scatter itself, over the WHOLE batch of columns
// in one call — threads spawn once per batch, not once per column (at
// the bench shape a per-column spawn cost ~5-10% of the scatter
// itself). `cursors` is the CONST plan from rsdl_group_plan; each
// (thread, column) works on a private copy so one plan serves every
// column.
void rsdl_group_rows_multi_mt(const void** srcs, void** dsts,
                              const int64_t* itemsizes, int64_t n_cols,
                              const int32_t* assignment, int64_t n,
                              const int64_t* cursors, int n_threads,
                              int64_t n_groups) {
  int64_t chunk = group_chunk(n, n_threads);
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) {
    int64_t begin = std::min<int64_t>(n, t * chunk);
    int64_t end = std::min<int64_t>(n, begin + chunk);
    const int64_t* plan = cursors + int64_t(t) * n_groups;
    threads.emplace_back([=] {
      std::vector<int64_t> cur(n_groups);
      for (int64_t c = 0; c < n_cols; ++c) {
        std::copy(plan, plan + n_groups, cur.begin());
        const void* src = srcs[c];
        void* dst = dsts[c];
        switch (itemsizes[c]) {
          case 1:
            group_scatter_typed(static_cast<const uint8_t*>(src),
                                static_cast<uint8_t*>(dst), assignment,
                                begin, end, cur.data());
            continue;
          case 2:
            group_scatter_typed(static_cast<const uint16_t*>(src),
                                static_cast<uint16_t*>(dst), assignment,
                                begin, end, cur.data());
            continue;
          case 4:
            group_scatter_typed(static_cast<const uint32_t*>(src),
                                static_cast<uint32_t*>(dst), assignment,
                                begin, end, cur.data());
            continue;
          case 8:
            group_scatter_typed(static_cast<const uint64_t*>(src),
                                static_cast<uint64_t*>(dst), assignment,
                                begin, end, cur.data());
            continue;
        }
        int64_t itemsize = itemsizes[c];
        const uint8_t* in = static_cast<const uint8_t*>(src);
        uint8_t* out = static_cast<uint8_t*>(dst);
        for (int64_t i = begin; i < end; ++i) {
          std::memcpy(out + cur[assignment[i]]++ * itemsize,
                      in + i * itemsize, itemsize);
        }
      }
    });
  }
  for (auto& th : threads) th.join();
}

// Stable group-by-key scatter: given assignment[i] in [0, n_groups), write
// rows grouped by key preserving input order (the map-stage partitioner).
// Equivalent to argsort(kind=stable)+gather but single-pass O(n).
// `offsets` holds each group's running write cursor (start offsets on
// entry, end offsets on return) — the caller computes it once per batch
// and passes a fresh copy per column, so the histogram pass is not
// repeated for every column. No bounds checks: the Python wrapper
// validates the assignment range before calling. This serial kernel is
// the reference the parallel rsdl_group_plan/rsdl_group_rows_mt pair
// must match bit-for-bit; the wrapper picks per call by thread count.
void rsdl_group_rows(const void* src, void* dst, const int32_t* assignment,
                     int64_t n, int64_t itemsize, int64_t* offsets) {
  // Typed scatters for the common element widths: the loop is inherently
  // serial (the running cursors define the stable order), so the only
  // lever is making each row a plain indexed store. With 32-bit decode
  // narrowing on, every column hits the 4-byte case — the map stage's
  // hottest op (measured: the per-row memcpy path ran ~2x slower,
  // BENCHLOG 2026-08-03).
  switch (itemsize) {
    case 1: {
      const uint8_t* in1 = static_cast<const uint8_t*>(src);
      uint8_t* out1 = static_cast<uint8_t*>(dst);
      for (int64_t i = 0; i < n; ++i) out1[offsets[assignment[i]]++] = in1[i];
      return;
    }
    case 2: {
      const uint16_t* in2 = static_cast<const uint16_t*>(src);
      uint16_t* out2 = static_cast<uint16_t*>(dst);
      for (int64_t i = 0; i < n; ++i) out2[offsets[assignment[i]]++] = in2[i];
      return;
    }
    case 4: {
      const uint32_t* in4 = static_cast<const uint32_t*>(src);
      uint32_t* out4 = static_cast<uint32_t*>(dst);
      for (int64_t i = 0; i < n; ++i) out4[offsets[assignment[i]]++] = in4[i];
      return;
    }
    case 8: {
      const uint64_t* in8 = static_cast<const uint64_t*>(src);
      uint64_t* out8 = static_cast<uint64_t*>(dst);
      for (int64_t i = 0; i < n; ++i) out8[offsets[assignment[i]]++] = in8[i];
      return;
    }
  }
  const uint8_t* in = static_cast<const uint8_t*>(src);
  uint8_t* out = static_cast<uint8_t*>(dst);
  for (int64_t i = 0; i < n; ++i) {
    std::memcpy(out + offsets[assignment[i]]++ * itemsize,
                in + i * itemsize, itemsize);
  }
}

int rsdl_abi_version() { return 5; }

}  // extern "C"
