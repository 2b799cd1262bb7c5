// SGM path-cost aggregation on Hopper (sm_90a), bound with ctypes from
// smvs_tpu_torch/sgm/cuda_agg.py.
//
// Replaces all five TPU kernels of smvs_tpu/sgm/pallas_agg.py:
//   1. _fused_kernel, reached through _fused_pass (pallas_agg.py:137-194,
//      call at :288): one forward or reverse sweep of 1 path (straight) or
//      3 paths (straight and both diagonals) added into an accumulator;
//   2. _fused_kernel_batch, reached through _fused_pass_batch
//      (pallas_agg.py:413-452, call at :488): the same sweep over B problems;
//   3. _fused_kernel_bidir, reached through _fused_pass_bidir
//      (pallas_agg.py:302-402, call at :389): the forward and the backward
//      sweep in one walk, returning acc + forward + backward;
//   4. _fused_kernel_loop, reached through _fused_pass(loop=True)
//      (pallas_agg.py:197-235, call at :288): row 1's result in fori_loop
//      form;
//   5. _scan_kernel, reached through scan_direction (pallas_agg.py:40-117,
//      call at :99): one path in one direction over an int32 [L, X, D]
//      volume scanned along axis 1, written out (not accumulated).
//
// Recurrence, per line and depth d (int32 arithmetic):
//   new[d] = cost[d] + min(prev[d], prev[d-1] + P1, prev[d+1] + P1,
//                          min(prev) + P2a) - min(prev)
//   P2a    = max(P1*3/2, P2 / (|I(pos) - I(prev pos on the path)| + 1))
// A path restarts from the raw cost at the start of the scan and, for a
// diagonal, where it enters through the border line.
//
// Design. One warp walks one chain of one problem along the scan axis:
// a straight chain is a line; a diagonal chain walks (x, l0 + s*k) from
// x = 0 or from the border line where the TPU kernel forced BIG (which
// makes the update return the raw cost), so no two blocks ever share a
// carried line and no cross-block synchronisation is needed. The D depths
// of a position sit in registers across the 32 lanes (K = ceil(D/32) per
// lane, 4 at D = 128); prev[d +- 1] across lanes come from
// __shfl_up/down_sync and min(prev) from a butterfly reduction. Depths
// d >= D hold BIG and take no part in a neighbour; costs stay below
// BIG - P2, so they never win a min either. P2a is computed in the kernel
// from the int32 intensities of the current and the previous chain
// position. Each launch handles one path, in one direction (rows 1, 2, 4,
// 5) or in both (row 3: the first half of the warps walks forward and
// read-modify-writes `out_f`, the second half walks backward into the
// separate `out_b`, so the two never touch one element; the caller adds
// `out_b` into `out_f` once after the last path). Chains of one launch are
// disjoint, so no atomics. The storage type is a template parameter:
// int16 for rows 1-4, int32 for row 5, whose costs exceed int16. Rows 1-4
// add into their output, row 5 writes the path cost itself. The next
// position's cost and accumulator are loaded one step ahead, since they do
// not depend on the recurrence. Scan, line and problem strides are
// arguments, so a horizontal sweep, and row 5's scan along axis 1, need no
// transposed copy.
//
// Bound on the H100 (3.35 TB/s): one aggregate_batch at the main path's
// shape, B=2 x 1440 x 1696 x 128, must read the int16 cost volume once
// (1.25 GB) and write the int16 8-path sum once (1.25 GB): 2.5 GB, 0.75 ms.
// NVIDIA's data sheet gives no peak rate for integer min and add work, so
// the bound is the bytes. That work is of the same order: at least about 3
// instructions per element and path in Hopper's 16x2 DPX forms (path costs
// fit in 16 bits), 16 G for the 8 paths, 0.5 to 1 ms at one or two such
// instructions per int32 lane (64 per SM) and clock. This kernel issues
// about 10 int32 instructions per element and path (about 3 ms at one per
// lane and clock), and it reads the cost and reads and writes the
// accumulator in each of the 8 launches (30 GB, about 9 ms at peak
// bandwidth): it trades 12x the bytes for one carried line per warp and no
// shared memory. Row 3 halves the launches of a single-problem aggregate
// (4 instead of 8) and doubles the chains in flight per launch, at the
// cost of one extra int16 volume and one elementwise add per sweep.
// Fusing the 3 paths of a vertical sweep into one launch is the next step
// towards the bound.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBig = 1 << 24;
constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

// Loads depths [d0, d0 + K) of one position; depths >= D read as 0.
template <typename T, int K>
__device__ __forceinline__ void load_k(const T* p, int (&v)[K], int d0, int D,
                                       bool vec) {
  if (vec && d0 + K <= D) {
    if constexpr (sizeof(T) == 2 && K == 4) {
      const short4 s = *reinterpret_cast<const short4*>(p);
      v[0] = s.x;
      v[1] = s.y;
      v[2] = s.z;
      v[3] = s.w;
      return;
    } else if constexpr (sizeof(T) == 2 && K == 2) {
      const short2 s = *reinterpret_cast<const short2*>(p);
      v[0] = s.x;
      v[1] = s.y;
      return;
    } else if constexpr (sizeof(T) == 4 && K == 4) {
      const int4 s = *reinterpret_cast<const int4*>(p);
      v[0] = s.x;
      v[1] = s.y;
      v[2] = s.z;
      v[3] = s.w;
      return;
    } else if constexpr (sizeof(T) == 4 && K == 2) {
      const int2 s = *reinterpret_cast<const int2*>(p);
      v[0] = s.x;
      v[1] = s.y;
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = (d0 + k < D) ? static_cast<int>(p[k]) : 0;
}

// Stores depths [d0, d0 + K) of one position; depths >= D are skipped.
template <typename T, int K>
__device__ __forceinline__ void store_k(T* p, const int (&v)[K], int d0, int D,
                                        bool vec) {
  if (vec && d0 + K <= D) {
    if constexpr (sizeof(T) == 2 && K == 4) {
      short4 s;
      s.x = static_cast<short>(v[0]);
      s.y = static_cast<short>(v[1]);
      s.z = static_cast<short>(v[2]);
      s.w = static_cast<short>(v[3]);
      *reinterpret_cast<short4*>(p) = s;
      return;
    } else if constexpr (sizeof(T) == 2 && K == 2) {
      short2 s;
      s.x = static_cast<short>(v[0]);
      s.y = static_cast<short>(v[1]);
      *reinterpret_cast<short2*>(p) = s;
      return;
    } else if constexpr (sizeof(T) == 4 && K == 4) {
      *reinterpret_cast<int4*>(p) = make_int4(v[0], v[1], v[2], v[3]);
      return;
    } else if constexpr (sizeof(T) == 4 && K == 2) {
      *reinterpret_cast<int2*>(p) = make_int2(v[0], v[1]);
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (d0 + k < D) p[k] = static_cast<T>(v[k]);
}

// kAdd: out += path (rows 1-4); otherwise out = path (row 5).
template <typename T, int K, bool kAdd>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    sgm_path_kernel(const T* __restrict__ cost,
                    const int32_t* __restrict__ inten, T* __restrict__ out_f,
                    T* __restrict__ out_b, int B, int X, int L, int D,
                    long long vb, long long vx, long long vl, long long ib,
                    long long ix, long long il, int dirs, int reverse,
                    int shift, int p1, int p2, bool vec) {
  const int lane = threadIdx.x & 31;
  const long long n_chains = shift ? static_cast<long long>(L) + X - 1
                                   : static_cast<long long>(L);
  const long long per_dir = static_cast<long long>(B) * n_chains;
  long long warp =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (warp >= dirs * per_dir) return;  // whole warp
  // With dirs == 2 the second half of the warps walks the reverse sweep
  // into out_b.
  const bool second = warp >= per_dir;
  if (second) warp -= per_dir;
  const bool rev = dirs == 2 ? second : reverse != 0;
  const long long b = warp / n_chains;
  const long long c = warp - b * n_chains;

  // Chain start: scan step 0 on line c, or the border line at step c-L+1.
  int t = 0;
  int l;
  if (c < L) {
    l = static_cast<int>(c);
  } else {
    t = static_cast<int>(c - L + 1);
    l = shift > 0 ? 0 : L - 1;
  }
  const T* cb = cost + b * vb;
  T* ob = (second ? out_b : out_f) + b * vb;
  const int32_t* ibase = inten + b * ib;
  const int p2min = p1 * 3 / 2;
  const int d0 = lane * K;

  int x = rev ? X - 1 - t : t;
  long long off = x * vx + l * vl + d0;
  int cur[K], av[K];
  load_k<T, K>(cb + off, cur, d0, D, vec);
  if constexpr (kAdd) load_k<T, K>(ob + off, av, d0, D, vec);
  int it = ibase[x * ix + l * il];

  int prev[K];
  int prev_i = 0;
  bool first = true;
  while (true) {
    // Prefetch the next chain position (independent of the recurrence).
    const int tn = t + 1;
    const int ln = l + shift;
    const bool more = tn < X && ln >= 0 && ln < L;
    int ncur[K], nav[K];
    int nit = 0;
    long long noff = 0;
    if (more) {
      const int xn = rev ? X - 1 - tn : tn;
      noff = xn * vx + ln * vl + d0;
      load_k<T, K>(cb + noff, ncur, d0, D, vec);
      if constexpr (kAdd) load_k<T, K>(ob + noff, nav, d0, D, vec);
      nit = ibase[xn * ix + ln * il];
    }

    int nv[K];
    if (first) {
#pragma unroll
      for (int k = 0; k < K; ++k) nv[k] = cur[k];
      first = false;
    } else {
      int m = prev[0];
#pragma unroll
      for (int k = 1; k < K; ++k) m = min(m, prev[k]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) m = min(m, __shfl_xor_sync(kFull, m, o));
      int left = __shfl_up_sync(kFull, prev[K - 1], 1);    // prev[d0 - 1]
      int right = __shfl_down_sync(kFull, prev[0], 1);     // prev[d0 + K]
      if (lane == 0) left = kBig;
      if (lane == 31) right = kBig;
      const int p2a = max(p2min, p2 / (abs(it - prev_i) + 1));
      const int mp = m + p2a;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int dn = k == 0 ? left : prev[k - 1];
        const int up = k == K - 1 ? right : prev[k + 1];
        const int upd = min(min(prev[k], min(up, dn) + p1), mp);
        nv[k] = cur[k] + upd - m;
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (d0 + k >= D) nv[k] = kBig;
      prev[k] = nv[k];
      if constexpr (kAdd) av[k] += nv[k];
    }
    if constexpr (kAdd) {
      store_k<T, K>(ob + off, av, d0, D, vec);
    } else {
      store_k<T, K>(ob + off, nv, d0, D, vec);
    }
    prev_i = it;
    if (!more) break;
    t = tn;
    l = ln;
    off = noff;
    it = nit;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      cur[k] = ncur[k];
      if constexpr (kAdd) av[k] = nav[k];
    }
  }
}

template <typename T, int K, bool kAdd>
cudaError_t launch(const void* cost, const void* inten, void* out_f,
                   void* out_b, int B, int X, int L, int D, long long vb,
                   long long vx, long long vl, long long ib, long long ix,
                   long long il, int dirs, int reverse, int shift, int p1,
                   int p2, cudaStream_t stream) {
  // Vector loads need every position's depth run aligned to K elements.
  const uintptr_t align = sizeof(T) * K;
  const bool vec = (K == 2 || K == 4) && D % K == 0 && vb % K == 0 &&
                   vx % K == 0 && vl % K == 0 &&
                   reinterpret_cast<uintptr_t>(cost) % align == 0 &&
                   reinterpret_cast<uintptr_t>(out_f) % align == 0 &&
                   (dirs == 1 || reinterpret_cast<uintptr_t>(out_b) % align == 0);
  const long long n_chains =
      shift ? static_cast<long long>(L) + X - 1 : static_cast<long long>(L);
  const long long warps = static_cast<long long>(dirs) * B * n_chains;
  const long long blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  sgm_path_kernel<T, K, kAdd>
      <<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0, stream>>>(
          static_cast<const T*>(cost), static_cast<const int32_t*>(inten),
          static_cast<T*>(out_f), static_cast<T*>(out_b), B, X, L, D, vb, vx,
          vl, ib, ix, il, dirs, reverse, shift, p1, p2, vec);
  return cudaGetLastError();
}

template <typename T, bool kAdd>
cudaError_t launch_k(const void* cost, const void* inten, void* out_f,
                     void* out_b, int B, int X, int L, int D, long long vb,
                     long long vx, long long vl, long long ib, long long ix,
                     long long il, int dirs, int reverse, int shift, int p1,
                     int p2, cudaStream_t s) {
  switch ((D + 31) / 32) {
    case 1: return launch<T, 1, kAdd>(cost, inten, out_f, out_b, B, X, L, D, vb, vx, vl, ib, ix, il, dirs, reverse, shift, p1, p2, s);
    case 2: return launch<T, 2, kAdd>(cost, inten, out_f, out_b, B, X, L, D, vb, vx, vl, ib, ix, il, dirs, reverse, shift, p1, p2, s);
    case 3: return launch<T, 3, kAdd>(cost, inten, out_f, out_b, B, X, L, D, vb, vx, vl, ib, ix, il, dirs, reverse, shift, p1, p2, s);
    default: return launch<T, 4, kAdd>(cost, inten, out_f, out_b, B, X, L, D, vb, vx, vl, ib, ix, il, dirs, reverse, shift, p1, p2, s);
  }
}

}  // namespace

// One path of B problems, in one direction (dirs = 1, `reverse` picks it)
// or in both (dirs = 2: forward into out_f, backward into out_b).
// elem_bytes = 2 with add = 1: int16 volumes, out += path costs, in place
// (rows 1-4). elem_bytes = 4 with add = 0: int32 volumes, out = path costs
// (row 5). cost/out: depth stride 1 and element strides (vb, vx, vl) for
// problem, scan position and line; inten: int32 with strides (ib, ix, il).
// shift is 0 (straight) or +-1 (diagonal: the line index moves by shift per
// scan step). Returns the cudaError_t of the launch.
extern "C" int sgm_agg_path(const void* cost, const void* inten, void* out_f,
                            void* out_b, int elem_bytes, int add, int B,
                            int X, int L, int D, long long vb, long long vx,
                            long long vl, long long ib, long long ix,
                            long long il, int dirs, int reverse, int shift,
                            int p1, int p2, void* stream) {
  if (B < 1 || X < 1 || L < 1 || D < 1 || D > 128 || shift < -1 ||
      shift > 1 || dirs < 1 || dirs > 2 || (dirs == 2 && out_b == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 2 && add)
    return static_cast<int>(launch_k<int16_t, true>(
        cost, inten, out_f, out_b, B, X, L, D, vb, vx, vl, ib, ix, il, dirs,
        reverse, shift, p1, p2, s));
  if (elem_bytes == 4 && !add)
    return static_cast<int>(launch_k<int32_t, false>(
        cost, inten, out_f, out_b, B, X, L, D, vb, vx, vl, ib, ix, il, dirs,
        reverse, shift, p1, p2, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
