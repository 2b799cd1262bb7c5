// The rectified SGM sweep's census and Hamming cost volume on Hopper
// (sm_90a), bound with ctypes from smvs_tpu_torch/sgm/cuda_cost.py. Two
// kernels.
//
// They replace no TPU kernel: the JAX package builds the cost volume with
// XLA (smvs_tpu/sgm/stereo.py: census_transform, _disparity_cost), and the
// port's plain PyTorch twin (sgm/stereo.py: plain_census_transform,
// plain_disparity_cost) runs it as about 300 eager ops a chunk of 8 planes
// on int64 temporaries. Both kernels give the twin's bits.
//
// census_kernel: the 9 x 7 census of a batch of [H, W] float32 images
// into int64 words, one launch for the whole batch. Bit order as the
// reference's (x-major over the window, the first comparison in the most
// significant of the 63 bits), 0 on the border band (x < 4, x >= W - 5,
// y < 3, y >= H - 4) and where the pixel is 0. A block stages its 32 x 8
// pixels and their window in shared memory; a thread takes one pixel.
//
// census_cost_kernel: the whole cost volume of one direction of a
// rectified pair in one launch. For plane d of D, with s = shifts[d]:
//   si = floor(s), a = s - si (float32), o = clamp(P - si, 1, P + wn) - P
//   with P = w + wn; t0 = nbr[y, x + o], t1 = nbr[y, x + o - 1] (0 off the
//   image); blend = float(double(1 - a) * t0 + double(a * t1)), the
//   rounding of iops.fma (a * t1 a float32 product, 1 - a in float32);
//   warped = blend where t0 != 0 and t1 != 0, else 0;
//   cost = popcount(main census ^ census of warped), 255 where warped is 0,
// stored as int16 into out[y, x, d] at the strides given (the rectified
// path's vol[0, :, :w] has a row stride of wn * D).
//
// Bound: the int16 volume written, h * w * D * 2 bytes, 0.16 ms at
// [1440, 1440, 128] and 3.35 TB/s, is far below the work: 63 comparisons
// a pixel and plane, two instructions each (a subtraction and a funnel
// shift, lt_sign), about 75 G instructions for both directions of a 1440
// x 1440 pair, some 2.5-3 ms of issue on 132 SMs. So the design spends
// no instruction it can avoid and reads device memory almost never:
// - a block owns a tile of 32 x 32 pixels (a lane a column, a thread 8
//   rows of it) and walks the planes of its group (all D where the tiles
//   fill the card; split into groups of 16-plane chunks across blocks
//   where they do not);
// - the neighbor rows its window needs (tile rows - 3 .. + 3) sit in
//   shared memory over a column window of `cap` columns; it is loaded
//   once for as many of the coming planes as it spans (read ahead from
//   shifts), so a sweep whose disparity span fits loads it once, and a
//   wider or unordered one reloads it where a plane leaves it;
// - each plane's blended tile (38 x 40) is formed once from that copy into
//   one of two shared buffers (one block barrier a plane), and each
//   thread reads its 9 columns of 14 values into registers and compares
//   them with its 8 centres, building the census as two 32-bit halves (31
//   bits and 32, as the JAX package packs it) by funnel shifts; the main
//   census stays in registers for the whole walk;
// - costs go to a [pixels x 16 planes] byte tile in shared memory (two,
//   alternating), written out every 16 planes as 16 consecutive int16 a
//   pixel, lanes on consecutive planes.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTW = 32;            // tile columns: one a lane
constexpr int kRows = 8;           // rows a thread: pixels in registers
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTH = kRows * kWarps;  // tile rows
constexpr int kBW = kTW + 8;       // blended tile: 4 columns either side
constexpr int kBH = kTH + 6;       // and 3 rows above and below
constexpr int kDC = 16;            // planes staged before a store
constexpr int kPix = kTW * kTH;
constexpr int kNeed = kTW + 9;     // window columns one plane reads
// The neighbor window's columns: a disparity span of up to kWindow - kNeed
// pixels is loaded once (80 px at 1440 x 1440 with 128 planes), and
// kBlocksPerSM blocks fit an SM's shared memory (74,112 bytes a block,
// smem_bytes); a wider span reloads the window where a plane leaves it.
constexpr int kWindow = 192;
constexpr int kBlocksPerSM = 3;    // census_cost_kernel's launch bounds
constexpr int kInvalid = 255;
constexpr int kCensusW = 32, kCensusH = 8;  // census_kernel's block

// Bit 31 set where c < n, for c != 0 (the census discards c == 0): the
// sign of c - n, one FADD. A difference of two distinct floats is never 0
// with subnormals kept (nvcc's default), so it is negative exactly where
// c < n; the card returns the canonical NaN, sign clear, for NaN and
// inf - inf, so those read "not less" as `<` does. The only disagreement,
// -0 against +0, needs c == 0. An ordered compare (set.lt) compiles to
// FSETP and SEL, one instruction more a bit: 4.29 ms against 2.70 at
// [1440, 1440, 128] on an H100 SXM at 700 W.
__device__ __forceinline__ unsigned lt_sign(float c, float n) {
  return __float_as_uint(__fsub_rn(c, n));
}

// (word << 1) | (sign >> 31): one funnel shift.
__device__ __forceinline__ unsigned push_bit(unsigned word, unsigned sign) {
  return __funnelshift_l(sign, word, 1);
}

// The census of a centre against a window read through at(dx + 4, dy + 3):
// 63 bits, the first 31 into hi, the last 32 into lo.
template <typename At>
__device__ __forceinline__ void census_bits(float c, At at, unsigned& hi,
                                            unsigned& lo) {
  hi = 0;
  lo = 0;
#pragma unroll
  for (int i = 0; i < 9; ++i) {
#pragma unroll
    for (int j = 0; j < 7; ++j) {
      const unsigned m = lt_sign(c, at(i, j));
      if (i * 7 + j < 31)
        hi = push_bit(hi, m);
      else
        lo = push_bit(lo, m);
    }
  }
}

__global__ void __launch_bounds__(kCensusW * kCensusH)
    census_kernel(const float* __restrict__ img,
                  unsigned long long* __restrict__ out, int B, int H, int W) {
  __shared__ float tile[kCensusH + 6][kCensusW + 8];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int x0 = blockIdx.x * kCensusW, y0 = blockIdx.y * kCensusH;
  const int x = x0 + tx, y = y0 + ty;
  for (int b = blockIdx.z; b < B; b += gridDim.z) {
    const float* im = img + static_cast<long long>(b) * H * W;
    for (int e = ty * kCensusW + tx; e < (kCensusH + 6) * (kCensusW + 8);
         e += kCensusW * kCensusH) {
      const int r = e / (kCensusW + 8), c = e % (kCensusW + 8);
      const int yy = y0 - 3 + r, xx = x0 - 4 + c;
      tile[r][c] = (yy >= 0 && yy < H && xx >= 0 && xx < W)
                       ? im[static_cast<long long>(yy) * W + xx]
                       : 0.f;
    }
    __syncthreads();
    if (x < W && y < H) {
      const float c = tile[ty + 3][tx + 4];
      unsigned hi, lo;
      census_bits(c, [&](int i, int j) { return tile[ty + j][tx + i]; }, hi,
                  lo);
      const bool valid =
          x >= 4 && x < W - 5 && y >= 3 && y < H - 4 && c != 0.f;
      out[static_cast<long long>(b) * H * W + static_cast<long long>(y) * W +
          x] = valid ? (static_cast<unsigned long long>(hi) << 32 | lo) : 0ull;
    }
    __syncthreads();
  }
}

struct Plane {
  int o;    // neighbor column of t0 minus the pixel's column
  float a;  // the blend's fraction
};

__device__ __forceinline__ Plane plane_of(const float* __restrict__ shifts,
                                          int d, long long P, int wn) {
  const float s = __ldg(shifts + d);
  const int si = static_cast<int>(floorf(s));
  long long st = P - si;
  st = st < 1 ? 1 : (st > P + wn ? P + wn : st);
  return {static_cast<int>(st - P), __fsub_rn(s, static_cast<float>(si))};
}

// Writes chunk q's staged costs (planes d0 + q * kDC on, n of them).
__device__ __forceinline__ void store_chunk(
    const unsigned char* __restrict__ stage, short* __restrict__ out, int q,
    int n, int d0, int x0, int y0, int h, int w, long long sy, long long sx,
    long long sd) {
  const int dd = threadIdx.x % kDC;
  if (dd >= n) return;
  const unsigned char* s = stage + (q & 1) * kPix * kDC;
  const long long dofs = static_cast<long long>(d0 + q * kDC + dd) * sd;
  for (int p = threadIdx.x / kDC; p < kPix; p += kThreads / kDC) {
    const int y = y0 + p / kTW, x = x0 + p % kTW;
    if (y < h && x < w) out[y * sy + x * sx + dofs] = s[p * kDC + dd];
  }
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    census_cost_kernel(const uint2* __restrict__ mcen,
                       const float* __restrict__ nbr,
                       const float* __restrict__ shifts,
                       short* __restrict__ out, int h, int w, int wn, int D,
                       int group, int cap, long long sy, long long sx,
                       long long sd) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* win = reinterpret_cast<float*>(smem);  // kBH x cap
  float* blend = win + kBH * cap;               // 2 x kBH x kBW
  unsigned char* stage =  // 2 x kPix x kDC
      reinterpret_cast<unsigned char*>(blend + 2 * kBH * kBW);
  const int tid = threadIdx.x, lane = tid & 31;
  const int ry = (tid >> 5) * kRows;  // the thread's first tile row
  const int x0 = blockIdx.x * kTW, y0 = blockIdx.y * kTH;
  const int d0 = blockIdx.z * group, d1 = min(D, d0 + group);
  const long long P = static_cast<long long>(w) + wn;
  const int x = x0 + lane;

  unsigned mhi[kRows], mlo[kRows], interior = 0;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int y = y0 + ry + i;
    uint2 m = make_uint2(0, 0);
    if (y < h && x < w) m = mcen[static_cast<long long>(y) * w + x];
    mlo[i] = m.x;
    mhi[i] = m.y;
    if (x >= 4 && x < w - 5 && y >= 3 && y < h - 4) interior |= 1u << i;
  }

  int wlo = 0;
  bool loaded = false;
  for (int d = d0; d < d1; ++d) {
    const Plane pl = plane_of(shifts, d, P, wn);
    const int need = x0 - 5 + pl.o;  // first window column this plane reads
    if (!loaded || need < wlo || need + kNeed > wlo + cap) {
      // Every thread reads the same shifts, so all take this branch. The
      // window's last reader, the previous plane's blend, ended before
      // that plane's barrier.
      int lo = need, hi = need;
      for (int k = d + 1; k < d1; ++k) {
        const int n = x0 - 5 + plane_of(shifts, k, P, wn).o;
        const int nl = min(lo, n), nh = max(hi, n);
        if (nh - nl + kNeed > cap) break;
        lo = nl;
        hi = nh;
      }
      wlo = lo;
      loaded = true;
      for (int e = tid; e < kBH * cap; e += kThreads) {
        const int r = e / cap, xn = wlo + e % cap;
        const int y = y0 - 3 + r;
        win[e] = (y >= 0 && y < h && xn >= 0 && xn < wn)
                     ? __ldg(nbr + static_cast<long long>(y) * wn + xn)
                     : 0.f;
      }
      __syncthreads();
    }

    // The blended tile: column c is pixel column x0 - 4 + c, whose t0 is
    // window column x0 - 4 + c + o - wlo.
    float* buf = blend + (d & 1) * kBH * kBW;
    const float a = pl.a;
    const double one_a = static_cast<double>(__fsub_rn(1.f, a));
    const int first = x0 - 4 + pl.o - wlo;
    for (int e = tid; e < kBH * kBW; e += kThreads) {
      const int r = e / kBW, c = e % kBW;
      const float* t = win + r * cap + first + c;
      const float t0 = t[0], t1 = t[-1];
      const float b = __double2float_rn(
          __dadd_rn(__dmul_rn(one_a, static_cast<double>(t0)),
                    static_cast<double>(__fmul_rn(a, t1))));
      buf[e] = (t0 != 0.f && t1 != 0.f) ? b : 0.f;
    }
    __syncthreads();

    const int q = (d - d0) / kDC, dd = (d - d0) % kDC;
    if (dd == 0 && q > 0)
      store_chunk(stage, out, q - 1, kDC, d0, x0, y0, h, w, sy, sx, sd);

    const float* col = buf + ry * kBW + lane;
    float c[kRows];
    unsigned hi[kRows], lo[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      c[i] = col[(i + 3) * kBW + 4];
      hi[i] = 0;
      lo[i] = 0;
    }
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      float v[kRows + 6];
#pragma unroll
      for (int k = 0; k < kRows + 6; ++k) v[k] = col[k * kBW + i];
#pragma unroll
      for (int j = 0; j < 7; ++j) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const unsigned m = lt_sign(c[r], v[r + j]);
          if (i * 7 + j < 31)
            hi[r] = push_bit(hi[r], m);
          else
            lo[r] = push_bit(lo[r], m);
        }
      }
    }
    unsigned char* st = stage + (q & 1) * kPix * kDC + dd;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const bool valid = ((interior >> r) & 1u) && c[r] != 0.f;
      const unsigned wh = valid ? hi[r] : 0u, wl = valid ? lo[r] : 0u;
      const int cost =
          c[r] != 0.f ? __popc(wh ^ mhi[r]) + __popc(wl ^ mlo[r]) : kInvalid;
      st[((ry + r) * kTW + lane) * kDC] = static_cast<unsigned char>(cost);
    }
  }
  __syncthreads();
  const int n = d1 - d0;
  if (n > 0) {
    const int q = (n - 1) / kDC;
    store_chunk(stage, out, q, n - q * kDC, d0, x0, y0, h, w, sy, sx, sd);
  }
}

// Shared memory of a census_cost_kernel block with a window of `cap`
// columns: the window, two blended tiles and two staged chunks.
int smem_bytes(int cap) {
  return 4 * kBH * cap + 4 * 2 * kBH * kBW + 2 * kPix * kDC;
}

// census_cost_kernel's plan for an [h, w, D] volume against an [h, wn]
// neighbor on a card of `sms` SMs: `group` planes a block (a multiple of
// kDC: all D where the tiles fill kBlocksPerSM blocks an SM, else split
// evenly over as many groups as fill them) and a window of `cap` columns
// (kWindow, or the neighbor's width and one plane's reach where less).
void cost_plan(int h, int w, int wn, int D, int sms, int* group, int* cap) {
  const long long tiles = static_cast<long long>((w + kTW - 1) / kTW) *
                          ((h + kTH - 1) / kTH);
  const long long chunks = (D + kDC - 1) / kDC;
  long long groups = (static_cast<long long>(kBlocksPerSM) * sms + tiles - 1) /
                     tiles;
  groups = groups < 1 ? 1 : (groups > chunks ? chunks : groups);
  *group = static_cast<int>((chunks + groups - 1) / groups) * kDC;
  *cap = wn + kNeed < kWindow ? wn + kNeed : kWindow;
}

}  // namespace

// census_kernel over B [H, W] float32 images into B [H, W] int64 words.
// Returns the cudaError_t of the launch.
extern "C" int sgm_census(const void* img, void* out, int B, int H, int W,
                          void* stream) {
  if (B < 1 || H < 1 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((W + kCensusW - 1) / kCensusW, (H + kCensusH - 1) / kCensusH,
                  B < 65535 ? B : 65535);
  census_kernel<<<grid, dim3(kCensusW, kCensusH), 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<unsigned long long*>(out),
      B, H, W);
  return static_cast<int>(cudaGetLastError());
}

// census_cost_kernel's plan (cost_plan) on a card of `sms` SMs: planes a
// block into *group, window columns into *cap.
extern "C" int sgm_cost_plan(int h, int w, int wn, int D, int sms,
                             int* group, int* cap) {
  if (h < 1 || w < 1 || wn < 1 || D < 1 || sms < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cost_plan(h, w, wn, D, sms, group, cap);
  return 0;
}

// census_cost_kernel over one direction: mcen [h, w] int64, nbr [h, wn]
// float32, shifts [D] float32, out int16 [h, w, D] at element strides
// (sy, sx, sd), planned by cost_plan for the current device. Returns the
// cudaError_t of the launch.
extern "C" int sgm_census_cost(const void* mcen, const void* nbr,
                               const void* shifts, void* out, int h, int w,
                               int wn, int D, long long sy, long long sx,
                               long long sd, void* stream) {
  if (h < 1 || w < 1 || wn < 1 || D < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, group = 0, cap = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  cost_plan(h, w, wn, D, sms, &group, &cap);
  const int smem = smem_bytes(cap);
  e = cudaFuncSetAttribute(census_cost_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((w + kTW - 1) / kTW, (h + kTH - 1) / kTH,
                  (D + group - 1) / group);
  census_cost_kernel<<<grid, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint2*>(mcen), static_cast<const float*>(nbr),
      static_cast<const float*>(shifts), static_cast<short*>(out), h, w, wn,
      D, group, cap, sy, sx, sd);
  return static_cast<int>(cudaGetLastError());
}
