// Whole-pyramid HGI encode (K1) and decode (K2) for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of the JAX package:
//   K1  rustyhgi_tpu/ops/pallas_codec.py::_encode_batch  (body _encode_tile)
//   K2  rustyhgi_tpu/ops/pallas_codec.py::_decode_batch  (body _decode_tile)
// and computes what they compute, bit for bit: anchors on the 2^L lattice
// are stored raw; level by level, coarse to fine, each refined pixel is
// predicted from the 4 corners of its enclosing cell (crossed rounding
// tree or left_top; a corner outside [H, W] reads 0), the residual is
// formed mod 256, quantized through the 256-entry table with the overflow
// fixup, and the reconstruction is written back for the finer levels.
// Decode is the mirror: image[q] = (pred + grid[q]) & 255.
//
// None of the TPU kernels' tiling is carried over: no row tiles or halos,
// no u32 words or stride-4 planes.  The design follows from two facts:
//   * a level writes only positions off its `step` lattice and reads only
//     positions on it, so one launch per level, one thread per cell of the
//     `step` lattice, is race-free, and launches on one stream order the
//     levels;
//   * the three refined pixels (y, x+sub), (y+sub, x), (y+sub, x+sub) of a
//     cell share one prediction, so a thread reads 4 corners and codes up
//     to 3 pixels.
// The whole level loop runs from one C entry point on the caller's stream.
//
// What bounds it on this card: device-memory bytes.  Each pixel is read
// and written about once, plus the corner reads (one extra byte per cell),
// with no reuse held on chip; the coarse levels are too small to fill the
// card, but they are 1/4 of the work per level up.  Stride-`step` byte
// accesses coalesce poorly at the finest levels.  Fusing the finest levels
// into shared-memory tiles with halos, so that a pixel crosses device
// memory once in each direction, is later work.
//
// Every effective depth (0..16 and beyond), every shape including 0x0 and
// 1xN, both predictors and every quantizer table are covered; offsets are
// 64-bit, so [B, H, W] batches of any size address correctly.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;  // batch planes per launch

// The quantizer: q = c_table[diff].  Only the lossy encode reads it.
__constant__ uint8_t c_table[256];

enum Predictor { kCrossed = 0, kLeftTop = 1 };

// Prediction of the cell whose top-left corner is (y0, x0), side `step`,
// read from plane `p` of h x w; corners outside the plane read 0
// (interpolator.rs:75-82).  Comparisons are written as `step < w - x0` so
// that nothing overflows int.
template <int PRED>
__device__ __forceinline__ int cell_prediction(const uint8_t* p, int h, int w,
                                               int y0, int x0, int step) {
  const long long r0 = (long long)y0 * w + x0;
  const int tl = p[r0];
  if (PRED == kLeftTop) return tl;
  const bool right = step < w - x0;
  const bool down = step < h - y0;
  const long long r1 = r0 + (long long)step * w;
  const int tr = right ? p[r0 + step] : 0;
  const int bl = down ? p[r1] : 0;
  const int br = (right && down) ? p[r1 + step] : 0;
  // The exact integer rounding tree of interpolator.rs:41-55, in int: the
  // sum reaches 1020.
  return (((tl + tr + 1) >> 1) + ((bl + br + 1) >> 1) + ((tl + bl + 1) >> 1) +
          ((tr + br + 1) >> 1)) >> 2;
}

// One closed-loop residual step (encoder.rs:53-64) at offset k.
template <bool LOSSLESS>
__device__ __forceinline__ void code(const uint8_t* __restrict__ src,
                                     uint8_t* __restrict__ grid,
                                     uint8_t* recon, long long k, int pred) {
  const int diff = (src[k] - pred) & 255;
  if (LOSSLESS) {
    grid[k] = (uint8_t)diff;
    return;
  }
  const int q = c_table[diff];
  // The fixup compares the carries as integers: store the raw diff when
  // quantizing flips whether pred + residual passes 255.
  const int g = ((pred + q > 255) != (pred + diff > 255)) ? diff : q;
  grid[k] = (uint8_t)g;
  recon[k] = (uint8_t)((pred + g) & 255);
}

// Anchors: dst0[k] = dst1[k] = src[k] on the `step` lattice (dst1 may be
// null).  One thread per cell.
__global__ void copy_anchors(const uint8_t* __restrict__ src,
                             uint8_t* __restrict__ dst0,
                             uint8_t* __restrict__ dst1, int h, int w,
                             int step, int wc, long long cells) {
  const long long cell = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= cells) return;
  const long long plane = (long long)blockIdx.y * h * w;
  const long long k =
      plane + (long long)(cell / wc) * step * w + (long long)(cell % wc) * step;
  const uint8_t v = src[k];
  dst0[k] = v;
  if (dst1 != nullptr) dst1[k] = v;
}

// K1, one level.  Lossless reads the corners from the source (the
// reconstruction equals it) and writes no recon.
template <int PRED, bool LOSSLESS>
__global__ void encode_level(const uint8_t* __restrict__ src,
                             uint8_t* __restrict__ grid, uint8_t* recon, int h,
                             int w, int step, int wc, long long cells) {
  const long long cell = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= cells) return;
  const long long plane = (long long)blockIdx.y * h * w;
  src += plane;
  grid += plane;
  if (!LOSSLESS) recon += plane;
  const int y0 = (int)(cell / wc) * step;
  const int x0 = (int)(cell % wc) * step;
  const int sub = step >> 1;
  const int pred =
      cell_prediction<PRED>(LOSSLESS ? src : recon, h, w, y0, x0, step);
  const bool right = sub < w - x0;
  const bool down = sub < h - y0;
  const long long k = (long long)y0 * w + x0;
  if (right) code<LOSSLESS>(src, grid, recon, k + sub, pred);
  if (down) code<LOSSLESS>(src, grid, recon, k + (long long)sub * w, pred);
  if (right && down)
    code<LOSSLESS>(src, grid, recon, k + (long long)sub * w + sub, pred);
}

// K2, one level.
template <int PRED>
__global__ void decode_level(const uint8_t* __restrict__ grid, uint8_t* out,
                             int h, int w, int step, int wc, long long cells) {
  const long long cell = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= cells) return;
  const long long plane = (long long)blockIdx.y * h * w;
  grid += plane;
  out += plane;
  const int y0 = (int)(cell / wc) * step;
  const int x0 = (int)(cell % wc) * step;
  const int sub = step >> 1;
  const int pred = cell_prediction<PRED>(out, h, w, y0, x0, step);
  const bool right = sub < w - x0;
  const bool down = sub < h - y0;
  const long long k = (long long)y0 * w + x0;
  if (right) out[k + sub] = (uint8_t)((pred + grid[k + sub]) & 255);
  if (down) {
    const long long kd = k + (long long)sub * w;
    out[kd] = (uint8_t)((pred + grid[kd]) & 255);
    if (right) out[kd + sub] = (uint8_t)((pred + grid[kd + sub]) & 255);
  }
}

// Cells of the `step` lattice: ceil(h/step) x ceil(w/step).
struct Lattice {
  int wc;
  long long cells;
  Lattice(int h, int w, int step)
      : wc((int)(((long long)w + step - 1) / step)),
        cells((((long long)h + step - 1) / step) * wc) {}
  unsigned blocks() const { return (unsigned)((cells + kThreads - 1) / kThreads); }
};

// Launches `launch(b0, nb)` over the batch in chunks of kMaxGridY planes.
template <typename F>
cudaError_t over_batch(int batch, F launch) {
  for (int b0 = 0; b0 < batch; b0 += kMaxGridY) {
    const int nb = batch - b0 < kMaxGridY ? batch - b0 : kMaxGridY;
    launch(b0, nb);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <int PRED, bool LOSSLESS>
cudaError_t encode_levels(const uint8_t* src, uint8_t* grid, uint8_t* recon,
                          int batch, int h, int w, int levels,
                          cudaStream_t stream) {
  const long long plane = (long long)h * w;
  for (int level = 0; level < levels; ++level) {
    const int step = 1 << (levels - level);
    const Lattice lat(h, w, step);
    const cudaError_t err = over_batch(batch, [&](int b0, int nb) {
      encode_level<PRED, LOSSLESS><<<dim3(lat.blocks(), nb), kThreads, 0, stream>>>(
          src + b0 * plane, grid + b0 * plane,
          LOSSLESS ? nullptr : recon + b0 * plane, h, w, step, lat.wc,
          lat.cells);
    });
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <int PRED>
cudaError_t decode_levels(const uint8_t* grid, uint8_t* out, int batch, int h,
                          int w, int levels, cudaStream_t stream) {
  const long long plane = (long long)h * w;
  for (int level = 0; level < levels; ++level) {
    const int step = 1 << (levels - level);
    const Lattice lat(h, w, step);
    const cudaError_t err = over_batch(batch, [&](int b0, int nb) {
      decode_level<PRED><<<dim3(lat.blocks(), nb), kThreads, 0, stream>>>(
          grid + b0 * plane, out + b0 * plane, h, w, step, lat.wc, lat.cells);
    });
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

cudaError_t anchors(const uint8_t* src, uint8_t* dst0, uint8_t* dst1, int batch,
                    int h, int w, int levels, cudaStream_t stream) {
  const long long plane = (long long)h * w;
  const int step = 1 << levels;
  const Lattice lat(h, w, step);
  return over_batch(batch, [&](int b0, int nb) {
    copy_anchors<<<dim3(lat.blocks(), nb), kThreads, 0, stream>>>(
        src + b0 * plane, dst0 + b0 * plane,
        dst1 == nullptr ? nullptr : dst1 + b0 * plane, h, w, step, lat.wc,
        lat.cells);
  });
}

}  // namespace

extern "C" {

// K1: src, grid (and recon when lossy) are [batch, h, w] uint8 device
// buffers; `table` is a host pointer to the 256-entry quantizer table, or
// null for the lossless path (then `recon` is unused).  `levels` is the
// effective depth.  Returns cudaGetLastError() after the last launch.
int hgi_encode(const void* src, void* grid, void* recon, const void* table,
               int batch, int h, int w, int levels, int predictor,
               void* stream) {
  const auto* s = static_cast<const uint8_t*>(src);
  auto* g = static_cast<uint8_t*>(grid);
  auto* r = static_cast<uint8_t*>(recon);
  auto st = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || h <= 0 || w <= 0) return cudaSuccess;
  if (predictor != kCrossed && predictor != kLeftTop)
    return cudaErrorInvalidValue;
  const bool lossless = table == nullptr;
  if (!lossless) {
    // Ordered on the stream before this call's launches.
    const cudaError_t err = cudaMemcpyToSymbolAsync(
        c_table, table, 256, 0, cudaMemcpyHostToDevice, st);
    if (err != cudaSuccess) return err;
  }
  cudaError_t err = anchors(s, g, lossless ? nullptr : r, batch, h, w, levels, st);
  if (err != cudaSuccess) return err;
  if (predictor == kCrossed)
    err = lossless ? encode_levels<kCrossed, true>(s, g, r, batch, h, w, levels, st)
                   : encode_levels<kCrossed, false>(s, g, r, batch, h, w, levels, st);
  else
    err = lossless ? encode_levels<kLeftTop, true>(s, g, r, batch, h, w, levels, st)
                   : encode_levels<kLeftTop, false>(s, g, r, batch, h, w, levels, st);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// K2: grid and out are [batch, h, w] uint8 device buffers.
int hgi_decode(const void* grid, void* out, int batch, int h, int w,
               int levels, int predictor, void* stream) {
  const auto* g = static_cast<const uint8_t*>(grid);
  auto* o = static_cast<uint8_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || h <= 0 || w <= 0) return cudaSuccess;
  if (predictor != kCrossed && predictor != kLeftTop)
    return cudaErrorInvalidValue;
  cudaError_t err = anchors(g, o, nullptr, batch, h, w, levels, st);
  if (err != cudaSuccess) return err;
  err = predictor == kCrossed
            ? decode_levels<kCrossed>(g, o, batch, h, w, levels, st)
            : decode_levels<kLeftTop>(g, o, batch, h, w, levels, st);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

const char* hgi_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
