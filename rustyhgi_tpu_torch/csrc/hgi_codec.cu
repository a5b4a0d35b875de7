// Whole-pyramid HGI encode and decode for Hopper (sm_90a), on the
// row-major grid (K1, K2) and on the subband layout (K3, K4, K5).
//
// Replaces the five Pallas TPU kernels of rustyhgi_tpu/ops/pallas_codec.py:
//   K1  _encode_batch      (body _encode_tile)    -> hgi_encode
//   K2  _decode_batch      (body _decode_tile)    -> hgi_decode
//   K3  _encode_sub_batch  (subband emission)     -> hgi_encode_subbands
//   K4  _repack_words      (quads -> grid words)  -> hgi_assemble_grid
//   K5  _decode_sub_batch  (K4's words into K2)   -> hgi_decode_subbands
// and computes what they compute, bit for bit: anchors on the 2^L lattice
// are stored raw; level by level, coarse to fine, each refined pixel is
// predicted from the 4 corners of its enclosing cell (crossed rounding
// tree or left_top; a corner outside [H, W] reads 0), the residual is
// formed mod 256, quantized through the 256-entry table with the overflow
// fixup, and the reconstruction is written back for the finer levels.
// Decode is the mirror: image[q] = (pred + residual[q]) & 255.
//
// The subband layout stores the same residuals as packed lattices: the
// anchors (hp >> L) x (wp >> L), then per level l, coarsest first, the
// quads q01, q10, q11 of the level's cells, each (hp >> (L-l)) x
// (wp >> (L-l)), where hp x wp is the image padded up to multiples of
// 2^L (the canvas).  K3 runs K1's level loop over every cell of the
// canvas lattice, so it also emits the residuals of pixels that lie in
// the padding, where the source reads 0: code(0 - pred), exactly what the
// JAX encode_subbands and its Pallas kernel emit there.  K5 reads its
// residuals straight from the quads; the TPU's repack-then-decode split
// buys nothing here, so there is no grid in between.  Stopped after `upto`
// levels, it writes the preview: the full image sampled every
// 2^(L-upto) pixels.  K4 is a gather from the quads into the grid.
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
// Each entry point runs its whole level loop on the caller's stream.
//
// What bounds them on this card: device-memory bytes.  Each pixel is read
// and written about once, plus the corner reads (one extra byte per cell),
// with no reuse held on chip; the coarse levels are too small to fill the
// card, but they are 1/4 of the work per level up.  Stride-`step` byte
// accesses coalesce poorly at the finest levels (the quads themselves are
// read and written coalesced).  Fusing the finest levels into
// shared-memory tiles with halos, so that a pixel crosses device memory
// once in each direction, is later work.
//
// Every effective depth (0..30), every shape including 0x0 and 1xN, both
// predictors and every quantizer table are covered; offsets are 64-bit,
// so [B, H, W] batches of any size address correctly.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;  // batch planes per launch
// Dims are at most 2^30 (the wrapper checks), so depths stop at 30.
constexpr int kMaxLevels = 31;

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
  // Only K3 visits cells whose top-left corner lies outside the plane (in
  // the canvas padding); for K1, K2 and K5 `top` and `left` always hold.
  const bool top = y0 < h;
  const bool left = x0 < w;
  const bool right = step < w - x0;  // implies left
  const bool down = step < h - y0;   // implies top
  const long long r0 = (long long)y0 * w + x0;
  const long long r1 = r0 + (long long)step * w;
  const int tl = (top && left) ? p[r0] : 0;
  if (PRED == kLeftTop) return tl;
  const int tr = (top && right) ? p[r0 + step] : 0;
  const int bl = (down && left) ? p[r1] : 0;
  const int br = (right && down) ? p[r1 + step] : 0;
  // The exact integer rounding tree of interpolator.rs:41-55, in int: the
  // sum reaches 1020.
  return (((tl + tr + 1) >> 1) + ((bl + br + 1) >> 1) + ((tl + bl + 1) >> 1) +
          ((tr + br + 1) >> 1)) >> 2;
}

// The coded residual of value v under prediction pred: one closed-loop
// residual step (encoder.rs:53-64).
template <bool LOSSLESS>
__device__ __forceinline__ int residual(int v, int pred) {
  const int diff = (v - pred) & 255;
  if (LOSSLESS) return diff;
  const int q = c_table[diff];
  // The fixup compares the carries as integers: store the raw diff when
  // quantizing flips whether pred + residual passes 255.
  return ((pred + q > 255) != (pred + diff > 255)) ? diff : q;
}

// Codes the pixel at offset k into the grid (and the recon when lossy).
template <bool LOSSLESS>
__device__ __forceinline__ void code(const uint8_t* __restrict__ src,
                                     uint8_t* __restrict__ grid,
                                     uint8_t* recon, long long k, int pred) {
  const int g = residual<LOSSLESS>(src[k], pred);
  grid[k] = (uint8_t)g;
  if (!LOSSLESS) recon[k] = (uint8_t)((pred + g) & 255);
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

// K3's anchors: anchors[cell] = src[k] on the 2^L lattice, and
// recon[k] = src[k] when recon is not null.  The packed anchors have the
// lattice's wc columns.
__global__ void pack_anchors(const uint8_t* __restrict__ src,
                             uint8_t* __restrict__ anchors,
                             uint8_t* __restrict__ recon, int h, int w,
                             int step, int wc, long long cells) {
  const long long cell = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= cells) return;
  const long long k = (long long)blockIdx.y * h * w +
                      (long long)(cell / wc) * step * w +
                      (long long)(cell % wc) * step;
  const uint8_t v = src[k];
  anchors[(long long)blockIdx.y * cells + cell] = v;
  if (recon != nullptr) recon[k] = v;
}

// K5's anchors: the inverse of pack_anchors, out[k] = anchors[cell].
__global__ void unpack_anchors(const uint8_t* __restrict__ anchors,
                               uint8_t* __restrict__ out, int h, int w,
                               int step, int wc, long long cells) {
  const long long cell = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= cells) return;
  const long long k = (long long)blockIdx.y * h * w +
                      (long long)(cell / wc) * step * w +
                      (long long)(cell % wc) * step;
  out[k] = anchors[(long long)blockIdx.y * cells + cell];
}

// Codes one refined pixel of K3 into its quad at qk; a pixel in the
// canvas padding reads 0 and has no recon.
template <bool LOSSLESS>
__device__ __forceinline__ void emit(const uint8_t* __restrict__ src,
                                     uint8_t* recon, uint8_t* __restrict__ quad,
                                     long long qk, bool inside, long long k,
                                     int pred) {
  const int g = residual<LOSSLESS>(inside ? src[k] : 0, pred);
  quad[qk] = (uint8_t)g;
  if (!LOSSLESS && inside) recon[k] = (uint8_t)((pred + g) & 255);
}

// K3, one level: one thread per cell of the canvas lattice (qw columns,
// `cells` a plane).  It writes the cell's three quads also where their
// pixel lies in the padding; the recon is written only inside [h, w], so
// a padding corner reads 0 at the finer levels, as one outside the
// canvas does.  Lossless reads the corners from the source.
template <int PRED, bool LOSSLESS>
__global__ void encode_sub_level(const uint8_t* __restrict__ src,
                                 uint8_t* recon, uint8_t* __restrict__ q01,
                                 uint8_t* __restrict__ q10,
                                 uint8_t* __restrict__ q11, int h, int w,
                                 int step, int qw, long long cells) {
  const long long cell = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= cells) return;
  const long long plane = (long long)blockIdx.y * h * w;
  src += plane;
  if (!LOSSLESS) recon += plane;
  const long long qk = (long long)blockIdx.y * cells + cell;
  const int y0 = (int)(cell / qw) * step;
  const int x0 = (int)(cell % qw) * step;
  const int sub = step >> 1;
  const int pred =
      cell_prediction<PRED>(LOSSLESS ? src : recon, h, w, y0, x0, step);
  const bool top = y0 < h;
  const bool left = x0 < w;
  const bool right = sub < w - x0;
  const bool down = sub < h - y0;
  const long long k = (long long)y0 * w + x0;
  const long long kd = k + (long long)sub * w;
  emit<LOSSLESS>(src, recon, q01, qk, top && right, k + sub, pred);
  emit<LOSSLESS>(src, recon, q10, qk, down && left, kd, pred);
  emit<LOSSLESS>(src, recon, q11, qk, down && right, kd + sub, pred);
}

// K5, one level: K2's decode_level with the residuals read from the quads
// (qw columns, qplane cells a plane) instead of the grid.
template <int PRED>
__global__ void decode_sub_level(const uint8_t* __restrict__ q01,
                                 const uint8_t* __restrict__ q10,
                                 const uint8_t* __restrict__ q11, uint8_t* out,
                                 int h, int w, int step, int wc,
                                 long long cells, int qw, long long qplane) {
  const long long cell = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= cells) return;
  out += (long long)blockIdx.y * h * w;
  const long long qk =
      (long long)blockIdx.y * qplane + (cell / wc) * qw + cell % wc;
  const int y0 = (int)(cell / wc) * step;
  const int x0 = (int)(cell % wc) * step;
  const int sub = step >> 1;
  const int pred = cell_prediction<PRED>(out, h, w, y0, x0, step);
  const bool right = sub < w - x0;
  const bool down = sub < h - y0;
  const long long k = (long long)y0 * w + x0;
  if (right) out[k + sub] = (uint8_t)((pred + q01[qk]) & 255);
  if (down) {
    const long long kd = k + (long long)sub * w;
    out[kd] = (uint8_t)((pred + q10[qk]) & 255);
    if (right) out[kd + sub] = (uint8_t)((pred + q11[qk]) & 255);
  }
}

// The quads of every level, coarsest first: q[3l], q[3l+1], q[3l+2] are
// level l's q01, q10, q11.  Passed by value (744 bytes of parameters).
struct Quads {
  const uint8_t* q[3 * kMaxLevels];
};

// K4: one thread per grid pixel (y, x), a gather.  The lowest set bit t
// of y | x names the pixel's level: t >= levels (or y = x = 0) is an
// anchor, otherwise level levels-1-t, whose cells have side 2^(t+1), and
// bit t of y and of x pick q01, q10 or q11.  Plane b0 + blockIdx.y.
__global__ void assemble_pixels(const uint8_t* __restrict__ anchors, Quads qs,
                                uint8_t* __restrict__ grid, int h, int w,
                                int levels, int aw, long long aplane,
                                long long pixels, int b0) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= pixels) return;
  const long long b = (long long)b0 + blockIdx.y;
  const int y = (int)(i / w);
  const int x = (int)(i % w);
  const int yx = y | x;
  const int t = yx == 0 ? levels : min(__ffs(yx) - 1, levels);
  uint8_t v;
  if (t >= levels) {
    v = anchors[b * aplane + (long long)(y >> levels) * aw + (x >> levels)];
  } else {
    const int level = levels - 1 - t;
    const int which = ((y >> t) & 1) * 2 + ((x >> t) & 1) - 1;
    const long long qw = (long long)aw << level;
    const long long qplane = aplane << (2 * level);
    v = qs.q[3 * level + which][b * qplane + (long long)(y >> (t + 1)) * qw +
                                (x >> (t + 1))];
  }
  grid[b * pixels + i] = v;
}

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

unsigned blocks_for(long long cells) {
  return (unsigned)((cells + kThreads - 1) / kThreads);
}

// Cells of the `step` lattice: ceil(h/step) x ceil(w/step).
struct Lattice {
  int wc;
  long long cells;
  Lattice(int h, int w, int step)
      : wc((int)(((long long)w + step - 1) / step)),
        cells((((long long)h + step - 1) / step) * wc) {}
  unsigned blocks() const { return blocks_for(cells); }
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

// K3's level loop.  Level l's canvas lattice has (ah << l) x (aw << l)
// cells of side 2^(levels-l).
template <int PRED, bool LOSSLESS>
cudaError_t encode_sub_levels(const uint8_t* src, uint8_t* const* quads,
                              uint8_t* recon, int batch, int h, int w,
                              int levels, int ah, int aw,
                              cudaStream_t stream) {
  const long long plane = (long long)h * w;
  for (int level = 0; level < levels; ++level) {
    const int step = 1 << (levels - level);
    const int qw = aw << level;
    const long long cells = ((long long)ah << level) * qw;
    uint8_t* const* q = quads + 3 * level;
    const cudaError_t err = over_batch(batch, [&](int b0, int nb) {
      const long long qo = b0 * cells;
      encode_sub_level<PRED, LOSSLESS>
          <<<dim3(blocks_for(cells), nb), kThreads, 0, stream>>>(
              src + b0 * plane, LOSSLESS ? nullptr : recon + b0 * plane,
              q[0] + qo, q[1] + qo, q[2] + qo, h, w, step, qw, cells);
    });
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// K5's level loop on an h x w output (the preview's dims when upto is
// below the archive's depth): its `upto` levels have steps 2^upto .. 2,
// and level l reads the quads of the archive's level l.
template <int PRED>
cudaError_t decode_sub_levels(const uint8_t* const* quads, uint8_t* out,
                              int batch, int h, int w, int upto, int ah,
                              int aw, cudaStream_t stream) {
  const long long plane = (long long)h * w;
  for (int level = 0; level < upto; ++level) {
    const int step = 1 << (upto - level);
    const Lattice lat(h, w, step);
    const int qw = aw << level;
    const long long qplane = ((long long)ah << level) * qw;
    const uint8_t* const* q = quads + 3 * level;
    const cudaError_t err = over_batch(batch, [&](int b0, int nb) {
      const long long qo = b0 * qplane;
      decode_sub_level<PRED><<<dim3(lat.blocks(), nb), kThreads, 0, stream>>>(
          q[0] + qo, q[1] + qo, q[2] + qo, out + b0 * plane, h, w, step,
          lat.wc, lat.cells, qw, qplane);
    });
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
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

// K3: src and recon are [batch, h, w] uint8 device buffers (recon only
// when lossy: `table` not null); anchors is [batch, ceil(h/2^L),
// ceil(w/2^L)] and quads a host array of 3*levels device pointers, level
// l's q01, q10, q11 each [batch, ceil(h/2^L) << l, ceil(w/2^L) << l].
// `levels` is the effective depth.
int hgi_encode_subbands(const void* src, void* anchors, void* const* quads,
                        void* recon, const void* table, int batch, int h,
                        int w, int levels, int predictor, void* stream) {
  const auto* s = static_cast<const uint8_t*>(src);
  auto* a = static_cast<uint8_t*>(anchors);
  auto* const* q = reinterpret_cast<uint8_t* const*>(quads);
  auto* r = static_cast<uint8_t*>(recon);
  auto st = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || h <= 0 || w <= 0) return cudaSuccess;
  if ((predictor != kCrossed && predictor != kLeftTop) || levels < 0 ||
      levels >= kMaxLevels)
    return cudaErrorInvalidValue;
  const bool lossless = table == nullptr;
  if (!lossless) {
    const cudaError_t err = cudaMemcpyToSymbolAsync(
        c_table, table, 256, 0, cudaMemcpyHostToDevice, st);
    if (err != cudaSuccess) return err;
  }
  const long long plane = (long long)h * w;
  const Lattice alat(h, w, 1 << levels);
  cudaError_t err = over_batch(batch, [&](int b0, int nb) {
    pack_anchors<<<dim3(alat.blocks(), nb), kThreads, 0, st>>>(
        s + b0 * plane, a + b0 * alat.cells,
        lossless ? nullptr : r + b0 * plane, h, w, 1 << levels, alat.wc,
        alat.cells);
  });
  if (err != cudaSuccess) return err;
  const int ah = (int)cdiv(h, 1LL << levels);
  const int aw = alat.wc;
  if (predictor == kCrossed)
    err = lossless ? encode_sub_levels<kCrossed, true>(s, q, r, batch, h, w, levels, ah, aw, st)
                   : encode_sub_levels<kCrossed, false>(s, q, r, batch, h, w, levels, ah, aw, st);
  else
    err = lossless ? encode_sub_levels<kLeftTop, true>(s, q, r, batch, h, w, levels, ah, aw, st)
                   : encode_sub_levels<kLeftTop, false>(s, q, r, batch, h, w, levels, ah, aw, st);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// K4: anchors and quads as K3 writes them (`levels` = the number of
// levels given); grid is [batch, h, w].
int hgi_assemble_grid(const void* anchors, const void* const* quads,
                      void* grid, int batch, int h, int w, int levels,
                      void* stream) {
  const auto* a = static_cast<const uint8_t*>(anchors);
  auto* g = static_cast<uint8_t*>(grid);
  auto st = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || h <= 0 || w <= 0) return cudaSuccess;
  if (levels < 0 || levels >= kMaxLevels) return cudaErrorInvalidValue;
  Quads qs = {};
  for (int i = 0; i < 3 * levels; ++i)
    qs.q[i] = static_cast<const uint8_t*>(quads[i]);
  const long long pixels = (long long)h * w;
  const int aw = (int)cdiv(w, 1LL << levels);
  const long long aplane = cdiv(h, 1LL << levels) * aw;
  const cudaError_t err = over_batch(batch, [&](int b0, int nb) {
    assemble_pixels<<<dim3(blocks_for(pixels), nb), kThreads, 0, st>>>(
        a, qs, g, h, w, levels, aw, aplane, pixels, b0);
  });
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// K5: anchors and quads as K3 writes them for an h x w plane at effective
// depth `levels`, of which the first `upto` levels are decoded (quads
// holds their 3*upto pointers); out is [batch, ceil(h/s), ceil(w/s)]
// with s = 2^(levels-upto): the whole image when upto = levels.
int hgi_decode_subbands(const void* anchors, const void* const* quads,
                        void* out, int batch, int h, int w, int levels,
                        int upto, int predictor, void* stream) {
  const auto* a = static_cast<const uint8_t*>(anchors);
  const auto* const* q = reinterpret_cast<const uint8_t* const*>(quads);
  auto* o = static_cast<uint8_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || h <= 0 || w <= 0) return cudaSuccess;
  if ((predictor != kCrossed && predictor != kLeftTop) || levels < 0 ||
      levels >= kMaxLevels || upto < 0 || upto > levels)
    return cudaErrorInvalidValue;
  const long long s = 1LL << (levels - upto);
  const int ho = (int)cdiv(h, s);
  const int wo = (int)cdiv(w, s);
  const long long plane = (long long)ho * wo;
  const Lattice alat(ho, wo, 1 << upto);  // ceil(h/2^L) x ceil(w/2^L)
  cudaError_t err = over_batch(batch, [&](int b0, int nb) {
    unpack_anchors<<<dim3(alat.blocks(), nb), kThreads, 0, st>>>(
        a + b0 * alat.cells, o + b0 * plane, ho, wo, 1 << upto, alat.wc,
        alat.cells);
  });
  if (err != cudaSuccess) return err;
  const int ah = (int)(alat.cells / alat.wc);
  err = predictor == kCrossed
            ? decode_sub_levels<kCrossed>(q, o, batch, ho, wo, upto, ah, alat.wc, st)
            : decode_sub_levels<kLeftTop>(q, o, batch, ho, wo, upto, ah, alat.wc, st);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

const char* hgi_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
