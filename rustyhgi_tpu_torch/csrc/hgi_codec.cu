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
// 2^L (the canvas).  K3 codes every cell of the canvas lattice, so it also
// emits the residuals of pixels that lie in the padding, where the source
// reads 0: code(0 - pred), exactly what the JAX encode_subbands and its
// Pallas kernel emit there; their reconstruction is never written, so a
// finer level reads such a corner as 0, as one outside the canvas.  K5
// reads its residuals straight from the quads; the TPU's repack-then-decode
// split buys nothing here, so there is no grid in between.  Stopped after
// `upto` levels, it writes the preview: the full image sampled every
// 2^(L-upto) pixels.  K4 is a gather from the quads into the grid.
//
// None of the TPU kernels' tiling is carried over: no row tiles, no u32
// words or stride-4 planes.  What bounds every kernel here is device
// memory: a pixel is read once and written once, plus corner reads.
//
// K1 has two designs, one for each of its paths:
//   * lossless (no table): the reconstruction is the source, so no level
//     depends on another and the whole pyramid is one launch.  A thread
//     codes a run of kRun pixels of one row; a pixel's level is the lowest
//     set bit t of y | x (as in K4), its cell's corners are read from the
//     source, and L1 and L2 serve their reuse.  Specialized on the row's
//     lowest set bit, a run reads every row its cells touch as one 16-byte
//     load plus the byte after it; only a column whose level reaches past
//     the run (1/256 of the pixels) reads its corners one by one.  One
//     read and one write per pixel: the bytes bound.
//   * lossy (closed loop): each level predicts from the reconstruction of
//     the coarser ones.  The finest F = min(L, fine) levels run in one
//     launch of 2-D tiles in shared memory: a block loads its tile of the
//     source plus a right and bottom halo of one 2^F cell, and the
//     reconstruction on the 2^F lattice over the same region; runs the F
//     levels coarse to fine with a barrier between them, halo cells
//     included; and writes its own grid and recon pixels once, 16 bytes a
//     thread.  The halo suffices because a cell at x0 reads corners at x0
//     and x0 + step only: a tile whose origin lies on the 2^F lattice
//     needs no left or top halo, and the pixels of its right and bottom
//     halo cells that its own cells read depend only on those halo cells
//     and on their 2^F corners.  Halo cells cost their source bytes again
//     (read from L2 by the neighbour).  Levels coarser than 2^F keep one
//     launch each of encode_level, one thread per cell; they touch at
//     most 1/4^F of the pixels, and the first also copies the anchors.
//     At L <= F the whole encode is one launch.
//     What bounds a tile on this card is its latency, not bytes: at one
//     plane a block of each SM runs its phases (load, F levels between
//     barriers, write) one after another.  So every phase keeps several
//     reads in flight a thread: the load reads four 16-byte pieces before
//     storing any, a level codes two cells a round with their reads
//     before their writes, and the finest level, 3/4 of the cells, runs
//     on 8-byte words, four cells a thread.
// The quantizer table reaches every lossy kernel by value, as a 256-byte
// kernel argument, and each block copies it to shared memory: lookups at
// indices that differ across a warp then cost no constant-memory replays,
// and calls on any streams may use any tables at once.
//
// K2 and K5 are the lossy K1's design mirrored, one kernel for both
// (decode_tiles): the finest F = min(L, fine) levels (K5: min(upto, fine))
// run in one launch of 2-D tiles with the same one-cell right and bottom
// halo, decoded in place in one shared region (a position holds its
// residual until its level turns it into its pixel), and each coarser
// level is one launch, the first also storing the anchors.  At L <= F
// (upto <= F, upto = 0 included) the whole decode is one launch.  They
// differ in the loader only: K2 reads its residuals from the grid in
// 16-byte pieces, four in flight a thread, as lossy K1 reads its source;
// K5 gathers them from the quads of the F finest levels, each quad row's
// segment over the region read as 16-byte aligned pieces, four in flight,
// its bytes placed at their pixels, the anchors' in the same round.  The
// lattice is then the coarse decode or the anchors, and the levels, the
// finest on 8-byte words, and the write are the same code.  A decode tile
// moves 2 bytes a pixel, lossy K1's 3, and reads no table.  A call that
// cuts few tiles, as a small preview does, is one block's latency end to
// end, so the wrappers pick smaller tiles for it (cuda_codec.decode_tile).
//
// K3 is K1's encode writing quads, in K1's two designs, and bound, like
// K1, by its bytes (a source byte read once, a quad byte written once,
// plus the recon when lossy).  Both leave their residuals through one
// writer, K4's gather inverted (scatter_run): a 16-byte run of a canvas
// row of class k (the lowest set bit of its row) is peeled by byte
// permutes into the k + 2 quad rows it belongs to, 8 >> j bytes of each,
// one store each, and a warp's stores to a quad row are coalesced.
//   * lossless: one launch at any depth (encode_sub_lossless), lossless
//     K1's runs over the canvas, a warp on 512 bytes of one row; rows
//     below the plane read 0.  The recon is the source, never written.
//   * lossy: lossy K1's tiles (encode_tiles, OUT kQuadsOut) cut on the
//     canvas, every canvas position coded and the recon kept only inside
//     the plane; the tile's rows are written by class (class_row), so
//     that a warp's scatters take one path.  Levels coarser than 2^F one
//     launch each (encode_sub_level), the first storing the anchors, else
//     the tiles do: one launch at L <= F.  The recon is not written when
//     the caller does not want it and no coarser level reads it.
//   Why a grid run and not a quad run: a thread that owned 16 quad columns
//   of one level, reading the three source rows its cells touch, has three
//   times fewer threads in flight than K1's runs, and took 2.5 times K1's
//   time at one 1080x1920 plane.
//
// K4 (assemble_rows) is bound by bytes too, one read and one write a
// pixel.  It takes the grid row by row: row y has class k = the lowest set
// bit of y (capped at L), and all its pixels come from k + 2 quad rows, so
// a thread writes one 16-byte run of a row with one store after 2 to 5
// narrow loads (8 >> j bytes of each), interleaved by byte permutes, and a
// warp covers 512 bytes of one row: every class is uniform across the
// warp and every load coalesced.  No division: the run and the row come
// from the 2-D launch.
//
// Every effective depth (0..30), every shape including 0x0 and 1xN, both
// predictors and every quantizer table are covered; offsets are 64-bit,
// so [B, H, W] batches of any size address correctly.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

// The quantizer table as the C entry points take it, by value.
struct QTable {
  uint8_t v[256];
};

namespace {

constexpr int kThreads = 256;
constexpr int kTileThreads = 256;  // threads of a block of the tiles of lossy K1, K3, K2 and K5
// Blocks of lossy K1's and K3's tiles an SM keeps at once: the registers a
// thread may use are capped at 65536 / (256 * 5), 48, so that a fifth
// block fits (a 64 x 128 tile's shared memory would let eight).
constexpr int kTileBlocks = 5;
constexpr int kMaxGridY = 65535;  // batch planes per launch
// Dims are at most 2^30 (the wrapper checks), so depths stop at 30.
constexpr int kMaxLevels = 31;
constexpr int kRun = 16;          // pixels of a row a lossless K1 or K3 thread codes
constexpr int kMaxFine = 5;       // the tiled levels of lossy K1, K3, K2 and K5 at most
constexpr int kMaxSharedBytes = 227 * 1024;

enum Predictor { kCrossed = 0, kLeftTop = 1 };

// The prediction of a cell from its corners: the exact integer rounding
// tree of interpolator.rs:41-55, in int (the sum reaches 1020), or the top
// left corner.
template <int PRED>
__device__ __forceinline__ int tree(int tl, int tr, int bl, int br) {
  if (PRED == kLeftTop) return tl;
  return (((tl + tr + 1) >> 1) + ((bl + br + 1) >> 1) + ((tl + bl + 1) >> 1) +
          ((tr + br + 1) >> 1)) >> 2;
}

// Prediction of the cell whose top-left corner is (y0, x0), side `step`,
// read from plane `p` of h x w; corners outside the plane read 0
// (interpolator.rs:75-82).  Comparisons are written as `step < w - x0` so
// that nothing overflows int.
template <int PRED>
__device__ __forceinline__ int cell_prediction(const uint8_t* p, int h, int w,
                                               int y0, int x0, int step) {
  // Only K3 visits cells whose top-left corner lies outside the plane (in
  // the canvas padding); elsewhere `top` and `left` always hold.
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
  return tree<PRED>(tl, tr, bl, br);
}

// The coded residual of value v under prediction pred: one closed-loop
// residual step (encoder.rs:53-64), the table `qt` in shared memory.
template <bool LOSSLESS>
__device__ __forceinline__ int residual(int v, int pred, const uint8_t* qt) {
  const int diff = (v - pred) & 255;
  if (LOSSLESS) return diff;
  const int q = qt[diff];
  // The fixup compares the carries as integers: store the raw diff when
  // quantizing flips whether pred + residual passes 255.
  return ((pred + q > 255) != (pred + diff > 255)) ? diff : q;
}

// The table as the kernels take it, a 256-byte argument on a 16-byte
// boundary, so that 16 threads copy it to shared memory, 16 bytes each.
struct alignas(16) KTable {
  uint4 v[16];
};

KTable ktable(const QTable& table) {
  KTable k;
  memcpy(&k, table.v, sizeof k);
  return k;
}

// The first 16 threads copy the table to `qt` (16-byte aligned shared
// memory); the caller synchronizes.
__device__ __forceinline__ void load_table(uint8_t* qt, const KTable& table) {
  if (threadIdx.x < 16) reinterpret_cast<uint4*>(qt)[threadIdx.x] = table.v[threadIdx.x];
}

// -- K1, lossless: the whole pyramid in one launch ---------------------------

// The lossless residual of pixel (y, x) of plane p: its level from the
// lowest set bit t of y | x (t >= levels, or y = x = 0: an anchor, stored
// raw); the corners of its cell, of side 2^(t+1), read from the source.
// A pixel outside the plane (K3's canvas padding) reads 0.
template <int PRED>
__device__ __forceinline__ uint32_t lossless_pixel(const uint8_t* __restrict__ p, int h,
                                                   int w, int y, int x, int levels) {
  const int yx = y | x;
  const int t = yx == 0 ? levels : min(__ffs(yx) - 1, levels);
  const int v = y < h && x < w ? p[(long long)y * w + x] : 0;
  if (t >= levels) return (uint32_t)v;
  const int step = 2 << t;
  return (uint32_t)((v - cell_prediction<PRED>(p, h, w, y & -step, x & -step, step)) & 255);
}

// kRun bytes as four little-endian words: one 16-byte load, or byte by byte.
template <bool VEC>
__device__ __forceinline__ void load_run(uint32_t (&r)[4], const uint8_t* p) {
  if (VEC) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    r[0] = v.x, r[1] = v.y, r[2] = v.z, r[3] = v.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      r[i] = (uint32_t)p[4 * i] | (uint32_t)p[4 * i + 1] << 8 |
             (uint32_t)p[4 * i + 2] << 16 | (uint32_t)p[4 * i + 3] << 24;
  }
}

template <bool VEC>
__device__ __forceinline__ void store_run(uint8_t* p, const uint32_t (&r)[4]) {
  if (VEC) {
    *reinterpret_cast<uint4*>(p) = make_uint4(r[0], r[1], r[2], r[3]);
  } else {
#pragma unroll
    for (int j = 0; j < kRun; ++j) p[j] = (uint8_t)(r[j >> 2] >> (8 * (j & 3)));
  }
}

__device__ __forceinline__ int byte_of(const uint32_t (&r)[4], int j) {
  return (int)((r[j >> 2] >> (8 * (j & 3))) & 255u);
}

// The rows a run reads, as offsets from its own row: slot i holds row
// y + kRowOffset[i].
__host__ __device__ constexpr int row_offset(int slot) {
  return slot < 4 ? -(8 >> slot) : (slot == 4 ? 0 : 1 << (slot - 5));  // -8..-1, 0, 1..16
}
__host__ __device__ constexpr int row_slot(int d) {
  return d < 0 ? (d == -8 ? 0 : d == -4 ? 1 : d == -2 ? 2 : 3)
               : (d == 0 ? 4 : d == 1 ? 5 : d == 2 ? 6 : d == 4 ? 7 : d == 8 ? 8 : 9);
}
constexpr int kRowSlots = 10;

__host__ __device__ constexpr int ctz16(int j) {
  return (j & 1) ? 0 : (j & 2) ? 1 : (j & 4) ? 2 : 3;
}

// The level of in-run column j (1..15) of a row whose lowest set bit is TY
// (TY == 4: four or more), and of column 0 when TY < 4 (the run's origin
// is a multiple of 16).
__host__ __device__ constexpr int run_level(int TY, int j) {
  return TY == 0 ? 0 : j == 0 ? TY : (ctz16(j) < TY ? ctz16(j) : TY);
}

// The row offsets of the corners of column j's cell: (y, y + 2s) when its
// level t lies below the row's (the cell starts on this row), else
// (y - s, y + s), with s = 2^t.
__host__ __device__ constexpr int top_offset(int TY, int j) {
  return (TY == 4 || run_level(TY, j) < TY) ? 0 : -(1 << run_level(TY, j));
}

__host__ __device__ constexpr bool reads_row(int TY, int d) {
  bool used = d == 0;
  for (int j = (TY == 4 ? 1 : 0); j < kRun; ++j) {
    const int top = top_offset(TY, j), step = 2 << run_level(TY, j);
    used = used || d == top || d == top + step;
  }
  return used;
}

// The residuals `out` of a run of kRun pixels of row y (lowest set bit TY)
// starting at column x0 (offset k in the plane), kRun <= w - x0: every row
// its cells read is one 16-byte load (zero below the plane, the run's own
// row included, as in K3's canvas padding) plus the byte after it (zero
// past the plane's right edge); at TY == 4 column 0, whose cell may reach
// beyond the run, reads its corners one by one.
template <int PRED, bool VEC, int TY>
__device__ __forceinline__ void lossless_run(const uint8_t* __restrict__ p, int h, int w, int y,
                                             int x0, int levels, long long k,
                                             uint32_t (&out)[4]) {
  const bool right = x0 + kRun < w;
  uint32_t rows[kRowSlots][4];
  int ends[kRowSlots];
#pragma unroll
  for (int i = 0; i < kRowSlots; ++i) {
    if (!reads_row(TY, row_offset(i))) continue;
    const int d = row_offset(i);
    if (y + d < h) {
      const uint8_t* q = p + k + (long long)d * w;
      load_run<VEC>(rows[i], q);
      ends[i] = right ? q[kRun] : 0;
    } else {
      rows[i][0] = rows[i][1] = rows[i][2] = rows[i][3] = 0u;
      ends[i] = 0;
    }
  }
  const uint32_t(&own)[4] = rows[row_slot(0)];
  out[0] = out[1] = out[2] = out[3] = 0u;
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    uint32_t r;
    if (TY == 4 && j == 0) {
      r = lossless_pixel<PRED>(p, h, w, y, x0, levels);
    } else {
      const int t = run_level(TY, j), step = 2 << t, c0 = j & -step;
      const int top = row_slot(top_offset(TY, j)), bot = row_slot(top_offset(TY, j) + step);
      const int pred = tree<PRED>(byte_of(rows[top], c0),
                                  c0 + step < kRun ? byte_of(rows[top], c0 + step) : ends[top],
                                  byte_of(rows[bot], c0),
                                  c0 + step < kRun ? byte_of(rows[bot], c0 + step) : ends[bot]);
      const int v = byte_of(own, j);
      r = (uint32_t)(t >= levels ? v : (v - pred) & 255);
    }
    out[j >> 2] |= r << (8 * (j & 3));
  }
}

// lossless_run specialized on the lowest set bit of y (4 for 4 or more).
template <int PRED, bool VEC>
__device__ __forceinline__ void lossless_run16(const uint8_t* __restrict__ p, int h, int w,
                                               int y, int x0, int levels, long long k,
                                               uint32_t (&out)[4]) {
  switch (y == 0 ? 4 : min(__ffs(y) - 1, 4)) {
    case 0: lossless_run<PRED, VEC, 0>(p, h, w, y, x0, levels, k, out); break;
    case 1: lossless_run<PRED, VEC, 1>(p, h, w, y, x0, levels, k, out); break;
    case 2: lossless_run<PRED, VEC, 2>(p, h, w, y, x0, levels, k, out); break;
    case 3: lossless_run<PRED, VEC, 3>(p, h, w, y, x0, levels, k, out); break;
    default: lossless_run<PRED, VEC, 4>(p, h, w, y, x0, levels, k, out); break;
  }
}

// One thread per run of kRun pixels of a row; `runs` runs a row, `total`
// runs in all (batch * h * runs).  VEC: w % 16 == 0 and both buffers on
// 16-byte boundaries.
template <int PRED, bool VEC>
__global__ void __launch_bounds__(kThreads)
    encode_lossless(const uint8_t* __restrict__ src, uint8_t* __restrict__ grid, int h,
                    int w, int levels, int runs, long long total) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const long long row = i / runs;
  const int x0 = (int)(i - row * runs) * kRun;
  const long long b = row / h;
  const int y = (int)(row - b * h);
  const long long plane = b * h * (long long)w;
  const uint8_t* p = src + plane;
  uint8_t* g = grid + plane;
  const long long k = (long long)y * w + x0;
  if (levels == 0 || x0 + kRun > w) {  // no levels, or a row's ragged end
    const int m = min(kRun, w - x0);
    for (int j = 0; j < m; ++j) g[k + j] = (uint8_t)lossless_pixel<PRED>(p, h, w, y, x0 + j, levels);
    return;
  }
  uint32_t out[4];
  lossless_run16<PRED, VEC>(p, h, w, y, x0, levels, k, out);
  store_run<VEC>(g + k, out);
}

// -- K1, lossy: coarse levels one launch each, the finest F tiled -------------

// One coarse level: one thread per cell of the `step` lattice codes its up
// to 3 refined pixels.  The first level (`anchors`) also stores the
// anchors, its cells' top-left corners, raw, and reads its corners from
// the source, which the anchors' reconstruction equals.
template <int PRED>
__global__ void encode_level(const uint8_t* __restrict__ src, uint8_t* __restrict__ grid,
                             uint8_t* __restrict__ recon, KTable table, int h, int w,
                             int step, int wc, long long cells, bool anchors) {
  __shared__ __align__(16) uint8_t qt[256];
  load_table(qt, table);
  __syncthreads();
  const long long cell = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= cells) return;
  const long long plane = (long long)blockIdx.y * h * w;
  src += plane;
  grid += plane;
  recon += plane;
  const int y0 = (int)(cell / wc) * step;
  const int x0 = (int)(cell % wc) * step;
  const int sub = step >> 1;
  const long long k = (long long)y0 * w + x0;
  if (anchors) {
    const uint8_t v = src[k];
    grid[k] = v;
    recon[k] = v;
  }
  const int pred = cell_prediction<PRED>(anchors ? src : recon, h, w, y0, x0, step);
  const bool right = sub < w - x0;
  const bool down = sub < h - y0;
  const long long ks[3] = {k + sub, k + (long long)sub * w, k + (long long)sub * w + sub};
  const bool in[3] = {right, down, right && down};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    if (!in[i]) continue;
    const int g = residual<false>(src[ks[i]], pred, qt);
    grid[ks[i]] = (uint8_t)g;
    recon[ks[i]] = (uint8_t)((pred + g) & 255);
  }
}

__host__ __device__ __forceinline__ int round16(int v) { return (v + 15) & ~15; }

// The tiled launch's shared memory: the table, then the reconstruction and
// the source (then residuals) over the tile and its halo, rows 0..th + S
// and columns 0..tw + S (S = 2^fine), each row round16(tw + S + 1) bytes.
__host__ __device__ __forceinline__ int tile_shared_bytes(int th, int tw, int fine) {
  const int s = 1 << fine;
  return 256 + 2 * (th + s + 1) * round16(tw + s + 1);
}

// A block's walk over the (row, column) cells of a grid `cols` wide
// (cols <= 2^12), cell threadIdx.x first and kTileThreads cells a step,
// without an integer division: a quotient below 2^9 by a float reciprocal
// is exact, since (i + 0.5) / cols stays 1 / (2 cols) from an integer.
struct Walk {
  int r, c, dr, dc, cols;
  __device__ explicit Walk(int cols_) : cols(cols_) {
    const float inv = 1.0f / (float)cols;
    r = (int)(((float)threadIdx.x + 0.5f) * inv);
    c = threadIdx.x - r * cols;
    dr = (int)(((float)kTileThreads + 0.5f) * inv);
    dc = kTileThreads - dr * cols;
  }
  __device__ void next() {
    r += dr;
    c += dc;
    if (c >= cols) {
      c -= cols;
      ++r;
    }
  }
};

__device__ __forceinline__ int byte8(const uint32_t (&r)[2], int j) {
  return (int)((r[j >> 2] >> (8 * (j & 3))) & 255u);
}

__device__ __forceinline__ void set_byte8(uint32_t (&r)[2], int j, int v) {
  const int sh = 8 * (j & 3);
  r[j >> 2] = (r[j >> 2] & ~(255u << sh)) | ((uint32_t)(v & 255) << sh);
}

// Level step 2 of a tile (reconstruction rc, source then residuals sc,
// rows `pitch` bytes apart, rh x rw cells' worth) whose coded pixels all
// lie inside the plane: a thread codes 4 cells of a row pair, 8 columns,
// from 8-byte words.  Row ly's even bytes are the corners and keep their
// values, so a neighbour reading them while the word is rewritten reads
// the same bytes.
template <int PRED>
__device__ __forceinline__ void finest_level_words(uint8_t* rc, uint8_t* sc, int pitch,
                                                   int rh, int rw, const uint8_t* qt) {
  for (Walk it(rw / 8); it.r < rh / 2; it.next()) {
    const int o = 2 * it.r * pitch + 8 * it.c;
    uint8_t* top = rc + o;
    const uint2 ta = *reinterpret_cast<const uint2*>(top);
    const uint2 ba = *reinterpret_cast<const uint2*>(top + 2 * pitch);
    const int t8 = top[8], b8 = top[2 * pitch + 8];
    const uint2 s0 = *reinterpret_cast<const uint2*>(sc + o);
    const uint2 s1 = *reinterpret_cast<const uint2*>(sc + o + pitch);
    const uint32_t t[2] = {ta.x, ta.y}, bt[2] = {ba.x, ba.y};
    const uint32_t v0[2] = {s0.x, s0.y}, v1[2] = {s1.x, s1.y};
    uint32_t r0[2] = {ta.x, ta.y}, r1[2] = {0u, 0u}, g0[2] = {s0.x, s0.y}, g1[2] = {0u, 0u};
#pragma unroll
    for (int i = 0; i < 8; i += 2) {
      const int pred = tree<PRED>(byte8(t, i), i < 6 ? byte8(t, i + 2) : t8, byte8(bt, i),
                                  i < 6 ? byte8(bt, i + 2) : b8);
      const int g01 = residual<false>(byte8(v0, i + 1), pred, qt);
      const int g10 = residual<false>(byte8(v1, i), pred, qt);
      const int g11 = residual<false>(byte8(v1, i + 1), pred, qt);
      set_byte8(g0, i + 1, g01);
      set_byte8(r0, i + 1, pred + g01);
      set_byte8(g1, i, g10);
      set_byte8(r1, i, pred + g10);
      set_byte8(g1, i + 1, g11);
      set_byte8(r1, i + 1, pred + g11);
    }
    *reinterpret_cast<uint2*>(top) = make_uint2(r0[0], r0[1]);
    *reinterpret_cast<uint2*>(top + pitch) = make_uint2(r1[0], r1[1]);
    *reinterpret_cast<uint2*>(sc + o) = make_uint2(g0[0], g0[1]);
    *reinterpret_cast<uint2*>(sc + o + pitch) = make_uint2(g1[0], g1[1]);
  }
}

// Rows 0..rh of a region of plane p whose origin is (y0, x0), pitch / 16
// pieces of 16 bytes a row, one piece a thread at a time: `store(o, v)`
// gets each piece's offset in the shared region and its bytes, where a
// position outside the plane reads 0.  Four pieces a round, all read
// before any is stored, so the reads' latencies overlap.  VEC: w % 16 == 0
// and p on a 16-byte boundary.
template <bool VEC, typename Store>
__device__ __forceinline__ void load_region(const uint8_t* __restrict__ p, int h, int w,
                                            int y0, int x0, int rh, int pitch, Store store) {
  for (Walk it(pitch / 16); it.r <= rh;) {
    uint4 v[4];
    int o[4];
#pragma unroll
    for (int u = 0; u < 4; ++u, it.next()) {
      o[u] = -1;
      if (it.r > rh) continue;
      const int gy = y0 + it.r, gx = x0 + 16 * it.c;
      o[u] = it.r * pitch + 16 * it.c;
      const long long k = (long long)gy * w + gx;
      if (VEC && gy < h && gx + 16 <= w) {
        v[u] = *reinterpret_cast<const uint4*>(p + k);
      } else {
        uint32_t b[4] = {0u, 0u, 0u, 0u};
        for (int j = 0; j < 16; ++j)
          if (gy < h && gx + j < w) b[j >> 2] |= (uint32_t)p[k + j] << (8 * (j & 3));
        v[u] = make_uint4(b[0], b[1], b[2], b[3]);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (o[u] >= 0) store(o[u], v[u]);
  }
}

// The tile's own pixels, rows 0..th and columns 0..tw of the shared region
// (origin (y0, x0), rows `pitch` bytes apart), to plane p: 16 bytes a
// thread where they lie whole.  `store(k, o)` writes the 16-byte piece at
// shared offset o to plane offset k; `store_byte(k, o)` one byte.
template <bool VEC, typename Store, typename StoreByte>
__device__ __forceinline__ void write_tile(int h, int w, int y0, int x0, int th, int tw,
                                           int pitch, Store store, StoreByte store_byte) {
  for (Walk it(tw / 16); it.r < th; it.next()) {
    const int gy = y0 + it.r, gx = x0 + 16 * it.c;
    if (gy >= h || gx >= w) continue;
    const long long k = (long long)gy * w + gx;
    const int o = it.r * pitch + 16 * it.c;
    if (VEC && gx + 16 <= w) {
      store(k, o);
    } else {
      for (int j = 0; j < 16 && gx + j < w; ++j) store_byte(k + j, o + j);
    }
  }
}

// Where K3's tile launch writes, passed by value: level step 2^(t+1) has
// quads q[t][0..2] (q01, q10, q11), each (hp >> (t+1)) x (wp >> (t+1)) a
// plane of the hp x wp canvas; the anchors, (hp >> fine) x (wp >> fine) a
// plane, when no coarser level ran (else null: the first coarse launch
// stores them).
struct TileQuadsOut {
  uint8_t* q[kMaxFine][3];
  uint8_t* anchors;
};

// n bytes (n <= 16) of v to p: one 16-byte store where p lies on a
// 16-byte boundary and n is 16; else, for n = 16, 8- or 4-byte stores as
// p allows, and byte stores for a part.
__device__ __forceinline__ void store_piece(uint8_t* p, uint4 v, int n) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if (n == 16 && (a & 15) == 0) {
    *reinterpret_cast<uint4*>(p) = v;
    return;
  }
  const uint32_t r[4] = {v.x, v.y, v.z, v.w};
  // Unrolled over the 16 bytes, so that r stays in registers.
  const int step = n == 16 && (a & 7) == 0 ? 8 : n == 16 && (a & 3) == 0 ? 4 : 1;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if (j >= n) break;
    if (step == 8 && (j & 7) == 0)
      *reinterpret_cast<uint2*>(p + j) = make_uint2(r[j >> 2], r[(j >> 2) + 1]);
    else if (step == 4 && (j & 3) == 0)
      *reinterpret_cast<uint32_t*>(p + j) = r[j >> 2];
    else if (step == 1)
      p[j] = (uint8_t)(r[j >> 2] >> (8 * (j & 3)));
  }
}

// n (1, 2, 4 or 8) bytes of v to p: one store where p is aligned to n,
// else byte by byte.
__device__ __forceinline__ void store_bytes(uint8_t* p, uint64_t v, int n) {
  if ((reinterpret_cast<uintptr_t>(p) & (n - 1)) == 0) {
    switch (n) {
      case 8: *reinterpret_cast<uint64_t*>(p) = v; return;
      case 4: *reinterpret_cast<uint32_t*>(p) = (uint32_t)v; return;
      case 2: *reinterpret_cast<uint16_t*>(p) = (uint16_t)v; return;
      default: *p = (uint8_t)v; return;
    }
  }
  for (int i = 0; i < n; ++i) p[i] = (uint8_t)(v >> (8 * i));
}

// The even (kEven) or odd (kOdd) bytes of 16, 8, 4 or 2 bytes: byte
// de-interleaves, the inverse of zip8, zip4, zip2.
constexpr uint32_t kEven = 0x6420, kOdd = 0x7531;
__device__ __forceinline__ uint64_t unzip16(uint4 v, uint32_t sel) {
  return (uint64_t)__byte_perm(v.z, v.w, sel) << 32 | __byte_perm(v.x, v.y, sel);
}
__device__ __forceinline__ uint32_t unzip8(uint64_t v, uint32_t sel) {
  return __byte_perm((uint32_t)v, (uint32_t)(v >> 32), sel);
}
__device__ __forceinline__ uint32_t unzip4(uint32_t v, uint32_t sel) {
  return __byte_perm(v, 0u, sel == kEven ? 0x4420 : 0x4431);  // 2 bytes, high half 0
}
__device__ __forceinline__ uint32_t unzip2(uint32_t v, uint32_t sel) {
  return (v >> (sel == kEven ? 0 : 8)) & 255u;
}

// Where K3 writes a residual of the canvas: quad(t, which) is the plane's
// quad `which` (q01, q10, q11) of level step 2^(t+1), wp >> (t+1) bytes a
// row, for t < fine; anchors (null: not this launch's) the plane's
// anchors, wp >> levels a row.  A position of a level at or above `fine`
// but below `levels` is a coarser launch's, and is left alone.
template <typename Quad>
__device__ __forceinline__ void scatter_byte(const Quad& quad, uint8_t* anchors, int wp,
                                             int levels, int fine, int y, int x, uint32_t v) {
  const int yx = y | x;
  const int t = yx == 0 ? levels : min(__ffs(yx) - 1, levels);
  if (t >= levels) {
    if (anchors != nullptr)
      anchors[(long long)(y >> levels) * (wp >> levels) + (x >> levels)] = (uint8_t)v;
    return;
  }
  if (t >= fine) return;
  const int which = ((y >> t) & 1) * 2 + ((x >> t) & 1) - 1;
  quad(t, which)[(long long)(y >> (t + 1)) * (wp >> (t + 1)) + (x >> (t + 1))] = (uint8_t)v;
}

// K3's writer, K4's gather inverted: the residuals v of a 16-byte run of
// canvas row y at column x0 (a multiple of 16, x0 + 16 <= wp) go to the
// k + 2 quad rows of the row's class k = the lowest set bit of y (capped at
// levels; y = 0: levels).  Peeling the odd bytes off, finest first, gives
// for each j < K = min(k, 4) the 8 >> j q01 bytes of level step 2^(j+1);
// what is left, the run's columns at multiples of 2^K, is the q10 and q11
// bytes of level step 2^(k+1) interleaved (k < levels), the anchors
// (k = levels <= 4), or column x0 alone (K = 4).  Each lands with one
// store (scatter_byte's rules for what is stored).
template <typename Quad>
__device__ __forceinline__ void scatter_run(const Quad& quad, uint8_t* anchors, int wp,
                                            int levels, int fine, int y, int x0, uint4 v) {
  const int L = levels;
  const int k = y == 0 ? L : min(__ffs(y) - 1, L);
  const int K = min(k, 4);
  auto put = [&](int t, int which, uint64_t bytes, int n) {
    if (t < fine)
      store_bytes(quad(t, which) + (long long)(y >> (t + 1)) * (wp >> (t + 1)) + (x0 >> (t + 1)),
                  bytes, n);
  };
  auto put_anchors = [&](uint64_t bytes, int n) {
    if (anchors != nullptr)
      store_bytes(anchors + (long long)(y >> L) * (wp >> L) + (x0 >> L), bytes, n);
  };
  if (K == 0) {
    if (k < L) {
      put(0, 1, unzip16(v, kEven), 8);
      put(0, 2, unzip16(v, kOdd), 8);
    } else if (anchors != nullptr) {  // L = 0: the canvas is the anchors
      store_piece(anchors + (long long)y * wp + x0, v, 16);
    }
    return;
  }
  put(0, 0, unzip16(v, kOdd), 8);
  const uint64_t e8 = unzip16(v, kEven);  // columns at multiples of 2
  if (K == 1) {
    if (k < L) {
      put(1, 1, unzip8(e8, kEven), 4);
      put(1, 2, unzip8(e8, kOdd), 4);
    } else {
      put_anchors(e8, 8);
    }
    return;
  }
  put(1, 0, unzip8(e8, kOdd), 4);
  const uint32_t e4 = unzip8(e8, kEven);  // multiples of 4
  if (K == 2) {
    if (k < L) {
      put(2, 1, unzip4(e4, kEven), 2);
      put(2, 2, unzip4(e4, kOdd), 2);
    } else {
      put_anchors(e4, 4);
    }
    return;
  }
  put(2, 0, unzip4(e4, kOdd), 2);
  const uint32_t e2 = unzip4(e4, kEven);  // multiples of 8
  if (K == 3) {
    if (k < L) {
      put(3, 1, unzip2(e2, kEven), 1);
      put(3, 2, unzip2(e2, kOdd), 1);
    } else {
      put_anchors(e2, 2);
    }
    return;
  }
  put(3, 0, unzip2(e2, kOdd), 1);
  scatter_byte(quad, anchors, wp, L, fine, y, x0, unzip2(e2, kEven));  // column x0 alone
}

// A run of n <= 16 residuals (r, little-endian) of canvas row y from
// column x0: scatter_run when it is whole, else byte by byte.
template <typename Quad>
__device__ __forceinline__ void scatter_residuals(const Quad& quad, uint8_t* anchors, int wp,
                                                  int levels, int fine, int y, int x0, int n,
                                                  const uint32_t (&r)[4]) {
  if (n == 16) {
    scatter_run(quad, anchors, wp, levels, fine, y, x0, make_uint4(r[0], r[1], r[2], r[3]));
    return;
  }
#pragma unroll
  for (int j = 0; j < 16; ++j)
    if (j < n) scatter_byte(quad, anchors, wp, levels, fine, y, x0 + j, byte_of(r, j));
}

// The tile row of rank `rank` when a tile's th rows (th a multiple of 16)
// are taken by class: the th/2 odd rows first, then the th/4 of lowest set
// bit 1, th/8 of bit 2, th/16 of bit 3, and last the th/16 multiples of
// 16.  A 64 x 128 tile's write then gives every warp 4 rows of one class.
__device__ __forceinline__ int class_row(int rank, int th) {
  int base = 0;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int n = th >> (c + 1);
    if (rank < base + n) return ((rank - base) << (c + 1)) | (1 << c);
    base += n;
  }
  return (rank - base) << 4;
}

// A K3 tile's output after its levels: its canvas rows, 16 bytes a thread,
// rows taken by class (class_row) so that a warp's scatters take one path,
// each run's residuals (sc) scattered to the quads of the tile's `fine`
// levels and, when no coarser level ran, to the anchors (scatter_run), and
// its recon (rc) written where it lies inside the plane, when recon is not
// null.  Plane b.
template <bool VEC>
__device__ __forceinline__ void write_tile_quads(const uint8_t* sc, const uint8_t* rc, int pitch,
                                                 const TileQuadsOut& out, uint8_t* recon,
                                                 long long b, int h, int w, int hp, int wp,
                                                 int levels, int fine, int y0, int x0, int th,
                                                 int tw) {
  auto quad = [&](int t, int which) {
    return out.q[t][which] + b * (long long)(hp >> (t + 1)) * (wp >> (t + 1));
  };
  uint8_t* anchors = out.anchors == nullptr
                         ? nullptr
                         : out.anchors + b * (long long)(hp >> levels) * (wp >> levels);
  for (Walk it(tw / 16); it.r < th; it.next()) {
    const int row = class_row(it.r, th);
    const int gy = y0 + row, gx = x0 + 16 * it.c;
    if (gy >= hp || gx >= wp) continue;
    const int o = row * pitch + 16 * it.c;
    const uint4 v = *reinterpret_cast<const uint4*>(sc + o);
    const uint32_t r[4] = {v.x, v.y, v.z, v.w};
    scatter_residuals(quad, anchors, wp, levels, fine, gy, gx, min(16, wp - gx), r);
    if (recon == nullptr || gy >= h || gx >= w) continue;
    const long long k = (long long)gy * w + gx;
    if (VEC && gx + 16 <= w) {
      *reinterpret_cast<uint4*>(recon + k) = *reinterpret_cast<const uint4*>(rc + o);
    } else {
      for (int j = 0; j < 16 && gx + j < w; ++j) recon[k + j] = rc[o + j];
    }
  }
}

enum TileOut { kGridOut = 0, kQuadsOut = 1 };

// The finest `fine` levels of one th x tw tile (blockIdx.x; tiles_x a row
// of tiles) of plane b0 + blockIdx.y, th and tw multiples of 16 and of
// 2^fine.  OUT kGridOut (K1) writes the tile's grid and recon; kQuadsOut
// (K3) cuts its tiles on the hp x wp canvas, codes every canvas position
// (a pixel in the padding reads 0), and writes the quads (`quads`) and,
// where recon is not null, the recon inside the plane.  `coarse`: coarser
// levels ran before, so the 2^fine lattice holds their reconstruction
// (and, for K1, grid); otherwise it is the anchors, the source.  VEC:
// w % 16 == 0 and src, grid and recon on 16-byte boundaries.
template <int PRED, bool VEC, int OUT>
__global__ void __launch_bounds__(kTileThreads, kTileBlocks)
    encode_tiles(const uint8_t* __restrict__ src, uint8_t* __restrict__ grid,
                 uint8_t* __restrict__ recon, const __grid_constant__ TileQuadsOut quads,
                 KTable table, int h, int w, int hp, int wp, int levels, int fine, bool coarse,
                 int th, int tw, int tiles_x, int b0) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int S = 1 << fine;
  const int rh = th + S, rw = tw + S;  // the tile and its halo; rows and columns 0..rh, 0..rw
  const int pitch = round16(rw + 1);
  uint8_t* qt = smem;
  uint8_t* rc = smem + 256;           // reconstruction
  uint8_t* sc = rc + (rh + 1) * pitch;  // source, then residuals
  const long long b = (long long)b0 + blockIdx.y;
  const long long plane = b * h * w;
  src += plane;
  if (OUT == kGridOut) grid += plane;
  if (OUT == kGridOut || recon != nullptr) recon += plane;
  const int y0 = (int)(blockIdx.x / tiles_x) * th;
  const int x0 = (int)(blockIdx.x % tiles_x) * tw;

  load_table(qt, table);
  // The source; the reconstruction is 0 until a level writes it.
  load_region<VEC>(src, h, w, y0, x0, rh, pitch, [&](int o, uint4 v) {
    *reinterpret_cast<uint4*>(rc + o) = make_uint4(0u, 0u, 0u, 0u);
    *reinterpret_cast<uint4*>(sc + o) = v;
  });
  __syncthreads();
  // The 2^fine lattice over the region, edges included.  After coarser
  // levels it is their reconstruction, and K1's grid values replace the
  // source at the tile's own lattice points, so that the final write keeps
  // them; otherwise it is the anchors.
  for (Walk it(rw / S + 1); it.r <= rh / S; it.next()) {
    const int r = it.r * S, c = it.c * S;
    const int gy = y0 + r, gx = x0 + c;
    if (gy >= h || gx >= w) continue;
    const int o = r * pitch + c;
    if (coarse) {
      const long long k = (long long)gy * w + gx;
      rc[o] = recon[k];
      if (OUT == kGridOut && r < th && c < tw) sc[o] = grid[k];
    } else {
      rc[o] = sc[o];
    }
  }
  __syncthreads();
  // The finest level of a tile whose halo lies inside the plane, in
  // 8-byte words (3/4 of the cells); every other level cell by cell.
  const bool words = S >= 8 && y0 + rh <= h && x0 + rw <= w;
  for (int step = S; step >= (words ? 4 : 2); step >>= 1) {
    const int sub = step >> 1;
    const int rows = rh / step;
    for (Walk it(rw / step); it.r < rows;) {
      // Two cells a round: their reads before their writes (the cells'
      // pixels are distinct and none is a corner of this level), so the
      // latencies of both overlap.  A cell's residuals are kept wherever
      // it lies (K3 emits those of the padding), its reconstruction only
      // inside the plane, so that a corner outside the plane reads 0.
      int pred[2], o[2][3], v[2][3];
      bool in[2][3], cell[2];
#pragma unroll
      for (int u = 0; u < 2; ++u, it.next()) {
        cell[u] = it.r < rows;
        const int ly = cell[u] ? it.r * step : 0, lx = cell[u] ? it.c * step : 0;
        const uint8_t* c0 = rc + ly * pitch + lx;
        pred[u] = tree<PRED>(c0[0], c0[step], c0[step * pitch], c0[step * pitch + step]);
        const bool right = x0 + lx + sub < w, down = y0 + ly + sub < h;
        o[u][0] = ly * pitch + lx + sub;
        o[u][1] = (ly + sub) * pitch + lx;
        o[u][2] = (ly + sub) * pitch + lx + sub;
        in[u][0] = cell[u] && right && y0 + ly < h;
        in[u][1] = cell[u] && down && x0 + lx < w;
        in[u][2] = cell[u] && right && down;
#pragma unroll
        for (int j = 0; j < 3; ++j) v[u][j] = sc[o[u][j]];
      }
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int j = 0; j < 3; ++j) v[u][j] = residual<false>(v[u][j], pred[u], qt);
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          // K1 writes only inside the plane; K3 also the padding's residuals.
          if (OUT == kQuadsOut && cell[u] && !in[u][j]) sc[o[u][j]] = (uint8_t)v[u][j];
          if (!in[u][j]) continue;
          sc[o[u][j]] = (uint8_t)v[u][j];
          rc[o[u][j]] = (uint8_t)((pred[u] + v[u][j]) & 255);
        }
    }
    __syncthreads();
  }
  if (words) {
    finest_level_words<PRED>(rc, sc, pitch, rh, rw, qt);
    __syncthreads();
  }
  if (OUT == kQuadsOut) {
    write_tile_quads<VEC>(sc, rc, pitch, quads, recon, b, h, w, hp, wp, levels, fine, y0, x0, th,
                          tw);
    return;
  }
  write_tile<VEC>(
      h, w, y0, x0, th, tw, pitch,
      [&](long long k, int o) {
        *reinterpret_cast<uint4*>(grid + k) = *reinterpret_cast<const uint4*>(sc + o);
        *reinterpret_cast<uint4*>(recon + k) = *reinterpret_cast<const uint4*>(rc + o);
      },
      [&](long long k, int o) {
        grid[k] = sc[o];
        recon[k] = rc[o];
      });
}

// K2, one coarse level: one thread per cell of the `step` lattice decodes
// its up to 3 refined pixels.  The first level (`anchors`) also stores the
// anchors, its cells' top-left corners, and reads its corners from the
// grid, which holds the anchors raw.
template <int PRED>
__global__ void decode_level(const uint8_t* __restrict__ grid, uint8_t* out,
                             int h, int w, int step, int wc, long long cells,
                             bool anchors) {
  const long long cell = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= cells) return;
  const long long plane = (long long)blockIdx.y * h * w;
  grid += plane;
  out += plane;
  const int y0 = (int)(cell / wc) * step;
  const int x0 = (int)(cell % wc) * step;
  const int sub = step >> 1;
  if (anchors) out[(long long)y0 * w + x0] = grid[(long long)y0 * w + x0];
  const int pred = cell_prediction<PRED>(anchors ? grid : out, h, w, y0, x0, step);
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

// K3, lossy, one level coarser than the tiles: K1's encode_level writing
// quads, one thread per cell of the canvas lattice (qw columns, `cells` a
// plane).  It codes the cell's three pixels also where they lie in the
// padding, where the source reads 0; the recon is written only inside the
// plane, so that a padding corner reads 0 at the finer levels, as one
// outside the canvas does.  The first level (`anchors` not null) also
// stores the anchors, its cells' top-left corners (0 in the padding), and
// their recon, and reads its corners from the source.
template <int PRED>
__global__ void encode_sub_level(const uint8_t* __restrict__ src, uint8_t* __restrict__ recon,
                                 uint8_t* __restrict__ anchors, uint8_t* __restrict__ q01,
                                 uint8_t* __restrict__ q10, uint8_t* __restrict__ q11,
                                 KTable table, int h, int w, int step, int qw, long long cells) {
  __shared__ __align__(16) uint8_t qt[256];
  load_table(qt, table);
  __syncthreads();
  const long long cell = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= cells) return;
  const long long plane = (long long)blockIdx.y * h * w;
  src += plane;
  recon += plane;
  const long long qk = (long long)blockIdx.y * cells + cell;
  const int y0 = (int)(cell / qw) * step;
  const int x0 = (int)(cell % qw) * step;
  const int sub = step >> 1;
  const bool top = y0 < h, left = x0 < w;
  const bool right = sub < w - x0, down = sub < h - y0;
  const long long k = (long long)y0 * w + x0;
  if (anchors != nullptr) {
    const uint8_t v = top && left ? src[k] : 0;
    anchors[qk] = v;
    if (top && left) recon[k] = v;
  }
  const int pred = cell_prediction<PRED>(anchors != nullptr ? src : recon, h, w, y0, x0, step);
  const long long kd = k + (long long)sub * w;
  const long long ks[3] = {k + sub, kd, kd + sub};
  const bool in[3] = {top && right, down && left, down && right};
  uint8_t* const q[3] = {q01, q10, q11};
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int g = residual<false>(in[j] ? src[ks[j]] : 0, pred, qt);
    q[j][qk] = (uint8_t)g;
    if (in[j]) recon[ks[j]] = (uint8_t)((pred + g) & 255);
  }
}

// K3's lossless output: the anchors, then level l's q01, q10, q11 at
// q[3l .. 3l + 2].  A __grid_constant__ parameter: a thread reads the
// entries of its row's class at an index known only at run time straight
// from the parameter space, with no copy.
struct SubbandsOut {
  uint8_t* anchors;
  uint8_t* q[3 * kMaxLevels];
};

// K3, lossless: the whole layout in one launch, lossless K1's runs with
// their residuals scattered to the quads.  The reconstruction is the
// source, so no level waits on another: a thread codes a run of 16 pixels
// of a canvas row as lossless K1 does (lossless_run, rows below the plane
// reading 0; a run past its right edge pixel by pixel) and scatters it to
// the quad rows of the row's class (scatter_run).  A warp covers 512 bytes of one
// row, 8 warps a block on 8 rows (grid-strided past 65535 blocks of rows),
// plane b0 + blockIdx.z of h x w on the hp x wp canvas.  VEC: w % 16 == 0
// and src on a 16-byte boundary.
template <int PRED, bool VEC>
__global__ void __launch_bounds__(kThreads)
    encode_sub_lossless(const uint8_t* __restrict__ src, const __grid_constant__ SubbandsOut out,
                        int h, int w, int levels, int hp, int wp, int b0) {
  constexpr int kWarps = kThreads / 32;
  const int x0 = kRun * ((int)blockIdx.x * 32 + (int)(threadIdx.x & 31));
  if (x0 >= wp) return;
  const long long b = (long long)b0 + blockIdx.z;
  const uint8_t* p = src + b * h * w;
  auto quad = [&](int t, int which) {
    return out.q[3 * (levels - 1 - t) + which] + b * (long long)(hp >> (t + 1)) * (wp >> (t + 1));
  };
  uint8_t* anchors = out.anchors + b * (long long)(hp >> levels) * (wp >> levels);
  const int n = min(kRun, wp - x0);
  for (int y = (int)blockIdx.y * kWarps + (int)(threadIdx.x >> 5); y < hp;
       y += (int)gridDim.y * kWarps) {
    uint32_t r[4] = {0u, 0u, 0u, 0u};
    if (levels > 0 && x0 + kRun <= w) {
      lossless_run16<PRED, VEC>(p, h, w, y, x0, levels, (long long)y * w + x0, r);
    } else {
#pragma unroll
      for (int j = 0; j < kRun; ++j)
        if (j < n) r[j >> 2] |= lossless_pixel<PRED>(p, h, w, y, x0 + j, levels) << (8 * (j & 3));
    }
    scatter_residuals(quad, anchors, wp, levels, levels, y, x0, n, r);
  }
}

// K5, one coarse level: K2's decode_level with the residuals read from
// the quads (qw columns, qplane cells a plane) instead of the grid.  The
// first level (`anchors` not null: the packed anchors, one per cell, wc a
// row) also unpacks the anchors to their pixels and reads its corners from
// them.
template <int PRED>
__global__ void decode_sub_level(const uint8_t* __restrict__ anchors,
                                 const uint8_t* __restrict__ q01,
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
  const long long k = (long long)y0 * w + x0;
  int pred;
  if (anchors != nullptr) {
    const uint8_t* a = anchors + (long long)blockIdx.y * cells + cell;
    const bool r = step < w - x0, d = step < h - y0;
    out[k] = a[0];
    pred = tree<PRED>(a[0], r ? a[1] : 0, d ? a[wc] : 0, (r && d) ? a[wc + 1] : 0);
  } else {
    pred = cell_prediction<PRED>(out, h, w, y0, x0, step);
  }
  const bool right = sub < w - x0;
  const bool down = sub < h - y0;
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

// -- K2 and K5: coarse levels one launch each, the finest F tiled -------------

enum Loader { kGrid = 0, kQuads = 1 };

// The decode tiles' shared region: rows 0..th + S, columns 0..tw + S
// (S = 2^fine), each row round16(tw + S + 1) bytes.
__host__ __device__ __forceinline__ int decode_shared_bytes(int th, int tw, int fine) {
  const int s = 1 << fine;
  return (th + s + 1) * round16(tw + s + 1);
}

// The quads of K5's tiled levels, passed by value, in tile order: level
// step 2^(t+1) (the archive's level upto - t - 1) has q[t][0..2], its
// q01, q10 and q11.
struct TileQuads {
  const uint8_t* q[kMaxFine][3];
};

// Where K5's values lie for plane b, kept in shared memory so that no
// thread indexes the kernel's parameters at run time: level step 2^(t+1), the
// archive's level upto - t - 1, has quads base[t][0..2] (q01, q10, q11),
// qw[t] bytes a row; the 2^fine lattice point (gy, gx) is
// lattice[(gy >> shift) * pitch + (gx >> shift)]: the coarse decode in
// `out` (shift 0, pitch w), or the packed anchors (shift fine, pitch aw).
struct QuadTable {
  const uint8_t* base[kMaxFine][3];
  int qw[kMaxFine];
  const uint8_t* lattice;
  int pitch, shift;
};

// The first 3 * fine + 1 threads fill the table (ah x aw anchors a plane,
// `out` plane b's), each reading its parameter at an index known when
// compiled; the caller synchronizes.
__device__ __forceinline__ void load_quad_table(QuadTable& tab, const TileQuads& tq,
                                                const uint8_t* anchors, const uint8_t* out,
                                                bool coarse, long long b, int w, int fine,
                                                int upto, int ah, int aw) {
  const int i = threadIdx.x;
  if (i == 3 * fine) {
    tab.lattice = coarse ? out : anchors + b * ah * aw;
    tab.pitch = coarse ? w : aw;
    tab.shift = coarse ? 0 : fine;
  }
#pragma unroll
  for (int j = 0; j < 3 * kMaxFine; ++j) {
    if (i != j || j >= 3 * fine) continue;
    const int t = j / 3, which = j % 3;
    const int level = upto - t - 1;
    const int qw = aw << level;
    tab.base[t][which] = tq.q[t][which] + b * ((long long)ah << level) * qw;
    if (which == 0) tab.qw[t] = qw;
  }
}

// Quad `which` of level step 2^(t+1) at pixel (gy, gx): its element
// (gy >> (t+1), gx >> (t+1)).  Only an address: t may name no level.
__device__ __forceinline__ const uint8_t* quad_at(const QuadTable& tab, int t, int which, int gy,
                                                  int gx) {
  t = t < kMaxFine - 1 ? t : kMaxFine - 1;
  return tab.base[t][which] + (long long)(gy >> (t + 1)) * tab.qw[t] + (gx >> (t + 1));
}

// Pixel (gy, gx)'s value before the tiled levels: its residual, read from
// its quad, at the `fine` finest levels, the lattice's value on the 2^fine
// lattice, 0 outside the plane.  Its level is the lowest set bit t of
// gy | gx, as in K4.
__device__ __forceinline__ uint32_t quad_byte(const QuadTable& tab, int h, int w, int gy, int gx,
                                              int fine) {
  if (gy >= h || gx >= w) return 0u;
  const int yx = gy | gx;
  const int t = yx == 0 ? fine : min(__ffs(yx) - 1, fine);
  if (t >= fine)
    return tab.lattice[(long long)(gy >> tab.shift) * tab.pitch + (gx >> tab.shift)];
  return *quad_at(tab, t, ((gy >> t) & 1) * 2 + ((gx >> t) & 1) - 1, gy, gx);
}

// N consecutive bytes (1, 2, 4 or 8) of a quad row, little-endian: one
// load where p is aligned to N, else byte by byte.
template <int N>
__device__ __forceinline__ uint64_t quad_bytes(const uint8_t* p) {
  if ((reinterpret_cast<uintptr_t>(p) & (N - 1)) == 0) {
    if (N == 8) return *reinterpret_cast<const uint64_t*>(p);
    if (N == 4) return *reinterpret_cast<const uint32_t*>(p);
    if (N == 2) return *reinterpret_cast<const uint16_t*>(p);
    return *p;
  }
  uint64_t v = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) v |= (uint64_t)p[i] << (8 * i);
  return v;
}

// Byte interleaves: a0 b0 a1 b1 ... of two runs of N bytes each.
__device__ __forceinline__ uint32_t zip2(uint32_t a, uint32_t b) {
  return __byte_perm(a, b, 0x5140);
}
__device__ __forceinline__ uint64_t zip4(uint32_t a, uint32_t b) {
  return (uint64_t)__byte_perm(a, b, 0x7362) << 32 | __byte_perm(a, b, 0x5140);
}
__device__ __forceinline__ uint4 zip8(uint64_t a, uint64_t b) {
  const uint32_t al = (uint32_t)a, ah = (uint32_t)(a >> 32);
  const uint32_t bl = (uint32_t)b, bh = (uint32_t)(b >> 32);
  return make_uint4(__byte_perm(al, bl, 0x5140), __byte_perm(al, bl, 0x7362),
                    __byte_perm(ah, bh, 0x5140), __byte_perm(ah, bh, 0x7362));
}

// -- K4: the subband layout to the grid, a gather by row class -------------

// The subband layout as K4 reads it: the anchors, then level l's q01, q10,
// q11 at q[3l .. 3l + 2], a plane of level l being (ah << l) x (aw << l).
// A __grid_constant__ parameter: a warp reads the entries of its row's
// class at an index known only at run time straight from the parameter
// space, with no copy.
struct SubbandsIn {
  const uint8_t* anchors;
  const uint8_t* q[3 * kMaxLevels];
};

// Pixel (y, x) of plane b in the layout: its level from the lowest set bit
// t of y | x (t >= levels, or y = x = 0: an anchor), bit t of y and of x
// picking q01, q10 or q11.
__device__ __forceinline__ uint32_t layout_byte(const SubbandsIn& in, long long b, int levels,
                                                int ah, int aw, int y, int x) {
  const int yx = y | x;
  const int t = yx == 0 ? levels : min(__ffs(yx) - 1, levels);
  if (t >= levels) return in.anchors[(b * ah + (y >> levels)) * aw + (x >> levels)];
  const int level = levels - 1 - t;
  const int which = ((y >> t) & 1) * 2 + ((x >> t) & 1) - 1;
  const long long qh = (long long)ah << level, qw = (long long)aw << level;
  return in.q[3 * level + which][(b * qh + (y >> (t + 1))) * qw + (x >> (t + 1))];
}

// n (1, 2, 4 or 8) consecutive bytes, little-endian.
__device__ __forceinline__ uint64_t layout_bytes(const uint8_t* p, int n) {
  switch (n) {
    case 8: return quad_bytes<8>(p);
    case 4: return quad_bytes<4>(p);
    case 2: return quad_bytes<2>(p);
    default: return quad_bytes<1>(p);
  }
}

// Byte interleave of two runs of n (1, 2 or 4) bytes each.
__device__ __forceinline__ uint64_t zip_n(uint64_t a, uint64_t b, int n) {
  if (n == 4) return zip4((uint32_t)a, (uint32_t)b);
  if (n == 2) return zip2((uint32_t)a, (uint32_t)b);
  return (a & 255u) | (b & 255u) << 8;
}

// K4: a thread writes one 16-byte run of one grid row with one store, a
// warp 512 consecutive bytes of the row, 8 warps a block on 8 rows
// (grid-strided past 65535 blocks of rows), plane b0 + blockIdx.z.  Row y
// has class k = the lowest set bit of y, capped at `levels` (y = 0: k =
// levels), uniform across the warp, and its pixels come from k + 2 quad
// rows: a run at x0 (a multiple of 16) takes, for each j < K = min(k, 4),
// the 8 >> j q01 bytes of level levels - 1 - j, row y >> (j + 1), at its
// columns of lowest set bit j; its columns at multiples of 2^K are the
// q10 and q11 bytes of level levels - 1 - k, row y >> (k + 1), interleaved
// (k < levels), the anchors (k = levels <= 4), or column x0 alone, read by
// itself (K = 4).  The runs are byte interleaves (__byte_perm) from the
// coarsest up.  A row's ragged end, w % 16 columns, is read byte by byte;
// every load takes the widest access its address allows, so quads on any
// byte boundary are read.
__global__ void __launch_bounds__(kThreads)
    assemble_rows(const __grid_constant__ SubbandsIn in, uint8_t* __restrict__ grid, int h,
                  int w, int levels, int ah, int aw, int b0) {
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int x0 = 16 * ((int)blockIdx.x * 32 + lane);
  if (x0 >= w) return;
  const long long b = (long long)b0 + blockIdx.z;
  const int L = levels;
  for (int y = (int)blockIdx.y * kWarps + warp; y < h; y += (int)gridDim.y * kWarps) {
    uint8_t* g = grid + (b * h + y) * (long long)w + x0;
    if (x0 + 16 > w) {
      for (int j = 0; j < w - x0; ++j) g[j] = (uint8_t)layout_byte(in, b, L, ah, aw, y, x0 + j);
      continue;
    }
    const int k = y == 0 ? L : min(__ffs(y) - 1, L);
    const int K = min(k, 4);
    // Every load of the run first, then the interleaves.
    uint64_t lo, hi = 0, q01[4] = {0, 0, 0, 0};
    if (K == 4) {
      lo = layout_byte(in, b, L, ah, aw, y, x0);
    } else if (k == L) {  // 16 >> K anchors (K = 0: L = 0, the grid is the anchors)
      const uint8_t* a = in.anchors + (b * ah + (y >> L)) * aw + (x0 >> L);
      lo = K == 0 ? quad_bytes<8>(a) : layout_bytes(a, 16 >> K);
      if (K == 0) hi = quad_bytes<8>(a + 8);
    } else {  // q10 and q11 of level L - 1 - k, 8 >> k bytes each
      const int level = L - 1 - k;
      const long long qw = (long long)aw << level;
      const long long o = (b * ((long long)ah << level) + (y >> (k + 1))) * qw + (x0 >> (k + 1));
      lo = layout_bytes(in.q[3 * level + 1] + o, 8 >> k);
      hi = layout_bytes(in.q[3 * level + 2] + o, 8 >> k);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j >= K) break;
      const int level = L - 1 - j;
      const long long qw = (long long)aw << level;
      const long long o = (b * ((long long)ah << level) + (y >> (j + 1))) * qw + (x0 >> (j + 1));
      q01[j] = layout_bytes(in.q[3 * level] + o, 8 >> j);
    }
    uint4 v;
    if (K == 0) {
      v = k < L ? zip8(lo, hi)
                : make_uint4((uint32_t)lo, (uint32_t)(lo >> 32), (uint32_t)hi, (uint32_t)(hi >> 32));
    } else {
      uint64_t e = K < 4 && k < L ? zip_n(lo, hi, 8 >> K) : lo;  // 16 >> K bytes
      if (K > 3) e = (e & 255u) | (q01[3] & 255u) << 8;
      if (K > 2) e = zip2((uint32_t)e, (uint32_t)q01[2]);
      if (K > 1) e = zip4((uint32_t)e, (uint32_t)q01[1]);
      v = zip8(e, q01[0]);
    }
    store_piece(g, v, 16);
  }
}

// A run of 16 pixels of row gy from column gx (a multiple of 16), all
// inside the plane, reads 2 to 5 segments of quad rows.  Let ty be the
// lowest set bit of gy (4 for 4 or more).  The columns whose lowest set
// bit C lies below ty are q01 of level step 2^(C+1), 8 >> C consecutive
// bytes of one quad row (slot C); the columns at or above ty are q11
// (slot ty) and q10 (slot 4) of step 2^(ty+1), 8 >> ty bytes each, column 0
// among the q10s; a row with ty = 4 reads column 0 alone (slot 4, the
// lattice's value where it is a lattice point).  At 1 <= fine < 4 a row
// with ty >= fine is a lattice row: its columns at or above `fine` are the
// 16 >> fine lattice points, consecutive bytes of one row of the packed
// anchors, read in slot `fine` (else unused) in the same round as the
// quads; from the coarse decode in `out` they read 0 here, and
// fill_lattice writes them.  run_loads issues the loads, run_compose
// interleaves them, so that a thread has the loads of several runs in
// flight before it waits on any.
struct RunLoads {
  uint64_t slot[5];
  int ty;  // -1: the run leaves the plane, and is read byte by byte
};

template <int C>
__device__ __forceinline__ uint64_t run_slot(const QuadTable& tab, int ty, int gy, int gx,
                                             int fine) {
  if constexpr (C >= 1) {
    if (C == fine && ty >= fine && tab.shift == fine)  // a lattice row, from the anchors
      return quad_bytes<(16 >> C)>(tab.lattice + (long long)(gy >> C) * tab.pitch + (gx >> C));
  }
  if (C >= fine || C > ty) return 0;
  return quad_bytes<(8 >> C)>(quad_at(tab, C, C < ty ? 0 : 2, gy, gx));
}

__device__ __forceinline__ RunLoads run_loads(const QuadTable& tab, int h, int w, int gy, int gx,
                                              int fine) {
  RunLoads rl;
  rl.ty = -1;
  if (gy >= h || gx + 16 > w) return rl;
  const int ty = gy == 0 ? 4 : min(__ffs(gy) - 1, 4);
  rl.ty = ty;
  rl.slot[0] = run_slot<0>(tab, ty, gy, gx, fine);
  rl.slot[1] = run_slot<1>(tab, ty, gy, gx, fine);
  rl.slot[2] = run_slot<2>(tab, ty, gy, gx, fine);
  rl.slot[3] = run_slot<3>(tab, ty, gy, gx, fine);
  if (ty < 4) {
    const uint8_t* p = quad_at(tab, ty, 1, gy, gx);
    rl.slot[4] = ty >= fine ? 0
                 : ty == 0  ? quad_bytes<8>(p)
                 : ty == 1  ? quad_bytes<4>(p)
                 : ty == 2  ? quad_bytes<2>(p)
                            : quad_bytes<1>(p);
  } else {
    rl.slot[4] = quad_byte(tab, h, w, gy, gx, fine);
  }
  return rl;
}

// The run's columns whose lowest set bit is at least k, for k = 3 .. 0:
// the columns of level k below the row's are the odd ones (slot k, q01),
// interleaved with those of k + 1; at the row's level the q10s (slot 4)
// with the q11s (slot k); the row with ty = 4 starts from its column 0.
// In a lattice row at fine < 4 the columns at or above `fine` are slot
// `fine` whole.
__device__ __forceinline__ uint4 run_compose(const RunLoads& rl, int fine) {
  const int ty = rl.ty;
  const bool lattice = ty >= fine;
  const uint32_t e3 = fine == 3 && lattice
                          ? (uint32_t)rl.slot[3]
                          : (uint32_t)(rl.slot[4] & 255u) | (uint32_t)(rl.slot[3] & 255u) << 8;
  const uint32_t e2 = fine == 2 && lattice
                          ? (uint32_t)rl.slot[2]
                          : zip2(ty == 2 ? (uint32_t)rl.slot[4] : e3, (uint32_t)rl.slot[2]);
  const uint64_t e1 = fine == 1 && lattice
                          ? rl.slot[1]
                          : zip4(ty == 1 ? (uint32_t)rl.slot[4] : e2, (uint32_t)rl.slot[1]);
  return zip8(ty == 0 ? rl.slot[4] : e1, rl.slot[0]);
}

// K5's values over a tile's region (origin (y0, x0), rows 0..rh, pitch
// / 16 runs of 16 bytes a row), gathered from the quads and the lattice
// (`tab`): four runs a round, the loads of all four issued before any is
// placed, each run then stored 16 bytes at once; a run that leaves the
// plane is read byte by byte, 0 outside it.  The lattice is gathered too,
// but for fine 0 and, at fine < 4, from the coarse decode.
__device__ __forceinline__ void load_quads(uint8_t* rc, const QuadTable& tab, int h, int w,
                                           int y0, int x0, int rh, int pitch, int fine) {
  for (Walk it(pitch / 16); it.r <= rh;) {
    RunLoads rl[4];
    int o[4], gy[4], gx[4];
#pragma unroll
    for (int u = 0; u < 4; ++u, it.next()) {
      o[u] = it.r <= rh ? it.r * pitch + 16 * it.c : -1;
      gy[u] = y0 + it.r, gx[u] = x0 + 16 * it.c;
      rl[u] = run_loads(tab, h, w, o[u] < 0 ? h : gy[u], gx[u], fine);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (o[u] < 0) continue;
      uint4 v;
      if (rl[u].ty >= 0) {
        v = run_compose(rl[u], fine);
      } else {
        uint32_t r[4] = {0u, 0u, 0u, 0u};
        for (int j = 0; j < 16; ++j)
          r[j >> 2] |= quad_byte(tab, h, w, gy[u], gx[u] + j, fine) << (8 * (j & 3));
        v = make_uint4(r[0], r[1], r[2], r[3]);
      }
      *reinterpret_cast<uint4*>(rc + o[u]) = v;
    }
  }
}

// The 2^fine lattice over the region, edges included: the coarse decode
// from `out` (plane b's) when `coarse`, else K5's packed anchors (ah x aw a
// plane); 0 outside the plane.  The caller synchronizes.
template <int LOADER>
__device__ __forceinline__ void fill_lattice(uint8_t* rc, const uint8_t* out,
                                             const uint8_t* anchors, long long b, int h, int w,
                                             int y0, int x0, int rh, int rw, int pitch, int fine,
                                             int ah, int aw, bool coarse) {
  const int S = 1 << fine;
  for (Walk it(rw / S + 1); it.r <= rh / S; it.next()) {
    const int r = it.r * S, c = it.c * S;
    const int gy = y0 + r, gx = x0 + c;
    const bool in = gy < h && gx < w;
    if (LOADER == kGrid && !in) continue;  // the load left 0 there
    rc[r * pitch + c] = !in      ? 0
                        : coarse ? out[(long long)gy * w + gx]
                                 : anchors[b * ah * aw + (long long)(gy >> fine) * aw + (gx >> fine)];
  }
}

// The finest level (step 2) of a decode tile, rows `pitch` bytes apart:
// a thread decodes 4 cells of a row pair, 8 columns, from 8-byte words.
// Row 2r's even bytes are the corners and keep their values, so a
// neighbour reading them while the word is rewritten reads the same
// bytes.  Pixels outside the plane are decoded too: nothing reads them as
// corners, and the tile's write leaves them out.
template <int PRED>
__device__ __forceinline__ void decode_finest_words(uint8_t* rc, int pitch, int rh, int rw) {
  for (Walk it(rw / 8); it.r < rh / 2; it.next()) {
    uint8_t* top = rc + 2 * it.r * pitch + 8 * it.c;
    const uint2 ta = *reinterpret_cast<const uint2*>(top);
    const uint2 ma = *reinterpret_cast<const uint2*>(top + pitch);
    const uint2 ba = *reinterpret_cast<const uint2*>(top + 2 * pitch);
    const int t8 = top[8], b8 = top[2 * pitch + 8];
    const uint32_t t[2] = {ta.x, ta.y}, m[2] = {ma.x, ma.y}, bt[2] = {ba.x, ba.y};
    uint32_t r0[2] = {ta.x, ta.y}, r1[2] = {0u, 0u};
#pragma unroll
    for (int i = 0; i < 8; i += 2) {
      const int pred = tree<PRED>(byte8(t, i), i < 6 ? byte8(t, i + 2) : t8, byte8(bt, i),
                                  i < 6 ? byte8(bt, i + 2) : b8);
      set_byte8(r0, i + 1, pred + byte8(t, i + 1));
      set_byte8(r1, i, pred + byte8(m, i));
      set_byte8(r1, i + 1, pred + byte8(m, i + 1));
    }
    *reinterpret_cast<uint2*>(top) = make_uint2(r0[0], r0[1]);
    *reinterpret_cast<uint2*>(top + pitch) = make_uint2(r1[0], r1[1]);
  }
}

// The levels of steps S .. 2 of a region whose lattice and residuals are
// in place, coarse to fine, a barrier after each: the finest in 8-byte
// words (3/4 of the cells) where the region's rows are whole words, every
// other level cell by cell, two cells a round with their reads before
// their writes (the cells' pixels are distinct and none is a corner of
// this level).
template <int PRED>
__device__ __forceinline__ void decode_region(uint8_t* rc, int h, int w, int y0, int x0, int rh,
                                              int rw, int pitch, int S) {
  const bool words = S >= 8;
  for (int step = S; step >= (words ? 4 : 2); step >>= 1) {
    const int sub = step >> 1;
    const int rows = rh / step;
    for (Walk it(rw / step); it.r < rows;) {
      int pred[2], o[2][3], v[2][3];
      bool in[2][3];
#pragma unroll
      for (int u = 0; u < 2; ++u, it.next()) {
        const bool cell = it.r < rows;
        const int ly = cell ? it.r * step : 0, lx = cell ? it.c * step : 0;
        const uint8_t* c0 = rc + ly * pitch + lx;
        pred[u] = tree<PRED>(c0[0], c0[step], c0[step * pitch], c0[step * pitch + step]);
        const bool right = x0 + lx + sub < w, down = y0 + ly + sub < h;
        o[u][0] = ly * pitch + lx + sub;
        o[u][1] = (ly + sub) * pitch + lx;
        o[u][2] = (ly + sub) * pitch + lx + sub;
        in[u][0] = cell && right && y0 + ly < h;
        in[u][1] = cell && down && x0 + lx < w;
        in[u][2] = cell && right && down;
#pragma unroll
        for (int j = 0; j < 3; ++j) v[u][j] = rc[o[u][j]];
      }
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int j = 0; j < 3; ++j)
          if (in[u][j]) rc[o[u][j]] = (uint8_t)((pred[u] + v[u][j]) & 255);
    }
    __syncthreads();
  }
  if (words) {
    decode_finest_words<PRED>(rc, pitch, rh, rw);
    __syncthreads();
  }
}

template <bool VEC>
__device__ __forceinline__ void write_decoded(uint8_t* out, const uint8_t* rc, int h, int w,
                                              int y0, int x0, int th, int tw, int pitch) {
  write_tile<VEC>(
      h, w, y0, x0, th, tw, pitch,
      [&](long long k, int o) {
        *reinterpret_cast<uint4*>(out + k) = *reinterpret_cast<const uint4*>(rc + o);
      },
      [&](long long k, int o) { out[k] = rc[o]; });
}

// The finest `fine` levels of one th x tw tile (blockIdx.x; tiles_x a row
// of tiles) of plane b0 + blockIdx.y of the h x w output, th and tw
// multiples of 16 and of 2^fine, decoded in place in one shared region: a
// position holds its residual until its level turns it into its pixel.
// LOADER kGrid (K2) reads the region's residuals from the grid, 16 bytes
// a thread, four in flight; kQuads (K5) from the quads of the archive's
// levels upto - fine .. upto - 1 and the lattice with them (load_quads).
// Then the lattice where it was not loaded (fill_lattice, after a
// barrier), the levels (decode_region) and the tile's own pixels,
// 16 bytes a thread where they lie whole.  VEC: w % 16 == 0 and the
// buffers read or written 16 bytes at a time on 16-byte boundaries.
template <int PRED, int LOADER, bool VEC>
__global__ void __launch_bounds__(kTileThreads)
    decode_tiles(const uint8_t* __restrict__ grid, const uint8_t* __restrict__ anchors,
                 TileQuads tq, uint8_t* out, int h, int w, int fine, int upto, int ah, int aw,
                 bool coarse, int th, int tw, int tiles_x, int b0) {
  extern __shared__ __align__(16) uint8_t rc[];
  const int S = 1 << fine;
  const int rh = th + S, rw = tw + S;  // the tile and its halo; rows and columns 0..rh, 0..rw
  const int pitch = round16(rw + 1);
  const long long b = (long long)b0 + blockIdx.y;
  out += b * h * w;
  const int y0 = (int)(blockIdx.x / tiles_x) * th;
  const int x0 = (int)(blockIdx.x % tiles_x) * tw;
  // K2's grid holds its anchors, K5 gathers its lattice but for fine 0 and,
  // at fine < 4, from the coarse decode; else the lattice overwrites the
  // loaded positions after a barrier.
  const bool lattice = LOADER == kQuads ? fine == 0 || (coarse && fine < 4) : coarse;
  if (LOADER == kGrid) {
    load_region<VEC>(grid + b * h * w, h, w, y0, x0, rh, pitch,
                     [&](int o, uint4 v) { *reinterpret_cast<uint4*>(rc + o) = v; });
  } else {
    __shared__ QuadTable tab;
    load_quad_table(tab, tq, anchors, out, coarse, b, w, fine, upto, ah, aw);
    __syncthreads();
    load_quads(rc, tab, h, w, y0, x0, rh, pitch, fine);
  }
  if (lattice) {
    __syncthreads();
    fill_lattice<LOADER>(rc, out, anchors, b, h, w, y0, x0, rh, rw, pitch, fine, ah, aw, coarse);
  }
  __syncthreads();
  decode_region<PRED>(rc, h, w, y0, x0, rh, rw, pitch, S);
  write_decoded<VEC>(out, rc, h, w, y0, x0, th, tw, pitch);
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

// K1 lossless: one launch, one thread per run of kRun pixels of a row.
template <int PRED>
cudaError_t encode_lossless_all(const uint8_t* src, uint8_t* grid, int batch, int h,
                                int w, int levels, bool vec, cudaStream_t stream) {
  const int runs = (int)cdiv(w, kRun);
  const long long total = (long long)batch * h * runs;
  const long long blocks = cdiv(total, kThreads);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (vec)
    encode_lossless<PRED, true><<<(unsigned)blocks, kThreads, 0, stream>>>(
        src, grid, h, w, levels, runs, total);
  else
    encode_lossless<PRED, false><<<(unsigned)blocks, kThreads, 0, stream>>>(
        src, grid, h, w, levels, runs, total);
  return cudaGetLastError();
}

// The tiled launch of lossy K1 (OUT kGridOut) or K3 (kQuadsOut) over the
// batch: the finest f levels in th x tw tiles cut on the hp x wp canvas (the
// plane, for K1), a block a tile.
template <int PRED, int OUT>
cudaError_t encode_tiled(const uint8_t* src, uint8_t* grid, uint8_t* recon,
                         const TileQuadsOut& quads, const KTable& table, int batch, int h, int w,
                         int hp, int wp, int levels, int f, bool coarse, int th, int tw,
                         bool vec, cudaStream_t stream) {
  const int smem = tile_shared_bytes(th, tw, f);
  const int tiles_x = (int)cdiv(wp, tw);
  const long long tiles = cdiv(hp, th) * tiles_x;
  if (smem > kMaxSharedBytes || tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  auto kernel = vec ? encode_tiles<PRED, true, OUT> : encode_tiles<PRED, false, OUT>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  return over_batch(batch, [&](int b0, int nb) {
    kernel<<<dim3((unsigned)tiles, nb), kTileThreads, smem, stream>>>(
        src, grid, recon, quads, table, h, w, hp, wp, levels, f, coarse, th, tw, tiles_x, b0);
  });
}

// K1 lossy: the levels coarser than 2^F one launch each (the first also
// storing the anchors), then the finest F = min(levels, fine) in one
// launch of th x tw tiles.
template <int PRED>
cudaError_t encode_lossy_all(const uint8_t* src, uint8_t* grid, uint8_t* recon,
                             const KTable& table, int batch, int h, int w, int levels,
                             int th, int tw, int fine, bool vec, cudaStream_t stream) {
  const long long plane = (long long)h * w;
  const int f = levels < fine ? levels : fine;
  const int coarse = levels - f;
  for (int level = 0; level < coarse; ++level) {
    const int step = 1 << (levels - level);
    const Lattice lat(h, w, step);
    const cudaError_t err = over_batch(batch, [&](int b0, int nb) {
      encode_level<PRED><<<dim3(lat.blocks(), nb), kThreads, 0, stream>>>(
          src + b0 * plane, grid + b0 * plane, recon + b0 * plane, table, h, w, step,
          lat.wc, lat.cells, level == 0);
    });
    if (err != cudaSuccess) return err;
  }
  return encode_tiled<PRED, kGridOut>(src, grid, recon, TileQuadsOut{}, table, batch, h, w, h, w,
                                     levels, f, coarse > 0, th, tw, vec, stream);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Whether th x tw tiles with `fine` tiled levels are refused: the kernels
// take multiples of 16 and of 2^fine, fine <= kMaxFine.
bool bad_tiling(int th, int tw, int fine) {
  return fine < 0 || fine > kMaxFine || th <= 0 || tw <= 0 || th % 16 || tw % 16 ||
         th % (1 << fine) || tw % (1 << fine);
}

// The tiled launch of K2 (LOADER kGrid) or K5 (kQuads) over the batch: the
// finest f levels in th x tw tiles, a block a tile.
template <int PRED, int LOADER>
cudaError_t decode_tiled(const uint8_t* grid, const uint8_t* anchors, const TileQuads& tq,
                         uint8_t* out, int batch, int h, int w, int f, int upto, int ah,
                         int aw, bool coarse, int th, int tw, bool vec, cudaStream_t stream) {
  const int tiles_x = (int)cdiv(w, tw);
  const long long tiles = cdiv(h, th) * tiles_x;
  const int smem = decode_shared_bytes(th, tw, f);
  if (smem > kMaxSharedBytes || tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  auto kernel = vec ? decode_tiles<PRED, LOADER, true> : decode_tiles<PRED, LOADER, false>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  return over_batch(batch, [&](int b0, int nb) {
    kernel<<<dim3((unsigned)tiles, nb), kTileThreads, smem, stream>>>(
        grid, anchors, tq, out, h, w, f, upto, ah, aw, coarse, th, tw, tiles_x, b0);
  });
}

// K2: the levels coarser than 2^F one launch each (the first also storing
// the anchors), then the finest F = min(levels, fine) in one launch of
// th x tw tiles; fine = 0 leaves every level a launch of its own.
template <int PRED>
cudaError_t decode_all(const uint8_t* grid, uint8_t* out, int batch, int h, int w, int levels,
                       int th, int tw, int fine, bool vec, cudaStream_t stream) {
  const long long plane = (long long)h * w;
  const int f = levels < fine ? levels : fine;
  const int coarse = levels - f;
  for (int level = 0; level < coarse; ++level) {
    const int step = 1 << (levels - level);
    const Lattice lat(h, w, step);
    const cudaError_t err = over_batch(batch, [&](int b0, int nb) {
      decode_level<PRED><<<dim3(lat.blocks(), nb), kThreads, 0, stream>>>(
          grid + b0 * plane, out + b0 * plane, h, w, step, lat.wc, lat.cells, level == 0);
    });
    if (err != cudaSuccess) return err;
  }
  if (coarse > 0 && f == 0) return cudaSuccess;
  return decode_tiled<PRED, kGrid>(grid, nullptr, TileQuads{}, out, batch, h, w, f, 0, 0, 0,
                                   coarse > 0, th, tw, vec, stream);
}

// K3 lossless: one launch (encode_sub_lossless), a thread a 16-byte run of
// the canvas, a warp 32 runs of one row, 8 rows a block.
template <int PRED>
cudaError_t encode_sub_lossless_all(const uint8_t* src, uint8_t* anchors, uint8_t* const* quads,
                                    int batch, int h, int w, int levels, int hp, int wp,
                                    cudaStream_t stream) {
  SubbandsOut out = {};
  out.anchors = anchors;
  for (int i = 0; i < 3 * levels; ++i) out.q[i] = quads[i];
  const long long rows = cdiv(hp, kThreads / 32);
  const dim3 blocks((unsigned)cdiv(cdiv(wp, kRun), 32),
                    (unsigned)(rows < kMaxGridY ? rows : kMaxGridY));
  const bool vec = w % 16 == 0 && aligned16(src);
  return over_batch(batch, [&](int b0, int nb) {
    if (vec)
      encode_sub_lossless<PRED, true><<<dim3(blocks.x, blocks.y, nb), kThreads, 0, stream>>>(
          src, out, h, w, levels, hp, wp, b0);
    else
      encode_sub_lossless<PRED, false><<<dim3(blocks.x, blocks.y, nb), kThreads, 0, stream>>>(
          src, out, h, w, levels, hp, wp, b0);
  });
}

// K3 lossy: the levels coarser than 2^F one launch each (the first also
// storing the anchors), then the finest F = min(levels, fine) in one
// launch of th x tw tiles cut on the canvas, which store the anchors when
// no coarser level ran.  recon may be null when no coarser level runs:
// the tiles then write none.
template <int PRED>
cudaError_t encode_sub_lossy_all(const uint8_t* src, uint8_t* anchors, uint8_t* const* quads,
                                 uint8_t* recon, const KTable& table, int batch, int h, int w,
                                 int levels, int ah, int aw, int th, int tw, int fine, bool vec,
                                 cudaStream_t stream) {
  const long long plane = (long long)h * w;
  const int f = levels < fine ? levels : fine;
  const int coarse = levels - f;
  if (coarse > 0 && recon == nullptr) return cudaErrorInvalidValue;
  for (int level = 0; level < coarse; ++level) {
    const int step = 1 << (levels - level);
    const int qw = aw << level;
    const long long cells = ((long long)ah << level) * qw;
    uint8_t* const* q = quads + 3 * level;
    const cudaError_t err = over_batch(batch, [&](int b0, int nb) {
      const long long qo = b0 * cells;
      encode_sub_level<PRED><<<dim3(blocks_for(cells), nb), kThreads, 0, stream>>>(
          src + b0 * plane, recon + b0 * plane, level == 0 ? anchors + qo : nullptr, q[0] + qo,
          q[1] + qo, q[2] + qo, table, h, w, step, qw, cells);
    });
    if (err != cudaSuccess) return err;
  }
  TileQuadsOut out = {};
  for (int t = 0; t < f; ++t)
    for (int which = 0; which < 3; ++which) out.q[t][which] = quads[3 * (levels - t - 1) + which];
  out.anchors = coarse > 0 ? nullptr : anchors;
  return encode_tiled<PRED, kQuadsOut>(src, nullptr, recon, out, table, batch, h, w, ah << levels,
                                       aw << levels, levels, f, coarse > 0, th, tw, vec, stream);
}

// K5 on an h x w output (the preview's dims when upto is below the
// archive's depth), whose `upto` levels have steps 2^upto .. 2, level l
// reading the archive's level-l quads: the levels coarser than 2^F one
// launch each (the first also unpacking the anchors, ah x aw a plane),
// then the finest F = min(upto, fine) in one launch of th x tw tiles.
template <int PRED>
cudaError_t decode_sub_all(const uint8_t* anchors, const Quads& qs, uint8_t* out, int batch,
                           int h, int w, int upto, int ah, int aw, int th, int tw, int fine,
                           bool vec, cudaStream_t stream) {
  const long long plane = (long long)h * w;
  const long long acells = (long long)ah * aw;
  const int f = upto < fine ? upto : fine;
  const int coarse = upto - f;
  for (int level = 0; level < coarse; ++level) {
    const int step = 1 << (upto - level);
    const Lattice lat(h, w, step);
    const int qw = aw << level;
    const long long qplane = ((long long)ah << level) * qw;
    const uint8_t* const* q = qs.q + 3 * level;
    const cudaError_t err = over_batch(batch, [&](int b0, int nb) {
      const long long qo = b0 * qplane;
      decode_sub_level<PRED><<<dim3(lat.blocks(), nb), kThreads, 0, stream>>>(
          level == 0 ? anchors + b0 * acells : nullptr, q[0] + qo, q[1] + qo, q[2] + qo,
          out + b0 * plane, h, w, step, lat.wc, lat.cells, qw, qplane);
    });
    if (err != cudaSuccess) return err;
  }
  if (coarse > 0 && f == 0) return cudaSuccess;
  TileQuads tq = {};
  for (int t = 0; t < f; ++t)
    for (int which = 0; which < 3; ++which) tq.q[t][which] = qs.q[3 * (upto - t - 1) + which];
  return decode_tiled<PRED, kQuads>(nullptr, anchors, tq, out, batch, h, w, f, upto, ah, aw,
                                    coarse > 0, th, tw, vec, stream);
}

}  // namespace

extern "C" {

// K1: src, grid (and recon when lossy) are [batch, h, w] uint8 device
// buffers; `table` is the 256-entry quantizer table, by value, read only
// when `lossy` (else recon is unused).  `levels` is the effective depth;
// the lossy path tiles its finest min(levels, fine) levels in th x tw
// tiles (multiples of 16 and of 2^fine, fine <= 5).  Returns
// cudaGetLastError() after the last launch.
int hgi_encode(const void* src, void* grid, void* recon, QTable table, int lossy,
               int batch, int h, int w, int levels, int predictor, int th, int tw,
               int fine, void* stream) {
  const auto* s = static_cast<const uint8_t*>(src);
  auto* g = static_cast<uint8_t*>(grid);
  auto* r = static_cast<uint8_t*>(recon);
  auto st = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || h <= 0 || w <= 0) return cudaSuccess;
  if ((predictor != kCrossed && predictor != kLeftTop) || levels < 0 ||
      levels >= kMaxLevels)
    return cudaErrorInvalidValue;
  if (!lossy) {
    const bool vec = w % 16 == 0 && aligned16(s) && aligned16(g);
    return predictor == kCrossed
               ? encode_lossless_all<kCrossed>(s, g, batch, h, w, levels, vec, st)
               : encode_lossless_all<kLeftTop>(s, g, batch, h, w, levels, vec, st);
  }
  if (bad_tiling(th, tw, fine)) return cudaErrorInvalidValue;
  const bool vec = w % 16 == 0 && aligned16(s) && aligned16(g) && aligned16(r);
  const cudaError_t err =
      predictor == kCrossed
          ? encode_lossy_all<kCrossed>(s, g, r, ktable(table), batch, h, w, levels, th, tw,
                                       fine, vec, st)
          : encode_lossy_all<kLeftTop>(s, g, r, ktable(table), batch, h, w, levels, th, tw,
                                       fine, vec, st);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// K2: grid and out are [batch, h, w] uint8 device buffers; `levels` is
// the effective depth, whose finest min(levels, fine) levels run in th x tw
// tiles (the rules of hgi_encode's).
int hgi_decode(const void* grid, void* out, int batch, int h, int w, int levels,
               int predictor, int th, int tw, int fine, void* stream) {
  const auto* g = static_cast<const uint8_t*>(grid);
  auto* o = static_cast<uint8_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || h <= 0 || w <= 0) return cudaSuccess;
  if ((predictor != kCrossed && predictor != kLeftTop) || levels < 0 ||
      levels >= kMaxLevels || bad_tiling(th, tw, fine))
    return cudaErrorInvalidValue;
  const bool vec = w % 16 == 0 && aligned16(g) && aligned16(o);
  const cudaError_t err =
      predictor == kCrossed
          ? decode_all<kCrossed>(g, o, batch, h, w, levels, th, tw, fine, vec, st)
          : decode_all<kLeftTop>(g, o, batch, h, w, levels, th, tw, fine, vec, st);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// K3: src (and recon, when not null) are [batch, h, w] uint8 device
// buffers; anchors is [batch, ceil(h/2^L), ceil(w/2^L)] and quads a host
// array of 3*levels device pointers, level l's q01, q10, q11 each [batch,
// ceil(h/2^L) << l, ceil(w/2^L) << l].  `levels` is the effective depth.
// Lossless (`lossy` 0) is one launch and never writes recon, which is the
// source.  Lossy reads `table`, by value, and tiles its finest min(levels,
// fine) levels in th x tw tiles (hgi_encode's rules); recon may be null
// only when levels <= fine, and no recon is written then.
int hgi_encode_subbands(const void* src, void* anchors, void* const* quads, void* recon,
                        QTable table, int lossy, int batch, int h, int w, int levels,
                        int predictor, int th, int tw, int fine, void* stream) {
  const auto* s = static_cast<const uint8_t*>(src);
  auto* a = static_cast<uint8_t*>(anchors);
  auto* const* q = reinterpret_cast<uint8_t* const*>(quads);
  auto* r = static_cast<uint8_t*>(recon);
  auto st = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || h <= 0 || w <= 0) return cudaSuccess;
  if ((predictor != kCrossed && predictor != kLeftTop) || levels < 0 ||
      levels >= kMaxLevels || bad_tiling(th, tw, fine))
    return cudaErrorInvalidValue;
  const int ah = (int)cdiv(h, 1LL << levels);
  const int aw = (int)cdiv(w, 1LL << levels);
  if (((long long)ah << levels) > 0x7fffffffLL || ((long long)aw << levels) > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaError_t err;
  if (!lossy) {
    err = predictor == kCrossed
              ? encode_sub_lossless_all<kCrossed>(s, a, q, batch, h, w, levels, ah << levels,
                                                  aw << levels, st)
              : encode_sub_lossless_all<kLeftTop>(s, a, q, batch, h, w, levels, ah << levels,
                                                  aw << levels, st);
  } else {
    const bool vec = w % 16 == 0 && aligned16(s) && (r == nullptr || aligned16(r));
    err = predictor == kCrossed
              ? encode_sub_lossy_all<kCrossed>(s, a, q, r, ktable(table), batch, h, w, levels,
                                               ah, aw, th, tw, fine, vec, st)
              : encode_sub_lossy_all<kLeftTop>(s, a, q, r, ktable(table), batch, h, w, levels,
                                               ah, aw, th, tw, fine, vec, st);
  }
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// K4: anchors and quads as K3 writes them (`levels` = the number of
// levels given), on any byte boundary; grid is [batch, h, w].  One launch.
int hgi_assemble_grid(const void* anchors, const void* const* quads, void* grid, int batch,
                      int h, int w, int levels, void* stream) {
  auto* g = static_cast<uint8_t*>(grid);
  auto st = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || h <= 0 || w <= 0) return cudaSuccess;
  if (levels < 0 || levels >= kMaxLevels) return cudaErrorInvalidValue;
  SubbandsIn in = {};
  in.anchors = static_cast<const uint8_t*>(anchors);
  for (int i = 0; i < 3 * levels; ++i) in.q[i] = static_cast<const uint8_t*>(quads[i]);
  const int ah = (int)cdiv(h, 1LL << levels);
  const int aw = (int)cdiv(w, 1LL << levels);
  const long long chunks = cdiv(cdiv(w, 16), 32);  // 32 runs of 16 bytes, a warp's
  const long long rows = cdiv(h, kThreads / 32);
  const dim3 blocks((unsigned)chunks, (unsigned)(rows < kMaxGridY ? rows : kMaxGridY));
  const cudaError_t err = over_batch(batch, [&](int b0, int nb) {
    assemble_rows<<<dim3(blocks.x, blocks.y, nb), kThreads, 0, st>>>(in, g, h, w, levels, ah,
                                                                     aw, b0);
  });
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// K5: anchors and quads as K3 writes them for an h x w plane at effective
// depth `levels`, of which the first `upto` levels are decoded (quads
// holds their 3*upto pointers); out is [batch, ceil(h/s), ceil(w/s)]
// with s = 2^(levels-upto): the whole image when upto = levels.  The
// finest min(upto, fine) levels run in th x tw tiles (hgi_encode's rules).
int hgi_decode_subbands(const void* anchors, const void* const* quads, void* out, int batch,
                        int h, int w, int levels, int upto, int predictor, int th, int tw,
                        int fine, void* stream) {
  const auto* a = static_cast<const uint8_t*>(anchors);
  auto* o = static_cast<uint8_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || h <= 0 || w <= 0) return cudaSuccess;
  if ((predictor != kCrossed && predictor != kLeftTop) || levels < 0 ||
      levels >= kMaxLevels || upto < 0 || upto > levels || bad_tiling(th, tw, fine))
    return cudaErrorInvalidValue;
  Quads qs = {};
  for (int i = 0; i < 3 * upto; ++i) qs.q[i] = static_cast<const uint8_t*>(quads[i]);
  const long long s = 1LL << (levels - upto);
  const int ho = (int)cdiv(h, s);
  const int wo = (int)cdiv(w, s);
  const int ah = (int)cdiv(ho, 1LL << upto);  // ceil(h/2^L) x ceil(w/2^L)
  const int aw = (int)cdiv(wo, 1LL << upto);
  const bool vec = wo % 16 == 0 && aligned16(o);
  const cudaError_t err =
      predictor == kCrossed
          ? decode_sub_all<kCrossed>(a, qs, o, batch, ho, wo, upto, ah, aw, th, tw, fine, vec, st)
          : decode_sub_all<kLeftTop>(a, qs, o, batch, ho, wo, upto, ah, aw, th, tw, fine, vec, st);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

const char* hgi_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
