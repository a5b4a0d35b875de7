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
// 2^L (the canvas).  K3 runs the level loop over every cell of the canvas
// lattice, so it also emits the residuals of pixels that lie in the
// padding, where the source reads 0: code(0 - pred), exactly what the JAX
// encode_subbands and its Pallas kernel emit there.  K5 reads its
// residuals straight from the quads; the TPU's repack-then-decode split
// buys nothing here, so there is no grid in between.  Stopped after `upto`
// levels, it writes the preview: the full image sampled every
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
// K3 keeps one launch per level, one thread per cell of the `step`
// lattice (a level writes only positions off its lattice and reads only
// positions on it, so a launch per level is race-free), a thread reading
// 4 corners and coding up to 3 pixels; launches on one stream order the
// levels.
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
constexpr int kTileThreads = 256;  // threads of a block of the tiles of lossy K1, K2 and K5
constexpr int kMaxGridY = 65535;  // batch planes per launch
// Dims are at most 2^30 (the wrapper checks), so depths stop at 30.
constexpr int kMaxLevels = 31;
constexpr int kRun = 16;          // pixels of a row a lossless K1 thread codes
constexpr int kMaxFine = 5;       // the tiled levels of lossy K1, K2 and K5 at most
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
template <int PRED>
__device__ __forceinline__ uint32_t lossless_pixel(const uint8_t* __restrict__ p, int h,
                                                   int w, int y, int x, int levels) {
  const int yx = y | x;
  const int t = yx == 0 ? levels : min(__ffs(yx) - 1, levels);
  const int v = p[(long long)y * w + x];
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

// A run of kRun pixels of row y (lowest set bit TY) starting at column x0,
// kRun <= w - x0: every row its cells read is one 16-byte load (zero below
// the plane) plus the byte after it (zero past the plane's right edge); at
// TY == 4 column 0, whose cell may reach beyond the run, reads its corners
// one by one.
template <int PRED, bool VEC, int TY>
__device__ __forceinline__ void lossless_run(const uint8_t* __restrict__ p, uint8_t* __restrict__ g,
                                             int h, int w, int y, int x0, int levels, long long k) {
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
  uint32_t out[4] = {0u, 0u, 0u, 0u};
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
  store_run<VEC>(g + k, out);
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
  switch (y == 0 ? 4 : min(__ffs(y) - 1, 4)) {
    case 0: lossless_run<PRED, VEC, 0>(p, g, h, w, y, x0, levels, k); break;
    case 1: lossless_run<PRED, VEC, 1>(p, g, h, w, y, x0, levels, k); break;
    case 2: lossless_run<PRED, VEC, 2>(p, g, h, w, y, x0, levels, k); break;
    case 3: lossless_run<PRED, VEC, 3>(p, g, h, w, y, x0, levels, k); break;
    default: lossless_run<PRED, VEC, 4>(p, g, h, w, y, x0, levels, k); break;
  }
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

// The finest `fine` levels of one th x tw tile (blockIdx.x; tiles_x a row
// of tiles) of plane blockIdx.y, th and tw multiples of 16 and of 2^fine.
// `coarse`: coarser levels ran before, so the 2^fine lattice holds their
// reconstruction and grid; otherwise it is the anchors, the source.  VEC:
// w % 16 == 0 and every buffer on a 16-byte boundary.
template <int PRED, bool VEC>
__global__ void __launch_bounds__(kTileThreads)
    encode_tiles(const uint8_t* __restrict__ src, uint8_t* __restrict__ grid,
                 uint8_t* __restrict__ recon, KTable table, int h, int w, int fine,
                 bool coarse, int th, int tw, int tiles_x) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int S = 1 << fine;
  const int rh = th + S, rw = tw + S;  // the tile and its halo; rows and columns 0..rh, 0..rw
  const int pitch = round16(rw + 1);
  uint8_t* qt = smem;
  uint8_t* rc = smem + 256;           // reconstruction
  uint8_t* sc = rc + (rh + 1) * pitch;  // source, then residuals
  const long long plane = (long long)blockIdx.y * h * w;
  src += plane;
  grid += plane;
  recon += plane;
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
  // levels it is their reconstruction, and their grid values replace the
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
      if (r < th && c < tw) sc[o] = grid[k];
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
      // latencies of both overlap.
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
          if (!in[u][j]) continue;  // outside the plane, or no cell
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

// Codes one refined pixel of K3 into its quad at qk; a pixel in the
// canvas padding reads 0 and has no recon.
template <bool LOSSLESS>
__device__ __forceinline__ void emit(const uint8_t* __restrict__ src,
                                     uint8_t* recon, uint8_t* __restrict__ quad,
                                     long long qk, bool inside, long long k,
                                     int pred, const uint8_t* qt) {
  const int g = residual<LOSSLESS>(inside ? src[k] : 0, pred, qt);
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
                                 uint8_t* __restrict__ q11, KTable table, int h,
                                 int w, int step, int qw, long long cells) {
  __shared__ __align__(16) uint8_t qt[256];
  if (!LOSSLESS) {
    load_table(qt, table);
    __syncthreads();
  }
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
  emit<LOSSLESS>(src, recon, q01, qk, top && right, k + sub, pred, qt);
  emit<LOSSLESS>(src, recon, q10, qk, down && left, kd, pred, qt);
  emit<LOSSLESS>(src, recon, q11, qk, down && right, kd + sub, pred, qt);
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
  const int smem = tile_shared_bytes(th, tw, f);
  const int tiles_x = (int)cdiv(w, tw);
  const long long tiles = cdiv(h, th) * tiles_x;
  if (smem > kMaxSharedBytes || tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  auto kernel = vec ? encode_tiles<PRED, true> : encode_tiles<PRED, false>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  return over_batch(batch, [&](int b0, int nb) {
    kernel<<<dim3((unsigned)tiles, nb), kTileThreads, smem, stream>>>(
        src + b0 * plane, grid + b0 * plane, recon + b0 * plane, table, h, w, f,
        coarse > 0, th, tw, tiles_x);
  });
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

// K3's level loop.  Level l's canvas lattice has (ah << l) x (aw << l)
// cells of side 2^(levels-l).
template <int PRED, bool LOSSLESS>
cudaError_t encode_sub_levels(const uint8_t* src, uint8_t* const* quads,
                              uint8_t* recon, const KTable& table, int batch, int h,
                              int w, int levels, int ah, int aw,
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
              q[0] + qo, q[1] + qo, q[2] + qo, table, h, w, step, qw, cells);
    });
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
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

// K3: src and recon are [batch, h, w] uint8 device buffers (recon only
// when `lossy`, which also reads `table`, by value); anchors is [batch,
// ceil(h/2^L), ceil(w/2^L)] and quads a host array of 3*levels device
// pointers, level l's q01, q10, q11 each [batch, ceil(h/2^L) << l,
// ceil(w/2^L) << l].  `levels` is the effective depth.
int hgi_encode_subbands(const void* src, void* anchors, void* const* quads,
                        void* recon, QTable table, int lossy, int batch, int h,
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
  const bool lossless = !lossy;
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
  const KTable kt = ktable(table);
  if (predictor == kCrossed)
    err = lossless ? encode_sub_levels<kCrossed, true>(s, q, r, kt, batch, h, w, levels, ah, aw, st)
                   : encode_sub_levels<kCrossed, false>(s, q, r, kt, batch, h, w, levels, ah, aw, st);
  else
    err = lossless ? encode_sub_levels<kLeftTop, true>(s, q, r, kt, batch, h, w, levels, ah, aw, st)
                   : encode_sub_levels<kLeftTop, false>(s, q, r, kt, batch, h, w, levels, ah, aw, st);
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
