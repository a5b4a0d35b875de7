// Device entropy stages of the .thgi fast mode for Hopper (sm_90a).
//
//   X1  rans_tpu_encode  replaces rustyhgi_tpu/ops/tpurans.py encode_device
//                        (an XLA program, not Pallas): codec 7
//   K6  bitpack_pack     replaces rustyhgi_tpu/ops/pallas_kernels.py
//                        pack_blocks (body _pack_kernel): codec 2, write
//   K7  bitpack_unpack   replaces pallas_kernels.py unpack_blocks (body
//                        _unpack_kernel): codec 2, read
//
// Each computes what the TPU code computes, bit for bit; none of its
// tiling is carried over.
//
// X1 encodes [B, n] planes, each with its own table and lanes, in three
// kernels and one memset on the caller's stream:
//   1. rans_histogram: 16-byte loads, one 256-bin sub-histogram per warp
//      in shared memory, merged per block and added into the plane's
//      global counts with atomics (integer, so order-free and exact);
//   2. rans_normalize: one block of 256 threads per plane, one symbol per
//      thread.  It counts the T*L - n padding zeros into symbol 0 (they
//      are coded), then runs the JAX normalizer: the float32 quotient
//      floor(f32(count) * 16384 / f32(total)) with IEEE division, the
//      drift absorbed by the first most frequent symbol, six rounds of
//      +-1 units spread by a block-wide scan.  It writes freq and, per
//      symbol, the lanes' entry {m_lo, m_hi, f << 18, (M - f) | bias << 16}
//      with m = floor((2^64 - 1) / f) + 1, and clears the lanes' look-back
//      state;
//   3. rans_encode_lanes: a block of W lanes (a ticket taken at its start
//      orders the blocks), the table in shared memory.  The block's
//      [rows, W] byte tile of symbols (row t of lane l at t*L + l) is
//      staged ahead of use in chunks of rows, double-buffered with
//      cp.async (16-byte pieces; the bytes at or past n are zero-filled,
//      so the padding codes symbol 0).  Each lane walks its rows
//      t = T-1 .. 0 in groups of four, three groups in flight: the
//      symbols of the group after next, the entries of the next, the
//      state updates of this one; the entries do not depend on the state.
//      The division x / f is a multiply-high: q = hi64(x * m), exact for
//      every x < 2^32 and f in [2, 2^14) since x * (m*f - 2^64) < 2^64;
//      for f = 1, m = 2^64 - 1 gives q = x - 1 and the entry's bias adds
//      the missing M - 1.  So the state's chain per row is a compare, a
//      predicated shift, two multiply-highs and a multiply-add.  The word
//      a row would emit is stored to shared memory every row, kept by
//      moving the lane's slot on when it is emitted: no branch.  After
//      each chunk a warp writes its lanes' words to their scratch rows,
//      from each row's end backwards, so a row ends in stored order.  The
//      block's word count then takes its offset by a decoupled look-back
//      over the blocks before it (one warp, 32 predecessors a step), and
//      the block copies its lanes' words, one run of the stream, to place.
//      That is the stored order (lane-major, decode order within a lane,
//      planes one after another), the same placement as JAX's global
//      sort_key_val, without a sort and without a stage that runs as one
//      block.
// What bounds it on this card: not bytes (one 1080x1920 plane reads 2 MB
// and writes about 1.3 MB) and not the issue rate, but the lanes' serial
// chain: T rows times the latency of one state update, on L lanes (2048
// at 1080x1920, one warp on each of 64 SMs).  With a single warp on its
// scheduler, any instruction that waits stalls the chain; so the loads
// run groups ahead, in an order the volatile shared-memory accesses keep,
// and the stores read a copy of the state.  A batch fills the card over
// its B * L / W blocks.
//
// K6 and K7 take a warp per 1024-symbol block ([8, 128]: row k, column
// j), or per 2 or 4 consecutive blocks, kPackWarps warps a CTA.  Lane l
// holds columns 4l .. 4l+3 of the 8 rows as eight 32-bit words: a warp's
// access to one row or plane is one whole 128-byte line.  K6 folds the
// four bytes of a word at once (SWAR zigzag), ORs the words and then the
// warp (__reduce_or_sync): the bit length of the OR is the block's width.
// Three mask-and-shift stages transpose each byte column's 8x8 bit
// matrix, so word r becomes plane r.  Compacting (codec 2's write), the
// CTA takes a ticket, sums its blocks' widths, and a decoupled look-back
// over the CTAs before it (X1's look_back) gives its first plane; each
// warp then stores only its kept planes, and the CTA writes its width
// nibbles (and CTA 0 the header) into place: the device buffer holds the
// codec-2 body as it is written to the archive, its planes on a 16-byte
// boundary, and the last CTA writes the planes' total for the host's
// first, 8-byte fetch.  The look-back's words are zeroed on the stream
// before each launch.  K7 compacted reads the body as it lies in the
// archive: a CTA's first plane is the sum of the nibbles before it, and
// each warp loads its blocks' kept planes (the rest zero), transposes
// back, unfolds and stores its 1024 bytes a block.  Without compaction
// (JAX's pack_blocks and unpack_blocks contract) the same kernels write
// or read all 8 planes of every block at block * 8.  What bounds both on
// this card: device memory, the stream read once and the kept planes
// written once (or the reverse); the fold and the transposes take some
// 40 integer instructions a word of four symbols.  At one 1080x1920
// plane the look-back's chain of round trips through L2, not the bytes,
// sets compacting K6's time.  16-byte accesses would need the planes
// regathered through shared memory: more instructions for the same
// lines.

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kScaleBits = 14;
constexpr int kM = 1 << kScaleBits;
constexpr uint32_t kStateL = 1u << 16;  // state lower bound
constexpr int kRenormShift = 18;        // emit iff x >= freq << 18
constexpr int kMinLanes = 128, kMaxLanes = 8192;
constexpr int kMaxGridY = 65535;  // planes per histogram launch
constexpr int kHistThreads = 256;
constexpr int kHistWarps = kHistThreads / 32;
constexpr long long kHistBytesPerBlock = 1 << 15;  // 8 16-byte loads a thread
constexpr int kHistMaxBlocksPerPlane = 264;        // 2 per SM on 132 SMs
// Symbol rows staged per chunk: the tile, its double buffer and the
// emitted words of a chunk stay within the 48 KB of static shared memory.
__host__ __device__ constexpr int chunk_rows(int lanes_a_block) {
  return lanes_a_block == 128 ? 64 : 128;
}
constexpr unsigned long long kAggregate = 1ull, kPrefix = 2ull;  // look-back flags
constexpr unsigned long long kValueMask = (1ull << 62) - 1;
constexpr int kBlock = 1024;  // symbols per bit-pack block: [8, 128]
constexpr int kLane = 128;
constexpr int kPackWarps = 8;  // K6's and K7's blocks a CTA, one a warp
// Compacting K6's look-back words: the ticket counter, then a CTA's word.
constexpr int kPackCounters = 1;

// Inclusive block-wide scan of v; *total gets the sum over the block.
// Every thread of a block of kWarps * 32 threads must call it.
template <typename T, int kWarps>
__device__ T block_scan(T v, T* warp_tot, T* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T u = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += u;
  }
  if (lane == 31) warp_tot[warp] = v;
  __syncthreads();
  T prefix = 0, sum = 0;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) {
    const T t = warp_tot[i];
    if (i < warp) prefix += t;
    sum += t;
  }
  __syncthreads();  // warp_tot may be written again by the next call
  *total = sum;
  return v + prefix;
}

__device__ __forceinline__ void count4(int* h, uint32_t word) {
  atomicAdd(&h[word & 255u], 1);
  atomicAdd(&h[(word >> 8) & 255u], 1);
  atomicAdd(&h[(word >> 16) & 255u], 1);
  atomicAdd(&h[word >> 24], 1);
}

// Plane blockIdx.y: the bytes before its first 16-byte boundary one by
// one, then 16-byte loads, then the tail.
__global__ void __launch_bounds__(kHistThreads)
    rans_histogram(const uint8_t* __restrict__ sym, int* hist, long long n) {
  __shared__ int sub[kHistWarps][256];
  for (int i = threadIdx.x; i < kHistWarps * 256; i += kHistThreads) (&sub[0][0])[i] = 0;
  __syncthreads();
  int* mine = sub[threadIdx.x >> 5];
  const uint8_t* s = sym + (long long)blockIdx.y * n;
  const long long head =
      min(n, (long long)((16 - (reinterpret_cast<uintptr_t>(s) & 15)) & 15));
  const long long vecs = (n - head) >> 4;
  const long long tid = (long long)blockIdx.x * kHistThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kHistThreads;
  if (tid < head) atomicAdd(&mine[s[tid]], 1);
  const uint4* v = reinterpret_cast<const uint4*>(s + head);
  for (long long i = tid; i < vecs; i += stride) {
    const uint4 q = v[i];
    count4(mine, q.x);
    count4(mine, q.y);
    count4(mine, q.z);
    count4(mine, q.w);
  }
  for (long long i = head + (vecs << 4) + tid; i < n; i += stride) atomicAdd(&mine[s[i]], 1);
  __syncthreads();
  int c = 0;
#pragma unroll
  for (int w = 0; w < kHistWarps; ++w) c += sub[w][threadIdx.x];
  if (c) atomicAdd(&hist[blockIdx.y * 256 + threadIdx.x], c);
}

// One block of 256 threads per plane; `freq` holds the histogram on entry
// and the table on exit.  Also clears the plane's `per_plane` look-back
// words, and block 0 the lanes' ticket.
__global__ void rans_normalize(int* freq, uint4* entries, int total, int pad,
                               unsigned long long* status, int per_plane,
                               unsigned* ticket) {
  __shared__ int warp_tot[8];
  __shared__ unsigned long long warp_max[8];
  __shared__ int fmx_shared;
  const int s = threadIdx.x;
  int* fp = freq + blockIdx.x * 256LL;
  const int c = fp[s] + (s == 0 ? pad : 0);
  if (s < per_plane) status[(long long)blockIdx.x * per_plane + s] = 0;
  if (blockIdx.x == 0 && s == 0) *ticket = 0;

  // floor(f32(c) * 16384 / f32(total)); c and total are exact in f32.
  const float q = __fdiv_rn(__fmul_rn((float)c, (float)kM), (float)total);
  const int scaled = (int)floorf(q);
  int f = c > 0 ? min(max(scaled, 1), kM - 1) : 0;
  int sum;
  block_scan<int, 8>(f, warp_tot, &sum);
  int drift = kM - sum;

  // argmax taking the first maximum: the largest (count, 255 - index).
  unsigned long long key = ((unsigned long long)(unsigned)c << 32) | (unsigned)(255 - s);
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const unsigned long long o = __shfl_down_sync(0xffffffffu, key, d);
    key = o > key ? o : key;
  }
  if ((s & 31) == 0) warp_max[s >> 5] = key;
  __syncthreads();
  key = warp_max[0];
  for (int i = 1; i < 8; ++i) key = warp_max[i] > key ? warp_max[i] : key;
  const int mx = 255 - (int)(key & 0xffffffffu);
  if (s == mx) fmx_shared = f;
  __syncthreads();
  const int fmx = fmx_shared;
  const int give = min(max(drift, -(fmx - 1)), (kM - 1) - fmx);
  if (s == mx) f += give;
  drift -= give;

  // Residual drift: +-1 units to the first |drift| eligible symbols, six
  // rounds (the JAX normalizer's bound).
  for (int round = 0; round < 6; ++round) {
    const bool pos = drift > 0;
    const int eligible = pos ? (f < kM - 1) : (f > 1);
    int count;
    const int rank = block_scan<int, 8>(eligible, warp_tot, &count);
    const int need = drift < 0 ? -drift : drift;
    if (eligible && rank <= need) f += pos ? 1 : -1;
    const int moved = min(count, need);
    drift -= pos ? moved : -moved;
  }
  const int cum = block_scan<int, 8>(f, warp_tot, &sum) - f;
  fp[s] = f;
  // The lanes' entry (an absent symbol's is never read).
  const unsigned long long m = f >= 2 ? ~0ull / (unsigned)f + 1 : ~0ull;
  const uint32_t bias = (uint32_t)cum + (f >= 2 ? 0u : (uint32_t)(kM - 1));
  entries[blockIdx.x * 256LL + s] =
      make_uint4((uint32_t)m, (uint32_t)(m >> 32), (uint32_t)f << kRenormShift,
                 (uint32_t)(kM - f) | (bias << 16));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int bytes) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_prev() {  // all groups but the newest
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Rows [lo, hi) of the block's lanes l0 .. l0+W-1 into dst[row - lo][lane]:
// 16-byte cp.async pieces (VEC: the plane starts on a 16-byte boundary),
// else byte by byte; positions at or past n read 0.
template <int W, bool VEC>
__device__ __forceinline__ void stage_rows(uint8_t (*dst)[W], const uint8_t* plane,
                                           long long n, int lanes, int l0, int lo,
                                           int hi) {
  const int rows = hi - lo;
  if (VEC) {
    constexpr int kPieces = W / 16;
    for (int i = threadIdx.x; i < rows * kPieces; i += W) {
      const int r = i / kPieces, p = i % kPieces;
      const long long pos = (long long)(lo + r) * lanes + l0 + 16 * p;
      const long long left = n - pos;
      const int bytes = left >= 16 ? 16 : (left > 0 ? (int)left : 0);
      cp_async16(&dst[r][16 * p], plane + (bytes ? pos : 0), bytes);
    }
  } else {
    for (int r = 0; r < rows; ++r) {
      const long long pos = (long long)(lo + r) * lanes + l0 + threadIdx.x;
      dst[r][threadIdx.x] = pos < n ? plane[pos] : 0;
    }
  }
}

// Shared-memory accesses of the lanes loop, volatile: the machine code
// keeps them in the order written, so the loads of later rows stay ahead
// of the state updates that need them.  Addresses are shared-window bytes.
__device__ __forceinline__ uint32_t shared_u8(uint32_t a) {
  uint32_t v;
  asm volatile("ld.volatile.shared.u8 %0, [%1];" : "=r"(v) : "r"(a));
  return v;
}

__device__ __forceinline__ uint4 shared_v4(uint32_t a) {
  uint4 v;
  asm volatile("ld.volatile.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(a));
  return v;
}

__device__ __forceinline__ void shared_store_u16(uint32_t a, uint32_t v) {
  asm volatile("st.volatile.shared.u16 [%0], %1;" ::"r"(a), "h"((unsigned short)v) : "memory");
}

// One symbol into the state x with its entry e.  The word x would emit is
// stored at slot + n * pitch every row, whether it is emitted or not; an
// emission keeps it by moving n on.  So no branch, and the store reads a
// copy of x, so that the shift below need not wait for the store to read
// its operand.
template <int PITCH>
__device__ __forceinline__ void rans_step(uint32_t& x, const uint4 e, uint32_t slot, int& n) {
  shared_store_u16(slot + 2u * PITCH * n, __byte_perm(x, 0u, 0x0010));  // a copy of x
  const bool emit = x >= e.z;
  n += emit;
  x = emit ? x >> 16 : x;
  const uint32_t mid = __umulhi(x, e.x);
  const uint32_t q = (uint32_t)(((unsigned long long)x * e.y + mid) >> 32);
  x += q * (e.w & 0xffffu) + (e.w >> 16);
}

// The symbols of rows r, r-1, r-2, r-3 of the lane's staged column.
template <int W>
__device__ __forceinline__ void load_syms(uint32_t (&s)[4], uint32_t col, int r) {
#pragma unroll
  for (int i = 0; i < 4; ++i) s[i] = shared_u8(col + (r - i) * W);
}

__device__ __forceinline__ void load_entries(uint4 (&e)[4], uint32_t tab, const uint32_t (&s)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) e[i] = shared_v4(tab + (s[i] << 4));
}

template <int PITCH>
__device__ __forceinline__ void step_group(uint32_t& x, const uint4 (&e)[4], uint32_t slot,
                                           int& n) {
#pragma unroll
  for (int i = 0; i < 4; ++i) rans_step<PITCH>(x, e[i], slot, n);
}

__device__ __forceinline__ unsigned long long load_status(const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

// Warp 0 of block `blk`: publishes the block's word count `agg`, then sums
// the counts of every block before it, 32 at a time, back to the nearest
// that holds its inclusive prefix; publishes its own and returns the
// exclusive one.
__device__ unsigned long long look_back(unsigned long long* status, int blk,
                                        unsigned long long agg) {
  const int lane = threadIdx.x & 31;
  if (blk == 0) {
    if (lane == 0) atomicExch(status, (kPrefix << 62) | agg);
    return 0;
  }
  if (lane == 0) atomicExch(status + blk, (kAggregate << 62) | agg);
  unsigned long long excl = 0;
  for (int j = blk - 1;; j -= 32) {
    const int idx = j - lane;
    unsigned long long v = kPrefix << 62;  // before block 0: a prefix of 0
    if (idx >= 0) {
      do {
        v = load_status(status + idx);
      } while ((v >> 62) == 0);
    }
    const unsigned prefix = __ballot_sync(0xffffffffu, (v >> 62) == kPrefix);
    const int last = prefix ? __ffs(prefix) - 1 : 31;
    unsigned long long add = lane <= last ? (v & kValueMask) : 0;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) add += __shfl_xor_sync(0xffffffffu, add, d);
    excl += add;
    if (prefix) break;
  }
  if (lane == 0) atomicExch(status + blk, (kPrefix << 62) | (excl + agg));
  return excl;
}

template <int W, bool VEC>
__global__ void __launch_bounds__(W)
    rans_encode_lanes(const uint8_t* __restrict__ sym, const uint4* __restrict__ entries,
                      uint16_t* scratch, int* __restrict__ counts,
                      uint32_t* __restrict__ states, uint16_t* __restrict__ stream,
                      unsigned long long* status, unsigned* ticket, long long n,
                      int lanes, int rows) {
  constexpr int kChunkRows = chunk_rows(W);
  constexpr int kPitch = W + 2;  // emitted words: rows kPitch apart, off one bank
  __shared__ uint4 tab[256];
  __shared__ __align__(16) uint8_t tile[2][kChunkRows][W];
  __shared__ uint16_t emitted[kChunkRows * kPitch];  // this chunk's, per lane
  __shared__ int warp_tot[W / 32];
  __shared__ int s_blk;
  __shared__ unsigned long long s_excl;
  if (threadIdx.x == 0) s_blk = (int)atomicAdd(ticket, 1u);
  __syncthreads();
  const int blk = s_blk;
  const int per_plane = lanes / W;
  const long long b = blk / per_plane;
  const int l0 = (blk % per_plane) * W;
  for (int i = threadIdx.x; i < 256; i += W) tab[i] = entries[b * 256 + i];
  const uint8_t* plane = sym + b * n;
  // Emission k goes to scratch[row_end - k]: each lane's scratch row is
  // filled from its end, so it ends in stored order.
  uint16_t* row_end = scratch + (b * lanes + l0 + threadIdx.x) * rows + rows - 1;
  const uint32_t slot = (uint32_t)__cvta_generic_to_shared(emitted + threadIdx.x);
  const uint32_t tab_s = (uint32_t)__cvta_generic_to_shared(tab);

  // Chunks from the top: the first holds ((rows - 1) % kChunkRows) + 1
  // rows, the others kChunkRows.
  int hi = rows, lo = rows - ((rows - 1) % kChunkRows + 1);
  stage_rows<W, VEC>(tile[0], plane, n, lanes, l0, lo, hi);
  cp_async_commit();
  uint32_t x = kStateL;
  int k = 0;  // words emitted before this chunk
  for (int c = 0; hi > 0; ++c) {
    const int next = max(lo - kChunkRows, 0);
    if (lo > 0) stage_rows<W, VEC>(tile[(c + 1) & 1], plane, n, lanes, l0, next, lo);
    cp_async_commit();  // possibly empty
    cp_async_wait_prev();
    __syncthreads();
    const uint32_t col = (uint32_t)__cvta_generic_to_shared(&tile[c & 1][0][threadIdx.x]);
    int r = hi - lo - 1, m = 0;  // m: words emitted in this chunk
    for (; (r & 3) != 3; --r) rans_step<kPitch>(x, shared_v4(tab_s + (shared_u8(col + r * W) << 4)), slot, m);
    if (r >= 3) {
      // Groups of four rows, three in flight: the symbols of the group
      // after next, the entries of the next group (from symbols read a
      // group earlier), the state updates of this one.  A row past the
      // chunk's last group reads a valid row, never used.
      uint32_t sa[4], sb[4];
      uint4 a[4], e[4];
      load_syms<W>(sa, col, r);
      load_entries(a, tab_s, sa);
      load_syms<W>(sb, col, max(r - 4, 3));
#pragma unroll 1
      for (;;) {
        load_entries(e, tab_s, sb);
        load_syms<W>(sa, col, max(r - 8, 3));
        step_group<kPitch>(x, a, slot, m);
        r -= 4;
        if (r < 3) break;
        load_entries(a, tab_s, sa);
        load_syms<W>(sb, col, max(r - 8, 3));
        step_group<kPitch>(x, e, slot, m);
        r -= 4;
        if (r < 3) break;
      }
    }
    // The lane writes its words of the chunk to its scratch row, from the
    // row's end backwards, so that the row ends in stored order.
    {
      uint16_t* dst = row_end - k;
      const uint16_t* from = emitted + threadIdx.x;
#pragma unroll 4
      for (int i = 0; i < m; ++i) dst[-i] = from[i * kPitch];
    }
    k += m;
    __syncthreads();  // the tile buffer is staged again two chunks on
    hi = lo;
    lo = next;
  }
  const long long lane_id = b * lanes + l0 + threadIdx.x;
  counts[lane_id] = k;
  states[lane_id] = x;

  int total;
  const int incl = block_scan<int, W / 32>(k, warp_tot, &total);
  if (threadIdx.x < 32) {
    const unsigned long long excl = look_back(status, blk, (unsigned long long)total);
    if (threadIdx.x == 0) s_excl = excl;
  }
  __syncthreads();
  // The block's lanes' words are one run of the stream, lane after lane:
  // each lane copies its own, eight words read before any is written.
  const uint16_t* from = row_end - (k - 1);
  uint16_t* to = stream + s_excl + (incl - k);
  for (int i = 0; i < k; i += 8) {
    uint16_t v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (i + u < k) v[u] = from[i + u];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (i + u < k) to[i + u] = v[u];
  }
}

template <int W>
cudaError_t launch_lanes(bool vec, unsigned blocks, cudaStream_t st, const uint8_t* s,
                         const uint4* e, uint16_t* scr, int* c, uint32_t* x,
                         uint16_t* out, unsigned long long* status, unsigned* ticket,
                         long long n, int lanes, int rows) {
  if (vec)
    rans_encode_lanes<W, true><<<blocks, W, 0, st>>>(s, e, scr, c, x, out, status, ticket,
                                                     n, lanes, rows);
  else
    rans_encode_lanes<W, false><<<blocks, W, 0, st>>>(s, e, scr, c, x, out, status,
                                                      ticket, n, lanes, rows);
  return cudaGetLastError();
}

// Zigzag (and its inverse) of the four bytes of a word at once: byte v
// to (v << 1) ^ (v >= 128 ? 0xff : 0), 8 bits each.
__device__ __forceinline__ uint32_t zigzag4(uint32_t v) {
  return ((v << 1) & 0xfefefefeu) ^ (((v >> 7) & 0x01010101u) * 0xffu);
}

__device__ __forceinline__ uint32_t unzigzag4(uint32_t z) {
  return ((z >> 1) & 0x7f7f7f7fu) ^ ((z & 0x01010101u) * 0xffu);
}

// Swap the bits of a above b's by D (mask m): one stage of the transpose.
template <int D>
__device__ __forceinline__ void swap_bits(uint32_t& a, uint32_t& b, uint32_t m) {
  const uint32_t t = ((a >> D) ^ b) & m;
  a ^= t << D;
  b ^= t;
}

// Bit r of byte c of w[k] to bit k of byte c of w[r]: the 8x8 bit
// transpose of each of the four byte columns, in three stages.  It is its
// own inverse.
__device__ __forceinline__ void transpose8(uint32_t (&w)[8]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) swap_bits<4>(w[k], w[k + 4], 0x0f0f0f0fu);
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    swap_bits<2>(w[k], w[k + 2], 0x33333333u);
    swap_bits<2>(w[k + 4], w[k + 6], 0x33333333u);
  }
#pragma unroll
  for (int k = 0; k < 8; k += 2) swap_bits<1>(w[k], w[k + 1], 0x55555555u);
}

// Four bytes at p, those at or past `left` read as 0.
__device__ __forceinline__ uint32_t load4_bytes(const uint8_t* p, long long left) {
  uint32_t v = 0;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (c < left) v |= (uint32_t)p[c] << (8 * c);
  return v;
}

// Blocks blk0 .. blk0 + kPer - 1 of the stream, lane's columns, as words
// of 4 bytes a row (0 past the stream).
template <int kPer>
__device__ __forceinline__ void load_blocks(uint32_t (&w)[kPer][8], const uint8_t* in,
                                            long long blk0, long long n, int nb, bool vec) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const long long blk = blk0 + p;
    const long long base = blk * kBlock + 4 * lane;
    if (blk >= nb) {
#pragma unroll
      for (int k = 0; k < 8; ++k) w[p][k] = 0;
    } else if (vec && blk * kBlock + kBlock <= n) {
      const uint32_t* src = reinterpret_cast<const uint32_t*>(in + base);
#pragma unroll
      for (int k = 0; k < 8; ++k) w[p][k] = __ldg(src + k * (kLane / 4));
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k)
        w[p][k] = load4_bytes(in + base + k * kLane, n - base - k * kLane);
    }
  }
}

// K6.  A warp packs kPer consecutive blocks, a CTA kPackWarps * kPer.
// kCompact: the codec-2 body into place (see the note at the top):
// `head` gets the header and the nibbles, `planes` (4-byte aligned) the
// kept planes one block after another, *total the planes' count; `words`
// is the look-back state, zeroed before the launch.  Else `planes` gets
// [nb, 8, 128] and `widths` [nb].  vec: `in` is 4-byte aligned.
template <bool kCompact, int kPer>
__global__ void __launch_bounds__(kPackWarps * 32)
    bitpack_pack_warps(const uint8_t* __restrict__ in, uint8_t* __restrict__ planes,
                       int* __restrict__ widths, uint8_t* __restrict__ head,
                       unsigned long long* words, unsigned long long* total, long long n,
                       int nb, bool vec) {
  constexpr int kCtaBlocks = kPackWarps * kPer;
  __shared__ int s_width[kCtaBlocks];
  __shared__ unsigned long long s_excl;
  __shared__ int s_cta;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int cta = blockIdx.x;
  if (kCompact) {  // the ticket orders the look-back
    if (threadIdx.x == 0) s_cta = (int)atomicAdd(reinterpret_cast<unsigned*>(words), 1u);
    __syncthreads();
    cta = s_cta;
  }
  uint32_t w[kPer][8];
  load_blocks<kPer>(w, in, (long long)cta * kCtaBlocks + warp * kPer, n, nb, vec);
  const long long blk0 = (long long)cta * kCtaBlocks + warp * kPer;
  int width[kPer];
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    uint32_t any = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      w[p][k] = zigzag4(w[p][k]);
      any |= w[p][k];
    }
    any = __reduce_or_sync(0xffffffffu, any);
    any |= any >> 16;
    any |= any >> 8;
    width[p] = 32 - __clz(any & 0xffu);  // bit length: planes kept (0 past the last block)
    transpose8(w[p]);
  }
  if (!kCompact) {
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const long long blk = blk0 + p;
      if (blk >= nb) break;
      uint32_t* dst = reinterpret_cast<uint32_t*>(planes + blk * kBlock) + lane;
#pragma unroll
      for (int r = 0; r < 8; ++r) dst[r * (kLane / 4)] = w[p][r];
      if (lane == 0) widths[blk] = width[p];
    }
    return;
  }
  if (lane == 0) {
#pragma unroll
    for (int p = 0; p < kPer; ++p) s_width[warp * kPer + p] = width[p];
  }
  __syncthreads();
  if (warp == 0) {
    const int mine = lane < kCtaBlocks ? s_width[lane] : 0;
    const long long nnib = (nb + 1) / 2;
    const long long byte = (long long)cta * (kCtaBlocks / 2) + lane;
    if (lane < kCtaBlocks / 2 && byte < nnib)
      head[8 + byte] = (uint8_t)(s_width[2 * lane] | (s_width[2 * lane + 1] << 4));
    if (cta == 0 && lane < 8)  // u32 LE n, u32 LE nb
      head[lane] = (uint8_t)((unsigned long long)(lane < 4 ? n : nb) >> (8 * (lane & 3)));
    const unsigned agg = __reduce_add_sync(0xffffffffu, (unsigned)mine);
    const unsigned long long excl = look_back(words + kPackCounters, cta, agg);
    if (lane == 0) {
      s_excl = excl;
      if (cta == (int)gridDim.x - 1) *total = excl + agg;
    }
  }
  __syncthreads();
  unsigned long long first = s_excl;
  for (int i = 0; i < warp * kPer; ++i) first += s_width[i];
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    if (blk0 + p >= nb) break;
    uint32_t* dst = reinterpret_cast<uint32_t*>(planes + first * kLane) + lane;
#pragma unroll
    for (int r = 0; r < 8; ++r)
      if (r < width[p]) dst[r * (kLane / 4)] = w[p][r];
    first += width[p];
  }
}

// The widths of the CTA's blocks before it, from the nibbles alone: every
// thread sums the nibble pairs of a share of the bytes before the CTA's.
template <int kCtaBlocks>
__device__ unsigned long long nibbles_before(const uint8_t* nibbles, int cta) {
  __shared__ unsigned s_part[kPackWarps];
  const long long bytes = (long long)cta * (kCtaBlocks / 2);
  unsigned sum = 0;
  for (long long i = threadIdx.x; i < bytes; i += kPackWarps * 32) {
    const unsigned b = nibbles[i];
    sum += min(b & 15u, 8u) + min(b >> 4, 8u);
  }
  sum = __reduce_add_sync(0xffffffffu, sum);
  if ((threadIdx.x & 31) == 0) s_part[threadIdx.x >> 5] = sum;
  __syncthreads();
  unsigned long long all = 0;
#pragma unroll
  for (int i = 0; i < kPackWarps; ++i) all += s_part[i];
  return all;
}

// K7.  A warp unpacks kPer consecutive blocks.  kCompact: `src` is the
// codec-2 body (header, nibbles, kept planes) of `len` bytes, and a
// CTA's first plane is the sum of the nibbles before it.  Else `src`
// holds [nb, 8, 128] planes.  `out` gets nb * 1024 bytes.  vec: the
// planes start on a 4-byte boundary.  Widths above 8 read as 8, bytes at
// or past `len` as 0 (the host has checked the body).
template <bool kCompact, int kPer>
__global__ void __launch_bounds__(kPackWarps * 32)
    bitpack_unpack_warps(const uint8_t* __restrict__ src, uint8_t* __restrict__ out,
                         long long len, int nb, bool vec) {
  constexpr int kCtaBlocks = kPackWarps * kPer;
  __shared__ int s_width[kCtaBlocks];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long nnib = (nb + 1) / 2;
  const long long at = kCompact ? 8 + nnib : 0;  // the first plane
  const int cta = blockIdx.x;
  unsigned long long first = 0;
  if (kCompact) {
    if (warp == 0 && lane < kCtaBlocks) {
      const long long b = (long long)cta * kCtaBlocks + lane;
      int mine = 0;
      if (b < nb) {
        const uint32_t nib = src[8 + (b >> 1)];
        mine = min((int)((b & 1) ? nib >> 4 : nib & 15u), 8);
      }
      s_width[lane] = mine;
    }
    first = nibbles_before<kCtaBlocks>(src + 8, cta);  // its __syncthreads orders s_width
    for (int i = 0; i < warp * kPer; ++i) first += s_width[i];
  }
  const long long blk0 = (long long)cta * kCtaBlocks + warp * kPer;
  uint32_t w[kPer][8] = {};
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const long long blk = blk0 + p;
    if (blk >= nb) break;
    const int width = kCompact ? s_width[warp * kPer + p] : 8;
    const unsigned long long plane0 = kCompact ? first : (unsigned long long)blk * 8;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const long long pos = at + (long long)(plane0 + r) * kLane + 4 * lane;
      if (r < width) {
        if (vec && pos + 4 <= len)
          w[p][r] = __ldg(reinterpret_cast<const uint32_t*>(src + pos));
        else
          w[p][r] = load4_bytes(src + pos, len - pos);
      }
    }
    first += width;
  }
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const long long blk = blk0 + p;
    if (blk >= nb) break;
    transpose8(w[p]);
    uint32_t* dst = reinterpret_cast<uint32_t*>(out + blk * kBlock) + lane;
#pragma unroll
    for (int k = 0; k < 8; ++k) dst[k * (kLane / 4)] = unzigzag4(w[p][k]);
  }
}

int pack_ctas(long long nb, int per) {
  return (int)((nb + kPackWarps * per - 1) / (kPackWarps * per));
}

template <typename... Args>
cudaError_t launch_pack(int per, long long nb, cudaStream_t st, bool compact, Args... args) {
  const int ctas = pack_ctas(nb, per);
  if (compact) {
    switch (per) {
      case 1: bitpack_pack_warps<true, 1><<<ctas, kPackWarps * 32, 0, st>>>(args...); break;
      case 2: bitpack_pack_warps<true, 2><<<ctas, kPackWarps * 32, 0, st>>>(args...); break;
      case 4: bitpack_pack_warps<true, 4><<<ctas, kPackWarps * 32, 0, st>>>(args...); break;
      default: return cudaErrorInvalidValue;
    }
  } else {
    switch (per) {
      case 1: bitpack_pack_warps<false, 1><<<ctas, kPackWarps * 32, 0, st>>>(args...); break;
      case 2: bitpack_pack_warps<false, 2><<<ctas, kPackWarps * 32, 0, st>>>(args...); break;
      case 4: bitpack_pack_warps<false, 4><<<ctas, kPackWarps * 32, 0, st>>>(args...); break;
      default: return cudaErrorInvalidValue;
    }
  }
  return cudaGetLastError();
}

template <typename... Args>
cudaError_t launch_unpack(int per, long long nb, cudaStream_t st, bool compact, Args... args) {
  const int ctas = pack_ctas(nb, per);
  if (compact) {
    switch (per) {
      case 1: bitpack_unpack_warps<true, 1><<<ctas, kPackWarps * 32, 0, st>>>(args...); break;
      case 2: bitpack_unpack_warps<true, 2><<<ctas, kPackWarps * 32, 0, st>>>(args...); break;
      case 4: bitpack_unpack_warps<true, 4><<<ctas, kPackWarps * 32, 0, st>>>(args...); break;
      default: return cudaErrorInvalidValue;
    }
  } else {
    switch (per) {
      case 1: bitpack_unpack_warps<false, 1><<<ctas, kPackWarps * 32, 0, st>>>(args...); break;
      case 2: bitpack_unpack_warps<false, 2><<<ctas, kPackWarps * 32, 0, st>>>(args...); break;
      case 4: bitpack_unpack_warps<false, 4><<<ctas, kPackWarps * 32, 0, st>>>(args...); break;
      default: return cudaErrorInvalidValue;
    }
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// X1: sym is [batch, n] uint8; freq [batch, 256] int32, entries [batch,
// 256] x 16 bytes, counts and states [batch, lanes] int32, stream and
// scratch [batch * lanes * rows] uint16, status [batch * lanes /
// lane_block + 1] x 8 bytes (the look-back words, then the ticket), all
// device buffers.  lanes = lanes_for(n), rows = ceil(n / lanes),
// lane_block (lanes a block: 32, 64 or 128) divides lanes.  On return
// stream holds every plane's words in stored order from offset 0.
int rans_tpu_encode(const void* sym, void* freq, void* counts, void* states, void* stream,
                    void* entries, void* scratch, void* status, int batch, int n,
                    int lanes, int rows, int lane_block, void* cu_stream) {
  const auto* s = static_cast<const uint8_t*>(sym);
  auto* f = static_cast<int*>(freq);
  auto* e = static_cast<uint4*>(entries);
  auto* st_words = static_cast<unsigned long long*>(status);
  auto st = static_cast<cudaStream_t>(cu_stream);
  const long long cells = (long long)rows * lanes;
  if (batch <= 0 || n <= 0 || lanes < kMinLanes || lanes > kMaxLanes ||
      (lanes & (lanes - 1)) || cells < n || cells - n >= lanes || cells > (1LL << 24) ||
      (lane_block != 32 && lane_block != 64 && lane_block != 128))
    return cudaErrorInvalidValue;
  const int per_plane = lanes / lane_block;
  const long long blocks = (long long)batch * per_plane;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  auto* ticket = reinterpret_cast<unsigned*>(st_words + blocks);
  cudaError_t err = cudaMemsetAsync(f, 0, sizeof(int) * 256 * (size_t)batch, st);
  if (err != cudaSuccess) return err;
  const int hist_blocks = (int)std::min<long long>(
      kHistMaxBlocksPerPlane, (n + kHistBytesPerBlock - 1) / kHistBytesPerBlock);
  for (int b0 = 0; b0 < batch; b0 += kMaxGridY) {
    const int nb = std::min(kMaxGridY, batch - b0);
    rans_histogram<<<dim3(hist_blocks, nb), kHistThreads, 0, st>>>(
        s + (long long)b0 * n, f + b0 * 256LL, n);
  }
  rans_normalize<<<batch, 256, 0, st>>>(f, e, (int)cells, (int)(cells - n), st_words,
                                        per_plane, ticket);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // 16-byte pieces need every plane on a 16-byte boundary.
  const bool vec = reinterpret_cast<uintptr_t>(s) % 16 == 0 && (batch == 1 || n % 16 == 0);
  auto* scr = static_cast<uint16_t*>(scratch);
  auto* c = static_cast<int*>(counts);
  auto* x = static_cast<uint32_t*>(states);
  auto* out = static_cast<uint16_t*>(stream);
  const unsigned nblk = (unsigned)blocks;
  switch (lane_block) {
    case 32:
      return launch_lanes<32>(vec, nblk, st, s, e, scr, c, x, out, st_words, ticket, n,
                              lanes, rows);
    case 64:
      return launch_lanes<64>(vec, nblk, st, s, e, scr, c, x, out, st_words, ticket, n,
                              lanes, rows);
    default:
      return launch_lanes<128>(vec, nblk, st, s, e, scr, c, x, out, st_words, ticket, n,
                               lanes, rows);
  }
}

// K6 without compaction: in is [n] uint8; out [nb, 8, 128] uint8 and
// widths [nb] int32, nb = ceil(n / 1024), all device buffers.  per: the
// blocks a warp packs (1, 2 or 4).
int bitpack_pack(const void* in, void* out, void* widths, long long n, long long nb, int per,
                 void* cu_stream) {
  auto st = static_cast<cudaStream_t>(cu_stream);
  if (n <= 0) return cudaSuccess;
  if (nb != (n + kBlock - 1) / kBlock || nb > 0x7fffffffLL ||
      reinterpret_cast<uintptr_t>(out) % 4)
    return cudaErrorInvalidValue;
  const bool vec = reinterpret_cast<uintptr_t>(in) % 4 == 0;
  return launch_pack(per, nb, st, false, static_cast<const uint8_t*>(in),
                     static_cast<uint8_t*>(out), static_cast<int*>(widths),
                     static_cast<uint8_t*>(nullptr), static_cast<unsigned long long*>(nullptr),
                     static_cast<unsigned long long*>(nullptr), n, (int)nb, vec);
}

// K7 without compaction: in is [nb, 8, 128] bit-planes, out [nb * 1024]
// uint8 (4-byte aligned).
int bitpack_unpack(const void* in, void* out, long long nb, int per, void* cu_stream) {
  auto st = static_cast<cudaStream_t>(cu_stream);
  if (nb <= 0) return cudaSuccess;
  if (nb > 0x7fffffffLL || reinterpret_cast<uintptr_t>(out) % 4) return cudaErrorInvalidValue;
  const bool vec = reinterpret_cast<uintptr_t>(in) % 4 == 0;
  return launch_unpack(per, nb, st, false, static_cast<const uint8_t*>(in),
                       static_cast<uint8_t*>(out), nb * kBlock, (int)nb, vec);
}

// K6 compacting: in is [n] uint8, 0 < n < 2^32; buf is the device buffer
// of the body: its first 8 bytes get the kept planes' total (u64), the
// header and the nibbles go to buf + head and the planes to buf + head + 8
// + ceil(nb / 2), which must be 4-byte aligned, with room for 8 planes a
// block.  words: kPackCounters + ceil(nb / (kPackWarps * per)) 8-byte
// words for the look-back, zeroed here on the stream before the launch.
int bitpack_pack_compact(const void* in, void* buf, long long head, void* words, long long n,
                         int per, void* cu_stream) {
  auto st = static_cast<cudaStream_t>(cu_stream);
  const long long nb = (n + kBlock - 1) / kBlock;
  auto* b = static_cast<uint8_t*>(buf);
  uint8_t* planes = b + head + 8 + (nb + 1) / 2;
  if (n <= 0 || n > 0xffffffffLL || head < 8 || reinterpret_cast<uintptr_t>(planes) % 4 ||
      reinterpret_cast<uintptr_t>(buf) % 8 || (per != 1 && per != 2 && per != 4))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(
      words, 0, (kPackCounters + pack_ctas(nb, per)) * sizeof(unsigned long long), st);
  if (err != cudaSuccess) return err;
  const bool vec = reinterpret_cast<uintptr_t>(in) % 4 == 0;
  return launch_pack(per, nb, st, true, static_cast<const uint8_t*>(in), planes,
                     static_cast<int*>(nullptr), b + head,
                     static_cast<unsigned long long*>(words),
                     reinterpret_cast<unsigned long long*>(b), n, (int)nb, vec);
}

// K7 compacted: body is a codec-2 body of len bytes on the device (any
// alignment) whose stream holds n symbols, 0 < n < 2^32; out gets
// ceil(n / 1024) * 1024 bytes (4-byte aligned).
int bitpack_unpack_compact(const void* body, void* out, long long len, long long n, int per,
                           void* cu_stream) {
  auto st = static_cast<cudaStream_t>(cu_stream);
  const long long nb = (n + kBlock - 1) / kBlock;
  if (n <= 0 || n > 0xffffffffLL || len < 8 + (nb + 1) / 2 ||
      reinterpret_cast<uintptr_t>(out) % 4)
    return cudaErrorInvalidValue;
  const auto* s = static_cast<const uint8_t*>(body);
  const bool vec = reinterpret_cast<uintptr_t>(s + 8 + (nb + 1) / 2) % 4 == 0;
  return launch_unpack(per, nb, st, true, s, static_cast<uint8_t*>(out), len, (int)nb, vec);
}

}  // extern "C"
