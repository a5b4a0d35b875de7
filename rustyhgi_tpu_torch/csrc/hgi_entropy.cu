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
// X1 encodes [B, n] planes, each with its own table and lanes, in four
// kernels on the caller's stream:
//   1. rans_histogram: a 256-bin histogram per block in shared memory,
//      added into the plane's global counts with atomics (integer, so
//      order-free and exact);
//   2. rans_normalize: one block of 256 threads per plane, one symbol per
//      thread.  It counts the T*L - n padding zeros into symbol 0 (they
//      are coded), then runs the JAX normalizer: the float32 quotient
//      floor(f32(count) * 16384 / f32(total)) with IEEE division, the
//      drift absorbed by the first most frequent symbol, six rounds of
//      +-1 units spread by a block-wide scan; it writes freq and the
//      packed lookup table freq << 16 | cum;
//   3. rans_encode_lanes: one thread per lane l, the table in shared
//      memory, walking rows t = T-1 .. 0 and reading sym[t*L + l]
//      (coalesced across a warp).  Emitted words go to a [T, L] scratch
//      at row k = the lane's emission count, so a warp's stores stay
//      close together;
//   4. rans_lane_offsets and rans_store_words: an exclusive scan of all
//      B*L word counts, then each lane's words copied to its offset in
//      reverse emission order.  That is the stored order (lane-major,
//      decode order within a lane, planes one after another), the same
//      placement as JAX's global sort_key_val, without a sort.
// What bounds it on this card: not bytes (one 1080x1920 plane reads 2 MB
// and writes about 1.3 MB) but the lanes' serial dependency chain, T steps
// of a 32-bit division each, on only L threads (2048 at 1080x1920, 16 per
// SM).  One plane cannot fill the card; a batch fills it over grid y.
// Reciprocal tables in place of the division, and several planes' lanes
// per block, are later work.
//
// K6 packs 1024-symbol blocks, one block of 128 threads each: thread j
// folds its column's 8 bytes (zigzag), builds the 8 plane bytes with
// shifts, and the block's largest value (warp __reduce_max_sync, then
// shared memory) gives the width, its bit length.  It writes all 8 planes
// and the width; the host keeps the used planes.  K7 is the inverse over
// host-expanded planes (absent ones zero).  Both are bound by device
// memory: each byte is read once and written once, coalesced.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kScaleBits = 14;
constexpr int kM = 1 << kScaleBits;
constexpr uint32_t kStateL = 1u << 16;  // state lower bound
constexpr int kRenormShift = 18;        // emit iff x >= freq << 18
constexpr int kMinLanes = 128, kMaxLanes = 8192;
constexpr int kMaxGridY = 65535;  // planes per launch
constexpr int kLaneThreads = 128;  // lanes are a multiple of 128
constexpr int kScanThreads = 1024;
constexpr int kHistBlocksPerPlane = 264;  // 2 per SM on 132 SMs
constexpr int kBlock = 1024;  // symbols per bit-pack block: [8, 128]
constexpr int kLane = 128;

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

__global__ void rans_histogram(const uint8_t* sym, int* hist, long long n) {
  __shared__ int local[256];
  local[threadIdx.x] = 0;  // blockDim.x == 256
  __syncthreads();
  const uint8_t* s = sym + blockIdx.y * n;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    atomicAdd(&local[s[i]], 1);
  __syncthreads();
  const int c = local[threadIdx.x];
  if (c) atomicAdd(&hist[blockIdx.y * 256 + threadIdx.x], c);
}

// One block of 256 threads per plane; `freq` holds the histogram on entry
// and the table on exit.
__global__ void rans_normalize(int* freq, uint32_t* table, int total, int pad) {
  __shared__ int warp_tot[8];
  __shared__ unsigned long long warp_max[8];
  __shared__ int fmx_shared;
  const int s = threadIdx.x;
  int* fp = freq + blockIdx.x * 256;
  const int c = fp[s] + (s == 0 ? pad : 0);

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
  table[blockIdx.x * 256 + s] = ((uint32_t)f << 16) | (uint32_t)cum;
}

__global__ void rans_encode_lanes(const uint8_t* sym, const uint32_t* table,
                                  uint16_t* scratch, int* counts,
                                  uint32_t* states, long long n, int lanes,
                                  int rows) {
  __shared__ uint32_t tab[256];
  const int b = blockIdx.y;
  for (int i = threadIdx.x; i < 256; i += blockDim.x) tab[i] = table[b * 256 + i];
  __syncthreads();
  const int l = blockIdx.x * blockDim.x + threadIdx.x;  // lanes % 128 == 0
  const uint8_t* s = sym + b * n;
  uint16_t* out = scratch + (long long)b * rows * lanes;
  uint32_t x = kStateL;
  int k = 0;
  for (int t = rows - 1; t >= 0; --t) {
    const long long i = (long long)t * lanes + l;
    const uint32_t e = tab[i < n ? s[i] : 0];  // the padding codes symbol 0
    const uint32_t f = e >> 16, c = e & 0xffffu;
    if ((x >> kRenormShift) >= f) {
      out[(long long)k * lanes + l] = (uint16_t)(x & 0xffffu);
      ++k;
      x >>= 16;
    }
    const uint32_t q = x / f;
    x = (q << kScaleBits) + (x - q * f) + c;
  }
  counts[b * lanes + l] = k;
  states[b * lanes + l] = x;
}

// One block: offsets[i] = sum(counts[:i]) over all B*L lanes, each thread
// summing a contiguous chunk.
__global__ void rans_lane_offsets(const int* counts, long long* offsets,
                                  long long total_lanes) {
  __shared__ long long warp_tot[kScanThreads / 32];
  const long long chunk = (total_lanes + kScanThreads - 1) / kScanThreads;
  const long long begin = min(threadIdx.x * chunk, total_lanes);
  const long long end = min(begin + chunk, total_lanes);
  long long sum = 0;
  for (long long i = begin; i < end; ++i) sum += counts[i];
  long long all;
  long long run = block_scan<long long, kScanThreads / 32>(sum, warp_tot, &all) - sum;
  for (long long i = begin; i < end; ++i) {
    offsets[i] = run;
    run += counts[i];
  }
}

// One block per lane: the lane's k-th stored word is its (count-1-k)-th
// emitted one.
__global__ void rans_store_words(const uint16_t* scratch, const int* counts,
                                 const long long* offsets, uint16_t* stream,
                                 int lanes, int rows) {
  const int l = blockIdx.x, b = blockIdx.y;
  const int cnt = counts[b * lanes + l];
  const long long off = offsets[b * lanes + l];
  const uint16_t* src = scratch + (long long)b * rows * lanes + l;
  for (int k = threadIdx.x; k < cnt; k += blockDim.x)
    stream[off + k] = src[(long long)(cnt - 1 - k) * lanes];
}

__global__ void bitpack_pack_blocks(const uint8_t* in, uint8_t* out,
                                    int* widths, long long n) {
  __shared__ uint32_t warp_max[kLane / 32];
  const int j = threadIdx.x;
  const long long base = (long long)blockIdx.x * kBlock;
  uint32_t z[8];
  uint32_t m = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const long long i = base + k * kLane + j;
    const uint32_t v = i < n ? in[i] : 0u;
    z[k] = v < 128 ? 2 * v : (256 - v) * 2 - 1;  // zigzag
    m = max(m, z[k]);
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    uint32_t p = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) p |= ((z[k] >> r) & 1u) << k;
    out[base + r * kLane + j] = (uint8_t)p;
  }
  m = __reduce_max_sync(0xffffffffu, m);
  if ((j & 31) == 0) warp_max[j >> 5] = m;
  __syncthreads();
  if (j == 0) {
    const uint32_t mm = max(max(warp_max[0], warp_max[1]), max(warp_max[2], warp_max[3]));
    widths[blockIdx.x] = 32 - __clz(mm);  // bit length: planes needed
  }
}

__global__ void bitpack_unpack_blocks(const uint8_t* in, uint8_t* out) {
  const int j = threadIdx.x;
  const long long base = (long long)blockIdx.x * kBlock;
  uint32_t p[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) p[r] = in[base + r * kLane + j];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    uint32_t z = 0;
#pragma unroll
    for (int r = 0; r < 8; ++r) z |= ((p[r] >> k) & 1u) << r;
    out[base + k * kLane + j] =
        (uint8_t)((z & 1u) == 0 ? z >> 1 : (256 - ((z + 1) >> 1)) & 255);
  }
}

}  // namespace

extern "C" {

// X1: sym is [batch, n] uint8; freq and table are [batch, 256] int32 /
// uint32, counts and states [batch, lanes], offsets [batch * lanes] int64,
// stream and scratch [batch * rows * lanes] uint16, all device buffers.
// lanes = lanes_for(n), rows = ceil(n / lanes).  On return stream holds
// every plane's words in stored order from offset 0.
int rans_tpu_encode(const void* sym, void* freq, void* counts, void* states,
                    void* stream, void* table, void* scratch, void* offsets,
                    int batch, int n, int lanes, int rows, void* cu_stream) {
  const auto* s = static_cast<const uint8_t*>(sym);
  auto* f = static_cast<int*>(freq);
  auto* c = static_cast<int*>(counts);
  auto* x = static_cast<uint32_t*>(states);
  auto* out = static_cast<uint16_t*>(stream);
  auto* tab = static_cast<uint32_t*>(table);
  auto* scr = static_cast<uint16_t*>(scratch);
  auto* off = static_cast<long long*>(offsets);
  auto st = static_cast<cudaStream_t>(cu_stream);
  const long long cells = (long long)rows * lanes;
  if (batch <= 0 || n <= 0 || lanes < kMinLanes || lanes > kMaxLanes ||
      (lanes & (lanes - 1)) || cells < n || cells - n >= lanes ||
      cells > (1LL << 24))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(f, 0, sizeof(int) * 256 * (size_t)batch, st);
  if (err != cudaSuccess) return err;
  const int hist_blocks =
      (int)std::min<long long>(kHistBlocksPerPlane, (n + 255) / 256);
  for (int b0 = 0; b0 < batch; b0 += kMaxGridY) {
    const int nb = std::min(kMaxGridY, batch - b0);
    rans_histogram<<<dim3(hist_blocks, nb), 256, 0, st>>>(
        s + (long long)b0 * n, f + b0 * 256LL, n);
  }
  rans_normalize<<<batch, 256, 0, st>>>(f, tab, (int)cells, (int)(cells - n));
  for (int b0 = 0; b0 < batch; b0 += kMaxGridY) {
    const int nb = std::min(kMaxGridY, batch - b0);
    rans_encode_lanes<<<dim3(lanes / kLaneThreads, nb), kLaneThreads, 0, st>>>(
        s + (long long)b0 * n, tab + b0 * 256LL, scr + b0 * cells,
        c + (long long)b0 * lanes, x + (long long)b0 * lanes, n, lanes, rows);
  }
  rans_lane_offsets<<<1, kScanThreads, 0, st>>>(c, off, (long long)batch * lanes);
  for (int b0 = 0; b0 < batch; b0 += kMaxGridY) {
    const int nb = std::min(kMaxGridY, batch - b0);
    rans_store_words<<<dim3(lanes, nb), kLaneThreads, 0, st>>>(
        scr + b0 * cells, c + (long long)b0 * lanes, off + (long long)b0 * lanes,
        out, lanes, rows);
  }
  err = cudaGetLastError();
  return err;
}

// K6: in is [n] uint8; out [nb, 8, 128] uint8 and widths [nb] int32,
// nb = ceil(n / 1024), all device buffers.
int bitpack_pack(const void* in, void* out, void* widths, long long n,
                 long long nb, void* cu_stream) {
  auto st = static_cast<cudaStream_t>(cu_stream);
  if (n <= 0) return cudaSuccess;
  if (nb != (n + kBlock - 1) / kBlock || nb > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  bitpack_pack_blocks<<<(unsigned)nb, kLane, 0, st>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out),
      static_cast<int*>(widths), n);
  return cudaGetLastError();
}

// K7: in is [nb, 8, 128] bit-planes, out [nb * 1024] uint8.
int bitpack_unpack(const void* in, void* out, long long nb, void* cu_stream) {
  auto st = static_cast<cudaStream_t>(cu_stream);
  if (nb <= 0) return cudaSuccess;
  if (nb > 0x7fffffffLL) return cudaErrorInvalidValue;
  bitpack_unpack_blocks<<<(unsigned)nb, kLane, 0, st>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out));
  return cudaGetLastError();
}

}  // extern "C"
