// The op-rate probe for Hopper (sm_90a):
//
//   K8  hgi_vpucal  replaces tools/chip_probe.py cmd_vpucal.build_mosaic.run
//                   (the VPU calibration probe's pallas_call)
//
// It computes what the TPU probe computes, bit for bit: every pixel of a
// uint8 [B, H, W] batch runs k rounds of one 3-op chain, in int32 (or
// float32 for f32add), and the result's low byte is stored.  With i the
// round index:
//
//   mix3    p = ((p + (i + 1)) >> 1) ^ p
//   add     p = ((p + (i | 1)) + p) + i
//   shift   p = ((p >> 1) ^ p) >> 1
//   csel    p = p > (i | 1) ? p + 1 : p
//   f32add  p = (p + 1.5f) * 0.5f + 0.25f, then truncated to int
//
// JAX's int32 wraps and its >> is arithmetic.  `add` doubles p each round
// and wraps after about 30, so the adds run in uint32 (signed overflow is
// undefined in C++) and the shifts on the signed value.  f32add uses
// __fadd_rn and __fmul_rn, which nvcc never contracts into an FMA, so each
// op rounds as the three separate PyTorch ops of the plain version do.
//
// Geometry is K2's (hgi_codec.cu): 256 threads a block, grid
// (blocks_for(cells), B).  A cell is one u32 word of 4 pixels of a row, so
// each thread carries four independent chains, the instruction-level
// parallelism the TPU kernel got from its 16 stride-4 planes.  When W is a
// multiple of 4 and both buffers are 4-byte aligned the word is one 32-bit
// load and store; otherwise the thread reads and writes its (up to 4)
// bytes one by one.  k is a runtime argument.  The round loop is unrolled
// by kUnroll (4) in a loop that nvcc keeps rolled, then a remainder loop
// of one round: the main loop body therefore holds exactly kUnroll rounds,
// which lets a reader of the SASS count the instructions of one round.
//
// What bounds it on this card: operations, by construction.  It reads and
// writes each pixel once (2 bytes) and issues 3k operations on it; at
// k = 200 that is 300 operations per byte, far above the card's ratio of
// int32 issue rate to memory rate (about 5 per byte).  Its time is the
// quantity it exists to measure.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;  // batch planes per launch
constexpr int kUnroll = 4;

enum Kind { kMix3 = 0, kAdd = 1, kShift = 2, kCsel = 3, kF32Add = 4 };

__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((uint32_t)a + (uint32_t)b);
}

template <int KIND>
__device__ __forceinline__ int round_int(int i, int p) {
  if (KIND == kMix3) return (wrap_add(p, i + 1) >> 1) ^ p;
  if (KIND == kAdd) return wrap_add(wrap_add(wrap_add(p, i | 1), p), i);
  if (KIND == kShift) return ((p >> 1) ^ p) >> 1;
  return p > (i | 1) ? wrap_add(p, 1) : p;  // kCsel
}

__device__ __forceinline__ float round_f32(float p) {
  return __fadd_rn(__fmul_rn(__fadd_rn(p, 1.5f), 0.5f), 0.25f);
}

// Four chains of k rounds; v[j] enters as the pixel's byte and leaves as
// the chain's result & 255.
template <int KIND>
__device__ __forceinline__ void chains(uint32_t v[4], int k) {
  if (KIND == kF32Add) {
    float p[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) p[j] = (float)v[j];
    int i = 0;
#pragma unroll 1
    for (; i + kUnroll <= k; i += kUnroll) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int j = 0; j < 4; ++j) p[j] = round_f32(p[j]);
    }
#pragma unroll 1
    for (; i < k; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) p[j] = round_f32(p[j]);
    // The chain stays in [0, 256) for any k, so the conversion is defined.
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = (uint32_t)__float2int_rz(p[j]) & 255u;
  } else {
    int p[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) p[j] = (int)v[j];
    int i = 0;
#pragma unroll 1
    for (; i + kUnroll <= k; i += kUnroll) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int j = 0; j < 4; ++j) p[j] = round_int<KIND>(i + u, p[j]);
    }
#pragma unroll 1
    for (; i < k; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) p[j] = round_int<KIND>(i, p[j]);
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = (uint32_t)p[j] & 255u;
  }
}

// One thread per cell: row y, pixels x0 .. x0 + 3 (fewer at a ragged
// right edge) of plane blockIdx.y.
template <int KIND, bool WORDS>
__global__ void vpucal_kernel(const uint8_t* __restrict__ in,
                              uint8_t* __restrict__ out, int h, int w, int wq,
                              long long cells, int k) {
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cells) return;
  const long long y = c / wq;
  const int x0 = (int)(c - y * wq) * 4;
  const long long at = (long long)blockIdx.y * h * w + y * w + x0;
  uint32_t v[4];
  if (WORDS) {
    const uint32_t word = *reinterpret_cast<const uint32_t*>(in + at);
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = (word >> (8 * j)) & 255u;
  } else {
    const int n = w - x0 < 4 ? w - x0 : 4;
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = j < n ? in[at + j] : 0u;
  }
  chains<KIND>(v, k);
  if (WORDS) {
    *reinterpret_cast<uint32_t*>(out + at) =
        v[0] | (v[1] << 8) | (v[2] << 16) | (v[3] << 24);
  } else {
    const int n = w - x0 < 4 ? w - x0 : 4;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < n) out[at + j] = (uint8_t)v[j];
  }
}

template <int KIND>
cudaError_t launch(const uint8_t* in, uint8_t* out, int batch, int h, int w,
                   int k, bool words, cudaStream_t stream) {
  const int wq = (w + 3) / 4;
  const long long cells = (long long)h * wq;
  const unsigned blocks = (unsigned)((cells + kThreads - 1) / kThreads);
  const long long plane = (long long)h * w;
  for (int b0 = 0; b0 < batch; b0 += kMaxGridY) {
    const int nb = batch - b0 < kMaxGridY ? batch - b0 : kMaxGridY;
    if (words)
      vpucal_kernel<KIND, true><<<dim3(blocks, nb), kThreads, 0, stream>>>(
          in + b0 * plane, out + b0 * plane, h, w, wq, cells, k);
    else
      vpucal_kernel<KIND, false><<<dim3(blocks, nb), kThreads, 0, stream>>>(
          in + b0 * plane, out + b0 * plane, h, w, wq, cells, k);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// K8: in and out are [batch, h, w] uint8 device buffers; kind is 0..4 in
// the order mix3, add, shift, csel, f32add; k >= 0 rounds.  Returns
// cudaGetLastError() after the last launch.
int hgi_vpucal(const void* in, void* out, int batch, int h, int w, int kind,
               int k, void* stream) {
  const auto* s = static_cast<const uint8_t*>(in);
  auto* o = static_cast<uint8_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (k < 0 || kind < kMix3 || kind > kF32Add) return cudaErrorInvalidValue;
  if (batch <= 0 || h <= 0 || w <= 0) return cudaSuccess;
  const bool words = w % 4 == 0 && reinterpret_cast<uintptr_t>(s) % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(o) % 4 == 0;
  cudaError_t err;
  switch (kind) {
    case kMix3: err = launch<kMix3>(s, o, batch, h, w, k, words, st); break;
    case kAdd: err = launch<kAdd>(s, o, batch, h, w, k, words, st); break;
    case kShift: err = launch<kShift>(s, o, batch, h, w, k, words, st); break;
    case kCsel: err = launch<kCsel>(s, o, batch, h, w, k, words, st); break;
    default: err = launch<kF32Add>(s, o, batch, h, w, k, words, st); break;
  }
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // extern "C"
