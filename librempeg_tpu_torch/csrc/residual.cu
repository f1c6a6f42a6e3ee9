// H.264 residual expansion: compact dequantised 4x4 rows -> 4x4 inverse
// transform -> per-MB spatial residual.
//
// Replaces the Pallas kernel of librempeg_tpu/codecs/h264/residual_pallas.py
// (expand_residual -> _kernel). Input rows are [K, 24] int16: columns
// 0-15 one 4x4 block's dequantised levels in raster order, columns 16-17
// its block id mb*24 + blk split as id = c16 + 32768 * c17 (blk 0-15 luma
// raster, 16-19 chroma u, 20-23 chroma v). The ids ascend, each at most
// once, and ids of nmb*24 or more are padding, at the tail (the packer
// emits np.flatnonzero order and appends PAD_ID rows). Output: [rows,
// 384] float32 with rows a multiple of MBS (out_rows(nmb), whole 120-MB
// stripes), luma 16x16 row-major in columns 0-255, chroma u 8x8 in
// 256-319, chroma v in 320-383, zero where no row lands and in the rows
// [nmb, rows).
//
// The TPU kernel expanded the rows through one-hot matmuls over a window
// of the sorted rows per 120-MB stripe, and ran the transform as exact
// f32 matmuls with a floor(x/2) basis. Here a block of 128 threads owns
// MBS consecutive output rows (MBs) and writes every float of them
// exactly once, zeros included, so the call is one launch into an empty
// output:
//   1. two warps find the block's rows, the first with an id of at least
//      mb0*24 and the first with an id of at least min(mb0 + MBS, nmb)*24,
//      each by a 32-ary search of the ascending ids (a ballot over 32
//      probes a round: 4 dependent loads for 48283 rows, the first
//      rounds' probes shared by every block, so cached), while the other
//      threads zero a shared tile of MBS x 384 floats;
//   2. one thread per row (at most MBS*24 = 192 rows, a second pass
//      where they outnumber the threads) loads its 48 bytes as three
//      16-byte loads, runs the spec's integer butterfly (8.5.12.2,
//      as device_recon._inv4) once, and stores the 4 lines of its block
//      into the tile as 16-byte shared stores;
//   3. the block writes the tile out with 16-byte stores, 6 a thread,
//      neighbouring threads on neighbouring addresses.
// A stripe may hold any number of rows (the bench stream's P frames code
// chroma DC in almost every MB, more than the TPU packer's 512-row window
// allowed).
//
// Bound on the H100: memory. Each row is 48 bytes in and each MB 1536
// bytes out (12.5 MB at 1080p, 8160 output rows); the transform is some
// 100 integer operations per row. Each output byte is written once and
// each row read once (the search's probes are 4 bytes each, a few per
// block); the earlier form zero-filled the output in a launch of its own
// and then scattered 4-byte stores over it, one thread per pixel.
// Measured on an NVIDIA H100 80GB HBM3 (700 W) on the bench stream's
// first P frame (48283 rows, 8160 MBs): 0.0101 ms, 0.0072 back to back,
// against a bound of 0.0044 (chip_smoke.py).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MBS = 8;                 // output rows (MBs) per block
constexpr int THREADS = 128;
constexpr int TILE4 = MBS * 384 / 4;   // the tile in float4s

// the block id of row r (columns 16-17, one 32-bit load)
__device__ __forceinline__ int row_id(const int16_t* __restrict__ packed,
                                      int r) {
  const uint32_t w =
      __ldg(reinterpret_cast<const uint32_t*>(packed + (size_t)r * 24 + 16));
  return (int)(int16_t)(w & 0xffffu) + 32768 * (int)(int16_t)(w >> 16);
}

// The first row in [0, K] whose id is at least target (K if none), by one
// warp: each round, lane j probes the last row of the j-th of 32 equal
// parts of [lo, hi); the lanes whose probe lies below target form a
// prefix of c lanes, so the answer lies in [lo + c*step, lo + (c+1)*step
// - 1], and the part shrinks below step = ceil((hi - lo) / 32).
__device__ int lower_bound(const int16_t* __restrict__ packed, int K,
                           int target, int lane) {
  int lo = 0, hi = K;
  while (lo < hi) {
    const int step = (hi - lo + 31) / 32;
    const int p = lo + (lane + 1) * step - 1;
    const bool below = p < hi && row_id(packed, p) < target;
    const int c = __popc(__ballot_sync(0xffffffffu, below));
    hi = min(hi, lo + (c + 1) * step - 1);
    lo += c * step;
  }
  return lo;
}

// the 4x4 inverse transform's butterfly (8.5.12.2) on one line
__device__ __forceinline__ void butterfly(int d0, int d1, int d2, int d3,
                                          int (&o)[4]) {
  const int e0 = d0 + d2, e1 = d0 - d2;
  const int e2 = (d1 >> 1) - d3, e3 = d1 + (d3 >> 1);
  o[0] = e0 + e3;
  o[1] = e1 + e2;
  o[2] = e1 - e2;
  o[3] = e0 - e3;
}

__global__ void __launch_bounds__(THREADS)
    residual_kernel(const int16_t* __restrict__ packed, int K, int nmb,
                    float* __restrict__ out) {
  __shared__ float4 tile[TILE4];
  __shared__ int range[2];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int mb0 = blockIdx.x * MBS;
  if (warp < 2) {
    const int target = min(mb0 + warp * MBS, nmb) * 24;
    const int r = mb0 < nmb ? lower_bound(packed, K, target, lane) : 0;
    if (lane == 0) range[warp] = r;
  }
  for (int i = tid; i < TILE4; i += THREADS)
    tile[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  __syncthreads();

  const int lo = range[0], n = range[1] - lo;
  for (int i = tid; i < n; i += THREADS) {
    const int4* p =
        reinterpret_cast<const int4*>(packed + (size_t)(lo + i) * 24);
    const int4 a = __ldg(p), b = __ldg(p + 1), c = __ldg(p + 2);
    const int id =
        (int)(int16_t)(c.x & 0xffff) + 32768 * (int)(int16_t)(c.x >> 16);
    const uint32_t w[8] = {(uint32_t)a.x, (uint32_t)a.y, (uint32_t)a.z,
                           (uint32_t)a.w, (uint32_t)b.x, (uint32_t)b.y,
                           (uint32_t)b.z, (uint32_t)b.w};
    // first stage along each line i of the block: f[i][c]
    int f[4][4];
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      const uint32_t w0 = w[2 * l], w1 = w[2 * l + 1];
      butterfly((int16_t)(w0 & 0xffff), (int16_t)(w0 >> 16),
                (int16_t)(w1 & 0xffff), (int16_t)(w1 >> 16), f[l]);
    }
    // second stage down each column c: g[c][r]
    int g[4][4];
#pragma unroll
    for (int col = 0; col < 4; ++col)
      butterfly(f[0][col], f[1][col], f[2][col], f[3][col], g[col]);

    const int mb = id / 24 - mb0, blk = id % 24;
    int base, stride;
    if (blk < 16) {
      base = (blk >> 2) * 64 + (blk & 3) * 4;
      stride = 16;
    } else {
      const int q = blk - 16, bq = q & 3;
      base = 256 + 64 * (q >> 2) + (bq >> 1) * 32 + (bq & 1) * 4;
      stride = 8;
    }
    float* t = reinterpret_cast<float*>(tile) + mb * 384 + base;
#pragma unroll
    for (int r = 0; r < 4; ++r)
      *reinterpret_cast<float4*>(t + r * stride) =
          make_float4((float)((g[0][r] + 32) >> 6),
                      (float)((g[1][r] + 32) >> 6),
                      (float)((g[2][r] + 32) >> 6),
                      (float)((g[3][r] + 32) >> 6));
  }
  __syncthreads();

  float4* o = reinterpret_cast<float4*>(out) + (size_t)blockIdx.x * TILE4;
  for (int i = tid; i < TILE4; i += THREADS) o[i] = tile[i];
}

}  // namespace

extern "C" int expand_residual(const void* packed, int K, int nmb, int rows,
                               void* out, void* stream) {
  if (rows % MBS != 0 || rows < nmb || K < 0 ||
      ((uintptr_t)packed & 15) != 0 || ((uintptr_t)out & 15) != 0)
    return (int)cudaErrorInvalidValue;
  if (rows > 0)
    residual_kernel<<<(unsigned)(rows / MBS), THREADS, 0,
                      (cudaStream_t)stream>>>((const int16_t*)packed, K, nmb,
                                              (float*)out);
  return (int)cudaGetLastError();
}
