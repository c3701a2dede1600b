// Block-sparse SpMM for Hopper (sm_90a), plain f32 CUDA cores: y = A x.
//
// A is stored as dense (BM, 128) f32 blocks, x is (N, K) f32 row-major and
// y is (M, K) f32 row-major. Two layouts of A:
//   K3 "jag":  data (NB, BM, 128), bcols (NB,), blocks sorted by block row,
//              bptr (R+1,) the offsets of each block row's run.
//   K4 "ELL":  data (R, W, BM, 128), cols (R, W); padding slots point at
//              column block 0 and hold zero data.
//
// Replaces the TPU kernels of indigo_tpu/ops/ell_spmm.py:
//   K3 <- jag_spmm_pallas (_jag_spmm_call / _jag_kernel)
//   K4 <- ell_spmm_pallas (_ell_spmm_call / _kernel)
//
// Bound on this card: device memory. Every stored block is read once, and
// a block is mostly zeros (a 2D radial gridding matrix at 256^2 fills 3 % of
// its 397 MB of blocks), so the one pass over the tiles is the floor:
// ~0.12 ms at 3.35 TB/s. x (147,456 x 16 f32 = 9.4 MB there) fits the 50 MB
// L2, so its slabs are re-read from L2, not from device memory. The
// 2 * NB * BM * 128 * K flops (3.2 GFLOP there, 97 % of them on stored
// zeros) are well under the f32 FMA rate at that traffic.
//
// Design:
//  * One CUDA block per block row r (and per KC-wide chunk of the K columns)
//    loops over its own stored blocks: bptr[r] .. bptr[r+1] for K3, slots
//    0 .. W-1 for K4. The TPU kept the output block resident across
//    sequential grid steps; here the block accumulates its (BM, KC) output
//    tile in registers and writes it once — no atomics, empty rows come out
//    exactly zero, and the result is deterministic.
//  * Each stored block is consumed in 32-column chunks: the (BM, 32) slice
//    of the block and the matching (32, KC) slab of x are staged in shared
//    memory with 16-byte loads (x with 16-byte loads when K % 4 == 0 and x
//    is aligned), then every thread accumulates its outputs with f32 FMA.
//    The slice is stored with a row pitch of 33 floats, so the loads and
//    the reads of the product are free of bank conflicts.
//  * The ragged last column block is masked in the kernel (x rows >= N read
//    as zero), so x is never padded with a copy; y rows >= M are not
//    written.
//  * Plain f32 FMA, no TF32: the reference accumulates at
//    Precision.HIGHEST.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 128;  // block columns (the reference's lane width)
constexpr int JC = 32;   // block columns staged per shared-memory step

template <int BM, int KC>
struct Tile {
  static constexpr int NT = BM * KC < 256 ? BM * KC : 256;  // threads
  static constexpr int OPT = BM * KC / NT;  // outputs per thread
};

template <int BM, int KC, bool JAG>
__global__ void __launch_bounds__(Tile<BM, KC>::NT)
block_spmm(const float* __restrict__ data, const int* __restrict__ colidx,
           const int* __restrict__ bptr, int W, const float* __restrict__ x,
           float* __restrict__ y, int M, int N, int K, bool xvec) {
  constexpr int NT = Tile<BM, KC>::NT;
  constexpr int OPT = Tile<BM, KC>::OPT;
  __shared__ float sA[BM][JC + 1];
  __shared__ __align__(16) float sX[JC][KC];

  const int r = blockIdx.x;
  const int k0 = blockIdx.y * KC;
  const int t = threadIdx.x;
  const int kk = t % KC;   // this thread's output column (same for all o)
  const int i0 = t / KC;   // its first output row; then i0 + o * NT / KC
  const int lo = JAG ? bptr[r] : r * W;
  const int hi = JAG ? bptr[r + 1] : lo + W;

  float acc[OPT];
#pragma unroll
  for (int o = 0; o < OPT; ++o) acc[o] = 0.f;

  for (int b = lo; b < hi; ++b) {
    const long long xrow0 = (long long)colidx[b] * BN;
    const float* blk = data + (long long)b * BM * BN;
    for (int j0 = 0; j0 < BN; j0 += JC) {
      for (int q = t; q < BM * JC / 4; q += NT) {
        const int i = q / (JC / 4), j = (q % (JC / 4)) * 4;
        const float4 v =
            __ldg(reinterpret_cast<const float4*>(blk + i * BN + j0 + j));
        sA[i][j] = v.x;
        sA[i][j + 1] = v.y;
        sA[i][j + 2] = v.z;
        sA[i][j + 3] = v.w;
      }
      if (xvec) {  // K % 4 == 0: a 4-column group is all in or all out
        for (int q = t; q < JC * KC / 4; q += NT) {
          const int j = q / (KC / 4), k = (q % (KC / 4)) * 4;
          const long long row = xrow0 + j0 + j;
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (row < N && k0 + k < K)
            v = __ldg(reinterpret_cast<const float4*>(x + row * K + k0 + k));
          *reinterpret_cast<float4*>(&sX[j][k]) = v;
        }
      } else {
        for (int q = t; q < JC * KC; q += NT) {
          const int j = q / KC, k = q % KC;
          const long long row = xrow0 + j0 + j;
          sX[j][k] = (row < N && k0 + k < K) ? __ldg(x + row * K + k0 + k)
                                             : 0.f;
        }
      }
      __syncthreads();
#pragma unroll 8
      for (int j = 0; j < JC; ++j) {
        const float xv = sX[j][kk];
#pragma unroll
        for (int o = 0; o < OPT; ++o)
          acc[o] = fmaf(sA[i0 + o * (NT / KC)][j], xv, acc[o]);
      }
      __syncthreads();
    }
  }

  const int col = k0 + kk;
#pragma unroll
  for (int o = 0; o < OPT; ++o) {
    const long long row = (long long)r * BM + i0 + o * (NT / KC);
    if (row < M && col < K) y[row * K + col] = acc[o];
  }
}

template <int BM, int KC, bool JAG>
cudaError_t launch_tile(const float* data, const int* colidx,
                        const int* bptr, int R, int W, const float* x,
                        float* y, int M, int N, int K, cudaStream_t stream) {
  const bool xvec =
      K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const dim3 grid((unsigned)R, (unsigned)((K + KC - 1) / KC));
  block_spmm<BM, KC, JAG><<<grid, Tile<BM, KC>::NT, 0, stream>>>(
      data, colidx, bptr, W, x, y, M, N, K, xvec);
  return cudaSuccess;
}

template <int BM, bool JAG>
cudaError_t launch_bm(const float* data, const int* colidx, const int* bptr,
                      int R, int W, const float* x, float* y, int M, int N,
                      int K, cudaStream_t stream) {
  if (K <= 16)
    return launch_tile<BM, 16, JAG>(data, colidx, bptr, R, W, x, y, M, N, K,
                                    stream);
  return launch_tile<BM, 32, JAG>(data, colidx, bptr, R, W, x, y, M, N, K,
                                  stream);
}

template <bool JAG>
int launch(const void* data, const void* colidx, const void* bptr, int R,
           int W, int bm, const void* x, void* y, int M, int N, int K,
           void* stream) {
  if (R < 1 || K < 1 || M < 0 || N < 0 ||
      reinterpret_cast<uintptr_t>(data) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const float* d = (const float*)data;
  const int* c = (const int*)colidx;
  const int* p = (const int*)bptr;
  const float* xx = (const float*)x;
  float* yy = (float*)y;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  switch (bm) {
    case 8: e = launch_bm<8, JAG>(d, c, p, R, W, xx, yy, M, N, K, s); break;
    case 16: e = launch_bm<16, JAG>(d, c, p, R, W, xx, yy, M, N, K, s); break;
    case 32: e = launch_bm<32, JAG>(d, c, p, R, W, xx, yy, M, N, K, s); break;
    case 64: e = launch_bm<64, JAG>(d, c, p, R, W, xx, yy, M, N, K, s); break;
    case 128:
      e = launch_bm<128, JAG>(d, c, p, R, W, xx, yy, M, N, K, s);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}

}  // namespace

extern "C" {

// Each launcher enqueues one kernel on `stream` and returns the launch's
// cudaError_t (0 on success); it never synchronises.

// K3: y (M, K) = jag (NB, bm, 128) x (N, K); R = ceil(M / bm) block rows.
int indigo_jag_spmm(const void* data, const void* bcols, const void* bptr,
                    int R, int bm, const void* x, void* y, int M, int N,
                    int K, void* stream) {
  return launch<true>(data, bcols, bptr, R, 0, bm, x, y, M, N, K, stream);
}

// K4: y (M, K) = ell (R, W, bm, 128) x (N, K).
int indigo_ell_spmm(const void* data, const void* cols, int R, int W, int bm,
                    const void* x, void* y, int M, int N, int K,
                    void* stream) {
  return launch<false>(data, cols, nullptr, R, W, bm, x, y, M, N, K, stream);
}

}  // extern "C"
