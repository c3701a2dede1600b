// Toeplitz SENSE normal operator for Hopper (sm_90a), plain f32 CUDA cores.
//
//   K1: out_s = sum_c conj(m_c) * crop(IFFT(Tf * FFT(pad_2x(m_c * v_s))))
//   K2: out_b = crop(IFFT(Tf * FFT(pad_2x(u_b))))
//
// K2 is K1 with the coil fusion turned off (one "coil", no maps): the same
// kernel family, kern_a and kern_c instantiated with kCoils = false, and
// the same kern_b.
//
// v (S, n1, n2, n3), maps (cc, n1, n2, n3), out (S, n1, n2, n3): complex64
// (float2, re/im interleaved), natural (z, y, x) order, x contiguous. Tf is
// the real doubled-grid spectrum in block (even|odd) layout on every axis,
// (2n1, 2n2, 2n3). Each axis transform is a small complex matrix product
// against the dft_pad2x_mats matrices: Mf (2n x n) forward with twiddles
// folded in, Mi (n x 2n) inverse-with-crop.
//
// Replaces the TPU kernels of indigo_tpu/ops/dft_pallas.py,
// sense_normal_pallas:
//   kernel A <- _make_kernel_A_fused : map multiply, forward z, forward y
//   kernel B <- _make_kernel_B       : forward x, spectrum multiply, inverse
//                                      (here inverse x, not z: see below)
//   kernel C <- _make_kernel_C_fused : inverse y, inverse z, conj-map combine
// and toeplitz_apply_pallas (K2): _make_kernel_A -> kern_a<false>,
// _make_kernel_B -> kern_b, _make_kernel_C -> kern_c<false>.
//
// Bound on this card: the six stages are 28 n^4 complex multiply-adds per
// coil (224 n^4 real flops, ~0.96 TFLOP per coil at 256^3), done as f32 FMA
// on the CUDA cores, so the kernels are compute-bound; the intermediates
// (B, 2n1, n2, n3) and (B, 2n1, 2n2, n3) complex live in device memory.
//
// Design:
//  * A and C each run two stages on different axes. A block's shared memory
//    (227 KB) cannot hold a 256 x 256 plane, so the two stages cannot share
//    one block the way the TPU's VMEM let them. Each of A and C is one
//    cooperative launch of a persistent grid: stage 1 over all tiles, a grid
//    barrier, stage 2 over all tiles, the intermediate in device memory.
//  * Stages on a non-contiguous axis are tiled complex GEMMs: a 64 x 64
//    output tile per 256-thread block, matrix and data tiles staged through
//    shared memory 16 deep, a 4 x 4 register tile per thread.
//  * B fuses the forward x transform, the spectrum multiply and the inverse
//    x transform: both stages are on the same (contiguous) axis, so a block
//    keeps 16 whole x-lines and their doubled spectra in shared memory and
//    writes back in place. (The TPU kernel B inverted along z instead; the
//    order of the separable inverse stages does not change the result.)
//  * C's coil sum: each block owns its output tile and loops over the coils
//    inside the block, accumulating conj(m_c) * result in registers — no
//    cross-block accumulation, no atomics, deterministic.
//  * No Karatsuba/bf16x3 packs, no radix-2 split and no sigma basis: those
//    served the TPU's matrix unit and Mosaic's layouts. Every n <= 256 runs
//    in natural order at plain f32 accuracy.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;  // threads per block
constexpr int TK = 64;   // output rows per tile
constexpr int TC = 64;   // output columns per tile
constexpr int TL = 16;   // contraction depth per shared-memory step
constexpr int LB = 16;   // x-lines per block in kernel B

__device__ __forceinline__ void cmac(float2& acc, float2 a, float2 b) {
  acc.x = fmaf(a.x, b.x, acc.x);
  acc.x = fmaf(-a.y, b.y, acc.x);
  acc.y = fmaf(a.x, b.y, acc.y);
  acc.y = fmaf(a.y, b.x, acc.y);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

struct Smem {
  float2 m[TK][TL];
  float2 x[TL][TC];
};

// acc[i][j] += sum_l M[k][l] * X[l][c] for k = k0 + ty + 16 i,
// c = c0 + tx + 16 j. M is (K x L) row-major; X is (L x C) with row stride
// ldx and contiguous columns, multiplied elementwise by Xm (same layout)
// when Xm is not null.
__device__ void tile_mac(const float2* __restrict__ M, int K, int L,
                         const float2* __restrict__ X,
                         const float2* __restrict__ Xm, long long ldx, int C,
                         int k0, int c0, float2 (&acc)[4][4], Smem& sm) {
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const float2 zero = make_float2(0.f, 0.f);
  for (int l0 = 0; l0 < L; l0 += TL) {
    for (int idx = tid; idx < TK * TL; idx += NT) {
      const int k = idx / TL, l = idx % TL, gk = k0 + k, gl = l0 + l;
      sm.m[k][l] = (gk < K && gl < L) ? M[(long long)gk * L + gl] : zero;
    }
    for (int idx = tid; idx < TL * TC; idx += NT) {
      const int l = idx / TC, c = idx % TC, gl = l0 + l, gc = c0 + c;
      float2 val = zero;
      if (gl < L && gc < C) {
        const long long o = gl * ldx + gc;
        val = X[o];
        if (Xm) val = cmul(val, Xm[o]);
      }
      sm.x[l][c] = val;
    }
    __syncthreads();
#pragma unroll
    for (int l = 0; l < TL; ++l) {
      float2 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sm.m[ty + 16 * i][l];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sm.x[l][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) cmac(acc[i][j], a[i], b[j]);
    }
    __syncthreads();
  }
}

__device__ void tile_zero(float2 (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = make_float2(0.f, 0.f);
}

__device__ void tile_store(float2* __restrict__ Y, long long ldy, int K,
                           int C, int k0, int c0, const float2 (&acc)[4][4]) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + ty + 16 * i, c = c0 + tx + 16 * j;
      if (k < K && c < C) Y[k * ldy + c] = acc[i][j];
    }
}

__host__ __device__ inline long long cdiv(long long a, long long b) {
  return (a + b - 1) / b;
}

// One stage Y[a] = M . X[a] over a batch of nA (L x C) slabs, tiles spread
// over the persistent grid.
__device__ void stage(const float2* __restrict__ M, int K, int L,
                      const float2* __restrict__ X, long long sXa,
                      long long ldx, float2* __restrict__ Y, long long sYa,
                      long long ldy, int C, long long nA, Smem& sm) {
  const long long kt = cdiv(K, TK), ct = cdiv(C, TC);
  const long long ntiles = nA * kt * ct;
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const long long a = t / (kt * ct), r = t % (kt * ct);
    const int k0 = (int)(r / ct) * TK, c0 = (int)(r % ct) * TC;
    float2 acc[4][4];
    tile_zero(acc);
    tile_mac(M, K, L, X + a * sXa, nullptr, ldx, C, k0, c0, acc, sm);
    tile_store(Y + a * sYa, ldy, K, C, k0, c0, acc);
  }
}

// Kernel A: t1[b] = Mf_z . (v_s * m_c) on (n1 x n2n3) slabs, then
// t2[b, Z] = Mf_y . t1[b, Z] on (n2 x n3) slabs; b = s * cc + c. Without
// kCoils (K2) there is no map multiply and cc = 1, so b = s.
template <bool kCoils>
__global__ void __launch_bounds__(NT)
    kern_a(const float2* __restrict__ v, const float2* __restrict__ maps,
           const float2* __restrict__ mfz, const float2* __restrict__ mfy,
           float2* __restrict__ t1, float2* __restrict__ t2, int S, int cc,
           int n1, int n2, int n3) {
  __shared__ Smem sm;
  const long long P = (long long)n2 * n3;
  const long long B = (long long)S * cc;
  const int K1 = 2 * n1;
  const long long kt = cdiv(K1, TK), ct = cdiv(P, TC);
  for (long long t = blockIdx.x; t < B * kt * ct; t += gridDim.x) {
    const long long b = t / (kt * ct), r = t % (kt * ct);
    const int k0 = (int)(r / ct) * TK, c0 = (int)(r % ct) * TC;
    const long long s = b / cc, c = b % cc;
    float2 acc[4][4];
    tile_zero(acc);
    tile_mac(mfz, K1, n1, v + s * n1 * P,
             kCoils ? maps + c * n1 * P : nullptr, P, (int)P, k0, c0, acc,
             sm);
    tile_store(t1 + b * K1 * P, P, K1, (int)P, k0, c0, acc);
  }
  cg::this_grid().sync();
  stage(mfy, 2 * n2, n2, t1, P, n3, t2, 2LL * n2 * n3, n3, n3, B * K1, sm);
}

// Kernel B: per x-line of t2 (B, 2n1, 2n2, n3): forward x (n3 -> 2n3),
// times the spectrum row Tf[Z, Y, :], inverse x (2n3 -> n3), in place.
// mfxT is Mf_x transposed (n3 x 2n3), mixT is Mi_x transposed (2n3 x n3).
__global__ void __launch_bounds__(NT)
    kern_b(float2* __restrict__ t2, const float* __restrict__ tf,
           const float2* __restrict__ mfxT, const float2* __restrict__ mixT,
           long long nlines, long long rows_tf, int n3) {
  extern __shared__ float2 smem[];
  const int n3x2 = 2 * n3;
  float2* sx = smem;              // LB x n3
  float2* sf = smem + LB * n3;    // LB x 2n3
  const long long q0 = (long long)blockIdx.x * LB;
  const int nl = (int)min((long long)LB, nlines - q0);
  const int tid = threadIdx.x;
  for (int idx = tid; idx < LB * n3; idx += NT)
    sx[idx] = idx < nl * n3 ? t2[q0 * n3 + idx] : make_float2(0.f, 0.f);
  __syncthreads();
  for (int k = tid; k < n3x2; k += NT) {
    float2 acc[LB];
#pragma unroll
    for (int i = 0; i < LB; ++i) acc[i] = make_float2(0.f, 0.f);
    for (int l = 0; l < n3; ++l) {
      const float2 m = mfxT[(long long)l * n3x2 + k];
#pragma unroll
      for (int i = 0; i < LB; ++i) cmac(acc[i], m, sx[i * n3 + l]);
    }
#pragma unroll
    for (int i = 0; i < LB; ++i) {
      const float w = i < nl ? tf[((q0 + i) % rows_tf) * n3x2 + k] : 0.f;
      sf[i * n3x2 + k] = make_float2(acc[i].x * w, acc[i].y * w);
    }
  }
  __syncthreads();
  for (int x = tid; x < n3; x += NT) {
    float2 acc[LB];
#pragma unroll
    for (int i = 0; i < LB; ++i) acc[i] = make_float2(0.f, 0.f);
    for (int k = 0; k < n3x2; ++k) {
      const float2 m = mixT[(long long)k * n3 + x];
#pragma unroll
      for (int i = 0; i < LB; ++i) cmac(acc[i], m, sf[i * n3x2 + k]);
    }
#pragma unroll
    for (int i = 0; i < LB; ++i)
      if (i < nl) t2[(q0 + i) * n3 + x] = acc[i];
  }
}

// Kernel C: t1[b, Z] = Mi_y . t2[b, Z] on (2n2 x n3) slabs, then per output
// tile out[s] = sum_c conj(m_c) * (Mi_z . t1[b]) on (2n1 x n2n3) slabs.
// Without kCoils (K2, cc = 1) the tile is out[s] = Mi_z . t1[s]: no coil
// loop, no map read, and no second accumulator held in registers.
template <bool kCoils>
__global__ void __launch_bounds__(NT)
    kern_c(const float2* __restrict__ t2, float2* __restrict__ t1,
           const float2* __restrict__ maps, float2* __restrict__ out,
           const float2* __restrict__ miy, const float2* __restrict__ miz,
           int S, int cc, int n1, int n2, int n3) {
  __shared__ Smem sm;
  const long long P = (long long)n2 * n3;
  const long long B = (long long)S * cc;
  stage(miy, n2, 2 * n2, t2, 2LL * n2 * n3, n3, t1, P, n3, n3, B * 2 * n1,
        sm);
  cg::this_grid().sync();
  const long long kt = cdiv(n1, TK), ct = cdiv(P, TC);
  for (long long t = blockIdx.x; t < S * kt * ct; t += gridDim.x) {
    const long long s = t / (kt * ct), r = t % (kt * ct);
    const int k0 = (int)(r / ct) * TK, c0 = (int)(r % ct) * TC;
    float2 o[4][4];
    tile_zero(o);
    if constexpr (kCoils) {
      const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
      for (int c = 0; c < cc; ++c) {
        const long long b = s * cc + c;
        float2 acc[4][4];
        tile_zero(acc);
        tile_mac(miz, n1, 2 * n1, t1 + b * 2 * n1 * P, nullptr, P, (int)P,
                 k0, c0, acc, sm);
        const float2* m = maps + (long long)c * n1 * P;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int k = k0 + ty + 16 * i, col = c0 + tx + 16 * j;
            if (k < n1 && col < P) {
              const float2 mm = m[(long long)k * P + col];
              cmac(o[i][j], make_float2(mm.x, -mm.y), acc[i][j]);
            }
          }
      }
    } else {
      tile_mac(miz, n1, 2 * n1, t1 + s * 2 * n1 * P, nullptr, P, (int)P, k0,
               c0, o, sm);
    }
    tile_store(out + s * n1 * P, P, n1, (int)P, k0, c0, o);
  }
}

// Largest grid whose blocks are all resident at once (cooperative launch).
cudaError_t coop_grid(const void* fn, int* grid) {
  int dev, sms, per;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, fn, NT, 0);
  if (e != cudaSuccess) return e;
  if (per < 1) return cudaErrorCooperativeLaunchTooLarge;
  *grid = per * sms;
  return cudaSuccess;
}

int finish(cudaError_t e) {
  cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}

// One cooperative launch of `fn` over the largest fully resident grid.
int coop_launch(const void* fn, void** args, void* stream) {
  int grid;
  cudaError_t e = coop_grid(fn, &grid);
  if (e != cudaSuccess) return finish(e);
  return finish(cudaLaunchCooperativeKernel(fn, grid, NT, args, 0,
                                            (cudaStream_t)stream));
}

}  // namespace

extern "C" {

// Each launcher enqueues one kernel on `stream` and returns the launch's
// cudaError_t (0 on success); it never synchronises.

int indigo_sense_normal_a(const void* v, const void* maps, const void* mfz,
                          const void* mfy, void* t1, void* t2, int S, int cc,
                          int n1, int n2, int n3, void* stream) {
  const float2 *pv = (const float2*)v, *pm = (const float2*)maps,
               *pz = (const float2*)mfz, *py = (const float2*)mfy;
  float2 *p1 = (float2*)t1, *p2 = (float2*)t2;
  void* args[] = {&pv, &pm, &pz, &py, &p1, &p2, &S, &cc, &n1, &n2, &n3};
  return coop_launch((const void*)kern_a<true>, args, stream);
}

int indigo_sense_normal_b(void* t2, const void* tf, const void* mfxT,
                          const void* mixT, int B, int n1, int n2, int n3,
                          void* stream) {
  const size_t smem = (size_t)LB * 3 * n3 * sizeof(float2);
  cudaError_t e = cudaFuncSetAttribute(
      kern_b, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return finish(e);
  const long long nlines = (long long)B * 4 * n1 * n2;
  const long long rows_tf = 4LL * n1 * n2;
  const long long nblocks = cdiv(nlines, LB);
  kern_b<<<(unsigned)nblocks, NT, smem, (cudaStream_t)stream>>>(
      (float2*)t2, (const float*)tf, (const float2*)mfxT,
      (const float2*)mixT, nlines, rows_tf, n3);
  return finish(cudaSuccess);
}

int indigo_sense_normal_c(const void* t2, void* t1, const void* maps,
                          void* out, const void* miy, const void* miz, int S,
                          int cc, int n1, int n2, int n3, void* stream) {
  const float2 *p2 = (const float2*)t2, *pm = (const float2*)maps,
               *py = (const float2*)miy, *pz = (const float2*)miz;
  float2 *p1 = (float2*)t1, *po = (float2*)out;
  void* args[] = {&p2, &p1, &pm, &po, &py, &pz, &S, &cc, &n1, &n2, &n3};
  return coop_launch((const void*)kern_c<true>, args, stream);
}

// K2 (toeplitz_apply): kernels A and C without the coil fusion on a batch
// of B volumes u (B, n1, n2, n3); kernel B is indigo_sense_normal_b with
// the same B.

int indigo_toeplitz_apply_a(const void* u, const void* mfz, const void* mfy,
                            void* t1, void* t2, int B, int n1, int n2,
                            int n3, void* stream) {
  const float2 *pv = (const float2*)u, *pm = nullptr,
               *pz = (const float2*)mfz, *py = (const float2*)mfy;
  float2 *p1 = (float2*)t1, *p2 = (float2*)t2;
  int cc = 1;
  void* args[] = {&pv, &pm, &pz, &py, &p1, &p2, &B, &cc, &n1, &n2, &n3};
  return coop_launch((const void*)kern_a<false>, args, stream);
}

int indigo_toeplitz_apply_c(const void* t2, void* t1, void* out,
                            const void* miy, const void* miz, int B, int n1,
                            int n2, int n3, void* stream) {
  const float2 *p2 = (const float2*)t2, *pm = nullptr,
               *py = (const float2*)miy, *pz = (const float2*)miz;
  float2 *p1 = (float2*)t1, *po = (float2*)out;
  int cc = 1;
  void* args[] = {&p2, &p1, &pm, &po, &py, &pz, &B, &cc, &n1, &n2, &n3};
  return coop_launch((const void*)kern_c<false>, args, stream);
}

const char* indigo_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
