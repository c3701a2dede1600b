// Adjoint centered pad-DFT for Hopper (sm_90a): the grid of the gridding
// adjoint back to the image, one pass per axis, each line an FFT in
// registers and shared memory on the f32 CUDA cores.
//
//   grid (K, g_0, .., g_{r-1}) complex64 -> image (K, n_0, .., n_{r-1})
//
// Per axis, with o = (g - n) / 2 the centered pad offset, the adjoint of
// ops/dft_fft.centered_pad_dft_mat(n, g) is
//   out[j] = (-1)^(g/2) (-1)^(j+o) sum_k (-1)^k exp(+2 pi i k (j+o) / g) x[k]
// for j < n. Since (-1)^k = exp(+2 pi i k (g/2) / g), that is
//   out[j] = (-1)^m Y[m mod g],  m = j + o + g/2,
// with Y the unnormalised inverse DFT of x of length g: the input
// checkerboard is an index shift of the outputs, and the output sign is the
// parity of m. No fftshift pass, no pad and no crop pass run: each line's
// transform computes the g outputs and stores the n it keeps.
//
// Replaces no TPU kernel: the reference applies this transform as three
// dense matrix products left to XLA (indigo_tpu/ops/dft_fft.py,
// dft_nd_apply with the conjugate-transposed centered_pad_dft_mat), which
// the port ran as three complex GEMMs (1.31 TFLOP per call at 320^3 -> 256^3
// with 8 coils, against ~35 GFLOP by FFT). ops/pad_dft_cuda.py holds its
// plain version (that einsum) and a torch mirror of this file's arithmetic.
//
// Bound on this card (NVIDIA H100 SXM, 3.35 TB/s, 67 TFLOP/s f32): bytes.
// The transform reads the grid once and writes the image once: 3.17 GB at
// 320^3 -> 256^3 with 8 coils, ~0.95 ms. These passes also write and read
// the two volumes between them: the passes run along the last axis first,
// then each axis before it, and each crops its axis (per coil 320^3 ->
// 320^2 256 -> 320 256^2 -> 256^3), 9.2 GB in all, ~2.75 ms.
//
// Design:
//  * Each line of g = P Q points is K1's two-factor FFT (fft_reg.cuh and
//    ops/dft_cuda.fft_factors: P = 16 when 16 | g, else 8; Q = g / P <=
//    32), in the inverse direction and natural order in. With k = Q i + b
//    and m = m1 + P m2, stage 1 takes the P-point DFT of the stride-Q run b
//    (radix-2 in registers) straight from device memory, times W_g^{-b m1}
//    and the sign (-1)^m1 (the parity of m, P being even), into shared
//    memory; stage 2 takes the Q-point DFT over b of each m1 from shared
//    memory (in registers: radix-2 for Q 8 and 16, 4 x 5 for Q 20 by
//    fft_reg_rs; direct sums for any other Q, formed for kept outputs
//    only) and stores output m1 + P m2 straight to device memory where its
//    j < n.
//  * Twiddles: the axis's table W_2g^k, k < 2g (ops/dft_cuda.fft_table), in
//    shared memory, as K1's passes hold theirs.
//  * A block owns C = 16 lines. Along the last axis the lines are
//    contiguous: a stage-1 thread reads its run b, threads of one line
//    side by side (consecutive b, consecutive addresses), and stage 2's
//    threads of a line write consecutive j. Along an earlier axis a block
//    owns 16 contiguous columns (128-byte rows) of one slab, threads of one
//    row side by side, so every load and store covers whole 128-byte rows
//    and no pass permutes the volume.
//  * Shared memory: the table and C P Q values (48 KB at g 320), laid out
//    so that both stages read and write them without bank conflicts (a
//    padded row of Q + 1 per (line, m1) along the last axis, columns
//    fastest otherwise).
#include <cuda_runtime.h>

#include <climits>

#include "fft_reg.cuh"

namespace {

constexpr int C = 16;    // lines (or 16 contiguous columns) per block
constexpr int NT = 320;  // threads per block: one stage-1 run each at 320

// One axis over the lines of one block. kLine: the axis is the last one,
// line l's point k at in[l g + k], output j at out[l n + j], `count`
// lines in all. Otherwise the block owns columns c0 + l (l < C) of slab
// blockIdx.x / nb: point k at in[k ncols + l], output j at
// out[j ncols + l]. tab: W_2g^k, k < 2g. shift = o + g/2. Q > 0: q == Q.
template <int P, int Q, bool kLine>
__global__ void __launch_bounds__(NT, 2)
    kern_pad_idft(const float2* __restrict__ in, float2* __restrict__ out,
                  const float2* __restrict__ tab, int q_, int n, int shift,
                  long long count, int ncols) {
  const int q = Q > 0 ? Q : q_, g = P * q;
  extern __shared__ __align__(16) float2 sm[];
  float2* w = sm;
  float2* s = sm + 2 * g;
  for (int k = threadIdx.x; k < 2 * g; k += NT) w[k] = tab[k];
  const float2* src;
  float2* dst;
  int nl;
  if (kLine) {
    const long long l0 = (long long)blockIdx.x * C;
    nl = (int)min((long long)C, count - l0);
    src = in + l0 * g;
    dst = out + l0 * n;
  } else {
    const int nb = (ncols + C - 1) / C;
    const long long o = blockIdx.x / nb;
    const int c0 = (blockIdx.x - (int)(o * nb)) * C;
    nl = min(C, ncols - c0);
    src = in + o * g * ncols + c0;
    dst = out + o * n * ncols + c0;
  }
  // shared index of (line l, m1, run b)
  auto sidx = [q](int l, int m1, int b) {
    return kLine ? l * (P * (q + 1)) + m1 * (q + 1) + b
                 : m1 * (q * C) + b * C + l;
  };
  __syncthreads();
  // stage 1: the P-point DFT of run b of line l, twiddled and signed
  for (int it = threadIdx.x; it < q * C; it += NT) {
    const int b = kLine ? it % q : it / C, l = kLine ? it / q : it % C;
    if (l >= nl) continue;
    float2 a[P];
#pragma unroll
    for (int i = 0; i < P; ++i)
      a[i] = src[kLine ? l * g + q * i + b : (q * i + b) * ncols + l];
    fft_reg<P, true>(a, w, 2 * g / P);
#pragma unroll
    for (int m1 = 0; m1 < P; ++m1) {
      float2 v = a[brev<P>(m1)];
      if (m1 > 0) v = twid<true>(v, w[2 * b * m1]);
      if (m1 & 1) v = make_float2(-v.x, -v.y);
      s[sidx(l, m1, b)] = v;
    }
  }
  __syncthreads();
  // stage 2: the Q-point DFT over the runs, outputs m1 + P m2 kept where
  // their j = m - shift (mod g) is below n
  for (int it = threadIdx.x; it < P * C; it += NT) {
    const int m1 = kLine ? it % P : it / C, l = kLine ? it / P : it % C;
    if (l >= nl) continue;
    float2 a[Q > 0 ? Q : MAXQ];
#pragma unroll
    for (int b = 0; b < (Q > 0 ? Q : MAXQ); ++b)
      if (Q > 0 || b < q) a[b] = s[sidx(l, m1, b)];
    int j = m1 - shift;
    if (j < 0) j += g;
    if constexpr (Q > 0) {
      if constexpr (Q == 20)
        fft_reg_rs<4, 5, true>(a, w, 2 * g / Q);
      else
        fft_reg<Q, true>(a, w, 2 * g / Q);
#pragma unroll
      for (int m2 = 0; m2 < Q; ++m2) {
        if (j < n)
          dst[kLine ? l * n + j : j * ncols + l] =
              a[Q == 20 ? m2 : brev<Q>(m2)];
        j += P;
        if (j >= g) j -= g;
      }
    } else {
      for (int m2 = 0; m2 < q; ++m2) {
        if (j < n)
          dst[kLine ? l * n + j : j * ncols + l] =
              dft_term<true>(a, q, m2, w, 2 * g / q);
        j += P;
        if (j >= g) j -= g;
      }
    }
  }
}

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

int finish(cudaError_t e) {
  cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}

struct Axis {
  const float2* in;
  float2* out;
  const float2* tab;
  int q, n;
  long long count;  // lines (last axis) or slabs (an earlier one)
  int ncols;        // contiguous columns after the axis (earlier axes)
};

template <int P, int Q, bool kLine>
cudaError_t launch(const Axis& a, cudaStream_t st) {
  const int g = P * a.q;
  const long long blocks =
      kLine ? cdiv(a.count, C) : a.count * cdiv(a.ncols, C);
  if (blocks < 1 || blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  const int smem = (2 * g + C * P * (a.q + 1)) * (int)sizeof(float2);
  auto kern = kern_pad_idft<P, Q, kLine>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kern<<<(unsigned)blocks, NT, smem, st>>>(a.in, a.out, a.tab, a.q, a.n,
                                           (g - a.n) / 2 + g / 2, a.count,
                                           a.ncols);
  return cudaSuccess;
}

using AxisFn = cudaError_t (*)(const Axis&, cudaStream_t);

template <int P, int Q>
AxisFn plan(bool line) {
  return line ? &launch<P, Q, true> : &launch<P, Q, false>;
}

// The factor plans of ops/dft_cuda.fft_factors: p = 16 when 16 | g, else
// 8; q = g / p <= MAXQ, instantiated for q 8, 16 and 20 (the 320-point
// grid of the main path), direct sums with a run-time q otherwise.
AxisFn pick(int p, int q, bool line) {
  if (q < 1 || q > MAXQ) return nullptr;
  if (p == 16)
    return q == 16   ? plan<16, 16>(line)
           : q == 20 ? plan<16, 20>(line)
           : q == 8  ? plan<16, 8>(line)
                     : plan<16, 0>(line);
  if (p == 8) return plan<8, 0>(line);
  return nullptr;
}

}  // namespace

extern "C" {

// One axis of the adjoint centered pad-DFT, enqueued on `stream`; returns
// the launch's cudaError_t (0 on success) and never synchronises. The axis
// has g = p q grid points and keeps n <= g. line != 0: the last axis, in
// (count, g) -> out (count, n). line == 0: in (count, g, ncols) -> out
// (count, n, ncols). tab: W_2g^k = exp(-i pi k / g), k < 2g, complex64.
int indigo_pad_idft(const void* in, void* out, const void* tab, int p, int q,
                    int line, int n, long long count, int ncols,
                    void* stream) {
  const AxisFn f = pick(p, q, line != 0);
  if (!f || n < 1 || n > p * q || count < 1 || (!line && ncols < 1))
    return finish(cudaErrorInvalidValue);
  const Axis a{(const float2*)in, (float2*)out, (const float2*)tab, q, n,
               count, ncols};
  return finish(f(a, (cudaStream_t)stream));
}

}  // extern "C"
