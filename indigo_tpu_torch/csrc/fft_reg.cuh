// The in-register FFT pieces that the port's CUDA kernels share
// (sense_normal.cu's K1/K2 passes, pad_dft.cu's adjoint pad-DFT): complex
// arithmetic on float2, the radix-2 P-point DFT in registers with its
// twiddles from a table (fft_reg), one output of a q-point DFT by direct
// sum (dft_term), and the two together for a length R S (fft_reg_rs). A table is W_2n^k = exp(-i pi k / n), k < 2n
// (ops/dft_cuda.fft_table); the inverse direction takes its conjugate.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int MAXQ = 32;  // largest second factor

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 cmulc(float2 a, float2 b) {  // a conj(b)
  return make_float2(a.x * b.x + a.y * b.y, a.y * b.x - a.x * b.y);
}

__device__ __forceinline__ float2 cscale(float2 a, float s) {
  return make_float2(a.x * s, a.y * s);
}

// a * w, or a * conj(w) for the inverse direction
template <bool INV>
__device__ __forceinline__ float2 twid(float2 a, float2 w) {
  return INV ? cmulc(a, w) : cmul(a, w);
}

__host__ __device__ constexpr int log2i(int p) {
  return p <= 1 ? 0 : 1 + log2i(p / 2);
}

// k with its log2(P) low bits reversed; k and P compile-time constants
// wherever it indexes a register array
template <int P>
__device__ __forceinline__ int brev(int k) {
  constexpr int kLog = log2i(P);
  return kLog == 0 ? 0 : (int)(__brev((unsigned)k) >> (32 - kLog));
}

// One radix-2 decimation-in-frequency stage of half-span H, then the rest:
// every index is a template constant, so the array stays in registers.
template <int P, int H, bool INV>
struct Dif {
  static __device__ __forceinline__ void run(float2 (&a)[P],
                                             const float2* __restrict__ w,
                                             int ws) {
#pragma unroll
    for (int s = 0; s < P; s += 2 * H)
#pragma unroll
      for (int j = 0; j < H; ++j) {
        const float2 u = a[s + j], v = a[s + j + H];
        a[s + j] = cadd(u, v);
        const float2 d = csub(u, v);
        const int m = j * (P / (2 * H));  // W_P^m; W_P^{P/4} = -i
        if (m == 0)
          a[s + j + H] = d;
        else if (4 * m == P)
          a[s + j + H] = INV ? make_float2(-d.y, d.x) : make_float2(d.y, -d.x);
        else
          a[s + j + H] = twid<INV>(d, w[m * ws]);
      }
    Dif<P, H / 2, INV>::run(a, w, ws);
  }
};

template <int P, bool INV>
struct Dif<P, 0, INV> {
  static __device__ __forceinline__ void run(float2 (&)[P], const float2*,
                                             int) {}
};

// In-register radix-2 DFT of P points (decimation in frequency): natural
// order in, bit-reversed order out (X[k] in a[brev<P>(k)]). W_P^m =
// w[m * ws].
template <int P, bool INV>
__device__ __forceinline__ void fft_reg(float2 (&a)[P],
                                        const float2* __restrict__ w, int ws) {
  Dif<P, P / 2, INV>::run(a, w, ws);
}

// One output of a q-point DFT by direct sum: sum_j x[j] W_q^{+-jk}, with
// W_q^m = w[m * ws].
template <bool INV>
__device__ __forceinline__ float2 dft_term(const float2* x, int q, int k,
                                           const float2* w, int ws) {
  float2 acc = x[0];
  int m = 0;  // j k mod q
  for (int j = 1; j < q; ++j) {
    m += k;
    if (m >= q) m -= q;
    acc = cadd(acc, twid<INV>(x[j], w[m * ws]));
  }
  return acc;
}

// In-register DFT of Q = R S points, R a power of two, from the two pieces
// above: the R-point radix-2 DFTs of the stride-S runs {S i + c : i < R},
// the twiddles W_Q^{+-c k1}, then S-point direct sums over c. Natural order
// in and out: a[m] <- sum_k a[k] W_Q^{+-k m}, with W_Q^m = w[m * ws].
template <int R, int S, bool INV>
__device__ __forceinline__ void fft_reg_rs(float2 (&a)[R * S],
                                           const float2* __restrict__ w,
                                           int ws) {
  float2 t[R][S];
#pragma unroll
  for (int c = 0; c < S; ++c) {
    float2 u[R];
#pragma unroll
    for (int i = 0; i < R; ++i) u[i] = a[S * i + c];
    fft_reg<R, INV>(u, w, S * ws);
#pragma unroll
    for (int k1 = 0; k1 < R; ++k1) {
      const float2 v = u[brev<R>(k1)];
      t[k1][c] = c * k1 > 0 ? twid<INV>(v, w[c * k1 * ws]) : v;
    }
  }
#pragma unroll
  for (int k1 = 0; k1 < R; ++k1)
#pragma unroll
    for (int k2 = 0; k2 < S; ++k2)
      a[k1 + R * k2] = dft_term<INV>(t[k1], S, k2, w, R * ws);
}

}  // namespace
