// Toeplitz SENSE normal operator for Hopper (sm_90a): FFT stages in shared
// memory on the f32 CUDA cores.
//
//   K1: out_s = sum_c conj(m_c) * crop(IFFT(Tf * FFT(pad_2x(m_c * v_s))))
//   K2: out_b = crop(IFFT(Tf * FFT(pad_2x(u_b))))
//
// Replaces the TPU kernels of indigo_tpu/ops/dft_pallas.py:
//   K1 sense_normal_pallas   (pallas_call at :643, :668, :690)
//   K2 toeplitz_apply_pallas (pallas_call at :759, :781, :803)
// K2 is K1 with the coil fusion turned off (one "coil", no maps): the same
// five kernels, kern_fwd and kern_inv instantiated with kMaps = false.
//
// v (S, n1, n2, n3), maps (cc, n1, n2, n3), out (S, n1, n2, n3): complex64
// (float2), natural (z, y, x) order, x contiguous. Tf is the real
// doubled-grid spectrum in block (even|odd) layout on every axis,
// (2n1, 2n2, 2n3). Intermediates t1 (B, 2n1, n2, n3) and t2 (B, 2n1, 2n2,
// n3), B = S * cc, live in device memory in the same block layout.
//
// Each axis runs the zero-aware doubled transform, as ops/toeplitz_fft.py:
//   forward            X_even = F_n x,  X_odd = F_n (t x),  t_j = e^{-i pi j/n}
//   inverse with crop  x = (IF_n X_even + conj(t) IF_n X_odd) / (2n)
// so no transform touches the padding zeros and the frequencies come out in
// the block layout directly. Five launches per op, one axis pass each:
//   kern_fwd (z, map multiply on load) -> kern_fwd (y) -> kern_x (forward x,
//   spectrum multiply, inverse x, in place) -> kern_inv (y) -> kern_inv (z,
//   conj-map coil sum).
//
// Bound on this card (NVIDIA H100 SXM, 67 TFLOP/s f32, 3.35 TB/s): the
// FFT round trip is ~140 n^3 log2(n) flops per coil (1.9e10 at 256^3)
// against ~1.34 GB of inputs and output at 256^3 / 4 coils, so operations
// set the bound: ~1.15 ms for K1 at 256^3 / nc 4, ~2.3 ms for K2 at B 8
// (chip_smoke.py computes it from each run's shapes). The five passes must
// move ~3.7 GB per coil through device memory at 256^3 (t1 and t2 each
// written and read once), the floor of this design (~1.1 ms per coil at
// 3.35 TB/s); what the design does about it is to keep every FFT stage
// and the spectrum multiply out of device memory. chip_smoke.py prints
// each pass's share of its bytes floor (PERF.md).
//
// Design:
//  * Each n-point transform is a two-factor FFT, n = p q with p in {8, 16}
//    and q = n / p <= 32: p-point DFTs along stride-q runs (radix-2
//    butterflies in registers, every index a template constant), a twiddle
//    W_n^{ab}, then q-point DFTs along contiguous runs (radix-2 in
//    registers for q in {8, 16}, direct sums otherwise). The forward leaves
//    frequency k1 + p k2 at row q k1 + k2; the inverse takes that order and,
//    with the factors' roles swapped, returns natural order.
//  * Every pass touches shared memory once, between its two stages: the
//    forward's p-point stage reads its stride-q runs straight from device
//    memory (both halves from one load, the odd one times t), and the
//    inverse's p-point stage hands its results straight to device memory
//    (or K1's coil accumulator). Row q a + j holds frequency a + p j, so a
//    forward pencil's q-point stage writes block-layout rows to device
//    memory directly, and an inverse pencil's reads them directly.
//  * Twiddles: one table per axis, W_2n^k for k < 2n, built in float64 on
//    the host and rounded to f32; a block copies it to shared memory. It
//    holds t, W_n, and the small factors' W_p, W_q (W_p^{p/4} = -i is a
//    swap). No stage matrix exists.
//  * z and y passes: a block owns a pencil bundle, the whole transform axis
//    by 16 contiguous x-columns (128 B rows), even and odd halves side by
//    side in shared memory (~70 KB at n = 256, two blocks per SM); a warp's
//    accesses to device memory cover whole 128 B rows.
//  * kern_x: a block of 128 threads owns L whole x-lines of one volume (L
//    n3 >= 2048 elements; 8 lines at n3 = 256, four blocks per SM). Its
//    spectrum rows arrive by cp.async while the first stage runs; the
//    forward q-point DFT, the spectrum multiply and the inverse q-point DFT
//    run back to back in registers. The blocks of the B volumes that read
//    the same spectrum rows run next to each other, so the spectrum comes
//    from L2 after the first.
//  * K1's coil sum: the z inverse block loops over the coils of its own
//    output bundle and accumulates conj(m_c) * result in registers (16
//    complex per thread): no atomics, deterministic.
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;    // threads per block of the z and y passes
constexpr int XT = 128;    // threads per block of the x pass
constexpr int WC = 16;     // x-columns per pencil bundle (z and y passes)
constexpr int MAXQ = 32;   // largest second factor

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

// Two n-point buffers (even | odd halves) of `ncol` columns in shared
// memory: element (buffer h, row r, column c) at p[h * bs + r * rs + c * cs].
struct Buf {
  float2* p;
  int bs, rs, cs, ncol;
};

// The first stage of the forward on both halves of run b of column c at
// once: x_j = ld(b, j, c) is row q j + b; the even half takes x, the odd
// half x t; output k of half h, times W_n^{kb}, goes to st(h, b, k, c,
// value). kColFast: items run column fastest (the column count a power of
// two), else run index fastest.
template <int P, int Q, bool kColFast, class Ld, class St>
__device__ void stride_fwd_in(int q_, int ncol, const float2* w, int n2,
                              Ld ld, St st) {
  const int q = Q > 0 ? Q : q_, lc = __ffs(ncol) - 1, ws = n2 / P;
  for (int it = threadIdx.x; it < q * ncol; it += blockDim.x) {
    const int b = kColFast ? (it >> lc) : it % q,
              c = kColFast ? (it & (ncol - 1)) : it / q;
    float2 e[P], o[P];
#pragma unroll
    for (int j = 0; j < P; ++j) {
      e[j] = ld(b, j, c);
      o[j] = cmul(e[j], w[q * j + b]);
    }
    fft_reg<P, false>(e, w, ws);
    fft_reg<P, false>(o, w, ws);
#pragma unroll
    for (int k = 0; k < P; ++k) {
      float2 ve = e[brev<P>(k)], vo = o[brev<P>(k)];
      if (k > 0) {
        ve = cmul(ve, w[2 * k * b]);
        vo = cmul(vo, w[2 * k * b]);
      }
      st(0, b, k, c, ve);
      st(1, b, k, c, vo);
    }
  }
}

// The last stage of an inverse on both halves of run b of column c at
// once: the inverse P-point DFTs along the stride-q run {q j + b : j < P},
// then (e + conj(t) o) * scale handed to out(m, x, value) for the natural
// index x = b + q m. Q > 0: q == Q, a compile-time constant.
template <int P, int Q, class Out>
__device__ __forceinline__ void inv_out_run(const Buf& s, int q_, int b,
                                            int c, const float2* w, int n2,
                                            float scale, Out out) {
  const int q = Q > 0 ? Q : q_, step = q * s.rs, ws = n2 / P;
  const float2* base = s.p + b * s.rs + c * s.cs;
  float2 e[P], o[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    e[j] = base[j * step];
    o[j] = base[s.bs + j * step];
  }
  fft_reg<P, true>(e, w, ws);
  fft_reg<P, true>(o, w, ws);
#pragma unroll
  for (int m = 0; m < P; ++m) {
    const int x = b + q * m;
    out(m, x,
        cscale(cadd(e[brev<P>(m)], cmulc(o[brev<P>(m)], w[x])), scale));
  }
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

// q-point DFTs along the contiguous runs {q a + j : j < q} (a < p) of both
// halves h and every column c: input j from ld(h, a, j, c), output k to
// st(h, a, k, c, value), times W_n^{ak} when TW. The input row q a + j
// holds frequency a + p j, so a pass may read or write global rows
// h n + a + p j directly. Q > 0: radix-2 in registers (q == Q); Q == 0:
// direct sums for any q <= MAXQ.
template <int Q, bool INV, bool TW, class Ld, class St>
__device__ void run_pass(int p, int q, int ncol, const float2* w, int n2,
                         Ld ld, St st) {
  const int items = 2 * p * ncol, lc = __ffs(ncol) - 1;
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int c = it & (ncol - 1), rest = it >> lc, a = rest % p,
              h = rest / p;
    if constexpr (Q > 0) {
      float2 x[Q];
#pragma unroll
      for (int j = 0; j < Q; ++j) x[j] = ld(h, a, j, c);
      fft_reg<Q, INV>(x, w, n2 / Q);
#pragma unroll
      for (int k = 0; k < Q; ++k) {
        float2 v = x[brev<Q>(k)];
        if (TW && k > 0) v = twid<INV>(v, w[2 * a * k]);
        st(h, a, k, c, v);
      }
    } else {
      float2 x[MAXQ];
      for (int j = 0; j < q; ++j) x[j] = ld(h, a, j, c);
      for (int k = 0; k < q; ++k) {
        float2 v = dft_term<INV>(x, q, k, w, n2 / q);
        if (TW && k > 0) v = twid<INV>(v, w[2 * a * k]);
        st(h, a, k, c, v);
      }
    }
  }
}

// Kernel x's middle, in registers and in place, for every run: the forward
// q-point DFT, the spectrum (frequency a + p k of half h of line c is
// ts[c * tld + h n + a + p k]), the inverse q-point DFT and W_n^{-am}.
// Items run line fastest, then half: with 8 lines of 257 and halves 2056
// apart, a warp's 16 (line, half) pairs fall on 16 distinct bank pairs.
template <int Q>
__device__ void run_fused(const Buf& s, int p, int q, const float2* w,
                          int n, const float* ts, int tld) {
  const int items = 2 * p * s.ncol, ws = 2 * n / q, lc = __ffs(s.ncol) - 1;
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int c = it & (s.ncol - 1), rest = it >> lc, h = rest & 1,
              a = rest >> 1;
    float2* base = s.p + h * s.bs + q * a * s.rs + c * s.cs;
    const float* t = ts + c * tld + h * n + a;
    if constexpr (Q > 0) {
      float2 x[Q], y[Q];
#pragma unroll
      for (int j = 0; j < Q; ++j) x[j] = base[j * s.rs];
      fft_reg<Q, false>(x, w, ws);
#pragma unroll
      for (int k = 0; k < Q; ++k) y[k] = cscale(x[brev<Q>(k)], t[p * k]);
      fft_reg<Q, true>(y, w, ws);
#pragma unroll
      for (int m = 0; m < Q; ++m) {
        float2 v = y[brev<Q>(m)];
        if (m > 0) v = twid<true>(v, w[2 * a * m]);
        base[m * s.rs] = v;
      }
    } else {
      float2 x[MAXQ], y[MAXQ];
      for (int j = 0; j < q; ++j) x[j] = base[j * s.rs];
      for (int k = 0; k < q; ++k)
        y[k] = cscale(dft_term<false>(x, q, k, w, ws), t[p * k]);
      for (int m = 0; m < q; ++m) {
        float2 v = dft_term<true>(y, q, m, w, ws);
        if (m > 0) v = twid<true>(v, w[2 * a * m]);
        base[m * s.rs] = v;
      }
    }
  }
}

__device__ void load_table(float2* w, const float2* __restrict__ tab, int n) {
  for (int k = threadIdx.x; k < 2 * n; k += blockDim.x) w[k] = tab[k];
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Forward pass along a strided axis (z or y) over a pencil bundle: reads
// rows r < n of `in` (times `mp` when kMaps), ncol columns, and writes
// rows k < 2n of `out` in block layout. Strides in elements.
template <int P, int Q, bool kMaps>
__global__ void __launch_bounds__(NT, 2)
    kern_fwd(const float2* __restrict__ in, const float2* __restrict__ maps,
             const float2* __restrict__ tab, float2* __restrict__ out, int cc,
             int n, int ncols, long long in_b, long long map_b,
             long long out_b, long long in_o, long long out_o,
             long long in_row, long long out_row) {
  extern __shared__ __align__(16) float2 sm[];
  float2* w = sm;
  const Buf s{sm + 2 * n, n * WC, WC, 1, WC};
  const int x0 = blockIdx.x * WC, ncol = min(WC, ncols - x0), q = n / P;
  const long long o = blockIdx.y, vol = blockIdx.z;
  const float2* src = in + (vol / cc) * in_b + o * in_o + x0;
  const float2* mp =
      kMaps ? maps + (vol % cc) * map_b + o * in_o + x0 : nullptr;
  float2* dst = out + vol * out_b + o * out_o + x0;
  load_table(w, tab, n);
  __syncthreads();
  // first stage straight from device memory
  stride_fwd_in<P, Q, true>(
      q, WC, w, 2 * n,
      [&](int b, int j, int c) {
        const int r = q * j + b;
        float2 v = make_float2(0.f, 0.f);
        if (c < ncol) {
          v = src[r * in_row + c];
          if (kMaps) v = cmul(v, mp[r * in_row + c]);
        }
        return v;
      },
      [&](int h, int b, int k, int c, float2 v) {
        s.p[h * s.bs + (q * k + b) * WC + c] = v;
      });
  __syncthreads();
  run_pass<Q, false, false>(
      P, q, WC, w, 2 * n,
      [&](int h, int a, int j, int c) {
        return s.p[h * s.bs + (q * a + j) * WC + c];
      },
      [&](int h, int a, int k, int c, float2 val) {
        if (c < ncol) dst[(h * n + a + P * k) * out_row + c] = val;
      });
}

// Inverse-with-crop pass along a strided axis over a pencil bundle: reads
// rows k < 2n of `in` (block layout), writes rows r < n of `out`. With
// kMaps (K1's z pass) the block loops over the cc coils of output volume
// blockIdx.z and writes sum_c conj(m_c) * result, accumulated in registers.
template <int P, int Q, bool kMaps>
__global__ void __launch_bounds__(NT, 2)
    kern_inv(const float2* __restrict__ in, const float2* __restrict__ maps,
             const float2* __restrict__ tab, float2* __restrict__ out, int cc,
             int n, int ncols, long long in_b, long long map_b,
             long long out_b, long long in_o, long long out_o,
             long long in_row, long long out_row) {
  // runs per thread of the last stage: q WC <= kRuns NT, as q <= 256 / P
  constexpr int kRuns = 16 / P;
  extern __shared__ __align__(16) float2 sm[];
  float2* w = sm;
  const Buf s{sm + 2 * n, n * WC, WC, 1, WC};
  const int x0 = blockIdx.x * WC, ncol = min(WC, ncols - x0), q = n / P;
  const long long o = blockIdx.y, vol = blockIdx.z;
  float2* dst = out + vol * out_b + o * out_o + x0;
  const float scale = 0.5f / n;
  float2 acc[kRuns * P];
#pragma unroll
  for (int i = 0; i < kRuns * P; ++i) acc[i] = make_float2(0.f, 0.f);
  load_table(w, tab, n);
  __syncthreads();
  for (int c = 0; c < cc; ++c) {
    const float2* src = in + (vol * cc + c) * in_b + o * in_o + x0;
    run_pass<Q, true, true>(
        P, q, WC, w, 2 * n,
        [&](int h, int a, int j, int col) {
          return col < ncol ? src[(h * n + a + P * j) * in_row + col]
                            : make_float2(0.f, 0.f);
        },
        [&](int h, int a, int k, int col, float2 val) {
          s.p[h * s.bs + (q * a + k) * WC + col] = val;
        });
    __syncthreads();
    const float2* mp = kMaps ? maps + c * map_b + o * out_o + x0 : nullptr;
    // the last stage straight to registers (K1) or device memory (K2):
    // columns fastest, so each access covers whole 128-byte rows
#pragma unroll
    for (int i = 0; i < kRuns; ++i) {
      const int it = threadIdx.x + NT * i, b = it / WC, col = it % WC;
      if (b < q)
        inv_out_run<P, Q>(s, q, b, col, w, 2 * n, scale,
                          [&](int m, int x, float2 val) {
                            if (col >= ncol) return;
                            if (kMaps)  // acc += conj(m) val
                              acc[i * P + m] = cadd(
                                  acc[i * P + m],
                                  cmulc(val, mp[x * out_row + col]));
                            else
                              dst[x * out_row + col] = val;
                          });
    }
    __syncthreads();  // the buffers are free for the next coil
  }
  if (kMaps) {
#pragma unroll
    for (int i = 0; i < kRuns; ++i) {
      const int it = threadIdx.x + NT * i, b = it / WC, col = it % WC;
#pragma unroll
      for (int m = 0; m < P; ++m)
        if (b < q && col < ncol)
          dst[(b + q * m) * out_row + col] = acc[i * P + m];
    }
  }
}

// The x pass on whole lines of t2 (B, 2n1, 2n2, n3): forward x (n3 ->
// 2n3), times the spectrum row, inverse x (2n3 -> n3), in place. Block
// blockIdx.x = rb * B + b owns lines [rb L, rb L + L) of volume b; L
// divides rows_tf = 4 n1 n2. The block's spectrum rows arrive in shared
// memory by cp.async while the lines load and take their first stage.
template <int P, int Q>
__global__ void __launch_bounds__(XT, 4)
    kern_x(float2* __restrict__ t2, const float* __restrict__ tf,
           const float2* __restrict__ tab, int B, int n, int L,
           long long rows_tf) {
  extern __shared__ __align__(16) float2 sm[];
  const int tld = 2 * n + 4;  // padded spectrum rows, 16-byte aligned
  float* ts = reinterpret_cast<float*>(sm);
  float2* w = sm + L * tld / 2;
  const int ld = n + 1;  // odd line stride: conflict-free column access
  const Buf s{w + 2 * n, L * ld, 1, ld, L};
  const int q = n / P;
  const long long rb = blockIdx.x / B, vol = blockIdx.x % B;
  const long long row0 = rb * L;
  float2* lines = t2 + (vol * rows_tf + row0) * n;
  const float* trow = tf + row0 * 2 * n;
  for (int ch = threadIdx.x; ch < L * n / 2; ch += XT) {
    const int l = ch / (n / 2), j = 4 * (ch % (n / 2));
    cp_async16(ts + l * tld + j, trow + (long long)l * 2 * n + j);
  }
  cp_async_commit();
  load_table(w, tab, n);
  __syncthreads();
  // first stage straight from the lines: run index fastest, so each load
  // instruction reads whole 128-byte segments
  stride_fwd_in<P, Q, false>(
      q, L, w, 2 * n,
      [&](int b, int j, int c) { return lines[c * n + q * j + b]; },
      [&](int h, int b, int k, int c, float2 v) {
        s.p[h * s.bs + c * ld + q * k + b] = v;
      });
  cp_async_wait_all();
  __syncthreads();
  run_fused<Q>(s, P, q, w, n, ts, tld);
  __syncthreads();
  // runs b fastest: each store instruction writes whole 128-byte segments
  for (int it = threadIdx.x; it < q * L; it += blockDim.x) {
    const int b = it % q, c = it / q;
    inv_out_run<P, Q>(s, q, b, c, w, 2 * n, 0.5f / n,
                      [&](int, int x, float2 v) { lines[c * n + x] = v; });
  }
}

__host__ __device__ inline long long cdiv(long long a, long long b) {
  return (a + b - 1) / b;
}

int finish(cudaError_t e) {
  cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}

// One pencil pass (kern_fwd or kern_inv): grid (x-bundles, slabs, batch).
struct Pencil {
  const float2* in;
  const float2* maps;
  const float2* tab;
  float2* out;
  int cc, n, ncols, nslab, nbatch;
  long long in_b, map_b, out_b, in_o, out_o, in_row, out_row;
};

size_t pencil_smem(int n) { return (size_t)(2 * n + 2 * n * WC) * 8; }

template <class K>
cudaError_t launch_pencil(K kern, const Pencil& a, cudaStream_t st) {
  const size_t smem = pencil_smem(a.n);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)cdiv(a.ncols, WC), a.nslab, a.nbatch);
  kern<<<grid, NT, smem, st>>>(a.in, a.maps, a.tab, a.out, a.cc, a.n,
                               a.ncols, a.in_b, a.map_b, a.out_b, a.in_o,
                               a.out_o, a.in_row, a.out_row);
  return cudaSuccess;
}

template <int P, int Q>
cudaError_t pencil_fwd(const Pencil& a, cudaStream_t st) {
  return a.maps ? launch_pencil(kern_fwd<P, Q, true>, a, st)
                : launch_pencil(kern_fwd<P, Q, false>, a, st);
}

template <int P, int Q>
cudaError_t pencil_inv(const Pencil& a, cudaStream_t st) {
  return a.maps ? launch_pencil(kern_inv<P, Q, true>, a, st)
                : launch_pencil(kern_inv<P, Q, false>, a, st);
}

struct XPass {
  float2* t2;
  const float* tf;
  const float2* tab;
  int B, n, L;
  long long rows_tf;
};

template <int P, int Q>
cudaError_t xpass(const XPass& a, cudaStream_t st) {
  const size_t smem = (size_t)a.L * (2 * a.n + 4) * 4 +
                      (size_t)(2 * a.n + 2 * a.L * (a.n + 1)) * 8;
  cudaError_t e = cudaFuncSetAttribute(
      kern_x<P, Q>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const long long blocks = a.rows_tf / a.L * a.B;
  kern_x<P, Q><<<(unsigned)blocks, XT, smem, st>>>(a.t2, a.tf, a.tab, a.B,
                                                   a.n, a.L, a.rows_tf);
  return cudaSuccess;
}

// The factor plans the kernels are instantiated for: p = 16 when 16 | n,
// else 8 (ops/dft_cuda.fft_factors); q = n / p in registers for 8 and 16.
template <class A>
using PassFn = cudaError_t (*)(const A&, cudaStream_t);

template <class A>
PassFn<A> pick(int n, int p, PassFn<A> f16_16, PassFn<A> f16_8,
               PassFn<A> f16_0, PassFn<A> f8_0) {
  if (n < 8 || n > 256 || n % p) return nullptr;
  const int q = n / p;
  if (p == 16) return q == 16 ? f16_16 : q == 8 ? f16_8 : f16_0;
  if (p == 8 && q <= MAXQ) return f8_0;
  return nullptr;
}

int run_fwd(const Pencil& a, int p, void* stream) {
  auto f = pick<Pencil>(a.n, p, pencil_fwd<16, 16>, pencil_fwd<16, 8>,
                        pencil_fwd<16, 0>, pencil_fwd<8, 0>);
  if (!f) return finish(cudaErrorInvalidValue);
  return finish(f(a, (cudaStream_t)stream));
}

int run_inv(const Pencil& a, int p, void* stream) {
  auto f = pick<Pencil>(a.n, p, pencil_inv<16, 16>, pencil_inv<16, 8>,
                        pencil_inv<16, 0>, pencil_inv<8, 0>);
  if (!f) return finish(cudaErrorInvalidValue);
  return finish(f(a, (cudaStream_t)stream));
}

}  // namespace

extern "C" {

// Each launcher enqueues one kernel on `stream` and returns the launch's
// cudaError_t (0 on success); it never synchronises. `tab` is the axis's
// twiddle table W_2n^k (k < 2n), `p` its first factor. maps == NULL runs
// K2's instance (no map multiply, no coil sum, cc = 1).

// z forward: v (S, n1, n2, n3) [x maps (cc, ...)] -> t1 (S cc, 2n1, n2, n3)
int indigo_toeplitz_fz(const void* v, const void* maps, const void* tab,
                       int p, void* t1, int S, int cc, int n1, int n2, int n3,
                       void* stream) {
  const long long P2 = (long long)n2 * n3;
  if (!maps) cc = 1;
  const Pencil a{(const float2*)v, (const float2*)maps, (const float2*)tab,
                 (float2*)t1, cc, n1, n3, n2, S * cc, n1 * P2, n1 * P2,
                 2LL * n1 * P2, n3, n3, P2, P2};
  return run_fwd(a, p, stream);
}

// y forward: t1 (B, 2n1, n2, n3) -> t2 (B, 2n1, 2n2, n3)
int indigo_toeplitz_fy(const void* t1, const void* tab, int p, void* t2,
                       int B, int n1, int n2, int n3, void* stream) {
  const long long P2 = (long long)n2 * n3;
  const Pencil a{(const float2*)t1, nullptr, (const float2*)tab,
                 (float2*)t2, 1, n2, n3, 2 * n1, B, 2LL * n1 * P2, 0,
                 4LL * n1 * P2, P2, 2 * P2, n3, n3};
  return run_fwd(a, p, stream);
}

// x: forward, spectrum multiply, inverse, in place on t2 (B, 2n1, 2n2, n3)
int indigo_toeplitz_x(void* t2, const void* tf, const void* tab, int p,
                      int B, int n1, int n2, int n3, void* stream) {
  int L = 8;
  while (L < 256 && 2 * L * n3 <= 2048) L *= 2;
  const XPass a{(float2*)t2, (const float*)tf, (const float2*)tab, B, n3, L,
                4LL * n1 * n2};
  auto f = pick<XPass>(n3, p, xpass<16, 16>, xpass<16, 8>, xpass<16, 0>,
                       xpass<8, 0>);
  if (!f) return finish(cudaErrorInvalidValue);
  return finish(f(a, (cudaStream_t)stream));
}

// y inverse with crop: t2 (B, 2n1, 2n2, n3) -> t1 (B, 2n1, n2, n3)
int indigo_toeplitz_iy(const void* t2, const void* tab, int p, void* t1,
                       int B, int n1, int n2, int n3, void* stream) {
  const long long P2 = (long long)n2 * n3;
  const Pencil a{(const float2*)t2, nullptr, (const float2*)tab,
                 (float2*)t1, 1, n2, n3, 2 * n1, B, 4LL * n1 * P2, 0,
                 2LL * n1 * P2, 2 * P2, P2, n3, n3};
  return run_inv(a, p, stream);
}

// z inverse with crop [and conj-map coil sum]: t1 (S cc, 2n1, n2, n3) ->
// out (S, n1, n2, n3)
int indigo_toeplitz_iz(const void* t1, const void* maps, const void* tab,
                       int p, void* out, int S, int cc, int n1, int n2,
                       int n3, void* stream) {
  const long long P2 = (long long)n2 * n3;
  if (!maps) cc = 1;
  const Pencil a{(const float2*)t1, (const float2*)maps, (const float2*)tab,
                 (float2*)out, cc, n1, n3, n2, S, 2LL * n1 * P2, n1 * P2,
                 n1 * P2, n3, n3, P2, P2};
  return run_inv(a, p, stream);
}

const char* indigo_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
