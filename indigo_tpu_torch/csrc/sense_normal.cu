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
// three kernels, kern_fwd and kern_inv instantiated with kMaps = false.
//
// v (S, n1, n2, n3), maps (cc, n1, n2, n3), out (S, n1, n2, n3): complex64
// (float2), natural (z, y, x) order, x contiguous. Tf is the real
// doubled-grid spectrum in block (even|odd) layout on every axis,
// (2n1, 2n2, 2n3). One intermediate, t1 (B, 2n1, n2, n3), B = S * cc,
// lives in device memory, its z axis in the same block layout.
//
// Each axis runs the zero-aware doubled transform, as ops/toeplitz_fft.py:
//   forward            X_even = F_n x,  X_odd = F_n (t x),  t_j = e^{-i pi j/n}
//   inverse with crop  x = (IF_n X_even + conj(t) IF_n X_odd) / (2n)
// so no transform touches the padding zeros and the frequencies come out in
// the block layout directly. Three launches per op:
//   kern_fwd (z, map multiply on load) -> kern_x (the plane pass: y forward,
//   x forward, spectrum multiply, x inverse, y inverse with crop, on each
//   z-frequency plane of t1, in place) -> kern_inv (z, conj-map coil sum).
//
// Bytes. A unit is one n1 n2 n3 complex64 volume (134 MB at 256^3). The five
// passes this replaced (z, y, x, y, z) also wrote and read t2 (B, 2n1, 2n2,
// n3), the y-spectrum of every plane: 27 units per coil volume through
// device memory, 20 of them in the three middle passes. The plane pass
// keeps a plane's y-spectrum (2n2 x n3, 1 MB at 256^2) in a ring of RING
// planes that stays in the 50 MB L2: t1 is read and written once per coil
// (4 units) and the f32 spectrum (4 units) is shared by the B volumes of
// a z-frequency. Bound on this card (NVIDIA H100 SXM, 67 TFLOP/s f32, 3.35
// TB/s): the FFT round trip is ~140 n^3 log2(n) flops per coil (1.9e10 at
// 256^3) against ~1.34 GB of inputs and output at 256^3 / 4 coils, so
// operations set the bound: ~1.15 ms for K1 at 256^3 / nc 4, ~2.3 ms for
// K2 at B 8 (chip_smoke.py computes it from each run's shapes, and each
// pass's share of its bytes floor from profiling.pass_bytes).
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
//    (or K1's coil accumulator).
//  * Twiddles: one table per axis, W_2n^k for k < 2n, built in float64 on
//    the host and rounded to f32; a block copies it to shared memory. It
//    holds t, W_n, and the small factors' W_p, W_q (W_p^{p/4} = -i is a
//    swap). No stage matrix exists.
//  * Pencil bundles (the z passes, and the plane pass's y stages): a block
//    owns the whole transform axis by 16 contiguous x-columns (128 B rows),
//    even and odd halves side by side in shared memory (~70 KB at n = 256,
//    two blocks per SM); a warp's accesses to device memory cover whole
//    128 B rows. K1's coil sum: the z inverse block loops over the coils of
//    its own output bundle and accumulates conj(m_c) * result in registers
//    (16 complex per thread): no atomics, deterministic.
//  * The plane pass (kern_x) is one persistent cooperative launch, two
//    blocks per SM, over a list of tasks. Plane p (z-frequency p / B of
//    volume p % B) takes in step p its y forward, a task per 16-column
//    bundle, from t1 into ring slot p % RING; in step p + DX its x round
//    trip, a task per 16 y-frequency lines (forward x, spectrum rows by
//    cp.async, inverse x, the forward q-point DFT, the spectrum multiply and
//    the inverse q-point DFT back to back in registers); in step p + DI its
//    y inverse with crop from the slot back into t1. A free block takes the
//    next task of the list (an atomic counter); a task first waits, on a
//    per-plane count in device memory, for the tasks it needs, which come
//    earlier in the list and are held by running blocks, so every wait ends.
//    The lag between a plane's stages hides most waits; the B volumes of
//    one z-frequency run side by side, so its spectrum plane comes from L2
//    after the first; the slot data a y inverse has read is discarded from
//    L2 without a write-back. Data written by another block loads through
//    L2 (ld.global.cg), never from a stale L1 line.
//  * A cluster of 8 CTAs holding each plane in distributed shared memory
//    was built first and measured slower: a CTA moved 256 KB per plane
//    through DSMEM at 11-17 B per cycle, about an SM's share of device
//    memory bandwidth, with three cluster barriers per plane (PERF.md
//    §6).
#include <cuda_runtime.h>

#include <algorithm>

#include "fft_reg.cuh"

namespace {

constexpr int NT = 256;    // threads per block of every kernel
constexpr int WC = 16;     // x-columns per pencil bundle

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

// Loads of data that another block of the same kernel wrote: through L2
// only (ld.global.cg), never a line this SM's L1 kept from before.
template <bool kCg>
__device__ __forceinline__ float2 ld2(const float2* p) {
  return kCg ? __ldcg(p) : *p;
}

// Forward pass along a strided axis (z or y) over one pencil bundle: reads
// rows r < n of src (times mp when kMaps), ncol <= WC columns, and writes
// rows k < 2n of dst in block layout. Strides in elements. sm: the table
// and both halves' buffers.
template <int P, int Q, bool kMaps>
__device__ __forceinline__ void fwd_bundle(const float2* src,
                                           const float2* mp, float2* dst,
                                           const float2* __restrict__ tab,
                                           float2* sm, int n, int ncol,
                                           long long in_row,
                                           long long out_row) {
  float2* w = sm;
  const Buf s{sm + 2 * n, n * WC, WC, 1, WC};
  const int q = n / P;
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

// Inverse-with-crop pass along a strided axis over one pencil bundle:
// reads rows k < 2n of the cc sources src + c in_b (block layout), writes
// rows r < n of dst; with kMaps (K1's z pass) it writes sum_c conj(m_c)
// * result, m_c = mp + c map_b, accumulated in registers. kCg: the sources
// were written by this kernel.
template <int P, int Q, bool kMaps, bool kCg>
__device__ __forceinline__ void inv_bundle(const float2* src,
                                           const float2* mp, float2* dst,
                                           const float2* __restrict__ tab,
                                           float2* sm, int cc, int n,
                                           int ncol, long long in_b,
                                           long long map_b, long long in_row,
                                           long long out_row) {
  // runs per thread of the last stage: q WC <= kRuns NT, as q <= 256 / P
  constexpr int kRuns = 16 / P;
  float2* w = sm;
  const Buf s{sm + 2 * n, n * WC, WC, 1, WC};
  const int q = n / P;
  const float scale = 0.5f / n;
  float2 acc[kRuns * P];
#pragma unroll
  for (int i = 0; i < kRuns * P; ++i) acc[i] = make_float2(0.f, 0.f);
  load_table(w, tab, n);
  __syncthreads();
  for (int c = 0; c < cc; ++c) {
    const float2* sc = src + c * in_b;
    run_pass<Q, true, true>(
        P, q, WC, w, 2 * n,
        [&](int h, int a, int j, int col) {
          return col < ncol ? ld2<kCg>(sc + (h * n + a + P * j) * in_row + col)
                            : make_float2(0.f, 0.f);
        },
        [&](int h, int a, int k, int col, float2 val) {
          s.p[h * s.bs + (q * a + k) * WC + col] = val;
        });
    __syncthreads();
    const float2* mc = kMaps ? mp + c * map_b : nullptr;
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
                                  cmulc(val, mc[x * out_row + col]));
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

// The z forward over pencil bundles: grid (x-bundles, slabs, batch).
template <int P, int Q, bool kMaps>
__global__ void __launch_bounds__(NT, 2)
    kern_fwd(const float2* __restrict__ in, const float2* __restrict__ maps,
             const float2* __restrict__ tab, float2* __restrict__ out, int cc,
             int n, int ncols, long long in_b, long long map_b,
             long long out_b, long long in_o, long long out_o,
             long long in_row, long long out_row) {
  extern __shared__ __align__(16) float2 sm[];
  const int x0 = blockIdx.x * WC, ncol = min(WC, ncols - x0);
  const long long o = blockIdx.y, vol = blockIdx.z;
  fwd_bundle<P, Q, kMaps>(
      in + (vol / cc) * in_b + o * in_o + x0,
      kMaps ? maps + (vol % cc) * map_b + o * in_o + x0 : nullptr,
      out + vol * out_b + o * out_o + x0, tab, sm, n, ncol, in_row, out_row);
}

// The z inverse with crop over pencil bundles: grid (x-bundles, slabs,
// output volumes); with kMaps the block sums the cc coils of its output
// volume blockIdx.z.
template <int P, int Q, bool kMaps>
__global__ void __launch_bounds__(NT, 2)
    kern_inv(const float2* __restrict__ in, const float2* __restrict__ maps,
             const float2* __restrict__ tab, float2* __restrict__ out, int cc,
             int n, int ncols, long long in_b, long long map_b,
             long long out_b, long long in_o, long long out_o,
             long long in_row, long long out_row) {
  extern __shared__ __align__(16) float2 sm[];
  const int x0 = blockIdx.x * WC, ncol = min(WC, ncols - x0);
  const long long o = blockIdx.y, vol = blockIdx.z;
  inv_bundle<P, Q, kMaps, false>(
      in + vol * cc * in_b + o * in_o + x0,
      kMaps ? maps + o * out_o + x0 : nullptr,
      out + vol * out_b + o * out_o + x0, tab, sm, cc, n, ncol, in_b, map_b,
      in_row, out_row);
}

// The x round trip on L whole lines of one plane's y-spectrum in device
// memory, in place: forward x (n -> 2n), times the spectrum rows trow (2n
// floats each), inverse x (2n -> n). The spectrum rows arrive in shared
// memory by cp.async while the lines load and take their first stage; the
// lines, written by other blocks of this kernel, load through L2.
template <int P, int Q>
__device__ __forceinline__ void x_lines(float2* lines, const float* trow,
                                        const float2* w, float2* sm, int n,
                                        int L) {
  const int tld = 2 * n + 4;  // padded spectrum rows, 16-byte aligned
  float* ts = reinterpret_cast<float*>(sm);
  const int ld = n + 1;  // odd line stride: conflict-free column access
  const Buf s{sm + L * tld / 2, L * ld, 1, ld, L};
  const int q = n / P;
  for (int ch = threadIdx.x; ch < L * n / 2; ch += blockDim.x) {
    const int l = ch / (n / 2), j = 4 * (ch % (n / 2));
    cp_async16(ts + l * tld + j, trow + (long long)l * 2 * n + j);
  }
  cp_async_commit();
  // first stage straight from the lines: run index fastest, so each load
  // instruction reads whole 128-byte segments
  stride_fwd_in<P, Q, false>(
      q, L, w, 2 * n,
      [&](int b, int j, int c) { return __ldcg(lines + c * n + q * j + b); },
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

// Waits until *c >= target: one thread polls with acquire loads, then the
// block goes on. A wait that never ends traps (a kernel error, not a hang).
__device__ __forceinline__ void wait_count(const int* c, int target) {
  if (threadIdx.x == 0) {
    unsigned spins = 0;
    for (;;) {
      int v;
      asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
                   : "=r"(v)
                   : "l"(c)
                   : "memory");
      if (v >= target) break;
      __nanosleep(128);
      if (++spins > (1u << 24)) __trap();
    }
  }
  __syncthreads();
}

// Publishes the block's global writes, then counts one task done in *c.
__device__ __forceinline__ void count_done(int* c) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) atomicAdd(c, 1);
}

// Plane ring and task order: plane p (z-frequency p / B of volume p % B)
// takes its y forward in step p, its x round trip in step p + DX and its y
// inverse in step p + DI, its y-spectrum living in ring slot p % RING.
constexpr int DX = 8, DI = 16, RING = 32;

// The plane pass, in place on t1 (B, 2n1, n2, n3): for each z-frequency
// plane the y forward into a ring slot, the x forward, the spectrum row
// and the x inverse in the slot, and the y inverse with crop back into
// t1. A persistent grid walks a fixed task list, each block taking the
// next task when it is free; a task waits for the counts of the tasks it
// needs, which come before it in the list and are taken by running
// blocks, so every wait ends. cnt: three counts per plane (y forward
// bundles, x batches, y inverse bundles) and the list's next task, zero
// at launch. L: lines per x batch.
template <int P2, int Q2, int P3, int Q3>
__global__ void __launch_bounds__(NT, 2)
    kern_x(float2* __restrict__ t1, const float* __restrict__ tf,
           const float2* __restrict__ tab_y, const float2* __restrict__ tab_x,
           float2* __restrict__ ring, int* __restrict__ cnt, int B, int n1,
           int n2, int n3, int L) {
  extern __shared__ __align__(16) float2 sm[];
  // the x table for the whole run, then a task's space: a pencil task's
  // table and buffers, or an x task's spectrum rows and lines
  float2* wx = sm;
  float2* tsm = wx + 2 * n3;
  load_table(wx, tab_x, n3);
  const int nbx = (n3 + WC - 1) / WC, nxl = 2 * n2 / L, tps = 2 * nbx + nxl;
  const int nplanes = 2 * n1 * B;
  const long long psize = (long long)n2 * n3, slot = 2 * psize;
  int* fwd_done = cnt;
  int* x_done = cnt + nplanes;
  int* inv_done = cnt + 2 * nplanes;
  int* queue = cnt + 3 * nplanes;  // the next task to hand out
  // tasks in list order to whichever block is free: a block takes its
  // next task's number while it runs the current one
  __shared__ int taken[2];
  if (threadIdx.x == 0) taken[0] = atomicAdd(queue, 1);
  __syncthreads();
  const int tasks = (nplanes + DI) * tps;
  for (int it = 0;; ++it) {
    const int t = taken[it & 1];
    if (t >= tasks) break;
    int next = 0;  // the next task's number, used only at the end
    if (threadIdx.x == 0) next = atomicAdd(queue, 1);
    const int step = t / tps, j = t - step * tps;
    if (j < nbx && step < nplanes) {  // y forward of plane step, bundle j
      const int p = step;
      const int r = p / B, x0 = j * WC;
      if (p >= RING) wait_count(inv_done + p - RING, nbx);
      fwd_bundle<P2, Q2, false>(
          t1 + ((long long)(p - r * B) * 2 * n1 + r) * psize + x0, nullptr,
          ring + (p % RING) * slot + x0, tab_y, tsm, n2, min(WC, n3 - x0),
          n3, n3);
      count_done(fwd_done + p);
    } else if (j >= nbx && j < nbx + nxl && step >= DX &&
               step - DX < nplanes) {  // x round trip of plane step - DX
      const int p = step - DX, row0 = (j - nbx) * L;
      wait_count(fwd_done + p, nbx);
      x_lines<P3, Q3>(ring + (p % RING) * slot + (long long)row0 * n3,
                      tf + (long long)(p / B) * 4 * psize +
                          (long long)row0 * 2 * n3,
                      wx, tsm, n3, L);
      count_done(x_done + p);
    } else if (j >= nbx + nxl && step >= DI) {  // y inverse of step - DI
      const int p = step - DI, x0 = (j - nbx - nxl) * WC;
      wait_count(x_done + p, nxl);
      const int r = p / B;
      inv_bundle<P2, Q2, false, true>(
          ring + (p % RING) * slot + x0, nullptr,
          t1 + ((long long)(p - r * B) * 2 * n1 + r) * psize + x0, tab_y,
          tsm, 1, n2, min(WC, n3 - x0), 0, 0, n3, n3);
      // the slot's lines this task read are dead: where each row of the
      // bundle is one whole 128-byte line, drop them from L2 without
      // writing them back
      if (n3 % WC == 0) {
        const float2* col = ring + (p % RING) * slot + x0;
        for (int i = threadIdx.x; i < 2 * n2; i += NT)
          asm volatile("discard.global.L2 [%0], 128;" ::"l"(
                           col + (long long)i * n3)
                       : "memory");
      }
      count_done(inv_done + p);
    }
    if (threadIdx.x == 0) taken[(it + 1) & 1] = next;
    __syncthreads();  // the next task's number is in
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

struct Plane {
  float2* t1;
  const float* tf;
  const float2* tab_y;
  const float2* tab_x;
  float2* ring;
  int* cnt;
  int B, n1, n2, n3, p2, p3;
};

// Lines per x task of the plane kernel (2 n2 is a multiple of 16).
constexpr int XL = 16;

// Shared memory of the plane kernel: the x tables, then the larger of a
// pencil task's (the table and both halves of a bundle) and an x task's
// (XL spectrum rows and both halves of XL lines).
size_t plane_smem(const Plane& a) {
  const size_t x = (size_t)XL * (2 * a.n3 + 4) * 4 +
                   (size_t)2 * XL * (a.n3 + 1) * 8;
  return (size_t)2 * a.n3 * 8 + std::max(pencil_smem(a.n2), x);
}

template <int P2, int Q2, int P3, int Q3>
cudaError_t plane_pass(const Plane& a, cudaStream_t st) {
  auto kern = kern_x<P2, Q2, P3, Q3>;
  const int L = XL;
  const size_t smem = plane_smem(a);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  // a persistent grid of the blocks that are resident at once
  int dev = 0, sms = 0, per_sm = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, NT,
                                                      smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int nplanes = 2 * a.n1 * a.B;
  e = cudaMemsetAsync(a.cnt, 0, (size_t)(3 * nplanes + 1) * sizeof(int), st);
  if (e != cudaSuccess) return e;
  // cooperative: every block is resident at once, or the launch fails
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(sms * per_sm);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, a.t1, a.tf, a.tab_y, a.tab_x, a.ring,
                            a.cnt, a.B, a.n1, a.n2, a.n3, L);
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

// the plane kernel's x plan, for its y plan (P2, Q2)
template <int P2, int Q2>
PassFn<Plane> plane_x(int n3, int p3) {
  return pick<Plane>(n3, p3, plane_pass<P2, Q2, 16, 16>,
                     plane_pass<P2, Q2, 16, 8>, plane_pass<P2, Q2, 16, 0>,
                     plane_pass<P2, Q2, 8, 0>);
}

PassFn<Plane> pick_plane(const Plane& a) {
  if (a.n2 < 8 || a.n2 > 256 || a.n2 % a.p2) return nullptr;
  const int q2 = a.n2 / a.p2;
  if (a.p2 == 16)
    return q2 == 16  ? plane_x<16, 16>(a.n3, a.p3)
           : q2 == 8 ? plane_x<16, 8>(a.n3, a.p3)
                     : plane_x<16, 0>(a.n3, a.p3);
  if (a.p2 == 8 && q2 <= MAXQ) return plane_x<8, 0>(a.n3, a.p3);
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

// the plane pass: y forward, x forward, spectrum `tf` (2n1, 2n2, 2n3),
// x inverse, y inverse, in place on every plane of t1 (B, 2n1, n2, n3).
// ring: RING planes' y-spectra, (RING, 2n2, n3); cnt: 3 * 2n1 * B + 1
// ints, zeroed here on the stream.
int indigo_toeplitz_plane(void* t1, const void* tf, const void* tab_y,
                          int py, const void* tab_x, int px, void* ring,
                          void* cnt, int B, int n1, int n2, int n3,
                          void* stream) {
  const Plane a{(float2*)t1,     (const float*)tf, (const float2*)tab_y,
                (const float2*)tab_x, (float2*)ring,    (int*)cnt,
                B,              n1,               n2,
                n3,             py,               px};
  auto f = pick_plane(a);
  if (!f) return finish(cudaErrorInvalidValue);
  return finish(f(a, (cudaStream_t)stream));
}

int indigo_toeplitz_ring_planes() { return RING; }

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
