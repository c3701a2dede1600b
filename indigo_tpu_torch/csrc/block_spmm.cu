// Row-gather SpMM for Hopper (sm_90a), plain f32 CUDA cores: y = A x.
//
// A is given in its row form (CSR of the stored nonzeros, derived on the
// host by indigo_tpu_torch/sparse.py from the block tiles): row_ptr (M+1,),
// nz_col (nnz,) and nz_val (nnz,), plus heavy_rows, the rows longer than
// heavy_nnz nonzeros, longest first. x is (N, K) f32 row-major and y is
// (M, K) f32 row-major. The dense tiles are never read.
//
// Replaces the TPU kernels of indigo_tpu/ops/ell_spmm.py, which multiply
// dense (bm, 128) tiles on the matrix unit:
//   K3 <- jag_spmm_pallas (_jag_spmm_call :109 / _jag_kernel :89)
//   K4 <- ell_spmm_pallas (_ell_spmm_call :61 / _kernel :39)
// Both entry points launch the one kernel below; the wrappers count their
// launches apart.
//
// Bound on this card: memory, at ~0.5 flop per byte, far below where the
// tensor cores pay. A 2D radial gridding matrix at 256^2 fills 3 % of its
// 397 MB of tiles; its 3.1 M nonzeros are 25 MB as (column, value) pairs,
// and x (147,456 x 16 f32 = 9.4 MB) stays in the 50 MB L2. So the floor is
// the nonzeros and y from device memory (~0.011 ms at 3.35 TB/s) plus one
// gather of an x row per nonzero from L2 (~200 MB).
//
// Design (PERF.md, PR 5, has the measurements):
//  * A unit of S = max(8, LPN) lanes per output row, so a warp holds four
//    rows of the K = 16 case. A row's lanes split into groups of LPN lanes,
//    one group per nonzero; each lane owns 4 columns (a float4, when K % 4
//    == 0 and x and y are 16-byte aligned) or 1 (the scalar variant). A
//    K = 16 row gathers 2 nonzeros a round and issues its 4 rounds together,
//    so a warp keeps 32 x rows in flight. A unit reads S (column, value)
//    pairs at once with loads that do not allocate in L1, prefetches the
//    next S while it gathers, and hands them to its groups with shuffles;
//    the warp loops to its longest row. The x gathers use the read-only
//    path (L1 and L2): rows of x are shared by neighbouring output rows.
//    The loop is latency-bound, so short rows share a warp: a warp per row
//    kept a quarter of the loads in flight.
//  * Each lane accumulates in registers; a fixed-order __shfl_xor sum
//    across the unit's groups ends the row, which is written once: no
//    atomics, empty rows come out exactly 0, and the result is bitwise the
//    same on every launch.
//  * Rows longer than heavy_nnz (the k-space centre of an adjoint gridding
//    matrix: up to ~2,000 nonzeros where the mean is 21) would hold one unit
//    for hundreds of rounds and end the launch late. They go first, one per
//    CUDA block: its units take contiguous slices of the row, and unit 0
//    sums the slices' partial rows from shared memory in a fixed order. The
//    row-per-unit blocks skip them.
//  * K wider than one group's columns (LPN <= 32 lanes) runs in column
//    chunks over gridDim.y.
//  * Plain f32 FMA, no TF32: the reference accumulates at
//    Precision.HIGHEST.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;  // warps per CUDA block
constexpr unsigned FULL = 0xffffffffu;

// (column, value) stream: read once, no L1 allocation
__device__ __forceinline__ int ld_stream(const int* p) {
  int v;
  asm("ld.global.nc.L1::no_allocate.b32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ float ld_stream(const float* p) {
  return __int_as_float(ld_stream(reinterpret_cast<const int*>(p)));
}

// One launch's arguments (the row form of an (M, N) matrix, x, y).
struct Args {
  const int* row_ptr;
  const int* nz_col;
  const float* nz_val;
  const int* heavy;  // H rows longer than heavy_nnz, longest first
  int H, heavy_nnz;
  const float* x;
  float* y;
  int M, K;
};

// LPN lanes share a nonzero; S = max(8, LPN) lanes share a row
template <int LPN, bool VEC>
struct Lanes {
  static constexpr int VW = VEC ? 4 : 1;        // columns per lane
  static constexpr int KC = LPN * VW;           // columns per chunk
  static constexpr int S = LPN < 8 ? 8 : LPN;   // lanes per row (a unit)
  static constexpr int NG = S / LPN;            // a row's nonzeros a round
  static constexpr int RPW = 32 / S;            // rows per warp
  static constexpr int RB = LPN < 8 ? LPN : 8;  // rounds loaded together
};

template <bool VEC>
__device__ __forceinline__ void gather(const float* x, long long off,
                                       float* v) {
  if (VEC) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(x + off));
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
    v[0] = __ldg(x + off);
  }
}

// acc += sum over the nonzeros [lo, hi) of nz_val * x[nz_col, k .. k+VW):
// each S-lane unit of the warp its own range (empty for a unit with no
// row); every lane of the warp calls it, and it returns the unit's total
// in every lane of the unit.
template <int LPN, bool VEC>
__device__ __forceinline__ void row_sum(const Args& A, int k, bool kok,
                                        int lo, int hi, int lane,
                                        float* acc) {
  using L = Lanes<LPN, VEC>;
  constexpr int S = L::S;
  const int u0 = lane & ~(S - 1), sl = lane & (S - 1), g = sl / LPN;
  const int len = hi - lo;
  int trips = len;  // the warp's longest range bounds its loop
#pragma unroll
  for (int off = S; off < 32; off <<= 1)
    trips = max(trips, __shfl_xor_sync(FULL, trips, off));
  int c = 0;
  float v = 0.f;
  if (sl < len) {
    c = ld_stream(A.nz_col + lo + sl);
    v = ld_stream(A.nz_val + lo + sl);
  }
  for (int base = 0; base < trips; base += S) {
    const int pn = base + S + sl;  // the next S pairs, loaded ahead
    int cn = 0;
    float vn = 0.f;
    if (pn < len) {
      cn = ld_stream(A.nz_col + lo + pn);
      vn = ld_stream(A.nz_val + lo + pn);
    }
    const int n = len - base;  // this unit's nonzeros from base on
#pragma unroll
    for (int r0 = 0; r0 < LPN; r0 += L::RB) {
      float xv[L::RB][L::VW];
      float w[L::RB];
#pragma unroll
      for (int r = 0; r < L::RB; ++r) {
        const int q = (r0 + r) * L::NG + g;  // this group's nonzero
        const int cq = __shfl_sync(FULL, c, u0 + q);
        w[r] = __shfl_sync(FULL, v, u0 + q);
#pragma unroll
        for (int e = 0; e < L::VW; ++e) xv[r][e] = 0.f;
        if (q < n && kok) gather<VEC>(A.x, (long long)cq * A.K + k, xv[r]);
      }
#pragma unroll
      for (int r = 0; r < L::RB; ++r)
#pragma unroll
        for (int e = 0; e < L::VW; ++e) acc[e] = fmaf(w[r], xv[r][e], acc[e]);
    }
    c = cn;
    v = vn;
  }
  // fixed-order sum across the unit's groups
#pragma unroll
  for (int off = LPN; off < S; off <<= 1)
#pragma unroll
    for (int e = 0; e < L::VW; ++e)
      acc[e] += __shfl_xor_sync(FULL, acc[e], off);
}

template <bool VEC>
__device__ __forceinline__ void store(float* y, long long off,
                                      const float* v) {
  if (VEC)
    *reinterpret_cast<float4*>(y + off) = make_float4(v[0], v[1], v[2], v[3]);
  else
    y[off] = v[0];
}

// Blocks [0, H): one heavy row each, split across the block's S-lane
// units. Blocks [H, ...): WARPS * 32 / S consecutive rows, one per unit.
template <int LPN, bool VEC>
__global__ void __launch_bounds__(WARPS * 32) row_spmm(const Args A) {
  using L = Lanes<LPN, VEC>;
  constexpr int S = L::S;
  constexpr int UNITS = WARPS * L::RPW;
  const int lane = threadIdx.x % 32, unit = threadIdx.x / S;
  const int sub = lane % LPN;
  const bool lead = (lane & (S - 1)) < LPN;  // the unit's first group
  const int k = blockIdx.y * L::KC + sub * L::VW;
  const bool kok = k < A.K;  // K % 4 == 0 on the float4 path
  float acc[L::VW];
#pragma unroll
  for (int e = 0; e < L::VW; ++e) acc[e] = 0.f;

  if ((int)blockIdx.x < A.H) {
    __shared__ float part[UNITS][L::KC];
    const int row = A.heavy[blockIdx.x];
    const int lo = A.row_ptr[row], hi = A.row_ptr[row + 1];
    const int step = ((hi - lo + UNITS - 1) / UNITS + S - 1) / S * S;
    const int a = min(lo + unit * step, hi), b = min(a + step, hi);
    row_sum<LPN, VEC>(A, k, kok, a, b, lane, acc);
    if (lead)
#pragma unroll
      for (int e = 0; e < L::VW; ++e) part[unit][sub * L::VW + e] = acc[e];
    __syncthreads();
    if (unit == 0 && lead && kok) {
#pragma unroll
      for (int e = 0; e < L::VW; ++e) {
        float s = part[0][sub * L::VW + e];
#pragma unroll
        for (int u = 1; u < UNITS; ++u) s += part[u][sub * L::VW + e];
        acc[e] = s;
      }
      store<VEC>(A.y, (long long)row * A.K + k, acc);
    }
    return;
  }
  const long long first =
      ((long long)(blockIdx.x - A.H) * WARPS + threadIdx.x / 32) * L::RPW;
  if (first >= A.M) return;  // the whole warp
  const long long row = first + lane / S;
  int lo = 0, hi = 0;
  if (row < A.M) {
    lo = A.row_ptr[row];
    hi = A.row_ptr[row + 1];
  }
  const bool own = row < A.M && hi - lo <= A.heavy_nnz;  // else a heavy
  if (!own) hi = lo;                                     // block's row
  row_sum<LPN, VEC>(A, k, kok, lo, hi, lane, acc);
  if (own && lead && kok) store<VEC>(A.y, row * A.K + k, acc);
}

template <int LPN, bool VEC>
cudaError_t launch_lpn(const Args& A, cudaStream_t stream) {
  using L = Lanes<LPN, VEC>;
  const long long rows = WARPS * L::RPW;  // per row-per-unit block
  const long long bx = A.H + ((long long)A.M + rows - 1) / rows;
  const long long by = (A.K + L::KC - 1) / L::KC;
  if (bx > INT_MAX || by > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)(bx > 0 ? bx : 1), (unsigned)by);
  row_spmm<LPN, VEC><<<grid, WARPS * 32, 0, stream>>>(A);
  return cudaSuccess;
}

template <bool VEC>
cudaError_t launch_vec(int lpn, const Args& A, cudaStream_t stream) {
  switch (lpn) {
    case 1: return launch_lpn<1, VEC>(A, stream);
    case 2: return launch_lpn<2, VEC>(A, stream);
    case 4: return launch_lpn<4, VEC>(A, stream);
    case 8: return launch_lpn<8, VEC>(A, stream);
    case 16: return launch_lpn<16, VEC>(A, stream);
    case 32: return launch_lpn<32, VEC>(A, stream);
  }
  return cudaErrorInvalidValue;
}

int launch(const void* row_ptr, const void* nz_col, const void* nz_val,
           const void* heavy, int H, int heavy_nnz, const void* x, void* y,
           int M, int K, void* stream) {
  if (K < 1 || M < 0 || H < 0) return (int)cudaErrorInvalidValue;
  const Args A{(const int*)row_ptr, (const int*)nz_col,
               (const float*)nz_val, (const int*)heavy, H,
               heavy_nnz < 0 ? INT_MAX : heavy_nnz, (const float*)x,
               (float*)y, M, K};
  // float4 lanes when every x row and y row starts on 16 bytes
  const bool vec = K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const int width = vec ? K / 4 : K;  // lanes one nonzero could use
  int lpn = 1;
  while (lpn < width && lpn < 32) lpn *= 2;
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t e =
      vec ? launch_vec<true>(lpn, A, s) : launch_vec<false>(lpn, A, s);
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}

}  // namespace

extern "C" {

// Each launcher enqueues one kernel on `stream` and returns the launch's
// cudaError_t (0 on success); it never synchronises. A: the row form of an
// (M, N) matrix with H heavy rows (heavy_nnz < 0: none is split).

// K3: y (M, K) = A x (N, K), A the row form of a BlockedJag.
int indigo_jag_spmm(const void* row_ptr, const void* nz_col,
                    const void* nz_val, const void* heavy, int H,
                    int heavy_nnz, const void* x, void* y, int M, int K,
                    void* stream) {
  return launch(row_ptr, nz_col, nz_val, heavy, H, heavy_nnz, x, y, M, K,
                stream);
}

// K4: y (M, K) = A x (N, K), A the row form of a BlockedELL.
int indigo_ell_spmm(const void* row_ptr, const void* nz_col,
                    const void* nz_val, const void* heavy, int H,
                    int heavy_nnz, const void* x, void* y, int M, int K,
                    void* stream) {
  return launch(row_ptr, nz_col, nz_val, heavy, H, heavy_nnz, x, y, M, K,
                stream);
}

}  // extern "C"
