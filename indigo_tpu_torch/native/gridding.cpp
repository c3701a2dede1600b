// Native gridding-matrix builder: Kaiser-Bessel interpolation weights.
//
// TPU-native-framework counterpart of the reference's native layer
// (indigo/backends/_customcpu.c — unverified, reference mount empty; see
// SURVEY.md §2). The reference's native code accelerated the device SpMM;
// on TPU the device SpMM is a Pallas kernel, so the native investment moves
// to the remaining host-side hot path: building the interpolation matrix for
// large 3D trajectories (hundreds of millions of nonzeros), which is
// embarrassingly parallel over samples.
//
// Output layout is element-ELLPACK: every sample row i owns the slice
// [i*W^d, (i+1)*W^d) of (cols, wts); Python wraps it into scipy CSR or
// feeds the blocked-ELL converter directly.
//
// Build: g++ -O3 -fopenmp -shared -fPIC gridding.cpp -o _native.so

#include <cmath>
#include <cstdint>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// Modified Bessel function of the first kind, order 0.
// Abramowitz & Stegun 9.8.1/9.8.2 polynomial approximations (|eps|<2e-7),
// same accuracy class as numpy.i0's implementation.
double bessel_i0(double x) {
    double ax = std::fabs(x);
    if (ax < 3.75) {
        double t = x / 3.75;
        t *= t;
        return 1.0 + t * (3.5156229 + t * (3.0899424 + t * (1.2067492 +
               t * (0.2659732 + t * (0.0360768 + t * 0.0045813)))));
    }
    double t = 3.75 / ax;
    return (std::exp(ax) / std::sqrt(ax)) *
           (0.39894228 + t * (0.01328592 + t * (0.00225319 +
            t * (-0.00157565 + t * (0.00916281 + t * (-0.02057706 +
            t * (0.02635537 + t * (-0.01647633 + t * 0.00392377))))))));
}

inline double kb(double t, double width, double beta, double inv_i0b) {
    double r = 2.0 * t / width;
    double x = 1.0 - r * r;
    if (x < 0.0) return 0.0;
    return bessel_i0(beta * std::sqrt(x)) * inv_i0b;
}

}  // namespace

extern "C" {

// traj: (M, ndim) float64 in [-0.5, 0.5); grid: ndim int64 sizes.
// cols_out: (M * width^ndim) int64; wts_out: same length float32.
// Returns nnz per row (width^ndim), or -1 on bad arguments.
std::int64_t kb_interp_ell(
    const double* traj, std::int64_t M, std::int32_t ndim,
    const std::int64_t* grid, std::int32_t width, double beta,
    std::int64_t* cols_out, float* wts_out) {
    if (ndim < 1 || ndim > 4 || width < 2 || width > 16) return -1;
    std::int64_t row_nnz = 1;
    for (int d = 0; d < ndim; ++d) row_nnz *= width;
    if (row_nnz > 4096) return -1;  // stack-buffer bound below
    const double inv_i0b = 1.0 / bessel_i0(beta);

#pragma omp parallel for schedule(static)
    for (std::int64_t i = 0; i < M; ++i) {
        // per-axis indices and weights
        std::int64_t idx[4][16];
        double w[4][16];
        for (int d = 0; d < ndim; ++d) {
            const std::int64_t G = grid[d];
            const double c = (traj[i * ndim + d] + 0.5) * (double)G;
            const std::int64_t base =
                (std::int64_t)std::ceil(c - 0.5 * width);
            for (int t = 0; t < width; ++t) {
                std::int64_t k = base + t;
                w[d][t] = kb(c - (double)k, width, beta, inv_i0b);
                k %= G;
                if (k < 0) k += G;
                idx[d][t] = k;
            }
        }
        // tensor product over axes, row-major; expand back-to-front so the
        // in-place widening never overwrites an unread slot. Stack buffers:
        // row_nnz <= 16^4 is bounded, but we cap at 4096 (checked above).
        std::int64_t* crow = cols_out + i * row_nnz;
        float* wrow = wts_out + i * row_nnz;
        std::int64_t ctmp[4096];
        double wtmp[4096];
        std::int64_t cur = 1;
        ctmp[0] = 0;
        wtmp[0] = 1.0;
        for (int d = 0; d < ndim; ++d) {
            const std::int64_t G = grid[d];
            for (std::int64_t p = cur - 1; p >= 0; --p) {
                const std::int64_t cbase = ctmp[p] * G;
                const double wbase = wtmp[p];
                for (int t = width - 1; t >= 0; --t) {
                    ctmp[p * width + t] = cbase + idx[d][t];
                    wtmp[p * width + t] = wbase * w[d][t];
                }
            }
            cur *= width;
        }
        for (std::int64_t p = 0; p < row_nnz; ++p) {
            crow[p] = ctmp[p];
            wrow[p] = (float)wtmp[p];
        }
    }
    return row_nnz;
}

std::int32_t native_num_threads() {
#ifdef _OPENMP
    return omp_get_max_threads();
#else
    return 1;
#endif
}

}  // extern "C"
