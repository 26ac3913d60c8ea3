// Host kernels of dynadjust_tpu_torch's host routes (plain C++, no
// device code): the blocked float64 matvec of the host refinement loop,
// GNSS baseline residuals and the rhs scatter.  They are the native
// counterpart of the reference's C++ normals-assembly inner loops
// (UpdateNormals_* / UpdateAtVinv), written as flat loops over
// precomputed index plans and split over std::thread workers.
//
// scatter_rhs and baseline_residuals are copies of the JAX package's
// native/assembly_kernels.cpp; block_matvec reads each matrix once, row
// by row, where the JAX package's walks Nij a second time by columns.  Exposed
// through a C ABI and bound with ctypes (ops/native.py), which builds it
// with g++ into _build/ at first use.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// out[idx[m*3+k]] += sign * w[m] * mmc[m*3+k]  for idx >= 0
// (the per-iteration rhs scatter: AtW * measured-minus-computed)
void scatter_rhs(const int64_t* idx, const double* w, const double* mmc,
                 double sign, int64_t n_msr, double* out) {
    for (int64_t m = 0; m < n_msr; ++m) {
        const double wm = w[m] * sign;
        for (int k = 0; k < 3; ++k) {
            const int64_t j = idx[m * 3 + k];
            if (j >= 0) out[j] += wm * mmc[m * 3 + k];
        }
    }
}

// GPS baseline residuals: mmc[m] = obs[m] - (x[j] - x[i])
void baseline_residuals(const int64_t* pairs, const double* obs,
                        const double* x, int64_t n_msr, double* mmc) {
    const int hw = (int)std::thread::hardware_concurrency();
    const int nt = hw > 1 ? (hw > 16 ? 16 : hw) : 1;
    auto worker = [&](int64_t lo, int64_t hi) {
        for (int64_t m = lo; m < hi; ++m) {
            const int64_t i = pairs[m * 2] * 3;
            const int64_t j = pairs[m * 2 + 1] * 3;
            for (int k = 0; k < 3; ++k)
                mmc[m * 3 + k] = obs[m * 3 + k] - (x[j + k] - x[i + k]);
        }
    };
    if (n_msr < 1 << 15 || nt == 1) {
        worker(0, n_msr);
        return;
    }
    std::vector<std::thread> ts;
    const int64_t chunk = (n_msr + nt - 1) / nt;
    for (int t = 0; t < nt; ++t) {
        const int64_t lo = t * chunk;
        const int64_t hi = lo + chunk < n_msr ? lo + chunk : n_msr;
        if (lo < hi) ts.emplace_back(worker, lo, hi);
    }
    for (auto& t : ts) t.join();
}

// v . a over n doubles, in 8 independent partial sums so that g++
// vectorises the loop (a single running sum cannot be reordered)
static inline double dot(const double* a, const double* v, int64_t n) {
    double s[8] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
    int64_t c = 0;
    for (; c + 8 <= n; c += 8)
        for (int k = 0; k < 8; ++k) s[k] += a[c + k] * v[c + k];
    double acc = ((s[0] + s[1]) + (s[2] + s[3])) +
                 ((s[4] + s[5]) + (s[6] + s[7]));
    for (; c < n; ++c) acc += a[c] * v[c];
    return acc;
}

// Blocked symmetric matvec for iterative refinement:
//   yi[b] = Nii[b] xi[b] + Nij[b] xj_b[b]
//   yj_b[b] = Nij[b]^T xi[b] + Njj[b] xj_b[b]
// shapes: Nii (B,ni,ni), Nij (B,ni,nj), Njj (B,nj,nj)
// Memory-bound: every matrix is read once, row by row.  Row r of Nij
// gives yi[r]'s second term and adds xi[r] * Nij[r,:] to the Nij^T xi
// term, so Nij is not read a second time by columns.  The B*ni rows of
// [Nii | Nij] and the B*nj rows of Njj are split evenly over the
// threads; each thread keeps its own Nij^T xi sums, added at the end.
void block_matvec(const double* Nii, const double* Nij, const double* Njj,
                  const double* xi, const double* xj_b,
                  int64_t B, int64_t ni, int64_t nj,
                  double* yi, double* yj_b) {
    const int hw = (int)std::thread::hardware_concurrency();
    const int64_t work = B * (ni * ni + ni * nj + nj * nj);
    const int nt = work < (1 << 18) || hw < 2 ? 1 : (hw > 16 ? 16 : hw);
    const int64_t rows_i = B * ni, rows_j = B * nj;
    std::vector<double> part((size_t)nt * rows_j, 0.0);
    auto worker = [&](int t) {
        double* pj = part.data() + (size_t)t * rows_j;
        const int64_t lo = rows_i * t / nt, hi = rows_i * (t + 1) / nt;
        for (int64_t g = lo; g < hi; ++g) {
            const int64_t b = g / ni;
            const double* C = Nij + g * nj;
            const double* vj = xj_b + b * nj;
            yi[g] = dot(Nii + g * ni, xi + b * ni, ni) + dot(C, vj, nj);
            const double xr = xi[g];
            double* o = pj + b * nj;
            for (int64_t c = 0; c < nj; ++c) o[c] += xr * C[c];
        }
        const int64_t loj = rows_j * t / nt, hij = rows_j * (t + 1) / nt;
        for (int64_t g = loj; g < hij; ++g)
            yj_b[g] = dot(Njj + g * nj, xj_b + (g / nj) * nj, nj);
    };
    if (nt == 1) {
        worker(0);
    } else {
        std::vector<std::thread> ts;
        for (int t = 0; t < nt; ++t) ts.emplace_back(worker, t);
        for (auto& th : ts) th.join();
    }
    for (int t = 0; t < nt; ++t) {
        const double* pj = part.data() + (size_t)t * rows_j;
        for (int64_t g = 0; g < rows_j; ++g) yj_b[g] += pj[g];
    }
}

}   // extern "C"
