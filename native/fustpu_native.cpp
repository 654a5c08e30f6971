// fustpu native runtime: setup-time mesh/geometry machinery in C++.
//
// The counterpart of the reference's native tier
// (/root/reference/cpp/common/precompute.hpp, spectral_op.hpp ctors,
// permute.hpp): everything that runs on the host around the XLA compute
// path — geometry-factor precomputation over millions of cells, dofmap and
// facet-table construction — implemented in C++ for setup speed at the
// 10^8-DOF scale, exposed to Python via a plain C ABI (ctypes; no pybind11
// in this image).  Results are bit-compatible with the numpy reference
// implementation in fustpu/ops/precompute.py (same f64 arithmetic order per
// quadrature point).
//
// Build: make -C native   (g++ -O3 -march=native, -fopenmp where the
// toolchain has it, no deps)

#include <cmath>
#include <cstdint>
#include <cstring>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

// Trilinear (hex8) basis gradients at a reference point (x, y, z).
// Corner (a,b,c) -> index 4a + 2b + c (fustpu.elements.hex convention).
inline void hex8_grad(double x, double y, double z, double g[8][3]) {
  const double lx[2] = {1.0 - x, x}, ly[2] = {1.0 - y, y},
               lz[2] = {1.0 - z, z};
  const double dx[2] = {-1.0, 1.0};
  for (int a = 0; a < 2; ++a)
    for (int b = 0; b < 2; ++b)
      for (int c = 0; c < 2; ++c) {
        const int v = 4 * a + 2 * b + c;
        g[v][0] = dx[a] * ly[b] * lz[c];
        g[v][1] = lx[a] * dx[b] * lz[c];
        g[v][2] = lx[a] * ly[b] * dx[c];
      }
}

inline void jacobian(const double* corners /*8x3*/, const double g[8][3],
                     double J[3][3]) {
  for (int p = 0; p < 3; ++p)
    for (int r = 0; r < 3; ++r) {
      double s = 0.0;
      for (int v = 0; v < 8; ++v) s += corners[3 * v + p] * g[v][r];
      J[p][r] = s;
    }
}

inline double det3(const double J[3][3]) {
  return J[0][0] * (J[1][1] * J[2][2] - J[1][2] * J[2][1]) -
         J[0][1] * (J[1][0] * J[2][2] - J[1][2] * J[2][0]) +
         J[0][2] * (J[1][0] * J[2][1] - J[1][1] * J[2][0]);
}

inline void inv3(const double J[3][3], double det, double Ji[3][3]) {
  const double id = 1.0 / det;
  Ji[0][0] = (J[1][1] * J[2][2] - J[1][2] * J[2][1]) * id;
  Ji[0][1] = (J[0][2] * J[2][1] - J[0][1] * J[2][2]) * id;
  Ji[0][2] = (J[0][1] * J[1][2] - J[0][2] * J[1][1]) * id;
  Ji[1][0] = (J[1][2] * J[2][0] - J[1][0] * J[2][2]) * id;
  Ji[1][1] = (J[0][0] * J[2][2] - J[0][2] * J[2][0]) * id;
  Ji[1][2] = (J[0][2] * J[1][0] - J[0][0] * J[1][2]) * id;
  Ji[2][0] = (J[1][0] * J[2][1] - J[1][1] * J[2][0]) * id;
  Ji[2][1] = (J[0][1] * J[2][0] - J[0][0] * J[2][1]) * id;
  Ji[2][2] = (J[0][0] * J[1][1] - J[0][1] * J[1][0]) * id;
}

}  // namespace

extern "C" {

// detJ[c,q] = w_q |det J|; G[c,q,:] = w_q |det J| * uppertri(J^-T J^-1).
// corners: (ncells, 8, 3); qpts: (nq, 3); qwts: (nq,).
void fustpu_cell_geometry(const double* corners, const double* qpts,
                          const double* qwts, int64_t ncells, int32_t nq,
                          double* detJ, double* G) {
  // gradients are the same for every cell: tabulate once
  double (*grads)[8][3] = new double[nq][8][3];
  for (int q = 0; q < nq; ++q)
    hex8_grad(qpts[3 * q], qpts[3 * q + 1], qpts[3 * q + 2], grads[q]);

#pragma omp parallel for schedule(static)
  for (int64_t c = 0; c < ncells; ++c) {
    const double* cc = corners + 24 * c;
    for (int q = 0; q < nq; ++q) {
      double J[3][3], Ji[3][3];
      jacobian(cc, grads[q], J);
      const double det = det3(J);
      const double sd = std::fabs(det) * qwts[q];
      detJ[c * nq + q] = sd;
      inv3(J, det, Ji);
      // K[r][s] = sum_p Ji[r][p] * Ji[s][p]
      double* g = G + (c * nq + q) * 6;
      int k = 0;
      for (int r = 0; r < 3; ++r)
        for (int s = r; s < 3; ++s) {
          double acc = 0.0;
          for (int p = 0; p < 3; ++p) acc += Ji[r][p] * Ji[s][p];
          g[k++] = acc * sd;
        }
    }
  }
  delete[] grads;
}

// Facet surface measure: detJ_f[f,q] = w_q |t_s x t_t| for (cell, facet)
// pairs.  qpts_f: (6, nq, 3) reference points per local facet;
// boundary_data: (nf, 2) int32 (cell, local_facet).
void fustpu_facet_geometry(const double* corners, const double* qpts_f,
                           const double* qwts, const int32_t* boundary_data,
                           int64_t nf, int32_t nq, double* detJ_f) {
  static const int free_ax[6][2] = {{1, 2}, {1, 2}, {0, 2},
                                    {0, 2}, {0, 1}, {0, 1}};
#pragma omp parallel for schedule(static)
  for (int64_t f = 0; f < nf; ++f) {
    const int64_t cell = boundary_data[2 * f];
    const int lf = boundary_data[2 * f + 1];
    const double* cc = corners + 24 * cell;
    const int a0 = free_ax[lf][0], a1 = free_ax[lf][1];
    for (int q = 0; q < nq; ++q) {
      const double* p = qpts_f + (lf * nq + q) * 3;
      double g[8][3], J[3][3];
      hex8_grad(p[0], p[1], p[2], g);
      jacobian(cc, g, J);
      const double t0[3] = {J[0][a0], J[1][a0], J[2][a0]};
      const double t1[3] = {J[0][a1], J[1][a1], J[2][a1]};
      const double cx = t0[1] * t1[2] - t0[2] * t1[1];
      const double cy = t0[2] * t1[0] - t0[0] * t1[2];
      const double cz = t0[0] * t1[1] - t0[1] * t1[0];
      detJ_f[f * nq + q] =
          std::sqrt(cx * cx + cy * cy + cz * cz) * qwts[q];
    }
  }
}

// Tensor-product dofmap of a structured box: out[(cx,cy,cz), (i,j,k)] =
// (cx P + i) gy gz + (cy P + j) gz + (cz P + k).
void fustpu_box_dofmap(int32_t ncx, int32_t ncy, int32_t ncz, int32_t P,
                       int32_t* out) {
  const int n = P + 1;
  const int64_t gy = (int64_t)ncy * P + 1, gz = (int64_t)ncz * P + 1;
  const int64_t nd = (int64_t)n * n * n;
#pragma omp parallel for collapse(2) schedule(static)
  for (int32_t cx = 0; cx < ncx; ++cx)
    for (int32_t cy = 0; cy < ncy; ++cy)
      for (int32_t cz = 0; cz < ncz; ++cz) {
        int32_t* o =
            out + (((int64_t)cx * ncy + cy) * ncz + cz) * nd;
        for (int i = 0; i < n; ++i)
          for (int j = 0; j < n; ++j)
            for (int k = 0; k < n; ++k)
              *o++ = (int32_t)(((int64_t)cx * P + i) * gy * gz +
                               ((int64_t)cy * P + j) * gz +
                               ((int64_t)cz * P + k));
      }
}

// Diagonal mass fold: m[dof] += detJ[c,q] * coeff[c] over the dofmap —
// the assembled global mass diagonal (deterministic, sequential per
// thread-partition of the x-axis to avoid write races on shared planes).
void fustpu_mass_diagonal(const double* detJ, const double* coeff,
                          const int32_t* dofmap, int64_t ncells, int32_t nd,
                          double* m /* zero-initialised, size ndofs */) {
  for (int64_t c = 0; c < ncells; ++c) {
    const double co = coeff ? coeff[c] : 1.0;
    const int32_t* dm = dofmap + c * nd;
    const double* dj = detJ + c * nd;
    for (int32_t i = 0; i < nd; ++i) m[dm[i]] += dj[i] * co;
  }
}

int32_t fustpu_abi_version() { return 1; }

}  // extern "C"
