// Native CSR SpGEMM (SMMP-style two-pass, dense sparse-accumulator rows).
//
// Host-side native kernel for Galerkin coarse-operator
// assembly (SURVEY.md §2 C6): C = A @ B for CSR matrices.  Two passes:
//   pass 1 computes row counts of C (symbolic),
//   pass 2 fills column indices and values (numeric),
// both using the classic O(flops) linked sparse accumulator, so memory stays
// O(nnz(C) + n_cols) instead of the numpy fallback's O(total products).
//
// Exposed with a plain C ABI for ctypes (no pybind11 in this image).

#include <cstdint>
#include <vector>

extern "C" {

// Pass 1: row pointer (Cp must have n_rows+1 slots; Cp[0] set to 0).
void spgemm_pass1(int64_t n_rows, int64_t n_cols_B,
                  const int64_t* Ap, const int64_t* Aj,
                  const int64_t* Bp, const int64_t* Bj,
                  int64_t* Cp) {
  std::vector<int64_t> mask(n_cols_B, -1);
  Cp[0] = 0;
  for (int64_t i = 0; i < n_rows; ++i) {
    int64_t row_nnz = 0;
    for (int64_t jj = Ap[i]; jj < Ap[i + 1]; ++jj) {
      const int64_t k = Aj[jj];
      for (int64_t kk = Bp[k]; kk < Bp[k + 1]; ++kk) {
        const int64_t j = Bj[kk];
        if (mask[j] != i) {
          mask[j] = i;
          ++row_nnz;
        }
      }
    }
    Cp[i + 1] = Cp[i] + row_nnz;
  }
}

// Pass 2: fill Cj/Cx (sized from pass 1).  Columns come out unsorted within
// a row; the Python wrapper sorts rows (cheap) for canonical CSR.
void spgemm_pass2(int64_t n_rows, int64_t n_cols_B,
                  const int64_t* Ap, const int64_t* Aj, const double* Ax,
                  const int64_t* Bp, const int64_t* Bj, const double* Bx,
                  const int64_t* Cp, int64_t* Cj, double* Cx) {
  std::vector<int64_t> next(n_cols_B, -1);
  std::vector<double> sums(n_cols_B, 0.0);
  for (int64_t i = 0; i < n_rows; ++i) {
    int64_t head = -2;
    int64_t length = 0;
    for (int64_t jj = Ap[i]; jj < Ap[i + 1]; ++jj) {
      const int64_t k = Aj[jj];
      const double v = Ax[jj];
      for (int64_t kk = Bp[k]; kk < Bp[k + 1]; ++kk) {
        const int64_t j = Bj[kk];
        sums[j] += v * Bx[kk];
        if (next[j] == -1) {
          next[j] = head;
          head = j;
          ++length;
        }
      }
    }
    int64_t dst = Cp[i];
    for (int64_t c = 0; c < length; ++c) {
      Cj[dst] = head;
      Cx[dst] = sums[head];
      ++dst;
      const int64_t tmp = head;
      head = next[head];
      next[tmp] = -1;
      sums[tmp] = 0.0;
    }
  }
}

}  // extern "C"
