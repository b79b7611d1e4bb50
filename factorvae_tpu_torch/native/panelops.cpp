// Native panel ops for the host-side data pipeline: the port's copy of
// factorvae_tpu/native/panelops.cpp, the same two functions and layouts
// (scatter_panel also takes the values' strides, below).
//
// The two O(D*I) index passes of the host data layer: the ffill/bfill fill
// maps (data/windows.compute_fill_maps) and the COO->dense panel scatter
// (data/panel.build_panel). Built with g++ into a plain shared object and
// bound with ctypes by factorvae_tpu_torch/native/__init__.py, which falls
// back to the numpy versions when it cannot be built.
//
// Layout contracts (row-major, C-contiguous but for values):
//   valid:       (D, I) uint8
//   last_valid:  (D, I) int32   largest d' <= d with valid[d',i], else -1
//   next_valid:  (D, I) int32   smallest d' >= d with valid[d',i], else D
//   scatter: values (n_rows, C) float32 -> out (I, D, C) float32 at
//            (cols[k], rows[k], :); out must be pre-filled with NaN. Unlike
//            the JAX file's, it takes values' strides in elements (row,
//            column), so a column-major frame needs no row-major copy; rows
//            are written in order, so of two rows with one (day,
//            instrument) the later one stays.

#include <cstdint>

extern "C" {

void fill_maps(const uint8_t* valid, int64_t d_total, int64_t n_inst,
               int32_t* last_valid, int32_t* next_valid) {
  // Day-major, each row from its neighbour row: contiguous reads and
  // writes (the JAX file walks an instrument's column instead).
  for (int64_t d = 0; d < d_total; ++d) {
    const uint8_t* v = valid + d * n_inst;
    int32_t* out = last_valid + d * n_inst;
    const int32_t day = static_cast<int32_t>(d);
    if (d == 0) {
      for (int64_t i = 0; i < n_inst; ++i) out[i] = v[i] ? day : -1;
    } else {
      const int32_t* prev = out - n_inst;
      for (int64_t i = 0; i < n_inst; ++i) out[i] = v[i] ? day : prev[i];
    }
  }
  for (int64_t d = d_total - 1; d >= 0; --d) {
    const uint8_t* v = valid + d * n_inst;
    int32_t* out = next_valid + d * n_inst;
    const int32_t day = static_cast<int32_t>(d);
    if (d == d_total - 1) {
      const int32_t none = static_cast<int32_t>(d_total);
      for (int64_t i = 0; i < n_inst; ++i) out[i] = v[i] ? day : none;
    } else {
      const int32_t* after = out + n_inst;
      for (int64_t i = 0; i < n_inst; ++i) out[i] = v[i] ? day : after[i];
    }
  }
}

void scatter_panel(const float* values, int64_t row_stride, int64_t col_stride,
                   const int64_t* rows, const int64_t* cols, int64_t n_rows,
                   int64_t d_total, int64_t n_cols_panel, float* out) {
  // Column-major values (pandas' own layout) are read a row at a time
  // across its columns: the next 15 rows' reads hit the same cache lines.
  for (int64_t k = 0; k < n_rows; ++k) {
    const float* src = values + k * row_stride;
    float* dst = out + (cols[k] * d_total + rows[k]) * n_cols_panel;
    for (int64_t c = 0; c < n_cols_panel; ++c) dst[c] = src[c * col_stride];
  }
}

}  // extern "C"
