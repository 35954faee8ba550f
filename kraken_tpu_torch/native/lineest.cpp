// Native port of kraken_tpu/lib/lineest.py:_bilinear_diag — the diagonal
// affine_transform (order=1, mode='constant') that dominates the bbox
// line-normalization host path (CenterNormalizer dewarp + scale_to_h runs
// it once per line at full line width).
//
// BIT-EXACT contract: every output element is computed with the same IEEE
// double expression tree the numpy implementation evaluates
//   rows = padded[rr0] * (1 - fr) + padded[rr0 + 1] * fr
//   out  = rows[:, cc0] * (1 - fc) + rows[:, cc0 + 1] * fc
// (same operand order, same clip/cval semantics), so results are
// bit-identical to the numpy path — pinned by
// tests/test_lineest.py::test_native_bilinear_diag_bitexact.
// fp-contract off: numpy evaluates a*b + c*d as two rounded multiplies and
// an add; FMA contraction would differ in the last ulp and break the
// bit-exactness contract (file-scoped so the other native kernels keep
// their existing numerics).
#pragma GCC optimize("fp-contract=off")

#include <cmath>
#include <cstdint>
#include <vector>

extern "C" {

// img: (h, w) float64 C-contiguous; out: (oh, ow) float64 preallocated.
void bilinear_diag_f64(const double* img, int64_t h, int64_t w,
                       double inv_scale, int64_t oh, int64_t ow,
                       double cval, double* out) {
    std::vector<double> r0f(oh), fr(oh);
    std::vector<int64_t> rr0(oh);
    std::vector<bool> r_out(oh);
    for (int64_t i = 0; i < oh; ++i) {
        double r = static_cast<double>(i) * inv_scale;
        double f = std::floor(r);
        r0f[i] = f;
        fr[i] = r - f;
        int64_t ri = static_cast<int64_t>(f);
        if (ri < 0) ri = 0;
        if (ri > h - 1) ri = h - 1;
        rr0[i] = ri;
        r_out[i] = (r < 0.0) || (r > static_cast<double>(h - 1));
    }
    std::vector<double> fc(ow);
    std::vector<int64_t> cc0(ow);
    std::vector<bool> c_out(ow);
    for (int64_t k = 0; k < ow; ++k) {
        double c = static_cast<double>(k) * inv_scale;
        double f = std::floor(c);
        fc[k] = c - f;
        int64_t ci = static_cast<int64_t>(f);
        if (ci < 0) ci = 0;
        if (ci > w - 1) ci = w - 1;
        cc0[k] = ci;
        c_out[k] = (c < 0.0) || (c > static_cast<double>(w - 1));
    }
    // one dewarped row buffer at padded width w+1: rows[j] for j in [0, w],
    // where padded[:, w] == cval and padded[h, :] == cval
    std::vector<double> row(w + 1);
    for (int64_t i = 0; i < oh; ++i) {
        double* o = out + i * ow;
        if (r_out[i]) {
            for (int64_t k = 0; k < ow; ++k) o[k] = cval;
            continue;
        }
        const double wf = fr[i];
        const double wl = 1.0 - wf;
        const int64_t r0 = rr0[i];
        const double* p0 = img + r0 * w;
        // padded[r0 + 1]: real row while r0 + 1 <= h - 1, else the cval row
        if (r0 + 1 <= h - 1) {
            const double* p1 = img + (r0 + 1) * w;
            for (int64_t j = 0; j < w; ++j) row[j] = p0[j] * wl + p1[j] * wf;
        } else {
            for (int64_t j = 0; j < w; ++j) row[j] = p0[j] * wl + cval * wf;
        }
        row[w] = cval * wl + cval * wf;
        for (int64_t k = 0; k < ow; ++k) {
            if (c_out[k]) { o[k] = cval; continue; }
            const int64_t c0 = cc0[k];
            o[k] = row[c0] * (1.0 - fc[k]) + row[c0 + 1] * fc[k];
        }
    }
}

}  // extern "C"
