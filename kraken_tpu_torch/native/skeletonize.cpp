// kraken_tpu native helpers: morphological thinning and endpoint detection.
//
// Zhang-Suen thinning over a uint8 binary image, operating in place on a
// caller-allocated buffer. Exposed through a plain C ABI consumed via
// ctypes (see kraken_tpu/native/__init__.py). These are the host-side hot
// loops of baseline vectorization that neither XLA nor numpy express well
// (data-dependent iteration until fixpoint).
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <queue>
#include <utility>
#include <vector>

extern "C" {

// Zhang-Suen thinning. img: row-major H*W uint8 (0/1), modified in place.
// Returns the number of iterations executed.
int zhang_suen_thin(uint8_t *img, int h, int w) {
    std::vector<int> candidates;
    std::vector<int> to_clear;
    candidates.reserve(static_cast<size_t>(h) * w / 8);
    to_clear.reserve(1024);

    // collect initial foreground pixels (skip the outer border; callers pad)
    for (int y = 1; y < h - 1; ++y) {
        const uint8_t *row = img + static_cast<size_t>(y) * w;
        for (int x = 1; x < w - 1; ++x) {
            if (row[x]) candidates.push_back(y * w + x);
        }
    }

    int iterations = 0;
    bool changed = true;
    while (changed) {
        changed = false;
        for (int step = 0; step < 2; ++step) {
            to_clear.clear();
            for (int idx : candidates) {
                if (!img[idx]) continue;
                const uint8_t p2 = img[idx - w];
                const uint8_t p3 = img[idx - w + 1];
                const uint8_t p4 = img[idx + 1];
                const uint8_t p5 = img[idx + w + 1];
                const uint8_t p6 = img[idx + w];
                const uint8_t p7 = img[idx + w - 1];
                const uint8_t p8 = img[idx - 1];
                const uint8_t p9 = img[idx - w - 1];
                const int b = p2 + p3 + p4 + p5 + p6 + p7 + p8 + p9;
                if (b < 2 || b > 6) continue;
                const int a = (p2 == 0 && p3 == 1) + (p3 == 0 && p4 == 1) +
                              (p4 == 0 && p5 == 1) + (p5 == 0 && p6 == 1) +
                              (p6 == 0 && p7 == 1) + (p7 == 0 && p8 == 1) +
                              (p8 == 0 && p9 == 1) + (p9 == 0 && p2 == 1);
                if (a != 1) continue;
                if (step == 0) {
                    if (p2 * p4 * p6 != 0 || p4 * p6 * p8 != 0) continue;
                } else {
                    if (p2 * p4 * p8 != 0 || p2 * p6 * p8 != 0) continue;
                }
                to_clear.push_back(idx);
            }
            if (!to_clear.empty()) {
                changed = true;
                for (int idx : to_clear) img[idx] = 0;
            }
        }
        ++iterations;
        if (changed) {
            // compact the candidate list to surviving foreground pixels
            size_t out = 0;
            for (int idx : candidates) {
                if (img[idx]) candidates[out++] = idx;
            }
            candidates.resize(out);
        }
    }
    return iterations;
}

// Endpoint detection: pixels with exactly one 8-neighbor on the skeleton.
// Writes (y, x) pairs into out (capacity max_pts), returns the count.
int skeleton_endpoints(const uint8_t *img, int h, int w,
                       int32_t *out, int max_pts) {
    int n = 0;
    for (int y = 1; y < h - 1 && n < max_pts; ++y) {
        const uint8_t *row = img + static_cast<size_t>(y) * w;
        for (int x = 1; x < w - 1; ++x) {
            if (!row[x]) continue;
            const int nb = img[(y - 1) * w + x - 1] + img[(y - 1) * w + x] +
                           img[(y - 1) * w + x + 1] + img[y * w + x - 1] +
                           img[y * w + x + 1] + img[(y + 1) * w + x - 1] +
                           img[(y + 1) * w + x] + img[(y + 1) * w + x + 1];
            if (nb == 1) {
                if (n >= max_pts) break;
                out[2 * n] = y;
                out[2 * n + 1] = x;
                ++n;
            }
        }
    }
    return n;
}

}  // extern "C"

extern "C" {

// Minimum-energy horizontal seam DP: patch is (h, w) float32 row-major with
// +inf padding rows already included by the caller. Writes one row index per
// column into out_rows (length w). 8-connected left-to-right DP.
void carve_seam(const float *patch, int h, int w, int32_t *out_rows) {
    std::vector<float> cost(static_cast<size_t>(h));
    std::vector<float> prev(static_cast<size_t>(h));
    std::vector<int32_t> back(static_cast<size_t>(h) * w);
    for (int y = 0; y < h; ++y) prev[y] = patch[static_cast<size_t>(y) * w];
    for (int x = 1; x < w; ++x) {
        for (int y = 1; y < h - 1; ++y) {
            // tie priority up > center > down, matching np.argmin over the
            // stacked [up, center, down] rows (first minimum wins)
            float best = prev[y - 1];
            int32_t arg = y - 1;
            if (prev[y] < best) { best = prev[y]; arg = y; }
            if (prev[y + 1] < best) { best = prev[y + 1]; arg = y + 1; }
            cost[y] = patch[static_cast<size_t>(y) * w + x] + best;
            back[static_cast<size_t>(y) * w + x] = arg;
        }
        cost[0] = prev[0];
        cost[h - 1] = prev[h - 1];
        std::swap(cost, prev);
    }
    // start at the cheapest row of the last column
    int32_t y = 1;
    float best = prev[1];
    for (int i = 2; i < h - 1; ++i) {
        if (prev[i] < best) { best = prev[i]; y = i; }
    }
    for (int x = w - 1; x >= 0; --x) {
        out_rows[x] = y;
        if (x > 0) y = back[static_cast<size_t>(y) * w + x];
    }
}

// Line-seed band marking for the legacy page segmenter: per column, walk
// the baseline (s=1) / topline (s=0) transition marks top-down from the
// bottom edge and fill the band above each baseline mark plus the span to
// the next topline mark within `limit` rows. Exact port of the per-column
// python loop in pageseg.compute_line_seeds (ocropy semantics, including
// the empty fill when y0 < delta from numpy's negative slice start).
void line_seeds(const uint8_t *bm, const uint8_t *tm, int h, int w,
                int delta, float limit, uint8_t *seeds) {
    std::vector<std::pair<int, int>> tr;
    for (int x = 0; x < w; ++x) {
        tr.clear();
        // descending y; at equal y the baseline mark sorts first, matching
        // reversed ascending (y, s) tuple order
        for (int y = h - 1; y >= 0; --y) {
            if (bm[static_cast<size_t>(y) * w + x]) tr.emplace_back(y, 1);
            if (tm[static_cast<size_t>(y) * w + x]) tr.emplace_back(y, 0);
        }
        tr.emplace_back(0, 0);
        for (size_t ls = 0; ls + 1 < tr.size(); ++ls) {
            const int y0 = tr[ls].first;
            if (tr[ls].second == 0) continue;
            if (y0 - delta >= 0)
                for (int y = y0 - delta; y < y0; ++y)
                    seeds[static_cast<size_t>(y) * w + x] = 1;
            const int y1 = tr[ls + 1].first;
            if (tr[ls + 1].second == 0 && static_cast<float>(y0 - y1) < limit)
                for (int y = y1; y < y0; ++y)
                    seeds[static_cast<size_t>(y) * w + x] = 1;
        }
    }
}

// Minimum-cost endpoint linking over a skeleton + 1px halo (mirrors
// lib/vectorization.py _link_endpoints: pixel entry cost 1e-4 on the
// skeleton / 1.0 on the halo, undirected edge weight = min of the two
// entry costs — scipy's undirected csr symmetrization — and a search
// limit of `limit` total cost). Writes the concatenated (y, x) points of
// each i->j path (i-major pair order, node-deduplicated) into out_pts
// and per-path lengths into out_lens. Returns the number of paths, or
// -1 when out_pts/out_lens capacity is exceeded (caller falls back).
int link_endpoint_paths(const uint8_t *skel, int h, int w,
                        const int32_t *eps, int n_eps, double limit,
                        int32_t *out_pts, int cap,
                        int32_t *out_lens, int max_paths) {
    const size_t n = static_cast<size_t>(h) * w;
    std::vector<uint8_t> halo(n, 0);
    for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x) {
            if (!skel[static_cast<size_t>(y) * w + x]) continue;
            const int y0 = y > 0 ? y - 1 : 0, y1 = y < h - 1 ? y + 1 : h - 1;
            const int x0 = x > 0 ? x - 1 : 0, x1 = x < w - 1 ? x + 1 : w - 1;
            for (int yy = y0; yy <= y1; ++yy)
                for (int xx = x0; xx <= x1; ++xx)
                    halo[static_cast<size_t>(yy) * w + xx] = 1;
        }
    std::vector<double> dist(n, 0.0);
    std::vector<int64_t> pred(n, -1);
    std::vector<int32_t> stamp(n, -1);
    const int dy8[8] = {-1, -1, -1, 0, 0, 1, 1, 1};
    const int dx8[8] = {-1, 0, 1, -1, 1, -1, 0, 1};
    auto entry = [&](int64_t idx) { return skel[idx] ? 1e-4 : 1.0; };

    std::vector<std::pair<int64_t, int64_t>> seen;  // deduped node-id pairs
    int n_paths = 0;
    int pts_used = 0;
    typedef std::pair<double, int64_t> QE;
    std::priority_queue<QE, std::vector<QE>, std::greater<QE>> pq;

    for (int i = 0; i < n_eps; ++i) {
        const int64_t src = static_cast<int64_t>(eps[2 * i]) * w + eps[2 * i + 1];
        if (src < 0 || src >= static_cast<int64_t>(n) || !halo[src]) continue;
        // Dijkstra from src, version-stamped with i
        while (!pq.empty()) pq.pop();
        dist[src] = 0.0;
        pred[src] = -1;
        stamp[src] = i;
        pq.emplace(0.0, src);
        while (!pq.empty()) {
            const double d = pq.top().first;
            const int64_t u = pq.top().second;
            pq.pop();
            if (stamp[u] != i || d > dist[u]) continue;
            const int uy = static_cast<int>(u / w), ux = static_cast<int>(u % w);
            const double eu = entry(u);
            for (int k = 0; k < 8; ++k) {
                const int vy = uy + dy8[k], vx = ux + dx8[k];
                if (vy < 0 || vy >= h || vx < 0 || vx >= w) continue;
                const int64_t v = static_cast<int64_t>(vy) * w + vx;
                if (!halo[v]) continue;
                const double ev = entry(v);
                // tiny diagonal penalty: scipy's dijkstra breaks the
                // equal-cost ties of a 2px-wide skeleton by heap insertion
                // order (unreproducible); preferring straight steps breaks
                // them deterministically and yields smoother paths
                const double tie = (dy8[k] != 0 && dx8[k] != 0) ? 2e-5 : 0.0;
                const double nd = d + (eu < ev ? eu : ev) + tie;
                if (nd > limit) continue;
                if (stamp[v] != i || nd < dist[v]) {
                    stamp[v] = i;
                    dist[v] = nd;
                    pred[v] = u;
                    pq.emplace(nd, v);
                }
            }
        }
        for (int j = i + 1; j < n_eps; ++j) {
            const int64_t tgt = static_cast<int64_t>(eps[2 * j]) * w + eps[2 * j + 1];
            if (tgt < 0 || tgt >= static_cast<int64_t>(n)) continue;
            if (stamp[tgt] != i) continue;  // unreachable within limit
            const int64_t lo = src < tgt ? src : tgt;
            const int64_t hi = src < tgt ? tgt : src;
            bool dup = false;
            for (const auto &p : seen)
                if (p.first == lo && p.second == hi) { dup = true; break; }
            if (dup) continue;
            seen.emplace_back(lo, hi);
            // walk tgt -> src to get the length, then emit reversed
            int len = 0;
            for (int64_t cur = tgt;; cur = pred[cur]) {
                ++len;
                if (cur == src) break;
                if (pred[cur] < 0) { len = -1; break; }
            }
            if (len < 0) continue;
            if (n_paths >= max_paths || pts_used + len > cap / 2) return -1;
            int64_t cur = tgt;
            for (int p = len - 1; p >= 0; --p, cur = pred[cur]) {
                out_pts[2 * (pts_used + p)] = static_cast<int32_t>(cur / w);
                out_pts[2 * (pts_used + p) + 1] = static_cast<int32_t>(cur % w);
            }
            pts_used += len;
            out_lens[n_paths++] = len;
        }
    }
    return n_paths;
}

}  // extern "C"

// Same-size 2-D sliding-window percentile with symmetric edge padding —
// the background-estimation hot loop of nlbin binarization
// (kraken_tpu/binarization._sliding_percentile). Per output pixel the
// window's order statistics are selected with nth_element and linearly
// interpolated exactly like np.percentile(..., 'linear'): virtual index
// v = (n-1)*q/100, result = s[floor(v)] + frac*(s[floor(v)+1]-s[floor(v)]).
// Windows are tiny (tens of values), so selection beats numpy's blocked
// window-stack partition ~5x and avoids its stack copies entirely.
extern "C" void sliding_percentile_f64(const double *arr, int h, int w,
                                       int wh, int ww, double q, double *out) {
    const int top = (wh - 1) / 2, bottom = wh - 1 - top;
    const int left = (ww - 1) / 2, right = ww - 1 - left;
    const int ph = h + wh - 1, pw = w + ww - 1;
    std::vector<double> padded(static_cast<size_t>(ph) * pw);
    // numpy 'symmetric' padding: reflect including the edge sample
    auto sym = [](int i, int n) {
        // fold i into [0, n) with symmetric (edge-inclusive) reflection
        if (n == 1) return 0;
        const int period = 2 * n;
        int m = i % period;
        if (m < 0) m += period;
        return m < n ? m : period - 1 - m;
    };
    for (int y = 0; y < ph; ++y) {
        const int sy = sym(y - top, h);
        const double *src = arr + static_cast<size_t>(sy) * w;
        double *dst = &padded[static_cast<size_t>(y) * pw];
        for (int x = 0; x < pw; ++x) dst[x] = src[sym(x - left, w)];
    }
    (void)bottom;
    (void)right;
    const int n = wh * ww;
    // numpy computes the virtual index as (q/100) * (n-1) in this float
    // order; any other association changes the last-ulp fraction
    const double v = (q / 100.0) * (n - 1);
    const int k_lo = static_cast<int>(v);
    const double frac = v - k_lo;
    std::vector<double> sorted(n);

    auto emit = [&](size_t idx) {
        const double lo = sorted[k_lo];
        double val = lo;
        if (frac > 0.0 && k_lo + 1 < n) {
            const double hi = sorted[k_lo + 1];
            // numpy's _lerp switches to the b-anchored form at t>=0.5; the
            // volatile store rounds the product before the add/subtract
            // like numpy's separate ops (defeats FMA contraction, which
            // differs in the last ulp)
            volatile double prod = frac >= 0.5 ? (hi - lo) * (1.0 - frac)
                                               : (hi - lo) * frac;
            val = frac >= 0.5 ? hi - prod : lo + prod;
        }
        out[idx] = val;
    };
    auto replace = [&](double old_v, double new_v) {
        // remove old_v, insert new_v, keeping `sorted` ordered (one memmove
        // over at most n doubles — windows here are tens of values)
        double *base = sorted.data();
        double *po = std::lower_bound(base, base + n, old_v);
        double *pn = std::lower_bound(base, base + n, new_v);
        if (pn > po) {
            std::memmove(po, po + 1, (pn - po - 1) * sizeof(double));
            pn[-1] = new_v;
        } else {
            std::memmove(pn + 1, pn, (po - pn) * sizeof(double));
            *pn = new_v;
        }
    };

    // slide along the axis whose cross-section is smaller: a y-step swaps
    // ww values, an x-step swaps wh values
    const bool slide_y = ww <= wh;
    const int outer = slide_y ? w : h;
    const int inner = slide_y ? h : w;
    const int cross = slide_y ? ww : wh;
    for (int o = 0; o < outer; ++o) {
        int m = 0;
        for (int dy = 0; dy < wh; ++dy) {
            const size_t row = static_cast<size_t>(slide_y ? dy : o + dy) * pw;
            const int col = slide_y ? o : 0;
            for (int dx = 0; dx < ww; ++dx) sorted[m++] = padded[row + col + dx];
        }
        std::sort(sorted.begin(), sorted.end());
        for (int i = 0; i < inner; ++i) {
            emit(slide_y ? static_cast<size_t>(i) * w + o
                         : static_cast<size_t>(o) * w + i);
            if (i + 1 >= inner) break;
            for (int k = 0; k < cross; ++k) {
                if (slide_y) {
                    const size_t col = static_cast<size_t>(o) + k;
                    replace(padded[static_cast<size_t>(i) * pw + col],
                            padded[static_cast<size_t>(i + wh) * pw + col]);
                } else {
                    const size_t row = static_cast<size_t>(o + k) * pw;
                    replace(padded[row + i], padded[row + i + ww]);
                }
            }
        }
    }
}

// Exact reimplementation of Pillow's Lanczos resampling for single-channel
// uint8 images (Resample.c: precompute_coeffs + normalize_coeffs_8bpc +
// the horizontal/vertical 8bpc passes, PRECISION_BITS fixed-point with
// identical rounding). Byte-identical output is REQUIRED — the Python
// binding self-checks against PIL at load time and falls back on any
// mismatch. Horizontal pass first, then vertical, matching PIL's order;
// a pass is skipped when its size is unchanged, also matching PIL.
namespace {

constexpr int kPrecisionBits = 32 - 8 - 2;

inline double sinc_filter(double x) {
    if (x == 0.0) return 1.0;
    x = x * M_PI;
    return std::sin(x) / x;
}

inline double lanczos_filter(double x) {
    if (-3.0 <= x && x < 3.0) return sinc_filter(x) * sinc_filter(x / 3.0);
    return 0.0;
}

inline uint8_t clip8(int in) {
    if (in >= (1 << kPrecisionBits << 8)) return 255;
    if (in <= 0) return 0;
    return static_cast<uint8_t>(in >> kPrecisionBits);
}

// returns ksize; fills bounds (2*outSize) and int coefficients (outSize*ksize)
int precompute_coeffs_int_uncached(int inSize, int outSize,
                                   std::vector<int> &bounds,
                                   std::vector<int> &kk_int) {
    const double scale = static_cast<double>(inSize) / outSize;
    double filterscale = scale;
    if (filterscale < 1.0) filterscale = 1.0;
    const double support = 3.0 * filterscale;
    const int ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
    std::vector<double> k(ksize);
    bounds.assign(static_cast<size_t>(outSize) * 2, 0);
    kk_int.assign(static_cast<size_t>(outSize) * ksize, 0);
    const double ss = 1.0 / filterscale;
    for (int xx = 0; xx < outSize; ++xx) {
        const double center = (xx + 0.5) * scale;
        double ww = 0.0;
        int xmin = static_cast<int>(center - support + 0.5);
        if (xmin < 0) xmin = 0;
        int xmax = static_cast<int>(center + support + 0.5);
        if (xmax > inSize) xmax = inSize;
        xmax -= xmin;
        for (int x = 0; x < xmax; ++x) {
            const double w = lanczos_filter((x + xmin - center + 0.5) * ss);
            k[x] = w;
            ww += w;
        }
        for (int x = 0; x < xmax; ++x)
            if (ww != 0.0) k[x] /= ww;
        bounds[2 * xx] = xmin;
        bounds[2 * xx + 1] = xmax;
        int *ki = &kk_int[static_cast<size_t>(xx) * ksize];
        for (int x = 0; x < xmax; ++x)
            ki[x] = static_cast<int>(k[x] < 0 ? k[x] * (1 << kPrecisionBits) - 0.5
                                              : k[x] * (1 << kPrecisionBits) + 0.5);
    }
    return ksize;
}

// coefficient-table cache keyed by (inSize, outSize): the sinc evaluations
// (~2*ksize libm sin calls per output sample) dominate small-line resizes,
// and line-normalization reuses a handful of geometry pairs per document.
// Values are the exact tables the uncached path computes, so output stays
// byte-identical to PIL.
struct CoeffEntry {
    int ksize;
    std::vector<int> bounds, kk;
};
std::mutex g_coeff_mu;
std::map<std::pair<int, int>, CoeffEntry> g_coeff_cache;

int precompute_coeffs_int(int inSize, int outSize,
                          std::vector<int> &bounds, std::vector<int> &kk_int) {
    const std::pair<int, int> key{inSize, outSize};
    {
        std::lock_guard<std::mutex> lock(g_coeff_mu);
        auto it = g_coeff_cache.find(key);
        if (it != g_coeff_cache.end()) {
            bounds = it->second.bounds;
            kk_int = it->second.kk;
            return it->second.ksize;
        }
    }
    const int ksize = precompute_coeffs_int_uncached(inSize, outSize, bounds, kk_int);
    std::lock_guard<std::mutex> lock(g_coeff_mu);
    if (g_coeff_cache.size() >= 512) g_coeff_cache.clear();
    g_coeff_cache.emplace(key, CoeffEntry{ksize, bounds, kk_int});
    return ksize;
}

}  // namespace

namespace {

// resamples rows (the "vertical" pass form): (h, w) -> (oh, w).
// SIMD-friendly: per output row, accumulate coefficient-scaled source rows.
// Integer adds commute, so this is bit-identical to any accumulation order.
void resample_rows_u8(const uint8_t *src, int h, int w, uint8_t *dst, int oh) {
    std::vector<int> bounds, kk;
    const int ksize = precompute_coeffs_int(h, oh, bounds, kk);
    std::vector<int> acc(w);
    for (int yy = 0; yy < oh; ++yy) {
        const int ymin = bounds[2 * yy], ymax = bounds[2 * yy + 1];
        const int *ki = &kk[static_cast<size_t>(yy) * ksize];
        for (int xx = 0; xx < w; ++xx) acc[xx] = 1 << (kPrecisionBits - 1);
        for (int y = 0; y < ymax; ++y) {
            const uint8_t *row = src + static_cast<size_t>(y + ymin) * w;
            const int c = ki[y];
            for (int xx = 0; xx < w; ++xx) acc[xx] += row[xx] * c;
        }
        uint8_t *orow = dst + static_cast<size_t>(yy) * w;
        for (int xx = 0; xx < w; ++xx) orow[xx] = clip8(acc[xx]);
    }
}

// cache-blocked transpose of (h, w) pixels with c interleaved channels
// -> (w, h) pixels
void transpose_u8(const uint8_t *src, int h, int w, int c, uint8_t *dst) {
    constexpr int B = 64;
    for (int y0 = 0; y0 < h; y0 += B)
        for (int x0 = 0; x0 < w; x0 += B) {
            const int y1 = y0 + B < h ? y0 + B : h;
            const int x1 = x0 + B < w ? x0 + B : w;
            for (int y = y0; y < y1; ++y)
                for (int x = x0; x < x1; ++x)
                    for (int k = 0; k < c; ++k)
                        dst[(static_cast<size_t>(x) * h + y) * c + k] =
                            src[(static_cast<size_t>(y) * w + x) * c + k];
        }
}

}  // namespace

extern "C" int resize_lanczos_u8(const uint8_t *in, int h, int w, int c,
                                 uint8_t *out, int oh, int ow) {
    if (h <= 0 || w <= 0 || oh <= 0 || ow <= 0 || c <= 0 || c > 4) return -1;
    const bool need_h = ow != w;
    const bool need_v = oh != h;
    if (!need_h && !need_v) {
        std::memcpy(out, in, static_cast<size_t>(h) * w * c);
        return 0;
    }
    // horizontal pass first (PIL's order) as transpose -> row-resample ->
    // transpose: the row-accumulate form vectorizes; transposes are cheap
    // and value-preserving, so output stays byte-identical to PIL.
    // Channels stay interleaved: a row of N pixels is N*c samples, and the
    // per-pixel coefficients apply unchanged to each channel sample.
    std::vector<uint8_t> bufA, bufB;
    const uint8_t *src = in;
    int cur_w = w;
    if (need_h) {
        bufA.resize(static_cast<size_t>(w) * h * c);
        transpose_u8(src, h, w, c, bufA.data());               // (w, h)
        bufB.resize(static_cast<size_t>(ow) * h * c);
        resample_rows_u8(bufA.data(), w, h * c, bufB.data(), ow);  // (ow, h)
        if (need_v) {
            bufA.resize(static_cast<size_t>(h) * ow * c);
            transpose_u8(bufB.data(), ow, h, c, bufA.data());      // (h, ow)
            src = bufA.data();
        } else {
            transpose_u8(bufB.data(), ow, h, c, out);
            return 0;
        }
        cur_w = ow;
    }
    resample_rows_u8(src, h, cur_w * c, out, oh);
    return 0;
}
