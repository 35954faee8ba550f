// kraken_tpu native page polygonizer.
//
// C++ port of the per-line baseline->bounding-polygon pipeline of
// kraken_tpu/lib/polygonization.py (itself the functional equivalent of the
// reference's calculate_polygonal_environment stack,
// kraken/lib/segmentation.py:560-843): ROI ray casting, biased/masked energy
// patch construction, level rotation, minimum-energy seam carving, seam
// smoothing and polygon completion. One call processes every line of a page,
// eliminating the per-line Python/numpy dispatch overhead that dominated the
// host segmentation stage (~120 ms/page -> ~15 ms on the fixture page).
//
// The seam DP itself is shared with the batched XLA path: callers may fetch
// the prepared patches (polyg_patch_dims/polyg_copy_patch), carve them on an
// accelerator, and feed the seam rows back (polyg_set_rows) — preparation
// and completion are then bit-identical between the host and device paths.
//
// Geometry follows the Python implementation in double precision with
// matching rounding rules (numpy trunc-to-zero astype(int), rint
// half-to-even for np.round/np.around). Rasterization (polygon fill, line
// drawing, bilinear rotation, contour tracing) is implemented here rather
// than delegated to OpenCV; results may differ from the cv2-based Python
// fallback by single boundary pixels, which the detection-quality floors in
// tests/test_seg_parity.py and the IoU regression test in
// tests/test_segmentation.py bound.
#include <algorithm>
#include <cfenv>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr float kMaskVal = 99999.0f;
constexpr double kInf = std::numeric_limits<double>::infinity();

struct Pt {
    double x, y;
};

// numpy np.round / np.rint: round half to even
inline double rint_he(double v) { return std::nearbyint(v); }
// numpy astype(int): truncate toward zero
inline int64_t trunc_int(double v) { return static_cast<int64_t>(v); }

struct Mat2 {
    // row-major 2x2
    double a, b, c, d;
    Pt apply(const Pt &p) const { return {a * p.x + b * p.y, c * p.x + d * p.y}; }
    Mat2 inv() const {
        const double det = a * d - b * c;
        return {d / det, -b / det, -c / det, a / det};
    }
};

struct Mask {
    int h = 0, w = 0;
    std::vector<uint8_t> v;
    void init(int hh, int ww, uint8_t fill) {
        h = hh;
        w = ww;
        v.assign(static_cast<size_t>(h) * w, fill);
    }
    uint8_t at(int y, int x) const { return v[static_cast<size_t>(y) * w + x]; }
    void set(int y, int x, uint8_t val) {
        if (y >= 0 && y < h && x >= 0 && x < w) v[static_cast<size_t>(y) * w + x] = val;
    }
};

// 8-connected Bresenham polyline draw (cv2.polylines thickness-1 analog),
// clipped to the mask bounds.
void draw_polyline(Mask &m, const std::vector<Pt> &pts, uint8_t val) {
    for (size_t i = 0; i + 1 < pts.size(); ++i) {
        int64_t x0 = static_cast<int64_t>(pts[i].x), y0 = static_cast<int64_t>(pts[i].y);
        const int64_t x1 = static_cast<int64_t>(pts[i + 1].x), y1 = static_cast<int64_t>(pts[i + 1].y);
        const int64_t dx = std::abs(x1 - x0), sx = x0 < x1 ? 1 : -1;
        const int64_t dy = -std::abs(y1 - y0), sy = y0 < y1 ? 1 : -1;
        int64_t err = dx + dy;
        for (;;) {
            m.set(static_cast<int>(y0), static_cast<int>(x0), val);
            if (x0 == x1 && y0 == y1) break;
            const int64_t e2 = 2 * err;
            if (e2 >= dy) {
                err += dy;
                x0 += sx;
            }
            if (e2 <= dx) {
                err += dx;
                y0 += sy;
            }
        }
    }
}

// Even-odd scanline polygon fill (+ boundary pixels drawn, matching
// cv2.fillPoly's boundary-inclusive behavior). Polygon vertices are rounded
// half-to-even first, like _rasterize_polygon's np.round.
void fill_polygon(Mask &m, const std::vector<Pt> &poly, uint8_t val) {
    if (poly.size() < 2) return;
    std::vector<Pt> p(poly.size());
    for (size_t i = 0; i < poly.size(); ++i)
        p[i] = {rint_he(poly[i].x), rint_he(poly[i].y)};
    double ymin = p[0].y, ymax = p[0].y;
    for (const auto &q : p) {
        ymin = std::min(ymin, q.y);
        ymax = std::max(ymax, q.y);
    }
    const int y0 = std::max(0, static_cast<int>(std::floor(ymin)));
    const int y1 = std::min(m.h - 1, static_cast<int>(std::ceil(ymax)));
    std::vector<double> xs;
    for (int y = y0; y <= y1; ++y) {
        xs.clear();
        const double yc = y;
        const size_t n = p.size();
        for (size_t i = 0; i < n; ++i) {
            const Pt &a = p[i];
            const Pt &b = p[(i + 1) % n];
            if (a.y == b.y) continue;
            // half-open rule [min, max) keeps vertex crossings counted once
            if ((yc >= std::min(a.y, b.y)) && (yc < std::max(a.y, b.y))) {
                xs.push_back(a.x + (yc - a.y) * (b.x - a.x) / (b.y - a.y));
            }
        }
        std::sort(xs.begin(), xs.end());
        for (size_t i = 0; i + 1 < xs.size(); i += 2) {
            int xa = static_cast<int>(std::ceil(xs[i]));
            int xb = static_cast<int>(std::floor(xs[i + 1]));
            xa = std::max(xa, 0);
            xb = std::min(xb, m.w - 1);
            for (int x = xa; x <= xb; ++x) m.set(y, x, val);
        }
    }
    // boundary inclusive
    std::vector<Pt> closed(p);
    closed.push_back(p[0]);
    draw_polyline(m, closed, val);
}

// two-pass chessboard (Chebyshev) chamfer distance to the nearest zero pixel
void chessboard_dist(const Mask &src, std::vector<float> &out) {
    const int h = src.h, w = src.w;
    constexpr float kBig = 1e8f;
    out.assign(static_cast<size_t>(h) * w, kBig);
    for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x)
            if (!src.at(y, x)) out[static_cast<size_t>(y) * w + x] = 0.0f;
    auto at = [&](int y, int x) -> float & { return out[static_cast<size_t>(y) * w + x]; };
    for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x) {
            float d = at(y, x);
            if (y > 0) {
                d = std::min(d, at(y - 1, x) + 1);
                if (x > 0) d = std::min(d, at(y - 1, x - 1) + 1);
                if (x < w - 1) d = std::min(d, at(y - 1, x + 1) + 1);
            }
            if (x > 0) d = std::min(d, at(y, x - 1) + 1);
            at(y, x) = d;
        }
    for (int y = h - 1; y >= 0; --y)
        for (int x = w - 1; x >= 0; --x) {
            float d = at(y, x);
            if (y < h - 1) {
                d = std::min(d, at(y + 1, x) + 1);
                if (x > 0) d = std::min(d, at(y + 1, x - 1) + 1);
                if (x < w - 1) d = std::min(d, at(y + 1, x + 1) + 1);
            }
            if (x < w - 1) d = std::min(d, at(y, x + 1) + 1);
            at(y, x) = d;
        }
}

// 4-connected cross dilation, `iters` iterations, zero border
void dilate_cross(Mask &m, int iters) {
    Mask tmp;
    tmp.init(m.h, m.w, 0);
    for (int it = 0; it < iters; ++it) {
        for (int y = 0; y < m.h; ++y)
            for (int x = 0; x < m.w; ++x) {
                uint8_t v = m.at(y, x);
                if (!v) {
                    if (y > 0 && m.at(y - 1, x)) v = 1;
                    else if (y < m.h - 1 && m.at(y + 1, x)) v = 1;
                    else if (x > 0 && m.at(y, x - 1)) v = 1;
                    else if (x < m.w - 1 && m.at(y, x + 1)) v = 1;
                }
                tmp.v[static_cast<size_t>(y) * m.w + x] = v;
            }
        std::swap(m.v, tmp.v);
    }
}

// Ramer-Douglas-Peucker polyline simplification (open polyline), keeping
// both endpoints — the same algorithm lib/geometry.douglas_peucker runs
// (via cv2.approxPolyDP); vertex subsets may differ only in tie cases.
std::vector<Pt> rdp(const std::vector<Pt> &pts, double tol) {
    const size_t n = pts.size();
    if (n < 3) return pts;
    std::vector<uint8_t> keep(n, 0);
    keep[0] = keep[n - 1] = 1;
    std::vector<std::pair<size_t, size_t>> stack{{0, n - 1}};
    while (!stack.empty()) {
        auto [lo, hi] = stack.back();
        stack.pop_back();
        if (hi <= lo + 1) continue;
        const double sx = pts[hi].x - pts[lo].x;
        const double sy = pts[hi].y - pts[lo].y;
        const double seg_len = std::hypot(sx, sy);
        double dmax = -1.0;
        size_t imax = lo + 1;
        for (size_t i = lo + 1; i < hi; ++i) {
            const double rx = pts[i].x - pts[lo].x;
            const double ry = pts[i].y - pts[lo].y;
            const double d = seg_len < 1e-12 ? std::hypot(rx, ry)
                                             : std::abs(sx * ry - sy * rx) / seg_len;
            if (d > dmax) {
                dmax = d;
                imax = i;
            }
        }
        if (dmax > tol) {
            keep[imax] = 1;
            stack.emplace_back(lo, imax);
            stack.emplace_back(imax, hi);
        }
    }
    std::vector<Pt> out;
    for (size_t i = 0; i < n; ++i)
        if (keep[i]) out.push_back(pts[i]);
    return out;
}

// per-vertex-normal polyline offset (_offset_polyline port)
std::vector<Pt> offset_polyline(const std::vector<Pt> &line, double offset, bool left) {
    if (offset == 0.0 || line.size() < 2) return line;
    const size_t n = line.size();
    std::vector<Pt> tang(n - 1);
    for (size_t i = 0; i + 1 < n; ++i) {
        double dx = line[i + 1].x - line[i].x;
        double dy = line[i + 1].y - line[i].y;
        double nrm = std::hypot(dx, dy);
        if (nrm == 0.0) nrm = 1.0;
        tang[i] = {dx / nrm, dy / nrm};
    }
    std::vector<Pt> out(n);
    for (size_t i = 0; i < n; ++i) {
        Pt vt;
        if (i == 0)
            vt = tang[0];
        else if (i == n - 1)
            vt = tang[n - 2];
        else
            vt = {(tang[i - 1].x + tang[i].x) / 2, (tang[i - 1].y + tang[i].y) / 2};
        const double nrm = std::max(std::hypot(vt.x, vt.y), 1e-9);
        vt = {vt.x / nrm, vt.y / nrm};
        Pt normal{vt.y, -vt.x};
        if (left) normal = {-normal.x, -normal.y};
        out[i] = {line[i].x + offset * normal.x, line[i].y + offset * normal.y};
    }
    return out;
}

// _interpolate_polyline port: resample at 10px arc-length steps
std::vector<Pt> interpolate_polyline(const std::vector<Pt> &line, double step = 10.0) {
    const size_t n = line.size();
    std::vector<double> dists(n, 0.0);
    for (size_t i = 1; i < n; ++i)
        dists[i] = dists[i - 1] + std::hypot(line[i].x - line[i - 1].x,
                                             line[i].y - line[i - 1].y);
    const double total = dists[n - 1];
    std::vector<Pt> out;
    out.push_back(line[0]);
    for (double t = step; t < total; t += step) {
        // np.searchsorted 'left', clipped to [1, n-1]
        size_t seg = std::lower_bound(dists.begin(), dists.end(), t) - dists.begin();
        seg = std::min(std::max<size_t>(seg, 1), n - 1);
        const double denom = dists[seg] - dists[seg - 1];
        const double frac = denom > 0 ? (t - dists[seg - 1]) / denom : 0.0;
        out.push_back({line[seg - 1].x + frac * (line[seg].x - line[seg - 1].x),
                       line[seg - 1].y + frac * (line[seg].y - line[seg - 1].y)});
    }
    out.push_back(line[n - 1]);
    return out;
}

struct Segment {
    Pt a, b;
    double xmin, xmax, ymin, ymax;  // AABB for pruning
};

// _calc_roi's _env: ray/AABB exit + nearest neighbor-segment hit per
// interpolated point. Returns false when a ray misses the image bounds.
bool roi_env(const std::vector<Pt> &ip, const Pt &dir, double bx, double by,
             const std::vector<Segment> &segs, std::vector<Pt> &out) {
    const size_t P = ip.size();
    out.resize(P);
    std::vector<Pt> bound(P);
    double fan_xmin = kInf, fan_xmax = -kInf, fan_ymin = kInf, fan_ymax = -kInf;
    for (size_t i = 0; i < P; ++i) {
        const double fx = dir.x == 0.0 ? kInf : 1.0 / dir.x;
        const double fy = dir.y == 0.0 ? kInf : 1.0 / dir.y;
        const double t1 = (-ip[i].x) * fx;
        const double t2 = (bx + 1 - ip[i].x) * fx;
        const double t3 = (-ip[i].y) * fy;
        const double t4 = (by + 1 - ip[i].y) * fy;
        const double tmin = std::max(std::min(t1, t2), std::min(t3, t4));
        const double tmax = std::min(std::max(t1, t2), std::max(t3, t4));
        double tt = kInf;
        if (tmin >= 0)
            tt = tmin;
        else if (tmax >= 0)
            tt = tmax;
        else
            return false;  // ray misses the image bounds
        bound[i] = {ip[i].x + dir.x * tt, ip[i].y + dir.y * tt};
        fan_xmin = std::min(fan_xmin, std::min(ip[i].x, bound[i].x));
        fan_xmax = std::max(fan_xmax, std::max(ip[i].x, bound[i].x));
        fan_ymin = std::min(fan_ymin, std::min(ip[i].y, bound[i].y));
        fan_ymax = std::max(fan_ymax, std::max(ip[i].y, bound[i].y));
    }
    // AABB-pruned candidate set (exact: a valid hit lies on both the ray
    // span and the segment)
    std::vector<const Segment *> cand;
    cand.reserve(segs.size());
    for (const auto &s : segs)
        if (s.xmin <= fan_xmax && s.xmax >= fan_xmin && s.ymin <= fan_ymax &&
            s.ymax >= fan_ymin)
            cand.push_back(&s);
    for (size_t i = 0; i < P; ++i) {
        const double rx = bound[i].x - ip[i].x;
        const double ry = bound[i].y - ip[i].y;
        double t_min = kInf;
        for (const Segment *s : cand) {
            const double sx = s->b.x - s->a.x;
            const double sy = s->b.y - s->a.y;
            const double denom = rx * sy - ry * sx;
            if (std::abs(denom) <= 1e-12) continue;
            const double dx = s->a.x - ip[i].x;
            const double dy = s->a.y - ip[i].y;
            const double t = (dx * sy - dy * sx) / denom;
            const double u = (dx * ry - dy * rx) / denom;
            if (t >= 0 && t <= 1 && u >= 0 && u <= 1) t_min = std::min(t_min, t);
        }
        if (std::isinf(t_min)) {
            out[i] = bound[i];
            continue;
        }
        Pt nearest{ip[i].x + t_min * rx, ip[i].y + t_min * ry};
        // 1px pull-back towards the baseline
        const double vx = nearest.x - ip[i].x;
        const double vy = nearest.y - ip[i].y;
        const double vlen = std::hypot(vx, vy);
        if (vlen > 1) {
            const double scale = (vlen - 1) / vlen;
            nearest = {ip[i].x + vx * scale, ip[i].y + vy * scale};
        }
        out[i] = nearest;
    }
    return true;
}

// the shared seam DP (skeletonize.cpp) — ONE implementation decides ties
// for the host, polygonizer, and (equivalence-tested) device paths
extern "C" void carve_seam(const float *patch, int h, int w, int32_t *out_rows);

// seam DP over a (h, w) float patch: adds the +inf padding rows carve_seam
// expects and strips the pad offset from the returned rows.
void carve_seam_rows(const std::vector<float> &patch, int h, int w,
                     std::vector<int32_t> &out_rows) {
    const float inf = std::numeric_limits<float>::infinity();
    std::vector<float> padded(static_cast<size_t>(h + 2) * w);
    for (int x = 0; x < w; ++x) padded[x] = inf;
    std::memcpy(&padded[w], patch.data(), sizeof(float) * h * w);
    for (int x = 0; x < w; ++x) padded[static_cast<size_t>(h + 1) * w + x] = inf;
    out_rows.resize(w);
    carve_seam(padded.data(), h + 2, w, out_rows.data());
    for (int x = 0; x < w; ++x) --out_rows[x];
}

// Moore-neighbor outer boundary trace of the component containing (sy, sx)
// with backtrack state (Jacob's stopping criterion: terminate when the
// (pixel, backtrack) state of the start repeats). (sy, sx) must be an
// outer-border start pixel, i.e. its west neighbor is background. Returns
// boundary pixels as (x, y).
std::vector<Pt> trace_boundary(const Mask &m, int sy, int sx, Mask &state) {
    // ring positions clockwise (y down): W, NW, N, NE, E, SE, S, SW
    static const int dy8[8] = {0, -1, -1, -1, 0, 1, 1, 1};
    static const int dx8[8] = {-1, -1, 0, 1, 1, 1, 0, -1};
    auto fg = [&](int y, int x) {
        return y >= 0 && y < m.h && x >= 0 && x < m.w && m.at(y, x) != 0;
    };
    std::vector<Pt> out;
    out.push_back({static_cast<double>(sx), static_cast<double>(sy)});
    int cy = sy, cx = sx;
    int b_dir = 0;  // direction from the current pixel to its backtrack (W)
    state.v[static_cast<size_t>(sy) * m.w + sx] |= 1;  // bit per b_dir
    const size_t cap = static_cast<size_t>(m.h) * m.w * 4 + 16;
    for (size_t guard = 0; guard < cap; ++guard) {
        int found = -1;
        for (int k = 1; k <= 8; ++k) {
            const int d = (b_dir + k) % 8;
            if (fg(cy + dy8[d], cx + dx8[d])) {
                found = d;
                break;
            }
        }
        if (found < 0) break;  // isolated pixel
        // new backtrack: the ring position examined just before `found`
        // (background, or the old backtrack), expressed relative to the
        // new pixel
        const int prev = (found + 7) % 8;
        const int by = cy + dy8[prev], bx = cx + dx8[prev];
        cy += dy8[found];
        cx += dx8[found];
        int nb = -1;
        for (int d = 0; d < 8; ++d)
            if (cy + dy8[d] == by && cx + dx8[d] == bx) {
                nb = d;
                break;
            }
        if (nb < 0) break;  // unreachable: consecutive ring cells are adjacent
        b_dir = nb;
        // terminate on ANY repeated (pixel, backtrack) state — robust for
        // both outer borders and inner (hole) boundaries, where the walk
        // never returns to the scan-start state
        uint8_t &bits = state.v[static_cast<size_t>(cy) * m.w + cx];
        if (bits & (1 << b_dir)) break;
        bits |= (1 << b_dir);
        out.push_back({static_cast<double>(cx), static_cast<double>(cy)});
    }
    return out;
}

// collinear-run compression over an 8-connected boundary chain
// (CHAIN_APPROX_SIMPLE analog)
std::vector<Pt> compress_chain(const std::vector<Pt> &chain) {
    const size_t n = chain.size();
    if (n < 3) return chain;
    std::vector<Pt> out;
    for (size_t i = 0; i < n; ++i) {
        const Pt &prev = chain[(i + n - 1) % n];
        const Pt &cur = chain[i];
        const Pt &next = chain[(i + 1) % n];
        const double d1x = cur.x - prev.x, d1y = cur.y - prev.y;
        const double d2x = next.x - cur.x, d2y = next.y - cur.y;
        if (d1x == d2x && d1y == d2y) continue;  // interior of a straight run
        out.push_back(cur);
    }
    if (out.empty()) out.push_back(chain[0]);
    return out;
}

double shoelace_area(const std::vector<Pt> &poly) {
    double a = 0.0;
    const size_t n = poly.size();
    for (size_t i = 0; i < n; ++i) {
        const Pt &p = poly[i];
        const Pt &q = poly[(i + 1) % n];
        a += p.x * q.y - q.x * p.y;
    }
    return std::abs(a) / 2.0;
}

// largest external boundary of the nonzero pixels of `m` (max |shoelace|),
// compressed; empty when no foreground exists. Only traced boundary pixels
// are marked visited (O(perimeter), not O(area)): starts inside an
// already-traced outer border land on marked pixels, and hole-adjacent
// starts trace inner boundaries whose area can never exceed the outer
// one, so max-area selection is unaffected (the python path's
// cv2.findContours RETR_EXTERNAL + max contourArea semantics).
std::vector<Pt> largest_external_contour(Mask &m) {
    std::vector<Pt> best;
    double best_area = -1.0;
    Mask state;  // per-pixel bitmask of visited backtrack directions
    state.init(m.h, m.w, 0);
    for (int y = 0; y < m.h; ++y)
        for (int x = 0; x < m.w; ++x) {
            if (!m.at(y, x) || state.at(y, x)) continue;
            if (x > 0 && m.at(y, x - 1)) continue;  // not a border start
            std::vector<Pt> chain = trace_boundary(m, y, x, state);
            const double area = chain.size() >= 3 ? shoelace_area(chain) : 0.0;
            if (area > best_area) {
                best_area = area;
                best = std::move(chain);
            }
        }
    if (best.size() >= 3) return compress_chain(best);
    return best;
}

// ---------------------------------------------------------------------------
// per-line pipeline state

struct SeamJob {
    // prepared patch (cropped, rotated), row-major float32
    std::vector<float> patch;
    int ph = 0, pw = 0;
    // completion context
    int x0 = 0;               // crop offset in the rotated frame
    Mat2 fwd;                 // from_rot: (p + mins) @ fwd.T
    Pt mins{0, 0};
    Mask outside;             // unrotated patch-frame mask (1 = outside ROI)
    int64_t cmin = 0, rmin = 0;
    std::vector<int32_t> rows;  // carved seam rows (set by host or caller)
    bool carved = false;
};

struct LineCtx {
    bool failed = false;
    SeamJob up, bottom;
    std::vector<Pt> upper_poly, bottom_poly;  // int-valued (x, y)
    Pt ep0{0, 0}, ep1{0, 0};
    int offset = 0;
    std::vector<int32_t> result;  // final polygon, interleaved x,y
    bool done = false;
};

struct PageCtx {
    const float *feats = nullptr;
    int H = 0, W = 0;
    std::vector<LineCtx> lines;
    std::vector<int> patch_line;  // patch k -> line index
    std::vector<int> patch_slot;  // patch k -> 0 (up) / 1 (bottom)
};

// _seam_prepare port. Returns false on failure (degenerate patch).
bool seam_prepare(const PageCtx &pc, const std::vector<Pt> &baseline_int,
                  const std::vector<Pt> &polygon, double angle, SeamJob &job,
                  int bias = 150) {
    double cminf = polygon[0].x, cmaxf = polygon[0].x;
    double rminf = polygon[0].y, rmaxf = polygon[0].y;
    for (const auto &p : polygon) {
        cminf = std::min(cminf, p.x);
        cmaxf = std::max(cmaxf, p.x);
        rminf = std::min(rminf, p.y);
        rmaxf = std::max(rmaxf, p.y);
    }
    const int64_t c_min = trunc_int(cminf), c_max = trunc_int(cmaxf);
    const int64_t r_min = trunc_int(rminf), r_max = trunc_int(rmaxf);
    if (c_min < 0 || r_min < 0 || c_min >= pc.W || r_min >= pc.H) return false;
    const int64_t r_end = std::min<int64_t>(r_max + 2, pc.H);
    const int64_t c_end = std::min<int64_t>(c_max + 2, pc.W);
    const int oh = static_cast<int>(r_end - r_min);
    const int ow = static_cast<int>(c_end - c_min);
    if (oh <= 0 || ow <= 0) return false;

    std::vector<float> patch(static_cast<size_t>(oh) * ow);
    for (int y = 0; y < oh; ++y)
        std::memcpy(&patch[static_cast<size_t>(y) * ow],
                    pc.feats + (static_cast<size_t>(r_min + y) * pc.W + c_min),
                    sizeof(float) * ow);

    // distance-from-baseline bias (chessboard chamfer from the rasterized
    // baseline polyline)
    Mask blmask;
    blmask.init(oh, ow, 1);
    std::vector<Pt> bl(baseline_int.size());
    for (size_t i = 0; i < baseline_int.size(); ++i)
        bl[i] = {rint_he(baseline_int[i].x - static_cast<double>(c_min)),
                 rint_he(baseline_int[i].y - static_cast<double>(r_min))};
    draw_polyline(blmask, bl, 0);
    std::vector<float> dist_bias;
    chessboard_dist(blmask, dist_bias);

    // ROI mask, dilated 2x with a 4-connected cross
    Mask roi;
    roi.init(oh, ow, 0);
    std::vector<Pt> shifted(polygon.size());
    for (size_t i = 0; i < polygon.size(); ++i)
        shifted[i] = {polygon[i].x - static_cast<double>(c_min),
                      polygon[i].y - static_cast<double>(r_min)};
    fill_polygon(roi, shifted, 1);
    dilate_cross(roi, 2);

    double vsum = 0.0;
    size_t vcount = 0;
    for (int y = 0; y < oh; ++y)
        for (int x = 0; x < ow; ++x) {
            const size_t idx = static_cast<size_t>(y) * ow + x;
            if (!roi.at(y, x)) {
                patch[idx] = kMaskVal;
            } else {
                vsum += patch[idx];
                ++vcount;
            }
        }
    const double valid_mean = vcount ? vsum / static_cast<double>(vcount) : 1.0;
    const double scale_bias = valid_mean / bias;
    for (size_t i = 0; i < patch.size(); ++i)
        patch[i] += dist_bias[i] * static_cast<float>(scale_bias);

    // rotation to the level frame
    const Pt extrema0{baseline_int.front().x - static_cast<double>(c_min),
                      baseline_int.front().y - static_cast<double>(r_min)};
    const Pt extrema1{baseline_int.back().x - static_cast<double>(c_min),
                      baseline_int.back().y - static_cast<double>(r_min)};
    const double scale = std::min(1.0, 600.0 / std::max<int64_t>(c_max - c_min, 1));
    const double ca = std::cos(angle), sa = std::sin(angle);
    const Mat2 fwd{ca / scale, -sa, sa / scale, ca};
    const Mat2 inv = fwd.inv();
    // corners (x, y): (0,0), (0, rows-1), (cols-1, rows-1), (cols-1, 0)
    const Pt corners[4] = {{0, 0},
                           {0, static_cast<double>(oh - 1)},
                           {static_cast<double>(ow - 1), static_cast<double>(oh - 1)},
                           {static_cast<double>(ow - 1), 0}};
    double mnx = kInf, mny = kInf, mxx = -kInf, mxy = -kInf;
    for (const auto &c : corners) {
        // pts @ inv.T = inv.apply(pt)
        const Pt m = inv.apply(c);
        mnx = std::min(mnx, m.x);
        mny = std::min(mny, m.y);
        mxx = std::max(mxx, m.x);
        mxy = std::max(mxy, m.y);
    }
    const int out_h = static_cast<int>(rint_he(mxy - mny + 1));
    const int out_w = static_cast<int>(rint_he(mxx - mnx + 1));
    if (out_h <= 0 || out_w <= 0) return false;
    const Pt mins{mnx, mny};

    // to_rot of the extrema x-coordinates determines the crop
    const Pt re0 = inv.apply(extrema0);
    const Pt re1 = inv.apply(extrema1);
    double xr0 = rint_he(re0.x - mins.x), xr1 = rint_he(re1.x - mins.x);
    if (xr0 > xr1) std::swap(xr0, xr1);
    const int x0 = std::max(0, static_cast<int>(xr0));
    const int x1 = std::min(out_w - 1, static_cast<int>(xr1));
    if (x1 <= x0) return false;  // degenerate rotated patch

    // inverse-map bilinear warp of the cropped columns only; the source
    // point advances by fwd's first column per x step, so the inner loop is
    // incremental, with a branch-free interior fast path
    const int cw = x1 - x0 + 1;
    job.patch.assign(static_cast<size_t>(out_h) * cw, kMaskVal);
    for (int y = 0; y < out_h; ++y) {
        const Pt row0 = fwd.apply({static_cast<double>(x0) + mins.x,
                                   static_cast<double>(y) + mins.y});
        double sx = row0.x, sy = row0.y;
        float *orow = &job.patch[static_cast<size_t>(y) * cw];
        for (int x = 0; x < cw; ++x, sx += fwd.a, sy += fwd.c) {
            const int ix = static_cast<int>(std::floor(sx));
            const int iy = static_cast<int>(std::floor(sy));
            const double fx = sx - ix, fy = sy - iy;
            double v;
            if (ix >= 0 && ix + 1 < ow && iy >= 0 && iy + 1 < oh) {
                const float *p0 = &patch[static_cast<size_t>(iy) * ow + ix];
                v = (1 - fy) * ((1 - fx) * p0[0] + fx * p0[1]) +
                    fy * ((1 - fx) * p0[ow] + fx * p0[ow + 1]);
            } else {
                auto sample = [&](int yy, int xx) -> double {
                    if (yy < 0 || yy >= oh || xx < 0 || xx >= ow)
                        return static_cast<double>(kMaskVal);
                    return patch[static_cast<size_t>(yy) * ow + xx];
                };
                v = (1 - fy) * ((1 - fx) * sample(iy, ix) + fx * sample(iy, ix + 1)) +
                    fy * ((1 - fx) * sample(iy + 1, ix) + fx * sample(iy + 1, ix + 1));
            }
            orow[x] = static_cast<float>(v);
        }
    }
    job.ph = out_h;
    job.pw = cw;
    job.x0 = x0;
    job.fwd = fwd;
    job.mins = mins;
    job.cmin = c_min;
    job.rmin = r_min;
    // keep the outside mask for the seam-point filter
    job.outside.init(oh, ow, 0);
    for (int y = 0; y < oh; ++y)
        for (int x = 0; x < ow; ++x)
            job.outside.v[static_cast<size_t>(y) * ow + x] = roi.at(y, x) ? 0 : 1;
    return true;
}

// finish(): seam rows -> absolute (x, y) seam points. Returns false when
// fewer than 2 valid points survive.
bool seam_finish(const SeamJob &job, std::vector<Pt> &out) {
    const int n = job.pw;
    // mean/std clip of the row track
    double mean = 0.0;
    for (int i = 0; i < n; ++i) mean += job.rows[i];
    mean /= n;
    double var = 0.0;
    for (int i = 0; i < n; ++i) {
        const double d = job.rows[i] - mean;
        var += d * d;
    }
    const double stdv = std::sqrt(var / n);
    out.clear();
    out.reserve(n);
    for (int i = 0; i < n; ++i) {
        const double ry = std::min(std::max(static_cast<double>(job.rows[i]),
                                            mean - stdv),
                                   mean + stdv);
        // from_rot: (pt + mins) @ fwd.T
        const Pt p = job.fwd.apply({static_cast<double>(job.x0 + i) + job.mins.x,
                                    ry + job.mins.y});
        const int64_t xi = trunc_int(p.x);
        const int64_t yi = trunc_int(p.y);
        if (xi < 0 || yi < 0 || xi >= job.outside.w || yi >= job.outside.h) continue;
        if (job.outside.at(static_cast<int>(yi), static_cast<int>(xi))) continue;
        out.push_back({static_cast<double>(xi + job.cmin),
                       static_cast<double>(yi + job.rmin)});
    }
    return out.size() >= 2;
}

// complete(): the two carved seams -> final bounding polygon
bool complete_line(LineCtx &lc) {
    std::vector<Pt> seam_u, seam_b;
    if (!seam_finish(lc.up, seam_u) || !seam_finish(lc.bottom, seam_b)) return false;
    std::vector<Pt> upper = rdp(seam_u, 5.0);
    std::vector<Pt> bottom = rdp(seam_b, 5.0);
    for (auto &p : upper) p = {static_cast<double>(trunc_int(p.x)), static_cast<double>(trunc_int(p.y))};
    for (auto &p : bottom) p = {static_cast<double>(trunc_int(p.x)), static_cast<double>(trunc_int(p.y))};
    if (lc.offset) {
        upper = offset_polyline(upper, lc.offset / 2, false);   // 'right'
        bottom = offset_polyline(bottom, lc.offset / 2, true);  // 'left'
        for (auto &p : upper) p = {rint_he(p.x), rint_he(p.y)};
        for (auto &p : bottom) p = {rint_he(p.x), rint_he(p.y)};
    }
    std::vector<Pt> polygon;
    polygon.push_back(lc.ep0);
    polygon.insert(polygon.end(), upper.begin(), upper.end());
    polygon.push_back(lc.ep1);
    polygon.insert(polygon.end(), bottom.rbegin(), bottom.rend());

    double mnx = kInf, mny = kInf, mxx = -kInf, mxy = -kInf;
    auto extend = [&](const std::vector<Pt> &ps) {
        for (const auto &p : ps) {
            mnx = std::min(mnx, p.x);
            mny = std::min(mny, p.y);
            mxx = std::max(mxx, p.x);
            mxy = std::max(mxy, p.y);
        }
    };
    extend(polygon);
    extend(lc.upper_poly);
    extend(lc.bottom_poly);
    const int64_t c0 = static_cast<int64_t>(std::floor(mnx)) - 1;
    const int64_t r0 = static_cast<int64_t>(std::floor(mny)) - 1;
    const int64_t c1 = static_cast<int64_t>(std::ceil(mxx)) + 2;
    const int64_t r1 = static_cast<int64_t>(std::ceil(mxy)) + 2;
    const int sh = static_cast<int>(r1 - r0), sw = static_cast<int>(c1 - c0);
    if (sh <= 0 || sw <= 0 || static_cast<int64_t>(sh) * sw > (1 << 28)) return false;
    Mask roi, cand;
    roi.init(sh, sw, 0);
    cand.init(sh, sw, 0);
    auto shift = [&](const std::vector<Pt> &ps) {
        std::vector<Pt> out(ps.size());
        for (size_t i = 0; i < ps.size(); ++i)
            out[i] = {ps[i].x - static_cast<double>(c0), ps[i].y - static_cast<double>(r0)};
        return out;
    };
    fill_polygon(roi, shift(lc.upper_poly), 1);
    fill_polygon(roi, shift(lc.bottom_poly), 1);
    fill_polygon(cand, shift(polygon), 1);
    Mask inter;
    inter.init(sh, sw, 0);
    bool any = false;
    for (size_t i = 0; i < inter.v.size(); ++i) {
        inter.v[i] = roi.v[i] & cand.v[i];
        any |= inter.v[i] != 0;
    }
    if (!any) return false;  // empty ROI/seam intersection
    std::vector<Pt> boundary = largest_external_contour(inter);
    if (boundary.size() < 3) return false;  // degenerate bounding polygon
    lc.result.clear();
    lc.result.reserve(boundary.size() * 2);
    for (const auto &p : boundary) {
        lc.result.push_back(static_cast<int32_t>(p.x + c0));
        lc.result.push_back(static_cast<int32_t>(p.y + r0));
    }
    return true;
}

}  // namespace

extern "C" {

// Prepares every baseline of a page for polygonization.
//
//   feats:       (H, W) float32 energy map (gradient feature map).
//   pts:         flat (x, y) float64 pairs of all polylines, baselines
//                first; poly_off[n_polys + 1] delimits them.
//   n_baselines: the first n_baselines polylines are polygonized; for line
//                i the boundary set is every other baseline plus the extras
//                listed in extra_idx[extra_off[i]:extra_off[i+1]] (indices
//                into the full polyline array).
//   topline:     0 = baseline (offset below), 1 = topline (offset above),
//                -1 = centerline (no offset).
//
// Returns an opaque context for the polyg_* accessors (free with
// polyg_free), or nullptr on allocation failure.
void *polyg_prepare(const float *feats, int H, int W, const double *pts,
                    const int64_t *poly_off, int n_polys, int n_baselines,
                    const int32_t *extra_idx, const int64_t *extra_off,
                    int topline) {
    auto *pc = new (std::nothrow) PageCtx();
    if (!pc) return nullptr;
    pc->feats = feats;
    pc->H = H;
    pc->W = W;
    pc->lines.resize(n_baselines);

    std::vector<std::vector<Pt>> polys(n_polys);
    for (int i = 0; i < n_polys; ++i) {
        const int64_t a = poly_off[i], b = poly_off[i + 1];
        polys[i].resize(b - a);
        for (int64_t k = a; k < b; ++k)
            polys[i][k - a] = {pts[2 * k], pts[2 * k + 1]};
    }
    // precomputed segment soup per polyline (AABBs for pruning)
    std::vector<std::vector<Segment>> poly_segs(n_polys);
    for (int i = 0; i < n_polys; ++i) {
        const auto &p = polys[i];
        auto &segs = poly_segs[i];
        segs.reserve(p.size() > 0 ? p.size() - 1 : 0);
        for (size_t k = 0; k + 1 < p.size(); ++k) {
            Segment s{p[k], p[k + 1], 0, 0, 0, 0};
            s.xmin = std::min(s.a.x, s.b.x);
            s.xmax = std::max(s.a.x, s.b.x);
            s.ymin = std::min(s.a.y, s.b.y);
            s.ymax = std::max(s.a.y, s.b.y);
            segs.push_back(s);
        }
    }
    const double bx = W - 1, by = H - 1;

    for (int i = 0; i < n_baselines; ++i) {
        LineCtx &lc = pc->lines[i];
        const std::vector<Pt> &line = polys[i];
        if (line.size() < 2) {
            lc.failed = true;
            continue;
        }
        // direction + angle
        double sdx = 0.0, sdy = 0.0, total = 0.0;
        std::vector<double> seglen(line.size() - 1);
        for (size_t k = 0; k + 1 < line.size(); ++k) {
            seglen[k] = std::hypot(line[k + 1].x - line[k].x, line[k + 1].y - line[k].y);
            total += seglen[k];
        }
        if (total <= 0) {
            lc.failed = true;
            continue;
        }
        for (size_t k = 0; k + 1 < line.size(); ++k) {
            sdx += (line[k + 1].x - line[k].x) * (seglen[k] / total);
            sdy += (line[k + 1].y - line[k].y) * (seglen[k] / total);
        }
        const double pn = std::hypot(sdx, sdy);
        if (pn <= 0 || !std::isfinite(pn)) {
            lc.failed = true;
            continue;
        }
        const Pt p_dir{sdx / pn, sdy / pn};

        lc.offset = topline >= 0 ? 8 : 0;
        const std::vector<Pt> offset_line =
            offset_polyline(line, lc.offset, /*left=*/topline == 1);

        // boundary segment soup for this line
        std::vector<Segment> segs;
        for (int j = 0; j < n_baselines; ++j) {
            if (j == i) continue;
            segs.insert(segs.end(), poly_segs[j].begin(), poly_segs[j].end());
        }
        if (extra_idx && extra_off) {
            for (int64_t k = extra_off[i]; k < extra_off[i + 1]; ++k) {
                const int32_t e = extra_idx[k];
                // extras indexing a baseline are already in the soup (every
                // other baseline is included above; self is excluded)
                if (e >= n_baselines && e < n_polys)
                    segs.insert(segs.end(), poly_segs[e].begin(), poly_segs[e].end());
            }
        }

        // ROI envelopes: up = (p_dir * (-1, 1))[::-1], down = (p_dir * (1, -1))[::-1]
        const Pt up_dir{p_dir.y, -p_dir.x};
        const Pt down_dir{-p_dir.y, p_dir.x};
        const std::vector<Pt> ip = interpolate_polyline(line);
        std::vector<Pt> env_up, env_bottom;
        if (!roi_env(ip, up_dir, bx, by, segs, env_up) ||
            !roi_env(ip, down_dir, bx, by, segs, env_bottom)) {
            lc.failed = true;
            continue;
        }
        // astype(int).clip(0)
        for (auto &p : env_up)
            p = {static_cast<double>(std::max<int64_t>(trunc_int(p.x), 0)),
                 static_cast<double>(std::max<int64_t>(trunc_int(p.y), 0))};
        for (auto &p : env_bottom)
            p = {static_cast<double>(std::max<int64_t>(trunc_int(p.x), 0)),
                 static_cast<double>(std::max<int64_t>(trunc_int(p.y), 0))};

        // int-cast baselines (the Python path passes line.astype(int))
        std::vector<Pt> line_i(line.size()), off_i(offset_line.size());
        for (size_t k = 0; k < line.size(); ++k)
            line_i[k] = {static_cast<double>(trunc_int(line[k].x)),
                         static_cast<double>(trunc_int(line[k].y))};
        for (size_t k = 0; k < offset_line.size(); ++k)
            off_i[k] = {static_cast<double>(trunc_int(offset_line[k].x)),
                        static_cast<double>(trunc_int(offset_line[k].y))};
        lc.ep0 = line_i.front();
        lc.ep1 = line_i.back();

        // the four candidate polygons
        auto concat_rev = [](const std::vector<Pt> &a, const std::vector<Pt> &b) {
            std::vector<Pt> out(a);
            out.insert(out.end(), b.rbegin(), b.rend());
            return out;
        };
        lc.upper_poly = concat_rev(line_i, env_up);
        lc.bottom_poly = concat_rev(line_i, env_bottom);
        const std::vector<Pt> upper_off = concat_rev(off_i, env_up);
        const std::vector<Pt> bottom_off = concat_rev(off_i, env_bottom);

        // seam angle from the int-cast baseline (as _prepare_seams does)
        double sdx2 = 0.0, sdy2 = 0.0, total2 = 0.0;
        for (size_t k = 0; k + 1 < line_i.size(); ++k) {
            const double l = std::hypot(line_i[k + 1].x - line_i[k].x,
                                        line_i[k + 1].y - line_i[k].y);
            total2 += l;
        }
        if (total2 <= 0) {
            lc.failed = true;
            continue;
        }
        for (size_t k = 0; k + 1 < line_i.size(); ++k) {
            const double l = std::hypot(line_i[k + 1].x - line_i[k].x,
                                        line_i[k + 1].y - line_i[k].y);
            sdx2 += (line_i[k + 1].x - line_i[k].x) * (l / total2);
            sdy2 += (line_i[k + 1].y - line_i[k].y) * (l / total2);
        }
        const double pn2 = std::hypot(sdx2, sdy2);
        if (pn2 <= 0 || !std::isfinite(pn2)) {
            lc.failed = true;
            continue;
        }
        const double angle = std::atan2(sdy2 / pn2, sdx2 / pn2);

        bool ok;
        if (topline == 1) {
            ok = seam_prepare(*pc, line_i, lc.upper_poly, angle, lc.up) &&
                 seam_prepare(*pc, off_i, bottom_off, angle, lc.bottom);
        } else {
            ok = seam_prepare(*pc, off_i, upper_off, angle, lc.up) &&
                 seam_prepare(*pc, line_i, lc.bottom_poly, angle, lc.bottom);
        }
        if (!ok) {
            lc.failed = true;
            continue;
        }
    }
    for (int i = 0; i < n_baselines; ++i) {
        if (pc->lines[i].failed) continue;
        pc->patch_line.push_back(i);
        pc->patch_slot.push_back(0);
        pc->patch_line.push_back(i);
        pc->patch_slot.push_back(1);
    }
    return pc;
}

int polyg_n_patches(void *ctx) {
    return static_cast<int>(static_cast<PageCtx *>(ctx)->patch_line.size());
}

// dims: (n_patches, 2) int32 (h, w)
void polyg_patch_dims(void *ctx, int32_t *dims) {
    auto *pc = static_cast<PageCtx *>(ctx);
    for (size_t k = 0; k < pc->patch_line.size(); ++k) {
        const LineCtx &lc = pc->lines[pc->patch_line[k]];
        const SeamJob &job = pc->patch_slot[k] == 0 ? lc.up : lc.bottom;
        dims[2 * k] = job.ph;
        dims[2 * k + 1] = job.pw;
    }
}

void polyg_copy_patch(void *ctx, int k, float *out) {
    auto *pc = static_cast<PageCtx *>(ctx);
    const LineCtx &lc = pc->lines[pc->patch_line[k]];
    const SeamJob &job = pc->patch_slot[k] == 0 ? lc.up : lc.bottom;
    std::memcpy(out, job.patch.data(), job.patch.size() * sizeof(float));
}

// feeds externally carved seam rows (length = patch width, pad offset
// already removed) for patch k
void polyg_set_rows(void *ctx, int k, const int32_t *rows) {
    auto *pc = static_cast<PageCtx *>(ctx);
    LineCtx &lc = pc->lines[pc->patch_line[k]];
    SeamJob &job = pc->patch_slot[k] == 0 ? lc.up : lc.bottom;
    job.rows.assign(rows, rows + job.pw);
    job.carved = true;
}

// carves every prepared patch with the native DP
void polyg_carve(void *ctx) {
    auto *pc = static_cast<PageCtx *>(ctx);
    for (size_t k = 0; k < pc->patch_line.size(); ++k) {
        LineCtx &lc = pc->lines[pc->patch_line[k]];
        SeamJob &job = pc->patch_slot[k] == 0 ? lc.up : lc.bottom;
        if (job.carved) continue;
        carve_seam_rows(job.patch, job.ph, job.pw, job.rows);
        job.carved = true;
    }
}

// completes every carved line; returns the number of successful polygons
int polyg_complete(void *ctx) {
    auto *pc = static_cast<PageCtx *>(ctx);
    int ok = 0;
    for (auto &lc : pc->lines) {
        if (lc.failed || lc.done) continue;
        if (!lc.up.carved || !lc.bottom.carved) {
            lc.failed = true;
            continue;
        }
        if (complete_line(lc)) {
            lc.done = true;
            ++ok;
        } else {
            lc.failed = true;
        }
    }
    return ok;
}

// result length in points for line i (-1 = failed)
int polyg_result_len(void *ctx, int i) {
    const LineCtx &lc = static_cast<PageCtx *>(ctx)->lines[i];
    if (lc.failed || !lc.done) return -1;
    return static_cast<int>(lc.result.size() / 2);
}

void polyg_result(void *ctx, int i, int32_t *out_xy) {
    const LineCtx &lc = static_cast<PageCtx *>(ctx)->lines[i];
    std::memcpy(out_xy, lc.result.data(), lc.result.size() * sizeof(int32_t));
}

void polyg_free(void *ctx) { delete static_cast<PageCtx *>(ctx); }

// test shims for the rasterization primitives (exercised by the unit tests
// in tests/test_native_polygonize.py; not used on the production path)
void dbg_fill_polygon(int h, int w, const double *xy, int n, uint8_t *out) {
    Mask m;
    m.init(h, w, 0);
    std::vector<Pt> poly(n);
    for (int i = 0; i < n; ++i) poly[i] = {xy[2 * i], xy[2 * i + 1]};
    fill_polygon(m, poly, 1);
    std::memcpy(out, m.v.data(), m.v.size());
}

int dbg_largest_contour(int h, int w, const uint8_t *mask, int32_t *out_xy,
                        int cap) {
    Mask m;
    m.init(h, w, 0);
    std::memcpy(m.v.data(), mask, m.v.size());
    std::vector<Pt> c = largest_external_contour(m);
    const int n = std::min<int>(static_cast<int>(c.size()), cap);
    for (int i = 0; i < n; ++i) {
        out_xy[2 * i] = static_cast<int32_t>(c[i].x);
        out_xy[2 * i + 1] = static_cast<int32_t>(c[i].y);
    }
    return static_cast<int>(c.size());
}

}  // extern "C"
