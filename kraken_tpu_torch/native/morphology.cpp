// Native connected-component labeling (4-connectivity) and bounding-box
// scan for the legacy page segmenter's hot loop — drop-in equivalents of
// scipy.ndimage.label (default cross structure) and find_objects, whose
// per-call overheads dominated the pageseg stage budget (~80 ms/page of
// the flagship leg).
//
// Output contract: labels are numbered 1..n in raster order of each
// component's first pixel — scipy.ndimage.label's numbering — so results
// are array-identical (pinned by tests/test_pageseg.py randomized
// equality tests).
#include <cstdint>
#include <vector>

namespace {

int32_t find_root(std::vector<int32_t>& parent, int32_t x) {
    int32_t root = x;
    while (parent[root] != root) root = parent[root];
    // path compression
    while (parent[x] != root) {
        int32_t next = parent[x];
        parent[x] = root;
        x = next;
    }
    return root;
}

inline void unite(std::vector<int32_t>& parent, int32_t a, int32_t b) {
    int32_t ra = find_root(parent, a);
    int32_t rb = find_root(parent, b);
    if (ra == rb) return;
    if (ra < rb) parent[rb] = ra; else parent[ra] = rb;
}

}  // namespace

extern "C" {

// img: (h, w) uint8 (nonzero = foreground); out: (h, w) int32.
// Returns the number of components.
int64_t label4_u8(const uint8_t* img, int64_t h, int64_t w, int32_t* out) {
    std::vector<int32_t> parent;
    parent.reserve(1024);
    parent.push_back(0);  // background sentinel
    // first pass: provisional labels, merging up/left (4-connectivity)
    for (int64_t r = 0; r < h; ++r) {
        const uint8_t* row = img + r * w;
        int32_t* orow = out + r * w;
        const int32_t* up = r > 0 ? out + (r - 1) * w : nullptr;
        for (int64_t c = 0; c < w; ++c) {
            if (!row[c]) { orow[c] = 0; continue; }
            int32_t left = c > 0 ? orow[c - 1] : 0;
            int32_t above = up ? up[c] : 0;
            if (left && above) {
                orow[c] = left;
                if (left != above) unite(parent, left, above);
            } else if (left) {
                orow[c] = left;
            } else if (above) {
                orow[c] = above;
            } else {
                int32_t fresh = static_cast<int32_t>(parent.size());
                parent.push_back(fresh);
                orow[c] = fresh;
            }
        }
    }
    // second pass: final labels in raster order of first encounter
    std::vector<int32_t> final_of(parent.size(), 0);
    int32_t n = 0;
    int64_t total = h * w;
    for (int64_t i = 0; i < total; ++i) {
        int32_t p = out[i];
        if (!p) continue;
        int32_t root = find_root(parent, p);
        if (!final_of[root]) final_of[root] = ++n;
        out[i] = final_of[root];
    }
    return n;
}

// labels: (h, w) int32 with values in [0, n]; boxes: (n, 4) int64 rows of
// (rmin, rmax_exclusive, cmin, cmax_exclusive); labels that never occur
// get rmin = -1 (the caller emits None, as scipy.ndimage.find_objects).
void find_objects_i32(const int32_t* labels, int64_t h, int64_t w,
                      int64_t n, int64_t* boxes) {
    for (int64_t i = 0; i < n; ++i) {
        boxes[i * 4 + 0] = -1;
        boxes[i * 4 + 1] = -1;
        boxes[i * 4 + 2] = -1;
        boxes[i * 4 + 3] = -1;
    }
    for (int64_t r = 0; r < h; ++r) {
        const int32_t* row = labels + r * w;
        for (int64_t c = 0; c < w; ++c) {
            int32_t v = row[c];
            if (v <= 0 || v > n) continue;
            int64_t* b = boxes + static_cast<int64_t>(v - 1) * 4;
            if (b[0] < 0) {
                b[0] = r; b[1] = r + 1; b[2] = c; b[3] = c + 1;
            } else {
                if (r + 1 > b[1]) b[1] = r + 1;
                if (c < b[2]) b[2] = c;
                if (c + 1 > b[3]) b[3] = c + 1;
            }
        }
    }
}

}  // extern "C"
