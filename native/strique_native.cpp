// Native host runtime for strique_tpu.
//
// The device owns the DP compute path (native/strique_cuda.cu on a GPU, lax
// elsewhere); this library owns the
// host-side hot loops around it, mirroring where the reference kept native
// code (reference src/align_raw.h, src/score_distance.h):
//
//   * per-read signal preprocessing (median filter, uint8 quantization,
//     greyscale open/close, minmax tail statistics) — the per-read host
//     cost that feeds the device pipeline;
//   * a full semi-global affine-gap CPU aligner with traceback — an
//     engine-parity fallback for hosts without an accelerator and the
//     float32 oracle for kernel tests.
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 dependency).
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// preprocessing
// ---------------------------------------------------------------------------

// Median filter kernel 3 with zero-padded edges (scipy.signal.medfilt).
void medfilt3_f64(const double* x, int64_t n, double* out) {
    if (n == 0) return;
    auto med3 = [](double a, double b, double c) {
        double lo = std::min(a, b), hi = std::max(a, b);
        return std::max(lo, std::min(hi, c));
    };
    out[0] = med3(0.0, x[0], n > 1 ? x[1] : 0.0);
    for (int64_t i = 1; i + 1 < n; ++i) out[i] = med3(x[i - 1], x[i], x[i + 1]);
    if (n > 1) out[n - 1] = med3(x[n - 2], x[n - 1], 0.0);
}

static double median_inplace(std::vector<double>& v) {
    if (v.empty()) return std::nan("");
    size_t mid = v.size() / 2;
    std::nth_element(v.begin(), v.begin() + mid, v.end());
    double hi = v[mid];
    if (v.size() % 2) return hi;
    std::nth_element(v.begin(), v.begin() + mid - 1, v.begin() + mid);
    return 0.5 * (v[mid - 1] + hi);
}

// Mean absolute deviation about the median (reference STRique.py:142-143).
double mad_f64(const double* x, int64_t n) {
    std::vector<double> v(x, x + n);
    double med = median_inplace(v);
    double s = 0;
    for (int64_t i = 0; i < n; ++i) s += std::fabs(x[i] - med);
    return s / n;
}

double median_f64(const double* x, int64_t n) {
    std::vector<double> v(x, x + n);
    return median_inplace(v);
}

// np.clip semantics: NaN propagates (std::min/max would clamp it to a
// bound, silently diverging from the NumPy reference on degenerate
// signals whose percentile tails are empty).
static inline double clip_np(double v, double lo, double hi) {
    if (v < lo) return lo;
    if (v > hi) return hi;
    return v;  // covers NaN
}

// Windowed min/max with clip-to-valid borders; erosion window [-l, w-1-l],
// dilation [-(w-1-l), +l] (scipy.ndimage grey ops, even footprint).
// van Herk / Gil-Werman sliding extremum: per block of w samples compute a
// forward prefix extremum and a backward suffix extremum, then every
// window [a, b] (b - a + 1 == w) straddles at most one block boundary and
// equals ext(suffix[a], prefix[b]).  Three branch-free linear passes the
// compiler vectorizes, replacing the branchy monotonic deque (which was
// itself ~2x the vH-GW cost).  Pure selection over the same value sets —
// bit-identical to the direct min/max scan.
static void win_reduce(const double* x, int64_t n, int left, int right, bool is_min,
                       double* out) {
    if (n == 0) return;
    const int64_t w = (int64_t)left + right + 1;
    static thread_local std::vector<double> pre_buf, suf_buf;
    pre_buf.resize(n);
    suf_buf.resize(n);
    double* pre = pre_buf.data();
    double* suf = suf_buf.data();
    for (int64_t s = 0; s < n; s += w) {
        int64_t e = std::min(s + w, n);
        double acc = x[s];
        pre[s] = acc;
        if (is_min)
            for (int64_t i = s + 1; i < e; ++i) pre[i] = acc = std::min(acc, x[i]);
        else
            for (int64_t i = s + 1; i < e; ++i) pre[i] = acc = std::max(acc, x[i]);
        acc = x[e - 1];
        suf[e - 1] = acc;
        if (is_min)
            for (int64_t i = e - 2; i >= s; --i) suf[i] = acc = std::min(acc, x[i]);
        else
            for (int64_t i = e - 2; i >= s; --i) suf[i] = acc = std::max(acc, x[i]);
    }
    // left-clipped windows [0, i+right]: i + right < w, so the window lies
    // inside block 0 and prefix[b] covers exactly [0, b]
    int64_t i = 0;
    for (int64_t stop = std::min<int64_t>(left, n); i < stop; ++i)
        out[i] = pre[std::min<int64_t>(i + right, n - 1)];
    // interior full windows: straddle (or exactly fill) blocks — the
    // suffix/prefix union covers exactly [i-left, i+right]
    int64_t end_main = n - right;
    if (is_min)
        for (; i < end_main; ++i) out[i] = std::min(suf[i - left], pre[i + right]);
    else
        for (; i < end_main; ++i) out[i] = std::max(suf[i - left], pre[i + right]);
    // right-clipped windows [i-left, n-1]: suffix[a] alone when a sits in
    // the last block, else suffix[a] + the last block's full prefix
    for (; i < n; ++i) {
        int64_t a = i - left;
        if (a / w == (n - 1) / w)
            out[i] = suf[a];
        else
            out[i] = is_min ? std::min(suf[a], pre[n - 1])
                            : std::max(suf[a], pre[n - 1]);
    }
}

// quantize + open/close chain (reference STRique.py:591-595); w = 8.
void morph_open_close_f64(const double* flt, int64_t n, double med, double mad,
                          double* out) {
    const int w = 8, l = w / 2;
    std::vector<double> q(n), t(n);
    for (int64_t i = 0; i < n; ++i) {
        double v = (flt[i] - med) / mad * 24.0 + 127.0;
        v = std::min(255.0, std::max(0.0, v));
        q[i] = std::floor(v);
    }
    win_reduce(q.data(), n, l, w - 1 - l, true, t.data());    // erode
    win_reduce(t.data(), n, w - 1 - l, l, false, q.data());   // dilate (open)
    win_reduce(q.data(), n, w - 1 - l, l, false, t.data());   // dilate
    win_reduce(t.data(), n, l, w - 1 - l, true, out);         // erode (close)
}

// Percentile anchor positions (numpy linear interpolation); the exact
// expressions below are the bit-identity contract shared by every tail
// implementation in this file (selection, histogram, fused flt stats).
struct TailAnchors { int64_t lo1, hi1, lo99, hi99; double w1, w99; };

static TailAnchors tail_anchors(int64_t n) {
    auto anchor = [&](double q, int64_t* lo, int64_t* hi, double* w) {
        double pos = (n - 1) * q / 100.0;
        *lo = (int64_t)std::floor(pos);
        *hi = std::min(*lo + 1, n - 1);
        *w = pos - *lo;
    };
    TailAnchors a;
    anchor(1.0, &a.lo1, &a.hi1, &a.w1);
    anchor(99.0, &a.lo99, &a.hi99, &a.w99);
    return a;
}

// Selection-based tail medians over a caller-supplied scratch copy ``v``
// of ``x`` (nth_element is permutation-independent, so callers may have
// already run other selections on v — results stay bit-identical).
static void minmax_tails_core(std::vector<double>& v, const double* x, int64_t n,
                              double* m5, double* m95) {
    TailAnchors a = tail_anchors(n);
    // partition: ranks [0, hi1] at the front, ranks [lo99, n) at the back
    std::nth_element(v.begin(), v.begin() + a.hi1, v.end());
    std::sort(v.begin(), v.begin() + a.hi1 + 1);
    std::nth_element(v.begin() + a.hi1 + 1, v.begin() + std::max(a.lo99, a.hi1 + 1), v.end());
    std::sort(v.begin() + std::max(a.lo99, a.hi1 + 1), v.end());
    double q5 = v[a.lo1] * (1.0 - a.w1) + v[a.hi1] * a.w1;
    double q95 = v[a.lo99] * (1.0 - a.w99) + v[a.hi99] * a.w99;
    // tail sizes by linear count over the raw data (a range-limited
    // binary search misses tail elements that land in the *other* sorted
    // block when the blocks touch at tiny n, e.g. n == 2);
    // the tail ranks themselves always lie inside the sorted regions:
    // q5 <= v[hi1] pins ranks [0, c5) into the sorted front, and
    // q95 >= v[lo99] pins ranks [n - c95, n) into the sorted back
    // (or, at tiny n, the two blocks jointly cover the whole array).
    int64_t c5 = 0, c95 = 0;
    for (int64_t i = 0; i < n; ++i) {
        c5 += x[i] < q5;
        c95 += x[i] > q95;
    }
    *m5 = c5 ? 0.5 * (v[(c5 - 1) / 2] + v[c5 / 2]) : std::nan("");
    *m95 = c95 ? 0.5 * (v[n - c95 + (c95 - 1) / 2] + v[n - c95 + c95 / 2]) : std::nan("");
}

// Tail medians for minmax normalization (reference STRique.py:152-158).
// Returns m5 and m95: medians of the <1st / >99th percentile tails.
// Selection-based: only the ~n/100 elements of each tail are ever sorted
// (two nth_element partitions + two tiny sorts), replacing the full
// O(n log n) sort that dominated per-read prep.  Every output is an exact
// function of order statistics, so results are bit-identical to the
// sort-everything version.
void minmax_tails_f64(const double* x, int64_t n, double* m5, double* m95) {
    std::vector<double> v(x, x + n);
    minmax_tails_core(v, x, n, m5, m95);
}

// Tail medians of the quantized morph channel via a 256-bin histogram.
// The open/close output consists of exact integers 0..255 (floor-quantized
// bins survive grey morphology unchanged), so every order statistic the
// generic minmax_tails_f64 selects is a histogram lookup: one O(n) count
// pass replaces two nth_element partitions over a scratch copy.  The
// interpolation/count/median expressions replicate minmax_tails_f64
// operation-for-operation, so results are bit-identical.
static void minmax_tails_hist256(const double* x, int64_t n, double* m5, double* m95) {
    int64_t hist[256] = {0};
    for (int64_t i = 0; i < n; ++i) ++hist[(int)x[i]];
    int64_t cum[257];
    cum[0] = 0;
    for (int v = 0; v < 256; ++v) cum[v + 1] = cum[v] + hist[v];
    auto kth = [&](int64_t k) -> double {  // 0-based order statistic
        int v = 0;
        while (cum[v + 1] <= k) ++v;
        return (double)v;
    };
    TailAnchors a = tail_anchors(n);
    double q5 = kth(a.lo1) * (1.0 - a.w1) + kth(a.hi1) * a.w1;
    double q95 = kth(a.lo99) * (1.0 - a.w99) + kth(a.hi99) * a.w99;
    int64_t c5 = 0, c95 = 0;
    for (int v = 0; v < 256; ++v) {
        if ((double)v < q5) c5 += hist[v];
        if ((double)v > q95) c95 += hist[v];
    }
    *m5 = c5 ? 0.5 * (kth((c5 - 1) / 2) + kth(c5 / 2)) : std::nan("");
    *m95 = c95 ? 0.5 * (kth(n - c95 + (c95 - 1) / 2) + kth(n - c95 + c95 / 2))
               : std::nan("");
}

// med + MAD + minmax tail medians of the flt channel from ONE scratch copy
// (the standalone helpers each re-copy the channel; the nth_element
// partitions are permutation-independent, so chaining all three
// selections on one buffer is bit-identical).
static void flt_stats(const double* x, int64_t n, double* med, double* mad,
                      double* m5, double* m95) {
    static thread_local std::vector<double> v;
    v.assign(x, x + n);
    *med = median_inplace(v);
    double s = 0;
    for (int64_t i = 0; i < n; ++i) s += std::fabs(x[i] - *med);
    *mad = s / n;
    minmax_tails_core(v, x, n, m5, m95);
}

// Full per-read preprocessing: raw signal -> normalized morph/flt channels.
// model[4] = {m5_mod, m95_mod, clip_lo, clip_hi}.
void preprocess_read(const double* raw, int64_t n, const double* model,
                     double* morph_n, double* flt_n) {
    std::vector<double> flt(n), morph(n);
    medfilt3_f64(raw, n, flt.data());
    double med, mad, f5, f95;
    flt_stats(flt.data(), n, &med, &mad, &f5, &f95);
    morph_open_close_f64(flt.data(), n, med, mad, morph.data());
    auto norm = [&](const double* ch, double m5, double m95, double* out) {
        double half_sig = (m95 - m5) / 2.0, mid_sig = m5 + half_sig;
        double half_mod = (model[1] - model[0]) / 2.0, mid_mod = model[0] + half_mod;
        double scale = half_mod / half_sig, off = mid_mod - mid_sig * scale;
        for (int64_t i = 0; i < n; ++i)
            out[i] = clip_np(ch[i] * scale + off, model[2], model[3]);
    };
    double mo5, mo95;
    minmax_tails_hist256(morph.data(), n, &mo5, &mo95);
    norm(morph.data(), mo5, mo95, morph_n);
    norm(flt.data(), f5, f95, flt_n);
}

// Upload-oriented preprocessing: same math as preprocess_read, but the
// morph channel is returned as its uint8 quantization bins plus a 256-entry
// float32 level table (morph is floor-quantized to 0..255 before the
// minmax affine, so bins+LUT reproduce the float32 morph bit-exactly at a
// quarter of the transfer bytes); flt is returned as float32 directly.
void preprocess_read_lut(const double* raw, int64_t n, const double* model,
                         float* flt32, double* flt64, uint8_t* q_out,
                         float* lut256) {
    std::vector<double> flt(n), morph(n);
    medfilt3_f64(raw, n, flt.data());
    double med, mad, f5, f95;
    flt_stats(flt.data(), n, &med, &mad, &f5, &f95);
    morph_open_close_f64(flt.data(), n, med, mad, morph.data());
    auto affine = [&](double m5, double m95) {
        double half_sig = (m95 - m5) / 2.0, mid_sig = m5 + half_sig;
        double half_mod = (model[1] - model[0]) / 2.0, mid_mod = model[0] + half_mod;
        double scale = half_mod / half_sig;
        return std::pair<double, double>(scale, mid_mod - mid_sig * scale);
    };
    double mo5, mo95;
    minmax_tails_hist256(morph.data(), n, &mo5, &mo95);
    auto mo = affine(mo5, mo95);
    for (int64_t i = 0; i < n; ++i)
        q_out[i] = (uint8_t)morph[i];  // open/close of floor-bins stays in 0..255
    for (int v = 0; v < 256; ++v)
        lut256[v] = (float)clip_np(v * mo.first + mo.second, model[2], model[3]);
    auto fo = affine(f5, f95);
    for (int64_t i = 0; i < n; ++i) {
        double v = clip_np(flt[i] * fo.first + fo.second, model[2], model[3]);
        flt64[i] = v;
        flt32[i] = (float)v;
    }
}

// ---------------------------------------------------------------------------
// CPU semi-global affine aligner (fallback / oracle)
// ---------------------------------------------------------------------------
// Same semantics as the device kernels and ops.align: free end gaps on the
// signal axis, matrix preference M > V > H, extension over opening on ties,
// leftmost end column.  Returns score; fills pos[m] with the nearest signal
// index per template element (reference __detect_range__ argmin semantics)
// and gap[m] flags.
float align_semiglobal_f32(const float* a, int64_t n, const float* b, int64_t m,
                           float dist_offset, float dist_min,
                           float go_h, float go_v, float ge_h, float ge_v,
                           int64_t* pos, uint8_t* gap) {
    const float NEGF = -1e30f;
    std::vector<float> S(m + 1), Ih(m + 1), Iv(m + 1), Sp(m + 1), Ihp(m + 1);
    std::vector<uint8_t> ptr((size_t)n * m);
    S[0] = 0.f;
    Ih[0] = NEGF;
    for (int64_t i = 1; i <= m; ++i) {
        Iv[i] = go_v + ge_v * (i - 1);
        S[i] = Iv[i];
        Ih[i] = NEGF;
    }
    std::vector<float> bottom(n + 1);
    bottom[0] = S[m];
    for (int64_t j = 1; j <= n; ++j) {
        Sp.swap(S);
        Ihp.swap(Ih);
        S[0] = 0.f;
        Ih[0] = NEGF;
        float iv_prev = NEGF;  // Iv[i-1] of this column
        float s_prev = 0.f;    // S[i-1] of this column
        for (int64_t i = 1; i <= m; ++i) {
            float d = std::fabs(a[j - 1] - b[i - 1]);
            float sc = dist_offset - (float)std::pow((double)d, 1.2);
            if (sc < dist_min) sc = dist_min;
            float M = Sp[i - 1] + sc;
            float ihe = Ihp[i] + ge_h, iho = Sp[i] + go_h;
            float H = std::max(ihe, iho);
            float ive = iv_prev + ge_v, ivo = s_prev + go_v;
            float V = std::max(ive, ivo);
            float best = std::max(M, std::max(H, V));
            uint8_t pb = (M >= best) ? 0 : ((V >= best) ? 2 : 1);
            if (ihe >= iho) pb |= 4;
            if (ive >= ivo) pb |= 8;
            ptr[(size_t)(j - 1) * m + (i - 1)] = pb;
            Ih[i] = H;
            Iv[i] = V;
            S[i] = best;
            iv_prev = V;
            s_prev = best;
        }
        bottom[j] = S[m];
    }
    int64_t j_end = 0;
    float score = bottom[0];
    for (int64_t j = 1; j <= n; ++j)
        if (bottom[j] > score) { score = bottom[j]; j_end = j; }
    // traceback (matches ops.align.traceback_pointers)
    int64_t i = m, j = j_end;
    int cur = (j > 0) ? (ptr[(size_t)(j - 1) * m + (i - 1)] & 3) : 2;
    // raw per-element records: consumed at column j (diag) or left-of j (gap)
    std::vector<int64_t> jp(m);
    std::vector<uint8_t> gp(m);
    while (i > 0) {
        uint8_t byte = (j > 0) ? ptr[(size_t)(j - 1) * m + (i - 1)] : (uint8_t)(2 | 8);
        bool is_m = cur == 0, is_h = cur == 1, is_v = cur == 2;
        if (is_m || is_v) {
            gp[i - 1] = is_v;
            jp[i - 1] = j - 1;
        }
        int64_t ni = is_h ? i : i - 1;
        int64_t nj = is_v ? j : j - 1;
        int ext = is_h ? ((byte >> 2) & 1) : ((byte >> 3) & 1);
        bool stay = !is_m && ext;
        uint8_t nbyte = (nj > 0) ? ptr[(size_t)(nj - 1) * m + (ni - 1)] : (uint8_t)(2 | 8);
        cur = stay ? cur : (ni > 0 ? (nbyte & 3) : 0);
        i = ni;
        j = nj;
    }
    // nearest-position fix-up for vertical-gap runs (argmin view semantics)
    for (int64_t k = 0; k < m;) {
        if (!gp[k]) { pos[k] = jp[k]; gap[k] = 0; ++k; continue; }
        int64_t k2 = k;
        while (k2 + 1 < m && gp[k2 + 1] && jp[k2 + 1] == jp[k]) ++k2;
        int64_t L = k2 - k + 1, jl = jp[k];
        for (int64_t r = 0; r < L; ++r) {
            int64_t p = (r + 1) <= (L - r) ? jl : jl + 1;
            pos[k + r] = std::min(std::max(p, (int64_t)0), n - 1);
            gap[k + r] = 1;
        }
        k = k2 + 1;
    }
    return score;
}

}  // extern "C"
