// Native training-image pipeline: threaded JPEG decode + augmentation.
//
// The TPU-native framework's data-loader hot path (the analogue of the
// reference's 8 torch DataLoader worker processes burning CPU on PIL,
// reference train/train_VGG19.py:62-64).  The PIL path costs ~33 ms/img of
// interpreter-bound work (~30 img/s/core) and its Python threads cannot
// scale past the GIL; this pool does the whole pixel path in C++ worker
// threads with the GIL released (measured 1.56x per core, and it scales
// with cores by construction — SCALING.md 'Input pipeline'):
//
//   JPEG decode (libjpeg) -> ColorJitter (PIL ImageEnhance semantics)
//   -> optional JPEG re-compress aug -> optional grayscale -> optional
//   hflip -> PIL-exact separable bicubic resample (fixed-point, Resample.c
//   semantics incl. antialias support scaling) -> crop/pad window +
//   ImageNet normalization fused into the float32 output write.
//
// Keypoint/geometry math stays in Python (rtpose_tpu/data/native_loader.py)
// — it is a few dozen floats per image.  Parity with the PIL pipeline is
// differential-tested in tests/test_native_loader.py.
//
// Thread-safety: the pool owns a job queue; submissions reference
// caller-owned buffers that must stay alive until imgpipe_wait_all.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <csetjmp>

namespace {

inline uint8_t clip8(int v) {
    return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// ---------------------------------------------------------------------------
// JPEG decode / encode (libjpeg, error-safe)
// ---------------------------------------------------------------------------

struct JerrMgr {
    jpeg_error_mgr pub;
    jmp_buf jmp;
};

void jerr_exit(j_common_ptr cinfo) {
    JerrMgr* e = reinterpret_cast<JerrMgr*>(cinfo->err);
    longjmp(e->jmp, 1);
}

// Decode a JPEG byte buffer to packed RGB.  Returns true on success.
bool decode_jpeg(const uint8_t* data, size_t len, std::vector<uint8_t>& rgb,
                 int* w, int* h) {
    jpeg_decompress_struct cinfo;
    JerrMgr jerr;
    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = jerr_exit;
    if (setjmp(jerr.jmp)) {
        jpeg_destroy_decompress(&cinfo);
        return false;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data), len);
    jpeg_read_header(&cinfo, TRUE);
    cinfo.out_color_space = JCS_RGB;
    jpeg_start_decompress(&cinfo);
    *w = cinfo.output_width;
    *h = cinfo.output_height;
    rgb.resize((size_t)*w * *h * 3);
    while (cinfo.output_scanline < cinfo.output_height) {
        JSAMPROW row = rgb.data() + (size_t)cinfo.output_scanline * *w * 3;
        jpeg_read_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return true;
}

// Re-encode + decode at `quality` (the JpegCompression augmentation,
// reference transforms.py:28-31).
bool recompress_jpeg(std::vector<uint8_t>& rgb, int w, int h, int quality) {
    jpeg_compress_struct cinfo;
    JerrMgr jerr;
    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = jerr_exit;
    uint8_t* buf = nullptr;
    unsigned long buflen = 0;
    if (setjmp(jerr.jmp)) {
        jpeg_destroy_compress(&cinfo);
        free(buf);
        return false;
    }
    jpeg_create_compress(&cinfo);
    jpeg_mem_dest(&cinfo, &buf, &buflen);
    cinfo.image_width = w;
    cinfo.image_height = h;
    cinfo.input_components = 3;
    cinfo.in_color_space = JCS_RGB;
    jpeg_set_defaults(&cinfo);
    jpeg_set_quality(&cinfo, quality, TRUE);
    jpeg_start_compress(&cinfo, TRUE);
    while (cinfo.next_scanline < cinfo.image_height) {
        JSAMPROW row = rgb.data() + (size_t)cinfo.next_scanline * w * 3;
        jpeg_write_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_compress(&cinfo);
    jpeg_destroy_compress(&cinfo);

    int w2, h2;
    std::vector<uint8_t> rgb2;
    bool ok = decode_jpeg(buf, buflen, rgb2, &w2, &h2);
    free(buf);
    if (!ok || w2 != w || h2 != h) return false;
    rgb.swap(rgb2);
    return true;
}

// ---------------------------------------------------------------------------
// Photometric ops with PIL semantics
// ---------------------------------------------------------------------------

// PIL L-mode luma (convert.c L24 macro): (R*19595 + G*38470 + B*7471
// + 0x8000) >> 16
inline uint8_t pil_luma(uint8_t r, uint8_t g, uint8_t b) {
    return (uint8_t)(((uint32_t)r * 19595 + (uint32_t)g * 38470 +
                      (uint32_t)b * 7471 + 0x8000) >> 16);
}

// PIL Image.blend towards a scalar "degenerate" value per pixel:
// out = in1 + alpha*(in2-in1), truncated toward zero, clipped
// (Blend.c: (UINT8) or CLIP8 of a float->int cast).
inline uint8_t pil_blend(uint8_t degenerate, uint8_t image, float alpha) {
    float v = (float)degenerate + alpha * ((float)image - (float)degenerate);
    return clip8((int)v);
}

// ImageEnhance.Brightness: blend(black, img, f)
void enhance_brightness(std::vector<uint8_t>& rgb, float f) {
    for (auto& v : rgb) v = pil_blend(0, v, f);
}

// ImageEnhance.Contrast: blend(constant mean-L gray, img, f) where
// mean = int(Stat(img.convert('L')).mean + 0.5)
void enhance_contrast(std::vector<uint8_t>& rgb, float f) {
    size_t n = rgb.size() / 3;
    double sum = 0.0;
    for (size_t i = 0; i < n; i++)
        sum += pil_luma(rgb[3 * i], rgb[3 * i + 1], rgb[3 * i + 2]);
    uint8_t mean = clip8((int)(sum / (double)n + 0.5));
    for (auto& v : rgb) v = pil_blend(mean, v, f);
}

// ImageEnhance.Color: blend(img.convert('L').convert('RGB'), img, f)
void enhance_saturation(std::vector<uint8_t>& rgb, float f) {
    size_t n = rgb.size() / 3;
    for (size_t i = 0; i < n; i++) {
        uint8_t l = pil_luma(rgb[3 * i], rgb[3 * i + 1], rgb[3 * i + 2]);
        for (int c = 0; c < 3; c++)
            rgb[3 * i + c] = pil_blend(l, rgb[3 * i + c], f);
    }
}

// PIL convert.c rgb2hsv / hsv2rgb round trip with the uint8 H channel
// shifted (mod 256): the exact formula of data/transforms.py adjust_hue.
// Float widths and rounding replicate Pillow's Convert.c exactly (float h
// storage with double intermediate expressions; hsv2rgb via degrees and
// lround) — differential-tested bit-exact in tests/test_native_loader.py.
void adjust_hue(std::vector<uint8_t>& rgb, int shift) {
    size_t n = rgb.size() / 3;
    for (size_t i = 0; i < n; i++) {
        uint8_t r = rgb[3 * i], g = rgb[3 * i + 1], b = rgb[3 * i + 2];
        uint8_t maxc = r > g ? (r > b ? r : b) : (g > b ? g : b);
        uint8_t minc = r < g ? (r < b ? r : b) : (g < b ? g : b);
        uint8_t uh = 0, us = 0, uv = maxc;
        if (minc != maxc) {
            float cr = (float)(maxc - minc);
            float s = cr / (float)maxc;
            float rc = ((float)(maxc - r)) / cr;
            float gc = ((float)(maxc - g)) / cr;
            float bc = ((float)(maxc - b)) / cr;
            float h;
            if (r == maxc) h = bc - gc;
            else if (g == maxc) h = 2.0 + rc - bc;
            else h = 4.0 + gc - rc;
            h = fmod((h / 6.0) + 1.0, 1.0);
            uh = clip8((int)(h * 255.0));
            us = clip8((int)(s * 255.0));
        }
        uh = (uint8_t)(((int)uh + shift) & 0xff);
        if (us == 0) {
            rgb[3 * i] = rgb[3 * i + 1] = rgb[3 * i + 2] = uv;
        } else {
            double fh = (((double)uh * 360.0) / 255.0) / 60.0;
            int iv = (int)fh;
            double f = fh - (double)iv;
            float fs = ((float)us) / 255.0f;
            uint8_t p = clip8((int)std::lround((float)uv * (1.0 - fs)));
            uint8_t q = clip8((int)std::lround((float)uv * (1.0 - fs * f)));
            uint8_t t = clip8((int)std::lround(
                (float)uv * (1.0 - fs * (1.0 - f))));
            uint8_t rr, gg, bb;
            switch (iv % 6) {
                case 0: rr = uv; gg = t;  bb = p;  break;
                case 1: rr = q;  gg = uv; bb = p;  break;
                case 2: rr = p;  gg = uv; bb = t;  break;
                case 3: rr = p;  gg = q;  bb = uv; break;
                case 4: rr = t;  gg = p;  bb = uv; break;
                default: rr = uv; gg = p; bb = q;  break;
            }
            rgb[3 * i] = rr;
            rgb[3 * i + 1] = gg;
            rgb[3 * i + 2] = bb;
        }
    }
}

// img.convert('L').convert('RGB')
void to_grayscale(std::vector<uint8_t>& rgb) {
    size_t n = rgb.size() / 3;
    for (size_t i = 0; i < n; i++) {
        uint8_t l = pil_luma(rgb[3 * i], rgb[3 * i + 1], rgb[3 * i + 2]);
        rgb[3 * i] = rgb[3 * i + 1] = rgb[3 * i + 2] = l;
    }
}

void hflip(std::vector<uint8_t>& rgb, int w, int h) {
    for (int y = 0; y < h; y++) {
        uint8_t* row = rgb.data() + (size_t)y * w * 3;
        for (int x = 0; x < w / 2; x++) {
            for (int c = 0; c < 3; c++)
                std::swap(row[3 * x + c], row[3 * (w - 1 - x) + c]);
        }
    }
}

// ---------------------------------------------------------------------------
// PIL-exact separable bicubic resample (Resample.c semantics)
// ---------------------------------------------------------------------------

constexpr int PRECISION_BITS = 32 - 8 - 2;

// PIL bicubic filter: a = -0.5, support 2.0
inline double bicubic_filter(double x) {
    constexpr double a = -0.5;
    if (x < 0.0) x = -x;
    if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
    if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
    return 0.0;
}

// Precompute fixed-point tap weights for one axis (Resample.c
// precompute_coeffs): antialias via filterscale when downscaling.
void precompute_coeffs(int in_size, int out_size, std::vector<int>& bounds,
                       std::vector<int>& kk, int* ksize_out) {
    double scale = (double)in_size / out_size;
    double filterscale = scale < 1.0 ? 1.0 : scale;
    double support = 2.0 * filterscale;
    int ksize = (int)std::ceil(support) * 2 + 1;
    bounds.resize(out_size * 2);
    kk.resize((size_t)out_size * ksize);
    std::vector<double> wd(ksize);
    for (int xx = 0; xx < out_size; xx++) {
        double center = (xx + 0.5) * scale;
        int xmin = (int)(center - support + 0.5);
        if (xmin < 0) xmin = 0;
        int xmax = (int)(center + support + 0.5);
        if (xmax > in_size) xmax = in_size;
        xmax -= xmin;
        double ww = 0.0;
        for (int x = 0; x < xmax; x++) {
            double w = bicubic_filter((x + xmin - center + 0.5)
                                      / filterscale);
            wd[x] = w;
            ww += w;
        }
        int* k = kk.data() + (size_t)xx * ksize;
        for (int x = 0; x < xmax; x++)
            k[x] = (int)(wd[x] / ww < 0
                         ? wd[x] / ww * (1 << PRECISION_BITS) - 0.5
                         : wd[x] / ww * (1 << PRECISION_BITS) + 0.5);
        for (int x = xmax; x < ksize; x++) k[x] = 0;
        bounds[xx * 2] = xmin;
        bounds[xx * 2 + 1] = xmax;
    }
    *ksize_out = ksize;
}

inline uint8_t clip8_prec(int v) {
    v >>= PRECISION_BITS;
    return clip8(v);
}

// Horizontal then vertical pass, uint8 intermediate (as PIL does for
// 8-bit images).
void resample_bicubic(const std::vector<uint8_t>& src, int w, int h,
                      std::vector<uint8_t>& dst, int tw, int th) {
    std::vector<int> bounds_h, kk_h, bounds_v, kk_v;
    int ksh, ksv;
    precompute_coeffs(w, tw, bounds_h, kk_h, &ksh);
    precompute_coeffs(h, th, bounds_v, kk_v, &ksv);

    std::vector<uint8_t> tmp((size_t)h * tw * 3);
    int half = 1 << (PRECISION_BITS - 1);
    for (int y = 0; y < h; y++) {
        const uint8_t* row = src.data() + (size_t)y * w * 3;
        uint8_t* orow = tmp.data() + (size_t)y * tw * 3;
        for (int xx = 0; xx < tw; xx++) {
            int xmin = bounds_h[xx * 2], xmax = bounds_h[xx * 2 + 1];
            const int* k = kk_h.data() + (size_t)xx * ksh;
            int s0 = half, s1 = half, s2 = half;
            for (int x = 0; x < xmax; x++) {
                const uint8_t* px = row + 3 * (x + xmin);
                s0 += px[0] * k[x];
                s1 += px[1] * k[x];
                s2 += px[2] * k[x];
            }
            orow[3 * xx] = clip8_prec(s0);
            orow[3 * xx + 1] = clip8_prec(s1);
            orow[3 * xx + 2] = clip8_prec(s2);
        }
    }
    dst.resize((size_t)th * tw * 3);
    for (int yy = 0; yy < th; yy++) {
        int ymin = bounds_v[yy * 2], ymax = bounds_v[yy * 2 + 1];
        const int* k = kk_v.data() + (size_t)yy * ksv;
        uint8_t* orow = dst.data() + (size_t)yy * tw * 3;
        for (int xx = 0; xx < tw * 3; xx++) {
            int s = half;
            for (int y = 0; y < ymax; y++)
                s += tmp[(size_t)(y + ymin) * tw * 3 + xx] * k[y];
            orow[xx] = clip8_prec(s);
        }
    }
}

// ---------------------------------------------------------------------------
// Job + thread pool
// ---------------------------------------------------------------------------

struct Job {
    int idx;                      // submit-order index since last wait
    const uint8_t* jpeg;
    size_t jpeg_len;
    // photometric (applied in pipeline order; 1.0 / shift 0 = no-op)
    float brightness, contrast, saturation;
    int hue_shift;
    int do_jpeg, jpeg_quality;
    int do_gray;
    int do_flip;
    // geometry
    int resize_w, resize_h;       // PIL bicubic target
    int crop_x, crop_y;           // window origin in resized image
    int out_x, out_y, out_w, out_h;  // content window in the output
    int canvas_w, canvas_h;       // output canvas (e.g. 368x368)
    float* out;                   // canvas_h*canvas_w*3 float32
    uint8_t* out_u8;              // optional canvas_h*canvas_w*3 uint8 view
    // ImageNet normalization constants
    float mean[3], std[3];
};

class Pool {
 public:
    explicit Pool(int threads) : stop_(false), pending_(0), errors_(0) {
        for (int i = 0; i < threads; i++)
            workers_.emplace_back([this] { run(); });
    }
    ~Pool() {
        {
            std::unique_lock<std::mutex> lk(mu_);
            stop_ = true;
        }
        cv_.notify_all();
        for (auto& t : workers_) t.join();
    }
    void submit(const Job& j) {
        {
            std::unique_lock<std::mutex> lk(mu_);
            Job j2 = j;
            j2.idx = next_idx_++;
            jobs_.push(j2);
            pending_++;
        }
        cv_.notify_one();
    }
    // returns number of failed jobs since last wait
    int wait_all() {
        std::unique_lock<std::mutex> lk(mu_);
        done_cv_.wait(lk, [this] { return pending_ == 0; });
        int e = errors_;
        errors_ = 0;
        failed_.clear();
        next_idx_ = 0;
        return e;
    }
    // like wait_all, but also reports WHICH jobs failed: fills out_idx
    // (up to cap) with the submit-order indices of failed jobs, sorted
    // ascending, so the caller can name/skip the offending files.
    int wait_all_failed(int* out_idx, int cap) {
        std::unique_lock<std::mutex> lk(mu_);
        done_cv_.wait(lk, [this] { return pending_ == 0; });
        std::sort(failed_.begin(), failed_.end());
        int n = static_cast<int>(failed_.size());
        for (int i = 0; i < n && i < cap; i++) out_idx[i] = failed_[i];
        failed_.clear();
        errors_ = 0;
        next_idx_ = 0;
        return n;
    }

 private:
    void run() {
        for (;;) {
            Job j;
            {
                std::unique_lock<std::mutex> lk(mu_);
                cv_.wait(lk, [this] { return stop_ || !jobs_.empty(); });
                if (stop_ && jobs_.empty()) return;
                j = jobs_.front();
                jobs_.pop();
            }
            bool ok = process(j);
            {
                std::unique_lock<std::mutex> lk(mu_);
                if (!ok) {
                    errors_++;
                    failed_.push_back(j.idx);
                }
                if (--pending_ == 0) done_cv_.notify_all();
            }
        }
    }

    static bool process(const Job& j) {
        std::vector<uint8_t> rgb;
        int w, h;
        if (!decode_jpeg(j.jpeg, j.jpeg_len, rgb, &w, &h)) return false;
        if (j.brightness != 1.0f) enhance_brightness(rgb, j.brightness);
        if (j.contrast != 1.0f) enhance_contrast(rgb, j.contrast);
        if (j.saturation != 1.0f) enhance_saturation(rgb, j.saturation);
        // hue_shift >= 0 applies the (lossy) HSV round trip even for a
        // zero shift, exactly like ColorJitter's unconditional adjust_hue
        if (j.hue_shift >= 0) adjust_hue(rgb, j.hue_shift);
        if (j.do_jpeg && !recompress_jpeg(rgb, w, h, j.jpeg_quality))
            return false;
        if (j.do_gray) to_grayscale(rgb);
        if (j.do_flip) hflip(rgb, w, h);

        std::vector<uint8_t> rs;
        const std::vector<uint8_t>* img = &rgb;
        int iw = w, ih = h;
        if (j.resize_w > 0 && j.resize_h > 0
            && (j.resize_w != w || j.resize_h != h)) {
            resample_bicubic(rgb, w, h, rs, j.resize_w, j.resize_h);
            img = &rs;
            iw = j.resize_w;
            ih = j.resize_h;
        }

        // destination window must fit the canvas: source coords are
        // clipped below, but an out-of-bounds window would scribble past
        // the caller's buffer from a worker thread — fail the job instead
        if (j.out_x < 0 || j.out_y < 0 || j.out_w < 0 || j.out_h < 0 ||
            j.out_x + j.out_w > j.canvas_w ||
            j.out_y + j.out_h > j.canvas_h) {
            return false;
        }

        // fused crop + pad + normalize: everything outside the content
        // window is 0 (PAD_FILL normalizes to ~0 and mask_valid_area zeroes
        // it exactly — see data/transforms.py mask_valid_area)
        if (j.out) {
            memset(j.out, 0,
                   sizeof(float) * 3 * j.canvas_w * j.canvas_h);
        }
        if (j.out_u8) {
            memset(j.out_u8, 0, (size_t)3 * j.canvas_w * j.canvas_h);
        }
        for (int y = 0; y < j.out_h; y++) {
            int sy = j.crop_y + y;
            if (sy < 0 || sy >= ih) continue;
            const uint8_t* srow = img->data() + (size_t)sy * iw * 3;
            for (int x = 0; x < j.out_w; x++) {
                int sx = j.crop_x + x;
                if (sx < 0 || sx >= iw) continue;
                size_t oi = ((size_t)(j.out_y + y) * j.canvas_w
                             + (j.out_x + x)) * 3;
                for (int c = 0; c < 3; c++) {
                    uint8_t v = srow[3 * sx + c];
                    if (j.out)
                        j.out[oi + c] = ((float)v / 255.0f - j.mean[c])
                                        / j.std[c];
                    if (j.out_u8) j.out_u8[oi + c] = v;
                }
            }
        }
        return true;
    }

    std::vector<std::thread> workers_;
    std::queue<Job> jobs_;
    std::mutex mu_;
    std::condition_variable cv_, done_cv_;
    bool stop_;
    int pending_;
    int errors_;
    int next_idx_ = 0;
    std::vector<int> failed_;   // submit-order indices of failed jobs
};

}  // namespace

// ---------------------------------------------------------------------------
// C API (ctypes)
// ---------------------------------------------------------------------------

extern "C" {

void* imgpipe_create(int threads) { return new Pool(threads); }

void imgpipe_destroy(void* p) { delete static_cast<Pool*>(p); }

int imgpipe_jpeg_size(const uint8_t* data, size_t len, int* w, int* h) {
    jpeg_decompress_struct cinfo;
    JerrMgr jerr;
    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = jerr_exit;
    if (setjmp(jerr.jmp)) {
        jpeg_destroy_decompress(&cinfo);
        return 1;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data), len);
    jpeg_read_header(&cinfo, TRUE);
    *w = cinfo.image_width;
    *h = cinfo.image_height;
    jpeg_destroy_decompress(&cinfo);
    return 0;
}

void imgpipe_submit(void* p, const uint8_t* jpeg, size_t jpeg_len,
                    float brightness, float contrast, float saturation,
                    int hue_shift, int do_jpeg, int jpeg_quality,
                    int do_gray, int do_flip,
                    int resize_w, int resize_h, int crop_x, int crop_y,
                    int out_x, int out_y, int out_w, int out_h,
                    int canvas_w, int canvas_h,
                    float* out, uint8_t* out_u8,
                    const float* mean, const float* stdv) {
    Job j;
    j.jpeg = jpeg;
    j.jpeg_len = jpeg_len;
    j.brightness = brightness;
    j.contrast = contrast;
    j.saturation = saturation;
    j.hue_shift = hue_shift;
    j.do_jpeg = do_jpeg;
    j.jpeg_quality = jpeg_quality;
    j.do_gray = do_gray;
    j.do_flip = do_flip;
    j.resize_w = resize_w;
    j.resize_h = resize_h;
    j.crop_x = crop_x;
    j.crop_y = crop_y;
    j.out_x = out_x;
    j.out_y = out_y;
    j.out_w = out_w;
    j.out_h = out_h;
    j.canvas_w = canvas_w;
    j.canvas_h = canvas_h;
    j.out = out;
    j.out_u8 = out_u8;
    for (int c = 0; c < 3; c++) {
        j.mean[c] = mean ? mean[c] : 0.0f;
        j.std[c] = stdv ? stdv[c] : 1.0f;
    }
    static_cast<Pool*>(p)->submit(j);
}

int imgpipe_wait_all(void* p) { return static_cast<Pool*>(p)->wait_all(); }

int imgpipe_wait_all_failed(void* p, int* out_idx, int cap) {
    return static_cast<Pool*>(p)->wait_all_failed(out_idx, cap);
}

}  // extern "C"
