// yolotpu_torch native preprocessing: the host-side per-frame hot path in
// C++. The port's own copy of yolotpu/native/preproc.cpp, function for
// function.
//
// Streaming at thousands of fps cannot afford Python/numpy letterboxing, so
// the framework keeps the reference's native preprocessing surface
// (linux_app/src/yolo2_image_loader.c: load->CHW float->letterbox;
// yolo2_v4l2.c: YUYV->RGB) as a small C++ library with the *same numerics*
// as yolotpu_torch.image (darknet bilinear with float32 index math,
// integer BT.601) — validated bit-for-bit by tests/test_torch_native.py.
//
// Exposed through a plain C ABI for ctypes.

#include <algorithm>
#include <cstdint>
#include <cstring>

extern "C" {

// HWC uint8 RGB -> CHW float32 in [0,1]  (yolo2_image_loader.c:34-80)
void yt_hwc_u8_to_chw_f32(const uint8_t* src, int h, int w, int c,
                          float* dst) {
    // divide (not multiply-by-reciprocal): matches numpy's f32 division bit
    // for bit (and yolo2_image_loader.c's /255.0f)
    for (int k = 0; k < c; ++k) {
        float* out = dst + (size_t)k * h * w;
        const uint8_t* in = src + k;
        for (int i = 0; i < h * w; ++i) {
            out[i] = in[(size_t)i * c] / 255.0f;
        }
    }
}

// darknet bilinear resize, CHW f32 (yolo_image.cpp:84-127 semantics):
// horizontal pass with last-column copy, vertical pass skipping the second
// tap on the last row; all index math in float32.
void yt_resize_chw_f32(const float* src, int c, int sh, int sw,
                       float* dst, int dh, int dw, float* scratch) {
    // scratch: c * sh * dw floats
    const float w_scale = (dw > 1) ? (float)(sw - 1) / (float)(dw - 1) : 0.0f;
    const float h_scale = (dh > 1) ? (float)(sh - 1) / (float)(dh - 1) : 0.0f;

    for (int k = 0; k < c; ++k) {
        const float* im = src + (size_t)k * sh * sw;
        float* part = scratch + (size_t)k * sh * dw;
        for (int r = 0; r < sh; ++r) {
            const float* row = im + (size_t)r * sw;
            float* prow = part + (size_t)r * dw;
            for (int col = 0; col < dw; ++col) {
                float val;
                if (col == dw - 1 || sw == 1) {
                    val = row[sw - 1];
                } else {
                    float sx = col * w_scale;
                    int ix = (int)sx;
                    float dx = sx - ix;
                    val = (1 - dx) * row[ix] + dx * row[ix + 1];
                }
                prow[col] = val;
            }
        }
    }
    for (int k = 0; k < c; ++k) {
        const float* part = scratch + (size_t)k * sh * dw;
        float* out = dst + (size_t)k * dh * dw;
        for (int r = 0; r < dh; ++r) {
            float sy = r * h_scale;
            int iy = (int)sy;
            float dy = sy - iy;
            float* orow = out + (size_t)r * dw;
            const float* p0 = part + (size_t)iy * dw;
            for (int col = 0; col < dw; ++col) {
                orow[col] = (1 - dy) * p0[col];
            }
            if (r == dh - 1 || sh == 1) continue;
            const float* p1 = part + (size_t)(iy + 1) * dw;
            for (int col = 0; col < dw; ++col) {
                orow[col] += dy * p1[col];
            }
        }
    }
}

// letterbox into a 0.5-gray (netw, neth) canvas with integer new_w/new_h
// (yolo_image.cpp:148-165). dst: c*neth*netw; scratch: c*sh*new_w + c*new_h*new_w
void yt_letterbox_chw_f32(const float* src, int c, int sh, int sw,
                          float* dst, int neth, int netw, float* scratch) {
    int new_w, new_h;
    if ((float)netw / sw < (float)neth / sh) {
        new_w = netw;
        new_h = (sh * netw) / sw;
    } else {
        new_h = neth;
        new_w = (sw * neth) / sh;
    }
    float* resized = scratch;                       // c*new_h*new_w
    float* rscratch = scratch + (size_t)c * new_h * new_w;  // c*sh*new_w
    yt_resize_chw_f32(src, c, sh, sw, resized, new_h, new_w, rscratch);

    const size_t total = (size_t)c * neth * netw;
    for (size_t i = 0; i < total; ++i) dst[i] = 0.5f;
    const int dy = (neth - new_h) / 2, dx = (netw - new_w) / 2;
    for (int k = 0; k < c; ++k) {
        for (int y = 0; y < new_h; ++y) {
            std::memcpy(dst + ((size_t)k * neth + dy + y) * netw + dx,
                        resized + ((size_t)k * new_h + y) * new_w,
                        sizeof(float) * new_w);
        }
    }
}

// fused: HWC uint8 frame -> letterboxed CHW f32 network input
void yt_frame_to_input(const uint8_t* rgb, int h, int w,
                       float* dst, int neth, int netw, float* scratch) {
    // scratch: c*h*w (chw) + c*new_h*new_w + c*h*new_w floats (upper bound:
    // 3*h*w + 3*neth*netw + 3*h*netw)
    float* chw = scratch;
    float* rest = scratch + (size_t)3 * h * w;
    yt_hwc_u8_to_chw_f32(rgb, h, w, 3, chw);
    yt_letterbox_chw_f32(chw, 3, h, w, dst, neth, netw, rest);
}

// integer BT.601 YUYV -> RGB24 (yolo2_v4l2.c:328-369)
void yt_yuyv_to_rgb(const uint8_t* yuyv, int w, int h, uint8_t* rgb) {
    auto clamp8 = [](int v) -> uint8_t {
        return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
    };
    for (int i = 0; i < w * h / 2; ++i) {
        int y0 = yuyv[4 * i + 0], u = yuyv[4 * i + 1];
        int y1 = yuyv[4 * i + 2], v = yuyv[4 * i + 3];
        int d = u - 128, e = v - 128;
        for (int p = 0; p < 2; ++p) {
            int cc = (p ? y1 : y0) - 16;
            rgb[6 * i + 3 * p + 0] = clamp8((298 * cc + 409 * e + 128) >> 8);
            rgb[6 * i + 3 * p + 1] = clamp8((298 * cc - 100 * d - 208 * e + 128) >> 8);
            rgb[6 * i + 3 * p + 2] = clamp8((298 * cc + 516 * d + 128) >> 8);
        }
    }
}

// int16 input quantization: round(x * 2^q) half away from zero with fp32
// pre-clamp (yolo2_model.cpp:257-273)
void yt_quantize_int16(const float* src, int64_t n, int q, int16_t* dst) {
    const float scale = (float)((q >= 0) ? (double)(1 << q) : 1.0 / (1 << -q));
    for (int64_t i = 0; i < n; ++i) {
        float v = src[i] * scale;
        if (v > 32767.f) v = 32767.f;
        if (v < -32768.f) v = -32768.f;
        long long r = (long long)(v >= 0 ? (v + 0.5f) : (v - 0.5f));
        if (r > 32767) r = 32767;
        if (r < -32768) r = -32768;
        dst[i] = (int16_t)r;
    }
}

}  // extern "C"
