// Chamfer distance-transform push-out field: host code, no kernel.
//
// The port's own copy of native/distfield.cpp (the JAX package's native
// helper), which is the reference's CPU worker-thread algorithm
// (src/main.rs:403-515): a two-pass 8-neighbour chamfer propagation of
// nearest-source coordinates over a grayscale mask. For every pixel it
// gives a vector (in pixels) toward its nearest "outside" (> 128) pixel,
// or toward the image border when nothing is outside.
//
// Why on the host: each relaxation reads the one its raster predecessor
// just wrote, and ties keep the earlier candidate (strict <), so the
// result is byte-exact only in this sequential order; it does not split
// into a scan. tpufluid_torch/native/distfield.py calls it for a field
// bound for a CUDA device (the NumPy copy there is its plain version),
// once per video frame, when the field is set.
//
// Distances are integer squares below 2^24 for any texture up to 2048
// pixels a side, so float32 holds them exactly, as the NumPy copy's
// float64 does.

#include <cstdint>
#include <limits>
#include <vector>
#include <cmath>

extern "C" {

// mask: u8[height * width] row-major; out: f32[height * width * 2]
// (x, y) vectors. Returns 0.
int tf_chamfer_push_field(const uint8_t* mask, int width, int height,
                          float* out) {
    const size_t n = static_cast<size_t>(width) * height;
    std::vector<float> dist(n, std::numeric_limits<float>::max());
    std::vector<int32_t> nearest_x(n, 0), nearest_y(n, 0);

    auto idx = [width](int32_t x, int32_t y) {
        return static_cast<size_t>(y) * width + x;
    };
    auto sq = [](int32_t x1, int32_t y1, int32_t x2, int32_t y2) {
        const float dx = static_cast<float>(x1 - x2);
        const float dy = static_cast<float>(y1 - y2);
        return dx * dx + dy * dy;
    };
    auto seed = [&](int32_t x, int32_t y) {
        dist[idx(x, y)] = 0.0f;
        nearest_x[idx(x, y)] = x;
        nearest_y[idx(x, y)] = y;
    };
    // one relaxation of pixel (x, y) by its neighbour (x + ox, y + oy)
    auto relax = [&](int32_t x, int32_t y, int32_t ox, int32_t oy) {
        const int32_t nx = x + ox, ny = y + oy;
        if (nx < 0 || ny < 0 || nx >= width || ny >= height) return;
        const size_t ni = idx(nx, ny);
        const float d = sq(x, y, nearest_x[ni], nearest_y[ni]);
        if (d < dist[idx(x, y)]) {
            dist[idx(x, y)] = d;
            nearest_x[idx(x, y)] = nearest_x[ni];
            nearest_y[idx(x, y)] = nearest_y[ni];
        }
    };

    // sources: pixels > 128; the image border when there is none
    bool has_source = false;
    for (int32_t y = 0; y < height; ++y)
        for (int32_t x = 0; x < width; ++x)
            if (mask[idx(x, y)] > 128) {
                seed(x, y);
                has_source = true;
            }
    if (!has_source)
        for (int32_t y = 0; y < height; ++y)
            for (int32_t x = 0; x < width; ++x)
                if (y == 0 || y == height - 1 || x == 0 || x == width - 1)
                    seed(x, y);

    // forward pass: left, top-left, top, top-right
    const int32_t fwd[4][2] = {{-1, 0}, {-1, -1}, {0, -1}, {1, -1}};
    for (int32_t y = 0; y < height; ++y)
        for (int32_t x = 0; x < width; ++x)
            for (const auto& o : fwd) relax(x, y, o[0], o[1]);

    // backward pass: right, bottom-right, bottom, bottom-left
    const int32_t bwd[4][2] = {{1, 0}, {1, 1}, {0, 1}, {-1, 1}};
    for (int32_t y = height - 1; y >= 0; --y)
        for (int32_t x = width - 1; x >= 0; --x)
            for (const auto& o : bwd) relax(x, y, o[0], o[1]);

    // push vector = source - pixel (zero at the sources)
    for (int32_t y = 0; y < height; ++y) {
        for (int32_t x = 0; x < width; ++x) {
            const size_t i = idx(x, y);
            const float dx = static_cast<float>(x - nearest_x[i]);
            const float dy = static_cast<float>(y - nearest_y[i]);
            const bool away = std::sqrt(dx * dx + dy * dy) > 1e-6f;
            out[i * 2 + 0] = away ? -dx : 0.0f;
            out[i * 2 + 1] = away ? -dy : 0.0f;
        }
    }
    return 0;
}

}  // extern "C"
