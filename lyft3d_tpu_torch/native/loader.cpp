// Native host-side data runtime: threaded lidar .bin loading, SE(3)
// transforms, and BEV count rasterization.
//
// The reference's host runtime is torch DataLoader worker processes plus
// spconv's C++ voxel generator (SURVEY.md §2.7 "CPU data-loading
// parallelism"); this library is the TPU framework's native equivalent: the
// feed path (file decode → frame transform → raster/pad) runs in C++ threads
// so the Python process only orchestrates and the device never starves.
//
// Exposed as a C ABI consumed via ctypes (no pybind11 in this image).
//
// Build: g++ -O3 -march=native -shared -fPIC loader.cpp -o libl3dnative.so -lpthread

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Decode a Lyft lidar .bin (float32 x5: x,y,z,intensity,ring) into
// out[max_points*4] as x,y,z,intensity rows. Returns points written, or -1
// on IO error.
int64_t l3d_read_lidar(const char* path, float* out, int64_t max_points) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    std::vector<float> buf(5 * 65536);
    int64_t written = 0;
    while (written < max_points) {
        size_t got = fread(buf.data(), sizeof(float), buf.size(), f);
        if (got == 0) break;
        int64_t pts = static_cast<int64_t>(got / 5);
        for (int64_t i = 0; i < pts && written < max_points; ++i, ++written) {
            out[written * 4 + 0] = buf[i * 5 + 0];
            out[written * 4 + 1] = buf[i * 5 + 1];
            out[written * 4 + 2] = buf[i * 5 + 2];
            out[written * 4 + 3] = buf[i * 5 + 3];
        }
        if (got < buf.size()) break;
    }
    fclose(f);
    return written;
}

// In-place 4x4 homogeneous transform of n points stored as (n, stride)
// rows with xyz in the first three columns. tm is row-major 4x4.
void l3d_transform_points(float* pts, int64_t n, int64_t stride,
                          const double* tm) {
    const float r00 = (float)tm[0], r01 = (float)tm[1], r02 = (float)tm[2], t0 = (float)tm[3];
    const float r10 = (float)tm[4], r11 = (float)tm[5], r12 = (float)tm[6], t1 = (float)tm[7];
    const float r20 = (float)tm[8], r21 = (float)tm[9], r22 = (float)tm[10], t2 = (float)tm[11];
    for (int64_t i = 0; i < n; ++i) {
        float* p = pts + i * stride;
        const float x = p[0], y = p[1], z = p[2];
        p[0] = r00 * x + r01 * y + r02 * z + t0;
        p[1] = r10 * x + r11 * y + r12 * z + t1;
        p[2] = r20 * x + r21 * y + r22 * z + t2;
    }
}

// Threaded batch load: read n_files lidar bins in parallel, apply each
// file's 4x4 transform, write fixed-capacity (max_points, 4) slabs into
// out[i]. counts[i] receives the real point count (≤ max_points).
void l3d_load_batch(const char** paths, int64_t n_files, const double* tms,
                    float* out, int64_t max_points, int64_t* counts,
                    int32_t n_threads) {
    if (n_threads < 1) n_threads = 1;
    std::atomic<int64_t> next(0);
    auto worker = [&]() {
        for (;;) {
            int64_t i = next.fetch_add(1);
            if (i >= n_files) return;
            float* slab = out + i * max_points * 4;
            int64_t n = l3d_read_lidar(paths[i], slab, max_points);
            if (n < 0) n = 0;
            l3d_transform_points(slab, n, 4, tms + i * 16);
            // Zero the padding tail so downstream masking is trivial.
            std::memset(slab + n * 4, 0, sizeof(float) * 4 * (max_points - n));
            counts[i] = n;
        }
    };
    std::vector<std::thread> threads;
    for (int32_t t = 0; t < n_threads; ++t) threads.emplace_back(worker);
    for (auto& th : threads) th.join();
}

// BEV voxel-count rasterization: points (n, stride) → grid (h, w, c)
// float32 counts. Mirrors ops/bev_raster semantics (col = x voxel,
// row = y voxel, channel = z slab).
void l3d_bev_raster(const float* pts, int64_t n, int64_t stride,
                    int32_t h, int32_t w, int32_t c,
                    double vx, double vy, double vz, double z_offset,
                    float* grid) {
    std::memset(grid, 0, sizeof(float) * (size_t)h * w * c);
    const double half_w = w / 2.0, half_h = h / 2.0;
    for (int64_t i = 0; i < n; ++i) {
        const float* p = pts + i * stride;
        const int64_t col = (int64_t)std::floor(p[0] / vx + half_w);
        const int64_t row = (int64_t)std::floor(p[1] / vy + half_h);
        const int64_t ch = (int64_t)std::floor((p[2] - z_offset) / vz);
        if (col < 0 || col >= w || row < 0 || row >= h || ch < 0 || ch >= c) continue;
        grid[(row * w + col) * c + ch] += 1.0f;
    }
}

}  // extern "C"
