// Golden-image driver: renders a world config through the *reference's own CPU
// renderer* (compiled from /root/reference with clean-room stubs) and dumps the
// framebuffer as a binary PPM plus a wall-clock timing line.  This binary is the
// ground truth for the JAX framework's image-parity tests and the machine-local
// reference baseline for BENCH comparisons.
//
// Usage: reforacle <config.json> <out.ppm> [--no-bvh] [--engine cpu|gpu]
//
// --engine cpu runs the reference's serial path (rtracer::cpu) — note its
//   depth-guard and in_obj quirks (scene.cu:224,260).
// --engine gpu runs the reference's CUDA stack-machine path serially: with the
//   stub launch geometry (1 thread, grid-stride loops cover all work) and
//   single-lane __ballot_sync, the *exact* device code paths execute on the
//   host.  This is the semantics the JAX framework must match.
#include <chrono>
#include <cstdio>
#include <cstring>
#include <string>

#include "procedural/cube_world.h"
#include "rayenv/cpu/scene.h"
#include "rayenv/gpu/scene.h"
#include "raytracer.h"

int main(int argc, char** argv) {
    if (argc < 3) {
        std::fprintf(stderr,
                     "usage: %s config.json out.ppm [--no-bvh] [--engine cpu|gpu]\n",
                     argv[0]);
        return 2;
    }
    std::string config = argv[1];
    std::string out = argv[2];
    bool use_bvh = true;
    std::string engine = "gpu";
    for (int i = 3; i < argc; i++) {
        if (std::strcmp(argv[i], "--no-bvh") == 0) use_bvh = false;
        if (std::strcmp(argv[i], "--engine") == 0 && i + 1 < argc) engine = argv[++i];
    }

    renv::Canvas* canvas_ptr = nullptr;
    double ms = 0.0;
    if (engine == "cpu") {
        renv::cpu::Scene* scene = procedural::cpu::generate(config);
        canvas_ptr = &scene->get_environment().get_canvas();
        auto from = std::chrono::high_resolution_clock::now();
        rtracer::cpu::update_scene(scene, 1, use_bvh);
        auto to = std::chrono::high_resolution_clock::now();
        ms = std::chrono::duration<double, std::milli>(to - from).count();
    } else {
        renv::gpu::Scene* scene = procedural::gpu::generate(config);
        canvas_ptr = &scene->get_environment().get_canvas();
        auto from = std::chrono::high_resolution_clock::now();
        rtracer::gpu::update_scene(scene, 1, use_bvh);
        auto to = std::chrono::high_resolution_clock::now();
        ms = std::chrono::duration<double, std::milli>(to - from).count();
    }
    renv::Canvas& canvas = *canvas_ptr;
    std::printf("time_ms %.3f\n", ms);

    int w = canvas.get_width();
    int h = canvas.get_height();
    FILE* fh = std::fopen(out.c_str(), "wb");
    std::fprintf(fh, "P6\n%d %d\n255\n", w, h);
    for (int y = 0; y < h; y++) {
        for (int x = 0; x < w; x++) {
            renv::Color c = canvas.get_color(x, y);
            unsigned char px[3] = {c.r(), c.g(), c.b()};
            std::fwrite(px, 1, 3, fh);
        }
    }
    std::fclose(fh);
    std::printf("wrote %s (%dx%d)\n", out.c_str(), w, h);
    return 0;
}
