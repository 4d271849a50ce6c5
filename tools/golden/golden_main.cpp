// Golden-parity harness: runs the REFERENCE renderer's own headers
// (included from /root/reference, never copied into this repo) with an
// injected deterministic uniform stream, and dumps raw doubles for the
// Python test suite to compare against the JAX framework.
//
// This file is original harness code (argument parsing, tape-backed rand,
// binary dumping); the traced scene is the reference's sample scene
// (src/render.cpp:26-65), reproduced here because parity is defined on
// exactly that scene.
//
// Build:  g++ -O2 -std=c++17 -I <ref>/include golden_main.cpp -o golden
// Usage:  golden W H SPP MIN_BOUNCES ABSORB TAPE_FILE OUT_FILE GRAD(0|1)
//                [UNBIASED(0|1)]
//
// TAPE_FILE: little-endian int32 array, values in [0, RAND_MAX); consumed
// sequentially by the rand() override below (libc's rand is preempted at
// link time, so drt::random::uniform() = rand()/RAND_MAX reads the tape —
// reference: include/drt/random.hpp:7-10).
//
// OUT_FILE layout (all doubles):
//   W*H*3  image (row-major, RGB)
//   4*3    gradients of sum over samples of backward(1):
//          d/d{red, green, white, emission}        (grad mode only)
//   1      number of tape values consumed (as double)
//   1      render-loop wall seconds (pixel loop only, excl. IO/startup)

#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#include "drt/bxdf.hpp"
#include "drt/camera.hpp"
#include "drt/emitter.hpp"
#include "drt/integrate.hpp"
#include "drt/pathtracer.hpp"
#include "drt/shape.hpp"
#include "drt/vector.hpp"

namespace {
std::vector<int> g_tape;
std::size_t g_pos = 0;
}

// Preempts libc rand() for every call in this binary, including the
// reference's inline drt::random::uniform().
extern "C" int rand() {
    if (g_pos >= g_tape.size()) {
        std::fprintf(stderr, "tape exhausted after %zu draws\n", g_pos);
        std::exit(3);
    }
    return g_tape[g_pos++];
}

using namespace drt;
using T = double;

// Reimplementation of drt::Pathtracer (pathtracer.hpp:53-136) with the
// `unbiased` flag of drt::integrate (integrate.hpp:56-66) exposed — the
// reference hard-codes `false` at pathtracer.hpp:111 and keeps
// raycast/scatter private, so enabling the reference's OWN unbiased
// machinery (IntegrateBackward, integrate.hpp:11-24) requires this
// harness-side mirror. Category-(b) parity scaffolding: the structure is
// forced line-by-line by the semantics being tested.
class HarnessTracer {
public:
    HarnessTracer(double absorb, std::size_t min_bounces, bool unbiased)
      : m_absorb(absorb), m_min_bounces(min_bounces),
        m_unbiased(unbiased) { }

    Vector<T, 3, true> trace(const Scene<T>& scene, Vector<T, 3> orig,
                             Vector<T, 3> dir, std::size_t depth = 0) const
    {
        // pathtracer.hpp:121-136
        if (depth >= m_min_bounces && random::uniform() < m_absorb)
            return Vector<T, 3>(0);
        double p = depth >= m_min_bounces ? (1 - m_absorb) : 1;
        Hit hit;
        if (raycast(scene, orig, dir, hit))
            return scatter(scene, hit, dir, depth) / p;
        return Vector<T, 3>(0);
    }

private:
    struct Hit {
        Vector<T, 3> point;
        Vector<T, 3> normal;
        BxDF<T>* bxdf;
        Emitter<T>* emitter;
    };

    bool raycast(const Scene<T>& scene, Vector<T, 3> orig,
                 Vector<T, 3> dir, Hit& hit) const
    {
        // pathtracer.hpp:72-89
        double tmin = inf;
        for (auto shape : scene) {
            double t;
            if (!shape->intersect(orig, dir, t) || t >= tmin)
                continue;
            tmin = t;
            hit.point = orig + t * dir;
            hit.normal = shape->normal(hit.point);
            hit.bxdf = shape->bxdf();
            hit.emitter = shape->emitter();
        }
        return !std::isinf(tmin);
    }

    Vector<T, 3, true> scatter(const Scene<T>& scene, Hit& hit,
                               Vector<T, 3> dir_in,
                               std::size_t depth) const
    {
        // pathtracer.hpp:91-115 with the integrate unbiased flag wired.
        Vector<T, 3, true> diffuse = integrate<T, 3>(
            [=](const Vector<T, 3>& dir_out) {
                Vector<T, 3> orig = hit.point + 1e-3 * dir_out;
                Vector<T, 3, true> brdf_value = internal::eval_bxdf(
                    hit.bxdf, hit.normal, -dir_in, dir_out);
                Vector<T, 3, true> radiance =
                    trace(scene, orig, dir_out, depth + 1);
                double cos_theta = dot(hit.normal, dir_out);
                return brdf_value * radiance * cos_theta;
            },
            [=]() {
                return internal::sample_bxdf(hit.bxdf, hit.normal,
                                             -dir_in);
            },
            1, m_unbiased);
        Vector<T, 3, true> emission = internal::emission(hit.emitter);
        return emission + diffuse;
    }

    double m_absorb;
    std::size_t m_min_bounces;
    bool m_unbiased;
};

int main(int argc, char** argv) {
    if (argc != 9 && argc != 10) {
        std::fprintf(stderr,
            "usage: %s W H SPP MIN_BOUNCES ABSORB TAPE OUT GRAD "
            "[UNBIASED]\n", argv[0]);
        return 1;
    }
    const std::size_t width = std::strtoul(argv[1], nullptr, 10);
    const std::size_t height = std::strtoul(argv[2], nullptr, 10);
    const std::size_t spp = std::strtoul(argv[3], nullptr, 10);
    const std::size_t min_bounces = std::strtoul(argv[4], nullptr, 10);
    const double absorb = std::strtod(argv[5], nullptr);
    const char* tape_path = argv[6];
    const char* out_path = argv[7];
    const bool grad_mode = std::strtoul(argv[8], nullptr, 10) != 0;
    const bool unbiased =
        argc == 10 && std::strtoul(argv[9], nullptr, 10) != 0;

    // Load tape.
    FILE* tf = std::fopen(tape_path, "rb");
    if (!tf) { std::perror("tape"); return 2; }
    std::fseek(tf, 0, SEEK_END);
    long bytes = std::ftell(tf);
    std::fseek(tf, 0, SEEK_SET);
    g_tape.resize(bytes / sizeof(int));
    if (std::fread(g_tape.data(), sizeof(int), g_tape.size(), tf)
            != g_tape.size()) {
        std::fprintf(stderr, "short tape read\n");
        return 2;
    }
    std::fclose(tf);

    // Scene parameters and materials — the reference sample scene
    // (src/render.cpp:26-36).
    Vector<T, 3, true> red(Vector<T, 3>{0.5, 0, 0}, true);
    Vector<T, 3, true> green(Vector<T, 3>{0, 0.5, 0}, true);
    Vector<T, 3, true> white(Vector<T, 3>{0.5, 0.5, 0.5}, true);
    Vector<T, 3, true> emission(Vector<T, 3>(1), true);
    auto diffuse_red = std::make_shared<DiffuseBxDF<T>>(red);
    auto diffuse_green = std::make_shared<DiffuseBxDF<T>>(green);
    auto diffuse_white = std::make_shared<DiffuseBxDF<T>>(white);
    auto emitter = std::make_shared<AreaEmitter<T>>(emission);

    // Shapes in reference scene-list order (src/render.cpp:39-59).
    Sphere<T> sphere_front(Vector<T, 3>{0., 0., 3.}, 1., diffuse_white);
    Sphere<T> sphere_back(Vector<T, 3>{-1., 1., 4.5}, 1., diffuse_white);
    Plane<T> left_plane(Vector<T, 3>{-1., 0., 0.}, -3., diffuse_red);
    Plane<T> right_plane(Vector<T, 3>{1., 0., 0.1}, -3., diffuse_green);
    Plane<T> back_plane(Vector<T, 3>{0., 0., -1.}, -6., diffuse_white);
    Plane<T> front_plane(Vector<T, 3>{0, 0, 1}, 0, diffuse_white);
    Plane<T> ground_plane(Vector<T, 3>{0., 1., 0.}, -3., diffuse_white);
    Plane<T> ceiling_plane(Vector<T, 3>{0., -1., 0.}, -3., diffuse_white);
    Sphere<T> light(Vector<T, 3>{0., 3., 3.}, 1., nullptr, emitter);
    Scene<T> scene{&sphere_front, &sphere_back, &left_plane, &right_plane,
                   &back_plane, &front_plane, &ground_plane, &ceiling_plane,
                   &light};

    Camera<T> cam(width, height);
    cam.look_at(Vector<T, 3>{0, 0, 0}, Vector<T, 3>{0, 0, 1});
    // Biased mode runs the reference's own Pathtracer; unbiased mode
    // needs the harness mirror (see HarnessTracer above).
    Pathtracer<T> tracer(absorb, min_bounces);
    HarnessTracer utracer(absorb, min_bounces, true);

    std::vector<double> img(width * height * 3, 0.0);
    auto t_start = std::chrono::steady_clock::now();
    for (std::size_t y = 0; y < height; ++y) {
        for (std::size_t x = 0; x < width; ++x) {
            Vector<T, 3> pixel(0);
            for (std::size_t i = 0; i < spp; ++i) {
                auto [dir, pdf] = cam.sample(x, y);
                Vector<T, 3, true> radiance = unbiased
                    ? utracer.trace(scene, cam.eye(), dir)
                    : tracer.trace(scene, cam.eye(), dir);
                pixel += radiance.detach() / pdf;
                if (grad_mode)
                    radiance.backward(Vector<T, 3>(1));
            }
            pixel /= double(spp);
            for (int c = 0; c < 3; ++c)
                img[(y * width + x) * 3 + c] = pixel[c];
        }
    }
    double render_seconds = std::chrono::duration<double>(
        std::chrono::steady_clock::now() - t_start).count();

    FILE* of = std::fopen(out_path, "wb");
    if (!of) { std::perror("out"); return 2; }
    std::fwrite(img.data(), sizeof(double), img.size(), of);
    if (grad_mode) {
        const Vector<T, 3, true>* params[4] = {&red, &green, &white,
                                               &emission};
        for (auto* p : params) {
            double g[3] = {p->grad()[0], p->grad()[1], p->grad()[2]};
            std::fwrite(g, sizeof(double), 3, of);
        }
    }
    double consumed = double(g_pos);
    std::fwrite(&consumed, sizeof(double), 1, of);
    std::fwrite(&render_seconds, sizeof(double), 1, of);
    std::fclose(of);
    return 0;
}
