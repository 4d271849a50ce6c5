"""Path-tracing kernel for NVIDIA GPUs: one Pallas kernel, Triton route.

The XLA wavefront (drt_tpu/renderer.py) is a `lax.scan` over bounces
whose carry (origins, directions, throughput, radiance, liveness — ~14
f32 per ray) goes through device memory on every bounce: XLA does not
fuse across loop iterations. This kernel keeps a whole path in
registers. Each program owns `BLOCK` consecutive pixels and loops over
that block's samples and bounces; per pixel it writes the mean radiance
and nothing else, plus — for a forward that a backward follows — the
8 B/bounce-ray residuals `(sc, best)` from which the reverse sweep
closes the parameter gradients (radiative backprop, reference:
include/drt/integrate.hpp:26-37, biased mode).

Scene baking: geometry, shape->material and shape->emitter maps are
Python literals at build time (the reference hard-codes its scene in
main() the same way, src/render.cpp:26-59). The nearest-hit loop
(pathtracer.hpp:72-89) unrolls over shapes; material dispatch
(bxdf.hpp:12-25) is a select chain over the classes present. Only the
differentiable albedo and emission tables are inputs, read as scalars.

Random numbers: a counter-based hash keyed by (seed, pixel, global
sample, bounce, dim). The draws do not depend on the block size or on
`spp_chunks`, and `hash_tapes` evaluates the same draws XLA-side, so
`trace_rays(..., tape=hash_tapes(...))` is an exact-sample oracle for
the kernel. (The reference draws libc `rand()`, random.hpp:7-10, so it
is comparable only statistically, like any other stream.)

Math forms are the identities of the reference's formulas (exact in real
arithmetic; agree with the XLA path to f32 rounding):
  cosine sampling   theta = asin(sqrt(u1))  =>  cos = sqrt(1-u1),
                                                sin = sqrt(u1)
  specular sampling theta = acos(sqrt(u1^(2/(e+2))))  =>  cos = u1^(1/(e+2))
(bxdf.hpp:69-79, :106-120).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from drt_tpu.config import RenderConfig
from drt_tpu.constants import PI, RAY_EPS
from drt_tpu.ops.vecmath import V3
from drt_tpu.scene import DIFFUSE, MIRROR, PLANE, SPECULAR, SPHERE, Scene

# Pixels per program and warps per program, chosen by a sweep on an
# H100 80GB HBM3 at 700 W over {64, 128, 256, 512} x {2, 4, 8}
# (tools/sweep_pathkernel.py, docs/KERNELS.md): one pixel per thread
# wins, and 64 x 2 and 128 x 4 tie within 2 %.
BLOCK = 64
NUM_WARPS = 2

# Largest scene whose nearest-hit loop is unrolled into the kernel, and
# deepest path: kernel size and compile time grow with both.
MAX_SHAPES = 24
MAX_DEPTH = 32

_TRI_DET_EPS = 1e-9  # matches drt_tpu/ops/intersect.py

# -- counter-based hash RNG --------------------------------------------------

# murmur3 fmix32 constants + Weyl/dim salts (public-domain mixer).
_C1 = np.uint32(0x85EBCA6B)
_C2 = np.uint32(0xC2B2AE35)
_GOLD = np.uint32(0x9E3779B9)
_DIMSALT = np.uint32(0x27D4EB2F)


def _fmix(x):
    """murmur3 finalizer on uint32 (full avalanche)."""
    x = x ^ (x >> np.uint32(16))
    x = x * _C1
    x = x ^ (x >> np.uint32(13))
    x = x * _C2
    x = x ^ (x >> np.uint32(16))
    return x


def _mul(a, c):
    """a * c mod 2^32; literal operands fold in Python."""
    if isinstance(a, np.uint32):
        return np.uint32((int(a) * int(c)) & 0xFFFFFFFF)
    return a * c


def _hash_bits(seed, pix, s, b, dim: int):
    """32 keyed bits for draw (seed, pixel, sample, bounce, dim); all
    operands uint32. Two chained fmix rounds over distinct-multiplier
    key words."""
    h = _fmix(pix * _GOLD + seed)
    return _fmix(h ^ _mul(s, _C1) ^ _mul(b, _C2)
                 ^ _mul(np.uint32(dim), _DIMSALT))


def _bits_to_open_unit(bits_u32, dtype):
    """Uniform in the OPEN interval (0, 1) from 32 bits:
    (bits23 + 0.5) * 2^-23 lies in [2^-24, 1 - 2^-24]. A uniform of
    exactly 0 or 1 would zero a sampling pdf (0/0 radiance). 23 bits,
    not 24: i24 + 0.5 needs 25 significand bits and f32 would round
    (2^24 - 1) + 0.5 up to exactly 1."""
    dtype = np.dtype(dtype).type
    i23 = lax.bitcast_convert_type(bits_u32 >> np.uint32(9), jnp.int32)
    return (i23.astype(dtype) + dtype(0.5)) * dtype(1.0 / (1 << 23))


def _u32(v):
    """i32 -> u32 bit pattern (Python ints fold to a literal)."""
    if isinstance(v, int):
        return np.uint32(v & 0xFFFFFFFF)
    return lax.bitcast_convert_type(jnp.asarray(v, jnp.int32), jnp.uint32)


def hash_uniform(seed, pix, s, b, dim: int, dtype):
    """The keyed uniform exactly as the kernel draws it; evaluable inside
    the kernel and XLA-side (the oracle)."""
    return _bits_to_open_unit(_hash_bits(_u32(seed), _u32(pix), _u32(s),
                                         _u32(b), dim), dtype)


def hash_tapes(seeds, npix: int, spp: int, depth: int, dtype,
               sample_base: int = 0):
    """XLA-side tapes of the kernel's draws in SPP-OUTER ray order (ray
    i -> pixel i % npix, sample i // npix + sample_base): returns
    (cam_u f[2, N], tape f[depth, 3, N]) with N = npix * spp. Feed to
    camera_rays / trace_rays(tape=...) to reproduce the kernel's exact
    sample set. seeds[0] keys the camera jitter, seeds[1] the bounces."""
    i = jnp.arange(npix * spp, dtype=jnp.int32)
    pix = i % npix
    s = i // npix + jnp.int32(sample_base)
    cam = jnp.stack([
        hash_uniform(seeds[0], pix, s, 0, dim, dtype) for dim in (0, 1)])
    tape = jnp.stack([
        jnp.stack([hash_uniform(seeds[1], pix, s, b, dim, dtype)
                   for dim in (0, 1, 2)])
        for b in range(depth)])
    return cam, tape


# -- scene and camera baked to literals --------------------------------------

class StaticScene:
    """Scene arrays frozen to Python/numpy literals for kernel baking."""

    def __init__(self, scene: Scene):
        self.shape_type = np.asarray(scene.shape_type).tolist()
        self.geo = np.asarray(scene.shape_geo, np.float64)
        shape_mat = np.asarray(scene.shape_mat)
        mat_type = np.asarray(scene.mat_type)
        mat_albedo = np.asarray(scene.mat_albedo)
        mat_exponent = np.asarray(scene.mat_exponent, np.float64)
        self.n_shapes = len(self.shape_type)
        self.mat_type = [int(mat_type[m]) for m in shape_mat]
        self.exponent = [float(mat_exponent[m]) for m in shape_mat]
        self.albedo_row = [int(mat_albedo[m]) for m in shape_mat]
        self.emit_row = np.asarray(scene.shape_emit).tolist()


class StaticCamera:
    """Camera basis frozen to literals (the reference hard-codes its
    camera in main() too, src/render.cpp:62-65)."""

    def __init__(self, cam, width: int, height: int):
        self.eye = np.asarray(cam.eye, np.float64)
        self.forward = np.asarray(cam.forward, np.float64)
        self.right = np.asarray(cam.right, np.float64)
        self.up = np.asarray(cam.up, np.float64)
        self.half = float(np.tan(float(cam.vfov) / 2.0))
        self.aspect = float(width) / float(height)
        self.width = width
        self.height = height


def _dot(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def _dot_lit(vx, vy, vz, c):
    """dot((vx,vy,vz), literal 3-vector), dropping exact-zero terms and
    keeping the x->y->z addition order of the survivors."""
    total = None
    for v, k in ((vx, float(c[0])), (vy, float(c[1])), (vz, float(c[2]))):
        if k == 0.0:
            continue
        t = v if k == 1.0 else (-v if k == -1.0 else v * k)
        total = t if total is None else total + t
    return 0.0 if total is None else total


def _intersect_static(ss: StaticScene, o: V3, d: V3, dtype):
    """Unrolled nearest hit over the baked shapes. Returns (best_t,
    masks) with masks[s] = 'nearest hit is shape s' (pathtracer.hpp:
    72-89; per-shape math mirrors drt_tpu/ops/intersect.py)."""
    shape = d.x.shape
    best_t = jnp.full(shape, jnp.inf, dtype)
    best_i = jnp.zeros(shape, jnp.int32)
    for s in range(ss.n_shapes):
        g = ss.geo[s]
        st = ss.shape_type[s]
        if st == PLANE:
            n3 = [dtype(g[0]), dtype(g[1]), dtype(g[2])]
            h = _dot_lit(o.x, o.y, o.z, n3)
            if float(g[3]) != 0.0:
                h = h - dtype(g[3])
            denom = _dot_lit(d.x, d.y, d.z, [-n3[0], -n3[1], -n3[2]])
            t = h / denom
            valid = t > 0
        elif st == SPHERE:
            cx, cy, cz = (dtype(g[0]), dtype(g[1]), dtype(g[2]))
            ocx, ocy, ocz = o.x - cx, o.y - cy, o.z - cz
            b2 = 2.0 * _dot(ocx, ocy, ocz, d.x, d.y, d.z)
            r = dtype(g[3])
            cc = _dot(ocx, ocy, ocz, ocx, ocy, ocz) - r * r
            disc = b2 * b2 - 4.0 * cc
            sq = jnp.sqrt(jnp.maximum(disc, 0.0))
            t1 = (-b2 - sq) / 2.0
            t2 = (-b2 + sq) / 2.0
            t = jnp.where(t1 > 0, t1, t2)
            valid = (disc >= 0) & (t > 0)
        else:  # TRIANGLE (Moller-Trumbore), framework extension
            v0 = g[0:3]
            e1 = g[3:6] - v0
            e2 = g[6:9] - v0
            px = d.y * dtype(e2[2]) - d.z * dtype(e2[1])
            py = d.z * dtype(e2[0]) - d.x * dtype(e2[2])
            pz = d.x * dtype(e2[1]) - d.y * dtype(e2[0])
            det = _dot_lit(px, py, pz, e1)
            tvx, tvy, tvz = (o.x - dtype(v0[0]), o.y - dtype(v0[1]),
                             o.z - dtype(v0[2]))
            qx = tvy * dtype(e1[2]) - tvz * dtype(e1[1])
            qy = tvz * dtype(e1[0]) - tvx * dtype(e1[2])
            qz = tvx * dtype(e1[1]) - tvy * dtype(e1[0])
            inv = 1.0 / det
            u = _dot(tvx, tvy, tvz, px, py, pz) * inv
            v = _dot(d.x, d.y, d.z, qx, qy, qz) * inv
            t = _dot_lit(qx, qy, qz, e2) * inv
            valid = ((jnp.abs(det) > _TRI_DET_EPS) & (u >= 0) & (v >= 0)
                     & (u + v <= 1) & (t > 0))
        closer = valid & (t < best_t)  # strict <: keep-first ties
        best_t = jnp.where(closer, t, best_t)
        best_i = jnp.where(closer, s, best_i)
    hit_valid = jnp.isfinite(best_t)
    masks = [(best_i == s) & hit_valid for s in range(ss.n_shapes)]
    return best_t, masks


def _normal_static(ss: StaticScene, masks, p: V3, dtype) -> V3:
    """Hit normal by per-shape masked select: raw plane normals
    (shape.hpp:58-59), constant triangle normals, normalize(p - c) for
    spheres (shape.hpp:105-106)."""
    nx = jnp.zeros_like(p.x)
    ny = jnp.zeros_like(p.x)
    nz = jnp.zeros_like(p.x)
    for s in range(ss.n_shapes):
        g = ss.geo[s]
        st = ss.shape_type[s]
        m = masks[s]
        if st == SPHERE:
            sx, sy, sz = (p.x - dtype(g[0]), p.y - dtype(g[1]),
                          p.z - dtype(g[2]))
            inv = 1.0 / jnp.sqrt(_dot(sx, sy, sz, sx, sy, sz))
            cn = (sx * inv, sy * inv, sz * inv)
        else:
            if st == PLANE:
                c = g[0:3]
            else:
                c = np.cross(g[3:6] - g[0:3], g[6:9] - g[0:3])
                c = c / np.linalg.norm(c)
            cn = (dtype(c[0]), dtype(c[1]), dtype(c[2]))
        nx = jnp.where(m, cn[0], nx)
        ny = jnp.where(m, cn[1], ny)
        nz = jnp.where(m, cn[2], nz)
    return V3(nx, ny, nz)


def _class_masks(ss: StaticScene, masks):
    """OR the per-shape hit masks together by static attribute."""
    by_mat: dict[int, object] = {}
    by_alb: dict[int, object] = {}
    by_emit: dict[int, object] = {}
    by_exp: dict[float, object] = {}

    def _or(table, k, m):
        table[k] = m if k not in table else (table[k] | m)

    for s in range(ss.n_shapes):
        _or(by_mat, ss.mat_type[s], masks[s])
        _or(by_alb, ss.albedo_row[s], masks[s])
        _or(by_emit, ss.emit_row[s], masks[s])
        if ss.mat_type[s] == SPECULAR:
            _or(by_exp, ss.exponent[s], masks[s])
    return by_mat, by_alb, by_emit, by_exp


def _gather_table(tab_ref, by_row: dict, shape, dtype, default: float):
    """Select-chain 'gather' of a tiny table by row masks. The last row
    is the padded sentinel (constant `default`, drt_tpu/scene.py
    albedo_table / emission_table)."""
    sentinel = tab_ref.shape[0] - 1
    out = [jnp.full(shape, default, dtype) for _ in range(3)]
    for row, m in by_row.items():
        if row >= sentinel:
            continue
        for c in range(3):
            out[c] = jnp.where(m, tab_ref[row, c], out[c])
    return V3(*out)


def _shade(by_mat: dict, by_exp: dict, normal: V3, d_in: V3, u1, u2,
           dtype):
    """Branch-free BxDF sample + scalar eval over the material classes
    present (mirrors drt_tpu/ops/bxdf.py: bxdf.hpp:29-41, :56-144), given
    the hit masks by material type and by specular exponent. Returns
    (dir_out, sc_raw) with sc_raw = s * cos / pdf, unsanitized."""

    if DIFFUSE in by_mat or SPECULAR in by_mat:
        # Frame about the raw normal (bxdf.hpp:29-41).
        use_e1 = jnp.abs(normal.x) < jnp.abs(normal.y)
        tvx = jnp.where(use_e1, 1.0 - normal.x * normal.x,
                        -normal.x * normal.y)
        tvy = jnp.where(use_e1, -normal.y * normal.x,
                        1.0 - normal.y * normal.y)
        tvz = jnp.where(use_e1, -normal.z * normal.x, -normal.z * normal.y)
        tinv = 1.0 / jnp.sqrt(_dot(tvx, tvy, tvz, tvx, tvy, tvz))
        tx, ty, tz = tvx * tinv, tvy * tinv, tvz * tinv
        bx = normal.y * tz - normal.z * ty
        by = normal.z * tx - normal.x * tz
        bz = normal.x * ty - normal.y * tx
        binv = 1.0 / jnp.sqrt(_dot(bx, by, bz, bx, by, bz))
        bx, by, bz = bx * binv, by * binv, bz * binv
        cos_phi = jnp.cos(2.0 * PI * u2)
        sin_phi = jnp.sin(2.0 * PI * u2)

    def frame_dir(cos_t, sin_t):
        fx = cos_phi * sin_t
        fy = sin_phi * sin_t
        return V3(tx * fx + bx * fy + normal.x * cos_t,
                  ty * fx + by * fy + normal.y * cos_t,
                  tz * fx + bz * fy + normal.z * cos_t)

    def reflect(v: V3, n: V3) -> V3:
        k = 2.0 * _dot(n.x, n.y, n.z, v.x, v.y, v.z)
        return V3(-v.x + k * n.x, -v.y + k * n.y, -v.z + k * n.z)

    def select(m, dd, sc_new, dir_out, sc):
        return (V3(jnp.where(m, dd.x, dir_out.x),
                   jnp.where(m, dd.y, dir_out.y),
                   jnp.where(m, dd.z, dir_out.z)),
                jnp.where(m, sc_new, sc))

    zero = jnp.zeros_like(u1)
    dir_out = V3(zero, zero, zero)
    sc = zero

    if DIFFUSE in by_mat:
        cos_t = jnp.sqrt(jnp.maximum(1.0 - u1, 0.0))
        dd = frame_dir(cos_t, jnp.sqrt(u1))
        # cos uses the RAW normal dot like the tracer (pathtracer.hpp:103).
        cos_geom = _dot(normal.x, normal.y, normal.z, dd.x, dd.y, dd.z)
        pdf = cos_t / PI
        # pdf > 0 guard (renderer.py _bounce): u1 == 1 gives 0/0.
        sc_d = jnp.where(pdf > 0, (1.0 / PI) * cos_geom / pdf, dtype(0.0))
        dir_out, sc = select(by_mat[DIFFUSE], dd, sc_d, dir_out, sc)

    for expo, m in by_exp.items():
        # Half-vector sampling (bxdf.hpp:106-120), one static exponent
        # class at a time.
        e = dtype(expo)
        cos_h = jnp.power(u1, 1.0 / (expo + 2.0))
        sin_h = jnp.sqrt(jnp.maximum(1.0 - cos_h * cos_h, 0.0))
        h = frame_dir(cos_h, sin_h)
        flip = _dot(h.x, h.y, h.z, d_in.x, d_in.y, d_in.z) < 0
        hf = reflect(h, normal)
        h = V3(jnp.where(flip, hf.x, h.x), jnp.where(flip, hf.y, h.y),
               jnp.where(flip, hf.z, h.z))
        dd = reflect(d_in, h)
        # eval (bxdf.hpp:93-104) against the recomputed halfway vector.
        hwx, hwy, hwz = d_in.x + dd.x, d_in.y + dd.y, d_in.z + dd.z
        hw2 = _dot(hwx, hwy, hwz, hwx, hwy, hwz)
        hinv = 1.0 / jnp.sqrt(hw2)
        cos_he = _dot(normal.x, normal.y, normal.z,
                      hwx * hinv, hwy * hinv, hwz * hinv)
        sin_he = jnp.sqrt(jnp.maximum(1.0 - cos_he * cos_he, 0.0))
        # C++ pow semantics for a negative base (ops/bxdf.py:_pow_cpp).
        mag = jnp.power(jnp.abs(cos_he), e)
        if float(expo) == int(expo):
            powv = (mag * jnp.where(cos_he < 0, dtype(-1.0), dtype(1.0))
                    if int(expo) % 2 == 1 else mag)
        else:
            powv = jnp.where(cos_he < 0, jnp.nan, mag)
        cos_geom = _dot(normal.x, normal.y, normal.z, dd.x, dd.y, dd.z)
        # pdf > 0 guard (f32 u1 near 1 collapses cos_h to 1) and the
        # degenerate-halfway guard (ops/bxdf.py eval_scale).
        pdf = (e + 2.0) / (2.0 * PI) * jnp.power(cos_h, e + 1.0) * sin_h
        s_val = jnp.where(hw2 > 0, (e + 2.0) / (2.0 * PI) * powv * sin_he,
                          dtype(0.0))
        sc_s = jnp.where(pdf > 0, s_val * cos_geom / pdf, dtype(0.0))
        dir_out, sc = select(m, dd, sc_s, dir_out, sc)

    if MIRROR in by_mat:
        dd = reflect(d_in, normal)
        cos_geom = _dot(normal.x, normal.y, normal.z, dd.x, dd.y, dd.z)
        # eval = 1/cos, pdf = 1 (bxdf.hpp:131-136); cos == 0 guarded
        # like ops/bxdf.py (inf * 0).
        sc_m = jnp.where(cos_geom != 0, (1.0 / cos_geom) * cos_geom,
                         dtype(0.0))
        dir_out, sc = select(by_mat[MIRROR], dd, sc_m, dir_out, sc)

    # NULL_BXDF shapes and misses keep dir_out = 0, sc = 0.
    return dir_out, sc


def _camera_dir(sc: StaticCamera, pix, u_s, u_t, dtype) -> V3:
    """Primary-ray direction for per-lane pixel indices (camera.hpp:
    51-60, mirroring drt_tpu/camera.py camera_rays; the origin is the
    eye)."""
    y = pix // sc.width
    x = pix - y * sc.width
    s = (x.astype(dtype) + u_s) / dtype(sc.width)
    t = (y.astype(dtype) + u_t) / dtype(sc.height)
    a = (2.0 * s - 1.0) * dtype(sc.aspect * sc.half)
    b = (2.0 * t - 1.0) * dtype(sc.half)
    # d = normalize(forward + right * a - up * b) (camera.hpp:57).
    comps = [dtype(sc.forward[i]) + a * dtype(sc.right[i])
             - b * dtype(sc.up[i]) for i in range(3)]
    inv = 1.0 / jnp.sqrt(_dot(*comps, *comps))
    return V3(comps[0] * inv, comps[1] * inv, comps[2] * inv)


# -- kernels ------------------------------------------------------------------

def padded_pixels(cfg: RenderConfig) -> int:
    """Pixel count rounded up to whole blocks."""
    npix = cfg.width * cfg.height
    return -(-npix // BLOCK) * BLOCK


def residual_bytes(cfg: RenderConfig) -> int:
    """Device bytes of the stored residuals (f32 sc + i32 best per
    bounce-ray) that a differentiable forward keeps for the sweep."""
    return 8 * cfg.spp * cfg.max_depth * padded_pixels(cfg)


def _compiler_params():
    return plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=1)


def make_path_tracer(scene: Scene, cam, cfg: RenderConfig,
                     collect: bool = False, interpret: bool = False):
    """Build `trace(albedo_tab, emission_tab, seeds: i32[2]) -> image
    f[H, W, 3]`, the per-pixel mean of cfg.spp paths.

    collect=True also returns the residuals `(rsc: f[spp*D, P], rbest:
    i32[spp*D, P])`, row s*D + b for sample s and bounce b, P the padded
    pixel count; best is 1 + the index of the shape the live path hit,
    0 for a dead path.
    """
    ss = StaticScene(scene)
    sc = StaticCamera(cam, cfg.width, cfg.height)
    D = cfg.max_depth
    npix = cfg.width * cfg.height
    n_pad = padded_pixels(cfg)
    inv_keep = 1.0 / (1.0 - cfg.absorb_prob)

    def kernel(seed_ref, alb_ref, emis_ref, lx_ref, ly_ref, lz_ref,
               rsc_ref=None, rbest_ref=None):
        dtype = np.float32
        first = pl.program_id(0) * BLOCK
        lanes = first + lax.broadcasted_iota(jnp.int32, (BLOCK,), 0)
        pix = jnp.minimum(lanes, npix - 1)  # padding lanes repeat a pixel
        pix_u = _u32(pix)
        seed0 = _u32(seed_ref[0])
        seed1 = _u32(seed_ref[1])

        def draw(seed, s_u, b, dim):
            return _bits_to_open_unit(
                _hash_bits(seed, pix_u, s_u, _u32(b), dim), dtype)

        def sample(s, acc):
            s_u = _u32(s)
            d = _camera_dir(sc, pix, draw(seed0, s_u, 0, 0),
                            draw(seed0, s_u, 0, 1), dtype)
            o = V3(*(jnp.full((BLOCK,), dtype(c), dtype) for c in sc.eye))
            one = jnp.ones((BLOCK,), dtype)
            zero = jnp.zeros((BLOCK,), dtype)

            def bounce(b, carry):
                # Mirrors drt_tpu/renderer.py _bounce (pathtracer.hpp:
                # 91-136): RR at depth b, nearest hit, emission, BxDF.
                o, d, T, L, alive = carry
                do_rr = b >= cfg.min_bounces
                alive = alive & ~(do_rr & (draw(seed1, s_u, b, 0)
                                           < cfg.absorb_prob))
                rr_scale = jnp.where(do_rr, dtype(inv_keep), dtype(1.0))
                best_t, masks = _intersect_static(ss, o, d, dtype)
                hit_any = masks[0]
                for m in masks[1:]:
                    hit_any = hit_any | m
                alive = alive & hit_any
                masks = [m & alive for m in masks]
                by_mat, by_alb, by_emit, by_exp = _class_masks(ss, masks)
                gate = jnp.where(alive, rr_scale, dtype(0.0))
                P = T * gate
                e = _gather_table(emis_ref, by_emit, (BLOCK,), dtype, 0.0)
                L = L + P * e
                # Dead-path hit data is inf/NaN: zero it so NaN never
                # reaches the throughput.
                p = V3(*(jnp.where(alive, oc + dc * best_t, 0.0)
                         for oc, dc in zip(o, d)))
                normal = _normal_static(ss, masks, p, dtype)
                d_in = V3(-d.x, -d.y, -d.z)
                dir_out, sc_raw = _shade(by_mat, by_exp, normal, d_in,
                                         draw(seed1, s_u, b, 1),
                                         draw(seed1, s_u, b, 2), dtype)
                sc_b = jnp.where(alive, sc_raw, dtype(0.0))
                if collect:
                    best = jnp.zeros((BLOCK,), jnp.int32)
                    for i, m in enumerate(masks):
                        best = jnp.where(m, i + 1, best)
                    row = s * D + b
                    rsc_ref[row, pl.ds(first, BLOCK)] = sc_b
                    rbest_ref[row, pl.ds(first, BLOCK)] = best
                a = _gather_table(alb_ref, by_alb, (BLOCK,), dtype, 1.0)
                T = P * (a * sc_b)
                o = V3(*(jnp.where(alive, pc + dc * RAY_EPS, 0.0)
                         for pc, dc in zip(p, dir_out)))
                d = V3(*(jnp.where(alive, dc, 0.0) for dc in dir_out))
                return o, d, T, L, alive

            carry = (o, d, V3(one, one, one), V3(zero, zero, zero),
                     jnp.ones((BLOCK,), bool))
            L = lax.fori_loop(jnp.int32(0), jnp.int32(D), bounce, carry)[3]
            return acc + L

        z = jnp.zeros((BLOCK,), dtype)
        L = lax.fori_loop(jnp.int32(0), jnp.int32(cfg.spp), sample,
                          V3(z, z, z)) * dtype(1.0 / cfg.spp)
        lx_ref[...] = L.x
        ly_ref[...] = L.y
        lz_ref[...] = L.z

    pix_spec = pl.BlockSpec((BLOCK,), lambda i: (i,))
    whole = pl.no_block_spec
    out_shape = [jax.ShapeDtypeStruct((n_pad,), jnp.float32)] * 3
    out_specs = [pix_spec] * 3
    if collect:
        out_shape += [jax.ShapeDtypeStruct((cfg.spp * D, n_pad),
                                           jnp.float32),
                      jax.ShapeDtypeStruct((cfg.spp * D, n_pad), jnp.int32)]
        out_specs += [whole, whole]
    call = pl.pallas_call(
        kernel,
        grid=(n_pad // BLOCK,),
        in_specs=[whole, whole, whole],
        out_specs=out_specs,
        out_shape=out_shape,
        backend="triton",
        compiler_params=_compiler_params(),
        interpret=interpret,
        name="path_trace_collect" if collect else "path_trace",
    )

    def trace(albedo_tab, emission_tab, seeds):
        out = call(seeds.astype(jnp.int32),
                   albedo_tab.astype(jnp.float32),
                   emission_tab.astype(jnp.float32))
        img = jnp.stack([c[:npix].reshape(cfg.height, cfg.width)
                         for c in out[:3]], axis=-1)
        if collect:
            return img, out[3], out[4]
        return img

    return trace


def make_path_sweep(scene: Scene, cfg: RenderConfig,
                    interpret: bool = False):
    """Build the reverse sweep over stored residuals:
    `sweep(albedo_tab, emission_tab, rsc, rbest, g) -> (d_albedo_tab,
    d_emission_tab)` for a per-pixel cotangent g f[H, W, 3] of the image
    that `make_path_tracer` returns.

    Per path it replays the throughput recurrence from (sc, best) —
    gate_b = rr_scale_b * [best_b > 0], P_b = T_{b-1} gate_b, T_b = P_b
    a_b sc_b — then runs the suffix sweep of adjoint._param_grads:
    S_b = gate_b (e_b + a_b sc_b S_{b+1}), d e_l += g P_b [eid_b = l],
    d a_k += g P_b sc_b S_{b+1} [aid_b = k]. Each program keeps per-lane
    partial sums over its samples and writes one row of an
    [n_programs, R] output; XLA sums the rows, so nothing carries between
    programs.
    """
    ss = StaticScene(scene)
    D = cfg.max_depth
    npix = cfg.width * cfg.height
    n_pad = padded_pixels(cfg)
    n_prog = n_pad // BLOCK
    inv_keep = 1.0 / (1.0 - cfg.absorb_prob)

    def build(n_alb: int, n_emit: int):
        # Gradient slots: (table, row, channel) for every row some shape
        # reads (sentinel rows have no parameter).
        alb_rows = sorted({r for r in ss.albedo_row if r < n_alb - 1})
        emit_rows = sorted({r for r in ss.emit_row if r < n_emit - 1})
        slots = ([("a", r, c) for r in alb_rows for c in range(3)]
                 + [("e", r, c) for r in emit_rows for c in range(3)])
        width = max(1, len(slots))
        width = 1 << (width - 1).bit_length()  # Triton blocks: power of 2

        def kernel(alb_ref, emis_ref, rsc_ref, rbest_ref, gx_ref, gy_ref,
                   gz_ref, out_ref):
            dtype = np.float32
            first = pl.program_id(0) * BLOCK
            cols = pl.ds(first, BLOCK)
            g = V3(gx_ref[...], gy_ref[...], gz_ref[...])

            def sample(s, acc):
                acc = dict(zip(slots, acc))
                T = V3(*(jnp.ones((BLOCK,), dtype) for _ in range(3)))
                fwd = []
                for b in range(D):
                    sc_b = rsc_ref[s * D + b, cols]
                    best = rbest_ref[s * D + b, cols]
                    rr = dtype(inv_keep if b >= cfg.min_bounces else 1.0)
                    gate = jnp.where(best > 0, rr, dtype(0.0))
                    P = T * gate
                    masks = [best == (i + 1) for i in range(ss.n_shapes)]
                    _, by_alb, by_emit, _ = _class_masks(ss, masks)
                    a = _gather_table(alb_ref, by_alb, (BLOCK,), dtype, 1.0)
                    T = P * (a * sc_b)
                    fwd.append((P, sc_b, gate, a, by_alb, by_emit))
                S = V3(*(jnp.zeros((BLOCK,), dtype) for _ in range(3)))
                for P, sc_b, gate, a, by_alb, by_emit in reversed(fwd):
                    e = _gather_table(emis_ref, by_emit, (BLOCK,), dtype,
                                      0.0)
                    gP = g * P
                    gPsS = gP * sc_b * S
                    for (kind, row, c) in slots:
                        table, val = ((by_emit, gP) if kind == "e"
                                      else (by_alb, gPsS))
                        if row in table:
                            acc[(kind, row, c)] = acc[(kind, row, c)] + \
                                jnp.where(table[row], val[c], 0.0)
                    S = (e + a * sc_b * S) * gate
                return tuple(acc[k] for k in slots)

            acc0 = tuple(jnp.zeros((BLOCK,), dtype) for _ in slots)
            acc = lax.fori_loop(jnp.int32(0), jnp.int32(cfg.spp), sample,
                                acc0)
            slot_id = lax.broadcasted_iota(jnp.int32, (1, width), 1)
            row_out = jnp.zeros((1, width), dtype)
            for i, v in enumerate(acc):
                row_out = jnp.where(slot_id == i, jnp.sum(v), row_out)
            out_ref[...] = row_out

        pix_spec = pl.BlockSpec((BLOCK,), lambda i: (i,))
        whole = pl.no_block_spec
        call = pl.pallas_call(
            kernel,
            grid=(n_prog,),
            in_specs=[whole, whole, whole, whole,
                      pix_spec, pix_spec, pix_spec],
            out_specs=pl.BlockSpec((1, width), lambda i: (i, 0)),
            out_shape=jax.ShapeDtypeStruct((n_prog, width), jnp.float32),
            backend="triton",
            compiler_params=_compiler_params(),
            interpret=interpret,
            name="path_sweep",
        )
        return slots, call

    def sweep(albedo_tab, emission_tab, rsc, rbest, g):
        n_alb, n_emit = albedo_tab.shape[0], emission_tab.shape[0]
        slots, call = build(n_alb, n_emit)
        gp = [jnp.pad(g[:, :, c].reshape(-1).astype(jnp.float32),
                      (0, n_pad - npix)) for c in range(3)]
        # One program's partial sums per row; the cross-program sum
        # runs in XLA.
        tot = call(albedo_tab.astype(jnp.float32),
                   emission_tab.astype(jnp.float32), rsc, rbest,
                   *gp).sum(axis=0)
        da = jnp.zeros((n_alb, 3), jnp.float32)
        de = jnp.zeros((n_emit, 3), jnp.float32)
        for i, (kind, row, c) in enumerate(slots):
            if kind == "a":
                da = da.at[row, c].set(tot[i])
            else:
                de = de.at[row, c].set(tot[i])
        return da, de

    return sweep
