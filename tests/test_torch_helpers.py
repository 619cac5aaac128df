"""Shared helpers for the tests of the PyTorch/CUDA port
(``tests/test_torch_*.py``): hand the JAX package's scene and camera to
the port as plain numpy, build the test scenes in either package, and bring
the JAX package's gradient stash and gradients dict to numpy.
"""

import dataclasses

import numpy as np


def mesh_tree(proto):
    """JAX ``MeshProto`` -> dict of numpy arrays (tuples of them for the
    level boxes) and ints, the form ``mesh_bvh.proto_from_numpy`` takes."""
    out = {}
    for f in dataclasses.fields(proto):
        v = getattr(proto, f.name)
        if isinstance(v, tuple):
            out[f.name] = tuple(np.asarray(a) for a in v)
        elif isinstance(v, int):
            out[f.name] = v
        else:
            out[f.name] = np.asarray(v)
    return out


def scene_tree(jscene):
    """JAX ``Scene`` -> nested dict of numpy arrays and flags, the form
    ``go_raytracing_tpu_torch.convert.scene_from_numpy`` takes."""
    def pack(p):
        return {k: (None if v is None else np.asarray(v))
                for k, v in p._asdict().items()}

    tree = {}
    for f in dataclasses.fields(jscene):
        v = getattr(jscene, f.name)
        if f.name in ("spheres", "planar", "volumes", "materials", "textures"):
            tree[f.name] = pack(v)
        elif f.name.startswith("light_"):
            tree[f.name] = np.asarray(v)
        elif f.name == "meshes":
            tree[f.name] = [mesh_tree(p) for p in v]
        else:
            tree[f.name] = v
    return tree


def port_and_jax(build, cam_fields):
    """One scene and camera in both packages: (JAX scene, JAX camera, the
    port's scene on the CPU carried across as numpy, the port's camera)."""
    import go_raytracing_tpu as grt
    from go_raytracing_tpu import camera as jcamera
    from go_raytracing_tpu_torch import convert

    js = build(grt)
    jcam = jcamera.Camera(**cam_fields)
    ts = convert.scene_from_numpy(scene_tree(js), "cpu")
    return js, jcam, ts, convert.camera_from_dict(dataclasses.asdict(jcam))


def build_mixed(pkg, **build_kwargs):
    """The mixed scene of tests/test_pallas.py's megakernel test: checker
    plane, metal, dielectric and moving spheres, quad, quad light, box
    volume.  ``pkg`` is either package (both expose SceneBuilder)."""
    b = pkg.SceneBuilder()
    checker_floor = b.lambertian(b.checker(0.7, (0.2, 0.2, 0.2), (0.9, 0.9, 0.9)))
    b.plane((0, 0, 0), (0, 1, 0), checker_floor)
    b.sphere((0, 1, -1), 0.8, b.metal((0.9, 0.8, 0.5), 0.2))
    b.sphere((-1.8, 0.8, 0), 0.7, b.dielectric(1.5))
    b.moving_sphere((1.8, 0.5, 0.5), (2.2, 0.9, 0.5), 0.4,
                    b.lambertian((0.2, 0.5, 0.8)))
    b.quad((1.0, 0.2, 0.8), (1.2, 0, 0), (0, 1.2, 0), b.lambertian((0.7, 0.2, 0.2)))
    light = b.diffuse_light((6, 6, 6))
    q = b.quad((-1, 4, -1), (2, 0, 0), (0, 0, 2), light)
    b.add_light(q)
    b.volume_box((-3, 0, -3), (3, 3, 3), 0.02, (0.8, 0.8, 0.8))
    return b.build(**build_kwargs)


MIXED_CAM = dict(
    image_width=16, aspect_ratio=1.0, samples_per_pixel=4, max_depth=4,
    look_from=(0, 2, 5), look_at=(0, 0.8, 0), background=(0.1, 0.1, 0.2),
    vfov=45.0, use_sky_gradient=False,
)


def build_mini_cornell(pkg, **build_kwargs):
    """The gradient test scene of tests/test_grad_kernel.py (checker floor,
    red wall, white ceiling and box, a fog volume filling the room, a quad
    light), with the light made bright enough (400, 380, 360) that the
    firefly clamp bites on the box's top and not on the floor.  Every
    gradient source of the product-chain tier at once."""
    b = pkg.SceneBuilder()
    white = b.lambertian((0.73, 0.72, 0.71))
    red = b.lambertian((0.65, 0.05, 0.05))
    checker = b.lambertian(b.checker(2.0, (0.2, 0.3, 0.1), (0.9, 0.9, 0.8)))
    light = b.diffuse_light((400.0, 380.0, 360.0))
    b.quad((0, 0, 0), (555, 0, 0), (0, 0, 555), checker)        # floor
    b.quad((555, 0, 0), (0, 555, 0), (0, 0, 555), red)          # right
    b.quad((555, 555, 555), (-555, 0, 0), (0, 0, -555), white)  # ceiling
    q = b.quad((213, 554, 227), (130, 0, 0), (0, 0, 105), light)
    b.add_light(q)
    b.box((150, 0, 150), (350, 200, 350), white)
    b.volume_box((0.1, 0.1, 0.1), (554.9, 554.9, 554.9), 0.0008,
                 (0.9, 0.95, 1.0))
    return b.build(**build_kwargs)


MINI_CORNELL_CAM = dict(
    image_width=24, aspect_ratio=1.0, samples_per_pixel=4, max_depth=4,
    look_from=(278, 278, -800), look_at=(278, 278, 0), vfov=40.0,
    background=(0.02, 0.01, 0.03),
)


def build_sky_diffuse(pkg, **build_kwargs):
    """Checker floor, two lambertian spheres and a quad light under the
    sky gradient (the product-tier scene of tests/test_grad_render.py plus
    a sphere): misses at every depth carry the sky colour."""
    b = pkg.SceneBuilder()
    b.quad((-5, 0, -5), (10, 0, 0), (0, 0, 10),
           b.lambertian(b.checker(0.8, (0.7, 0.3, 0.2), (0.2, 0.3, 0.7))))
    b.sphere((0, 1, 0), 1.0, b.lambertian((0.2, 0.6, 0.3)))
    b.sphere((-2, 0.7, 1), 0.7, b.lambertian((0.6, 0.5, 0.4)))
    q = b.quad((-1, 4, -1), (2, 0, 0), (0, 0, 2), b.diffuse_light((5, 5, 5)))
    b.add_light(q)
    return b.build(**build_kwargs)


SKY_CAM = dict(
    image_width=16, aspect_ratio=1.0, samples_per_pixel=4, max_depth=3,
    look_from=(0, 2, 6), look_at=(0, 1, 0), vfov=40.0, use_sky_gradient=True,
)


def build_sphere_field(pkg, **build_kwargs):
    """64 lambertian spheres on a floor under a quad light: enough spheres
    for the tiled ray layout (tests/test_grad_render.py's tiled scene)."""
    b = pkg.SceneBuilder()
    b.quad((-40, 0, -40), (80, 0, 0), (0, 0, 80), b.lambertian((0.6, 0.55, 0.5)))
    blue = b.lambertian((0.2, 0.3, 0.7))
    for i in range(8):
        for j in range(8):
            b.sphere((i * 3 - 10, 0.5, j * 3 - 10), 0.5, blue)
    q = b.quad((-2, 12, -2), (4, 0, 0), (0, 0, 4), b.diffuse_light((7, 7, 7)))
    b.add_light(q)
    return b.build(**build_kwargs)


SPHERE_FIELD_CAM = dict(
    image_width=12, aspect_ratio=1.0, samples_per_pixel=2, max_depth=3,
    look_from=(0, 8, 20), look_at=(0, 0, 0), vfov=45.0,
    background=(0.05, 0.06, 0.08),
)


def build_mini_glossy(pkg, **build_kwargs):
    """The pathwise gradient scene of tests/test_grad_pathwise.py: checker
    floor, white back wall, quad light, a fuzzy gold sphere, a mirror, a
    glass sphere and a lambertian sphere.  Every gradient source of the
    pathwise tier but volumes."""
    b = pkg.SceneBuilder()
    white = b.lambertian((0.73, 0.72, 0.71))
    checker = b.lambertian(b.checker(0.5, (0.2, 0.3, 0.1), (0.9, 0.9, 0.8)))
    gold = b.metal((0.8, 0.6, 0.2), fuzz=0.25)
    mirror = b.metal((0.9, 0.9, 0.9), fuzz=0.0)
    glass = b.dielectric(1.5)
    light = b.diffuse_light((13.0, 12.0, 11.0))
    b.quad((-6, 0, -6), (12, 0, 0), (0, 0, 12), checker)   # floor
    b.quad((-6, 0, -6), (0, 8, 0), (12, 0, 0), white)      # back wall
    q = b.quad((-1.5, 7.9, -1.5), (3, 0, 0), (0, 0, 3), light)
    b.add_light(q)
    b.sphere((-2.2, 1.2, 0.0), 1.2, gold)
    b.sphere((0.0, 1.0, 1.2), 1.0, glass)
    b.sphere((2.2, 1.2, 0.0), 1.2, mirror)
    b.sphere((0.0, 1.0, -2.0), 1.0, white)
    return b.build(**build_kwargs)


def build_mini_volume_glossy(pkg, **build_kwargs):
    """The volume scene of tests/test_grad_pathwise.py: a fog box around a
    fuzzy gold sphere and a glass sphere on a checker floor under a quad
    light, so that fuzz and IOR gradients flow through the volume's scatter
    distance."""
    b = pkg.SceneBuilder()
    checker = b.lambertian(b.checker(0.5, (0.2, 0.3, 0.1), (0.9, 0.9, 0.8)))
    gold = b.metal((0.8, 0.6, 0.2), fuzz=0.25)
    glass = b.dielectric(1.5)
    light = b.diffuse_light((13.0, 12.0, 11.0))
    b.quad((-6, 0, -6), (12, 0, 0), (0, 0, 12), checker)   # floor
    q = b.quad((-1.5, 7.9, -1.5), (3, 0, 0), (0, 0, 3), light)
    b.add_light(q)
    b.sphere((-1.8, 1.2, 0.0), 1.2, gold)
    b.sphere((0.8, 1.0, 1.2), 1.0, glass)
    b.volume_box((-4, 0.05, -4), (4, 4, 4), 0.18, (0.85, 0.9, 0.95))
    return b.build(**build_kwargs)


MINI_GLOSSY_CAM = dict(
    image_width=16, aspect_ratio=1.0, samples_per_pixel=4, max_depth=4,
    look_from=(0, 3, 9), look_at=(0, 1.5, 0), vfov=45.0,
    background=(0.02, 0.01, 0.03),
)


def build_random_prims(pkg, n_spheres=40, n_planar=True, seed=0, **build_kwargs):
    """The random scene of tests/test_pallas.py's intersection tests
    (spheres, three in ten of them moving, and one or two of each planar
    kind), with four materials dealt out in turn so that the attribute
    kernels have something to tell apart: solid lambertian, checker
    lambertian, fuzzy metal, glass."""
    r = np.random.default_rng(seed)
    b = pkg.SceneBuilder()
    mats = [b.lambertian((0.9, 0.5, 0.1)),
            b.lambertian(b.checker(0.7, (0.2, 0.3, 0.1), (0.9, 0.9, 0.8))),
            b.metal((0.8, 0.6, 0.2), 0.25), b.dielectric(1.5)]
    for i in range(n_spheres):
        m = mats[i % 4]
        if r.random() < 0.3:
            c = r.normal(size=3) * 4
            b.moving_sphere(c, c + r.normal(size=3), r.uniform(0.3, 1.2), m)
        else:
            b.sphere(r.normal(size=3) * 4, r.uniform(0.3, 1.2), m)
    if n_planar:
        b.quad((-2, -2, -6), (4, 0, 0), (0, 4, 0), mats[0])
        b.triangle((-3, -1, -4), (0, -1, -4), (-1.5, 2, -4), mats[1])
        b.circle((2, 0, -5), (0.3, 0.2, 1), 1.0, mats[2])
        b.plane((0, -5, 0), (0, 1, 0), mats[1])
        b.quad((5, -2, -2), (0, 0, 4), (0, 4, 0), mats[3])
    return b.build(**build_kwargs)


def random_rays(n=700, seed=1):
    """Origins, directions and times of tests/test_pallas.py's ``_rays``, as
    float32 numpy arrays ([n, 3], [n, 3], [n])."""
    r = np.random.default_rng(seed)
    o = (r.normal(size=(n, 3)) * 3).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    tm = r.random(n).astype(np.float32)
    return o, d, tm


def build_fog_room(pkg, **build_kwargs):
    """A scene outside the megakernel's gate: a round fog and a pyramid fog
    in a small room with a checker floor, a red wall, a quad light, a fuzzy
    metal sphere and a glass sphere."""
    b = pkg.SceneBuilder()
    white = b.lambertian((0.73, 0.72, 0.71))
    red = b.lambertian((0.65, 0.05, 0.05))
    checker = b.lambertian(b.checker(1.5, (0.2, 0.3, 0.1), (0.9, 0.9, 0.8)))
    b.quad((-5, 0, -5), (10, 0, 0), (0, 0, 10), checker)      # floor
    b.quad((-5, 0, -5), (0, 8, 0), (10, 0, 0), white)         # back wall
    b.quad((5, 0, -5), (0, 8, 0), (0, 0, 10), red)            # right wall
    q = b.quad((-1.5, 7.9, -1.5), (3, 0, 0), (0, 0, 3),
               b.diffuse_light((13.0, 12.0, 11.0)))
    b.add_light(q)
    b.sphere((-2.2, 1.2, 0.0), 1.2, b.metal((0.8, 0.6, 0.2), fuzz=0.25))
    b.sphere((2.0, 1.0, 1.0), 1.0, b.dielectric(1.5))
    b.volume_sphere((0.0, 2.0, -1.0), 2.0, 0.35, (0.85, 0.9, 0.95))
    b.volume_pyramid((1.5, 0.0, -2.5), 3.0, 4.0, 0.5, (0.9, 0.7, 0.6))
    return b.build(**build_kwargs)


FOG_ROOM_CAM = dict(
    image_width=16, aspect_ratio=1.0, samples_per_pixel=2, max_depth=4,
    look_from=(0, 3, 9), look_at=(0, 1.5, 0), vfov=45.0,
    background=(0.02, 0.01, 0.03),
)


def build_lucy(pkg, n_instances=3, mesh_detail=(12, 10), **build_kwargs):
    """``cornell-lucy`` at a test size: the Cornell box with instances of the
    procedural statue (``mesh_detail=(12, 10)``: 216 triangles, the
    small-mesh kernel's tables).  ``pkg`` is either package; the port's
    builder also takes ``device``."""
    scene, _ = pkg.load_scene("cornell-lucy", n_instances=n_instances,
                              mesh_detail=mesh_detail, **build_kwargs)
    return scene


def lucy_instances(n):
    """The first ``n`` statue placements of ``cornell-lucy`` as (local->world
    4x4, material 0) pairs, the form both packages' ``build_proto`` take."""
    from go_raytracing_tpu_torch.geometry.scene import Affine
    from go_raytracing_tpu_torch.scenes.builders import LUCY_POSITIONS

    return [(Affine.trs(scale=(0.15, 0.15, 0.15), rotation_deg=(0, rot, 0),
                        position=pos).m, 0)
            for pos, rot in LUCY_POSITIONS[:n]]


def mesh_rays(n, seed=0):
    """Two thirds camera rays aimed at the instances of ``lucy_instances``
    (unnormalized directions), one third bounce-like rays from inside the
    box in random directions."""
    r = np.random.default_rng(seed)
    n_cam = 2 * n // 3
    o = np.empty((n, 3), np.float32)
    d = np.empty((n, 3), np.float32)
    o[:n_cam] = np.array([278.0, 278.0, -800.0]) + r.normal(size=(n_cam, 3)) * 5
    centres = np.array([[150, 120, 150], [400, 120, 150]], np.float64)
    tgt = centres[r.integers(0, 2, n_cam)] + r.normal(size=(n_cam, 3)) * [70, 110, 45]
    d[:n_cam] = tgt - o[:n_cam]
    o[n_cam:] = r.uniform([50, 1, 50], [500, 300, 500], size=(n - n_cam, 3))
    d[n_cam:] = r.normal(size=(n - n_cam, 3))
    return o, d


LUCY_CAM = dict(
    image_width=16, aspect_ratio=1.0, samples_per_pixel=2, max_depth=3,
    look_from=(278, 278, -800), look_at=(278, 278, 0), vfov=40.0,
    background=(0.0, 0.0, 0.0),
)


def grads_to_numpy(grads):
    """Gradients dict of either package -> dict of numpy arrays."""
    return {k: (v.detach().cpu().numpy() if hasattr(v, "detach")
                else np.asarray(v)) for k, v in grads.items()}


def jax_stash_to_numpy(carry, n_rays):
    """Carry of the JAX package's ``grad_fwd_stash`` (miss colour rows and
    the two stash arrays, each padded to [.., rows, 128] blocks) -> (miss
    colour [3, R], stash_f [D, 12 or 19, R], stash_i [D, 3, R]) in numpy."""
    mc, sf, si = carry
    mc = np.stack([np.asarray(a).reshape(-1)[:n_rays] for a in mc])
    sf, si = np.asarray(sf), np.asarray(si)
    return (mc, sf.reshape(sf.shape[0], sf.shape[1], -1)[:, :, :n_rays],
            si.reshape(si.shape[0], si.shape[1], -1)[:, :, :n_rays])


def pathwise_case(build, cam_fields):
    """One chunk of the scene's camera rays through the pathwise gradient
    forward and reverse sweep of both packages, with a seeded cotangent.
    The JAX package runs its Pallas kernels in interpret mode (``INTERPRET``
    and ``BLOCK_ROWS`` are restored afterwards).  Also: the port's reverse
    sweep on the JAX kernel's own stash, the port's plain forward, and the
    port's reverse with a cotangent of zeros.  Callers cache the result: the
    JAX reverse call alone takes most of a minute on a CPU."""
    import jax.numpy as jnp
    import torch

    import go_raytracing_tpu as grt
    from go_raytracing_tpu import camera as jcamera
    from go_raytracing_tpu.ops import pallas_wavefront as jmega
    from go_raytracing_tpu_torch import camera as tcamera
    from go_raytracing_tpu_torch import convert
    from go_raytracing_tpu_torch.ops import cuda_wavefront as cw

    js = build(grt)
    jcam = jcamera.Camera(**cam_fields)
    ts = convert.scene_from_numpy(scene_tree(js), "cpu")
    tcam = convert.camera_from_dict(dataclasses.asdict(jcam))
    w, h = tcam.image_width, tcam.image_height
    n, seed = w * h * tcam.samples_per_pixel, 0
    ids = torch.arange(n, dtype=torch.int64)
    o, d, tm = tcamera.generate_rays(tcam, ids % w, (ids // w) % h, ids, seed)
    g3 = (np.random.default_rng(3).uniform(size=(3, n)) * 1e-3).astype(np.float32)

    def to_j(v):
        return grt.core.vec3.V3(*(jnp.asarray(c.numpy()) for c in v))

    jids = jnp.asarray(ids.numpy().astype(np.uint32))
    old = jmega.INTERPRET, jmega.BLOCK_ROWS
    jmega.INTERPRET, jmega.BLOCK_ROWS = True, 8
    try:
        assert jmega.grad_pathwise_applicable(js, jcam.max_depth)
        assert not jmega.grad_applicable(js, jcam.max_depth)
        j_rad, j_carry = jmega.grad_fwd_stash(
            js, jcam, to_j(o), to_j(d), jnp.asarray(tm.numpy()), jids, seed,
            pathwise=True)
        j_rad = np.stack([np.asarray(c) for c in j_rad])
        j_stash = jax_stash_to_numpy(j_carry, n)  # before the reverse donates it
        j_grads = grads_to_numpy(jmega.grad_rev_stash(
            js, jcam, jids, seed, tuple(jnp.asarray(r) for r in g3), j_carry,
            pathwise=True))
    finally:
        jmega.INTERPRET, jmega.BLOCK_ROWS = old

    assert cw.grad_pathwise_applicable(ts, tcam.max_depth)
    assert not cw.grad_applicable(ts, tcam.max_depth)
    before = cw.LAUNCHES_GRAD_FWD_PATHWISE, cw.LAUNCHES_GRAD_REV_PATHWISE
    t_rad, t_carry = cw.grad_fwd_stash(ts, tcam, o, d, tm, ids, seed, pathwise=True)
    t_grads = cw.grad_rev_stash(ts, tcam, torch.from_numpy(g3), t_carry,
                                pathwise=True, stream=ids, seed=seed)
    zero_grads = cw.grad_rev_stash(ts, tcam, torch.zeros(3, n), t_carry,
                                   pathwise=True, stream=ids, seed=seed)
    # CPU tensors: plain versions, no launch
    assert (cw.LAUNCHES_GRAD_FWD_PATHWISE, cw.LAUNCHES_GRAD_REV_PATHWISE) == before
    fwd_rows, _ = cw.wavefront_fwd(cw.build_tables(ts), o, d, tm, ids, seed,
                                   tcam.max_depth)
    j_mc, j_sf, j_si = (torch.from_numpy(np.array(x)) for x in j_stash)
    n_tex = int(ts.textures.color.shape[0])
    n_mat = int(ts.materials.kind.shape[0])
    on_jax_stash = cw.wavefront_grad_rev_pathwise(
        cw.build_tables(ts), j_sf, j_si, torch.from_numpy(g3), j_mc, ids, seed,
        bool(tcam.use_sky_gradient), n_tex, n_mat)
    return dict(ts=ts, tcam=tcam, rays=(o, d, tm, ids), seed=seed, g3=g3,
                j_rad=j_rad, j_stash=j_stash, j_grads=j_grads,
                t_rad=torch.stack(list(t_rad)).numpy(), t_carry=t_carry,
                t_grads=grads_to_numpy(t_grads),
                zero_grads=grads_to_numpy(zero_grads),
                fwd_rad=fwd_rows[:3].numpy(),
                on_jax_stash=dict(
                    color=on_jax_stash[0][:, 0].numpy(),
                    even_color=on_jax_stash[0][:, 1].numpy(),
                    odd_color=on_jax_stash[0][:, 2].numpy(),
                    fuzz=on_jax_stash[1].numpy(), ior=on_jax_stash[2].numpy()))


PATHWISE_KEYS = ("color", "even_color", "odd_color", "fuzz", "ior")


def check_pathwise_forward(c, cw):
    """Radiance and stash of the pathwise gradient forward, port (plain
    version) against the JAX kernel.  ``cw`` is the port's
    ``ops.cuda_wavefront``.

    Same random bits and formulas in both, but XLA contracts a*b+c into one
    fused multiply-add on the CPU and PyTorch does not, so a hit point that
    comes out of a cancellation (a sphere met at a grazing angle from ten
    units away) differs in its last digits and so does everything after it
    on that path.  So: at rtol 1e-5 / atol 1e-6 at most 5 % of the rays
    (radiance) and of the entered rows (each stash row) may differ, and
    every one of them stays inside rtol 2e-3 / atol 5e-3.  A ray whose mask
    words differ took another branch and differs wholly: at most 1 % of rays
    may, and the rest of the comparison leaves them out.  On all other rays
    the int rows are equal wherever the port's ray entered the bounce (the
    JAX kernel leaves arbitrary rows where a ray was dead)."""
    j_mc, j_sf, j_si = c["j_stash"]
    t_mc, t_sf, t_si = (x.numpy() for x in c["t_carry"])
    assert t_sf.shape == j_sf.shape and t_sf.shape[1] == cw.PW_STASH_F_ROWS
    assert t_si.shape == j_si.shape
    assert np.isfinite(c["t_rad"]).all() and np.isfinite(t_sf).all()
    t_mk, j_mk = t_si[:, 2], j_si[:, 2]
    entered = (t_mk & (cw.PW_HIT | cw.PW_LIT)) != 0           # [D, R]
    same_path = ((t_mk == j_mk) | ~entered).all(axis=0)       # [R]
    assert (~same_path).mean() < 0.01, (~same_path).mean()
    tight = dict(rtol=1e-5, atol=1e-6)
    loose = dict(rtol=2e-3, atol=5e-3)
    t_rad, j_rad = c["t_rad"][:, same_path], c["j_rad"][:, same_path]
    assert (~np.isclose(t_rad, j_rad, **tight).all(axis=0)).mean() < 0.05
    np.testing.assert_allclose(t_rad, j_rad, **loose)
    np.testing.assert_allclose(t_mc[:, same_path], j_mc[:, same_path], **loose)

    live = entered & same_path[None]
    assert live.sum() > 1000
    for row in (0, 1):
        np.testing.assert_array_equal(t_si[:, row][live], j_si[:, row][live])
    for row in range(cw.PW_STASH_F_ROWS):
        a, b = t_sf[:, row][live], j_sf[:, row][live]
        assert (~np.isclose(a, b, **tight)).mean() < 0.05, row
        np.testing.assert_allclose(a, b, err_msg=f"row {row}", **loose)
    # rows of bounces a ray never entered are inert in the port
    was_alive = np.ones_like(entered)
    was_alive[1:] = (t_mk[:-1] & cw.PW_ALIVE_NEXT) != 0
    assert (entered == was_alive).all()
    dead = ~entered
    assert dead.any() and (t_mk[dead] == 0).all()
    assert (t_sf.transpose(1, 0, 2)[:, dead] == 0).all()
    assert (t_si[:, 0][dead] == cw.SLOT_NONE).all()
    assert (t_si[:, 1][dead] == cw.MSLOT_NONE).all()
    return t_si


def check_pathwise_reverse(c):
    """The gradients dict of the pathwise reverse sweep, port (plain
    version) against the JAX kernel with the same seeded cotangent: every
    key within rtol 2e-3 / atol 3e-6 (the JAX kernel's own tolerance against
    ``jax.grad`` is 5e-3 / 3e-6), first with both sweeps on the JAX kernel's
    stash (the reverse alone), then each package on its own stash (forward
    and reverse).  Every key has an entry above 1e-6, or the scene would be
    too weak to show a fault.  A cotangent of zeros gives zeros: inert rows
    and masked lanes add exactly nothing, and no NaN."""
    assert set(c["t_grads"]) == set(PATHWISE_KEYS) == set(c["j_grads"])
    for k in PATHWISE_KEYS:
        ref = c["j_grads"][k]
        assert np.abs(ref).max() > 1e-6, k
        assert np.isfinite(c["t_grads"][k]).all(), k
        np.testing.assert_allclose(c["on_jax_stash"][k], ref, rtol=2e-3,
                                   atol=3e-6, err_msg=k)
        np.testing.assert_allclose(c["t_grads"][k], ref, rtol=2e-3, atol=3e-6,
                                   err_msg=k)
        assert c["t_grads"][k].shape == ref.shape
        assert (c["zero_grads"][k] == 0).all(), k
