"""Batched ray-primitive intersection ops (jnp baseline tier).

Each function is pure, shape-polymorphic over a rays axis R and a
primitives axis N, producing [R, N] hit/t grids. Semantics replicate the
reference's Burst kernels exactly, including edge-case behavior:

- AABB slab test returns tFar when the origin is inside the box, and
  reports a hit for boxes fully behind only if tFar >= 0
  (Jobs/AudioRaytracerJobBatched.cs:284-308).
- Sphere test uses the full quadratic with a = dot(d, d) and prefers the
  near root t0 when t0 >= 0, else t1 (cs:323-355) — so a ray starting
  inside a sphere hits the shell ahead.
- Closest-hit tie-breaking: the reference scans spheres, then AABBs, then
  OBBs with a strict ``dist < closestDist`` update (cs:225-280), so at
  exactly equal distance the earliest-scanned primitive wins. We reproduce
  that by concatenating t grids in [sphere, aabb, obb] order and taking
  argmin (first occurrence of the minimum).
- Permeation chord tests accumulate (tExit - max(tEnter, 0)) * density
  with no far clamp at the target distance
  (Jobs/AudioPermeationJobBatched.cs:265-328) — chords beyond the target
  still count; a quirk we keep for parity.

Misses are encoded as t = +inf so min-reductions need no masks.
"""

from __future__ import annotations

import jax.numpy as jnp

from audio_raytracer_tpu.ops import quaternion
from audio_raytracer_tpu.types import Scene

Array = jnp.ndarray

INF = jnp.inf


def safe_norm(x: Array, axis=-1, keepdims=False, eps=1e-20) -> Array:
    """L2 norm with a tiny epsilon under the sqrt so the VJP at ||x|| = 0
    is 0 instead of NaN (masked dead lanes would otherwise poison every
    gradient through the 0 * NaN backward of jnp.linalg.norm)."""
    return jnp.sqrt(jnp.sum(x * x, axis=axis, keepdims=keepdims) + eps)


def safe_normalize(x: Array, eps=1e-20) -> Array:
    return x / safe_norm(x, keepdims=True, eps=eps)


# ---------------------------------------------------------------------------
# Primitive t-grids: rays [R, 3] x prims [N, ...] -> t [R, N] (+inf = miss)
#
# Sums and extrema over the xyz axis are written per component, so every
# [R, N] grid is elementwise in its inputs and XLA fuses it into the
# reduction that consumes it instead of materializing [R, N, 3] terms.
# ---------------------------------------------------------------------------


def _dot3(a: Array, b: Array) -> Array:
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def _aabb_slab(o, d, center, half_extents):
    """Raw slab interval. o,d: [R,1,3]; center/half: [N,3] (or broadcast).

    Returns (t_near, t_far) each [R, N]; interval validity is the caller's
    concern (hit vs permeation differ on it).

    Zero direction components are nudged to +/-1e-12 instead of producing
    inf slopes: forward behavior is indistinguishable (t ~ 1e12 dominates
    every min/max the same way inf does) and the backward pass stays
    NaN-free (0-cotangent x inf = NaN would poison pose gradients for
    axis-aligned rays, e.g. the Fibonacci poles).
    """
    d = jnp.where(jnp.abs(d) < 1e-12, jnp.copysign(1e-12, d), d)
    inv_d = 1.0 / d
    t0 = (center - half_extents - o) * inv_d
    t1 = (center + half_extents - o) * inv_d
    tmin = jnp.minimum(t0, t1)
    tmax = jnp.maximum(t0, t1)
    t_near = jnp.maximum(jnp.maximum(tmin[..., 0], tmin[..., 1]),
                         tmin[..., 2])
    t_far = jnp.minimum(jnp.minimum(tmax[..., 0], tmax[..., 1]),
                        tmax[..., 2])
    return t_near, t_far


def aabb_t(o: Array, d: Array, center: Array, half_extents: Array,
           active: Array | None = None) -> Array:
    """Hit distance grid for AABBs. o,d: [R,3]; center/half: [N,3] -> [R,N]."""
    o = o[..., None, :]
    d = d[..., None, :]
    t_near, t_far = _aabb_slab(o, d, center, half_extents)
    miss = (t_near > t_far) | (t_far < 0.0)
    t = jnp.where(t_near > 0.0, t_near, t_far)
    t = jnp.where(miss, INF, t)
    if active is not None:
        t = jnp.where(active, t, INF)
    return t


def obb_t(o: Array, d: Array, center: Array, half_extents: Array,
          inv_rot: Array, active: Array | None = None) -> Array:
    """Hit distance grid for OBBs: rotate into local frame with the stored
    inverse quaternion (pre-inverted at bake time), then slab test
    (Jobs/AudioRaytracerJobBatched.cs:314-320)."""
    local_o = quaternion.rotate(inv_rot, o[..., None, :] - center)  # [R,N,3]
    local_d = quaternion.rotate(inv_rot, d[..., None, :])  # [R,N,3]
    t_near, t_far = _aabb_slab(local_o, local_d, 0.0, half_extents)
    miss = (t_near > t_far) | (t_far < 0.0)
    t = jnp.where(t_near > 0.0, t_near, t_far)
    t = jnp.where(miss, INF, t)
    if active is not None:
        t = jnp.where(active, t, INF)
    return t


def sphere_t(o: Array, d: Array, center: Array, radius: Array,
             active: Array | None = None) -> Array:
    """Hit distance grid for spheres (full quadratic, near-root-preferred).

    o,d: [R,3]; center: [N,3]; radius: [N] -> [R,N].
    """
    oc = o[..., None, :] - center  # [R, N, 3]
    a = _dot3(d, d)[..., None]  # [R, 1]
    b = 2.0 * _dot3(oc, d[..., None, :])  # [R, N]
    c = _dot3(oc, oc) - radius * radius  # [R, N]
    disc = b * b - 4.0 * a * c
    # Double-where keeps the backward pass NaN-free: sqrt'(0) = inf would
    # otherwise meet the zero cotangent of missed lanes as inf * 0 = NaN.
    hit_disc = disc >= 0.0
    sqrt_disc = jnp.sqrt(jnp.where(hit_disc, disc, 1.0))
    t0 = (-b - sqrt_disc) / (2.0 * a)
    t1 = (-b + sqrt_disc) / (2.0 * a)
    t = jnp.where(t0 >= 0.0, t0, jnp.where(t1 >= 0.0, t1, INF))
    t = jnp.where(hit_disc, t, INF)
    if active is not None:
        t = jnp.where(active, t, INF)
    return t


# ---------------------------------------------------------------------------
# Closest hit over the whole scene
# ---------------------------------------------------------------------------


def scene_t_grid(o: Array, d: Array, scene: Scene,
                 skip_target_id: Array | None = None) -> Array:
    """[R, P] hit-distance grid over the concatenated primitive axis in
    reference scan order [sphere, aabb, obb].

    ``skip_target_id`` ([R] int32 or scalar): primitives owned by that
    audio target are treated as misses — the muffle-ray exclusion
    (AudioRaytracerJobBatched.cs:405-449).
    """
    ts = sphere_t(o, d, scene.spheres.center, scene.spheres.radius,
                  scene.spheres.active)
    ta = aabb_t(o, d, scene.aabbs.center, scene.aabbs.half_extents,
                scene.aabbs.active)
    tb = obb_t(o, d, scene.obbs.center, scene.obbs.half_extents,
               scene.obbs.inv_rot, scene.obbs.active)
    t = jnp.concatenate([ts, ta, tb], axis=-1)
    if skip_target_id is not None:
        owner = jnp.concatenate(
            [scene.spheres.target_id, scene.aabbs.target_id,
             scene.obbs.target_id], axis=-1)
        skip = jnp.asarray(skip_target_id)[..., None] == owner
        t = jnp.where(skip, INF, t)
    return t


def closest_hit(o: Array, d: Array, scene: Scene):
    """Closest hit over all primitives.

    Returns (hit [R] bool, t [R], prim_index [R] int32) where prim_index
    addresses the [sphere, aabb, obb] concatenated order. argmin returns
    the first occurrence of the minimum, reproducing the reference's
    strict-< scan-order tie-break (AudioRaytracerJobBatched.cs:239-276).
    """
    t_grid = scene_t_grid(o, d, scene)
    if t_grid.shape[-1] == 0:
        shape = t_grid.shape[:-1]
        return (jnp.zeros(shape, bool), jnp.full(shape, INF, t_grid.dtype),
                jnp.zeros(shape, jnp.int32))
    idx = jnp.argmin(t_grid, axis=-1).astype(jnp.int32)
    t = jnp.min(t_grid, axis=-1)
    return jnp.isfinite(t), t, idx


def any_hit_within(o: Array, d: Array, limit: Array, scene: Scene,
                   skip_target_id: Array | None = None) -> Array:
    """Occlusion test: does any primitive intersect strictly closer than
    ``limit``? (CanRaySeePoint / CanRaySeeAudioTarget inverted:
    AudioRaytracerJobBatched.cs:365-449.)

    limit: [R] (broadcast against the prim axis). Returns [R] bool.
    """
    t_grid = scene_t_grid(o, d, scene, skip_target_id)
    return jnp.any(t_grid < limit[..., None], axis=-1)


# ---------------------------------------------------------------------------
# Permeation chords (entry/exit interval variants)
# ---------------------------------------------------------------------------


def _skip_chords(loss, prims, skip_target_id):
    if skip_target_id is None:
        return loss
    skip = jnp.asarray(skip_target_id)[..., None]
    return jnp.where(skip == prims.target_id, 0.0, loss)


def sphere_chords(o: Array, d: Array, spheres,
                  skip_target_id: Array | None = None) -> Array:
    """[R, N] chord length x density through each sphere: half-b
    quadratic, d normalized (AudioPermeationJobBatched.cs:303-328)."""
    oc = o[..., None, :] - spheres.center
    b = _dot3(oc, d[..., None, :])
    c = _dot3(oc, oc) - spheres.radius ** 2
    disc = b * b - c
    hit_disc = disc >= 0.0
    sqrt_disc = jnp.sqrt(jnp.where(hit_disc, disc, 1.0))
    t_enter = -b - sqrt_disc
    t_exit = -b + sqrt_disc
    chord = jnp.maximum(0.0, t_exit - jnp.maximum(t_enter, 0.0))
    valid = hit_disc & (t_exit >= 0.0) & spheres.active
    loss = jnp.where(valid, chord, 0.0) * spheres.material.density
    return _skip_chords(loss, spheres, skip_target_id)


def _box_chords(near, far, boxes, skip_target_id):
    chord = jnp.maximum(0.0, far - jnp.maximum(near, 0.0))
    valid = (near <= far) & (far >= 0.0) & boxes.active
    loss = jnp.where(valid, chord, 0.0) * boxes.material.density
    return _skip_chords(loss, boxes, skip_target_id)


def aabb_chords(o: Array, d: Array, aabbs,
                skip_target_id: Array | None = None) -> Array:
    """[R, N] chord length x density through each AABB (cs:265-288)."""
    near, far = _aabb_slab(o[..., None, :], d[..., None, :], aabbs.center,
                           aabbs.half_extents)
    return _box_chords(near, far, aabbs, skip_target_id)


def obb_chords(o: Array, d: Array, obbs,
               skip_target_id: Array | None = None) -> Array:
    """[R, N] chord length x density through each OBB (cs:294-300)."""
    local_o = quaternion.rotate(obbs.inv_rot, o[..., None, :] - obbs.center)
    local_d = quaternion.rotate(obbs.inv_rot, d[..., None, :])
    near, far = _aabb_slab(local_o, local_d, 0.0, obbs.half_extents)
    return _box_chords(near, far, obbs, skip_target_id)


def permeation_loss(o: Array, d: Array, scene: Scene,
                    skip_target_id: Array | None = None) -> Array:
    """Total permeation power loss per ray: sum over primitives of
    chord-length-through x material density
    (Jobs/AudioPermeationJobBatched.cs:225-328).

    o, d: [R, 3] (d normalized — sphere test assumes |d| = 1).
    Returns [R].
    """
    return (jnp.sum(sphere_chords(o, d, scene.spheres, skip_target_id),
                    axis=-1)
            + jnp.sum(aabb_chords(o, d, scene.aabbs, skip_target_id),
                      axis=-1)
            + jnp.sum(obb_chords(o, d, scene.obbs, skip_target_id),
                      axis=-1))


def primitive_t_per_ray(o: Array, d: Array, kind: Array, center: Array,
                        half_extents: Array, inv_rot: Array) -> Array:
    """Differentiable hit distance of one SELECTED primitive per ray.

    The winner-recompute trick: the chunked fold or the closest-hit
    kernel provides the argmin selection (non-differentiable), then this
    O(R) jnp recompute of the winner's t makes the distance
    differentiable in ray origin / direction and the gathered primitive
    geometry — gradients to listener and collider poses without
    differentiating (or keeping residuals of) the O(R*P) search.

    o, d: [R, 3]; kind/center/half_extents/inv_rot: per-ray gathered winner
    attributes (ops.intersect.unified_arrays layout: sphere radius is
    half_extents[..., 0], inv_rot identity for spheres/AABBs). Returns [R];
    values on miss lanes are unspecified (mask with the kernel's hit flag).
    Same formulas as the kernels (AudioRaytracerJobBatched.cs:284-355).
    """
    # Box (AABB and OBB unified: identity inv_rot for AABBs).
    lo = quaternion.rotate(inv_rot, o - center)
    ld = quaternion.rotate(inv_rot, d)
    t_near, t_far = _aabb_slab(lo, ld, 0.0, half_extents)
    t_box = jnp.where(t_near > 0.0, t_near, t_far)

    # Sphere (full quadratic, near-root preferred).
    oc = o - center
    radius = half_extents[..., 0]
    a = jnp.sum(d * d, axis=-1)
    b = 2.0 * jnp.sum(oc * d, axis=-1)
    c = jnp.sum(oc * oc, axis=-1) - radius * radius
    disc = b * b - 4.0 * a * c
    hit_disc = disc >= 0.0
    sqrt_disc = jnp.sqrt(jnp.where(hit_disc, disc, 1.0))  # NaN-safe bwd
    t0 = (-b - sqrt_disc) / (2.0 * a)
    t1 = (-b + sqrt_disc) / (2.0 * a)
    t_sph = jnp.where(t0 >= 0.0, t0, t1)
    t_sph = jnp.where(hit_disc, t_sph, 0.0)  # finite on miss lanes

    return jnp.where(kind == 0, t_sph, t_box)


# ---------------------------------------------------------------------------
# Unified (gather-friendly) scene view for reflection / materials
# ---------------------------------------------------------------------------


def unified_arrays(scene: Scene):
    """Concatenate per-type primitive data in [sphere, aabb, obb] order so
    per-ray hit attributes are a single gather by prim_index.

    Returns a dict of arrays over the unified primitive axis P:
    kind (0=sphere, 1=aabb, 2=obb), center [P,3], half_extents [P,3]
    (radius replicated for spheres), inv_rot [P,4] (identity for
    sphere/aabb), absorption/echo/density [P], target_id [P].
    """
    ns, na, nb = scene.spheres.count, scene.aabbs.count, scene.obbs.count

    kind = jnp.concatenate([
        jnp.zeros((ns,), jnp.int32),
        jnp.ones((na,), jnp.int32),
        jnp.full((nb,), 2, jnp.int32),
    ])
    center = jnp.concatenate(
        [scene.spheres.center, scene.aabbs.center, scene.obbs.center], axis=0)
    half_extents = jnp.concatenate([
        jnp.broadcast_to(scene.spheres.radius[:, None], (ns, 3)),
        scene.aabbs.half_extents,
        scene.obbs.half_extents,
    ], axis=0)
    identity_q = jnp.broadcast_to(
        jnp.asarray([0.0, 0.0, 0.0, 1.0], center.dtype), (ns + na, 4))
    inv_rot = jnp.concatenate([identity_q, scene.obbs.inv_rot], axis=0)

    def cat(field):
        return jnp.concatenate([
            getattr(scene.spheres.material, field),
            getattr(scene.aabbs.material, field),
            getattr(scene.obbs.material, field),
        ])

    target_id = jnp.concatenate(
        [scene.spheres.target_id, scene.aabbs.target_id, scene.obbs.target_id])

    return dict(
        kind=kind,
        center=center,
        half_extents=half_extents,
        inv_rot=inv_rot,
        absorption=cat("absorption"),
        echo=cat("echo"),
        density=cat("density"),
        target_id=target_id,
    )


_PACKED_WIDTH = 16  # 13 used columns padded to a half-vreg lane multiple


def packed_unified_table(uni: dict):
    """[P, 16] f32 row-packed view of unified_arrays output.

    Columns: kind, center xyz, half_extents xyz, inv_rot xyzw, absorption,
    echo (13 used; padded to 16). One row gather replaces 13 scalar-table
    gathers on the per-ray winner index.
    """
    P = uni["kind"].shape[0]
    cols = [uni["kind"].astype(jnp.float32)[:, None],
            uni["center"], uni["half_extents"], uni["inv_rot"],
            uni["absorption"][:, None], uni["echo"][:, None]]
    packed = jnp.concatenate(cols, axis=1)
    pad = _PACKED_WIDTH - packed.shape[1]
    return jnp.concatenate(
        [packed, jnp.zeros((P, pad), jnp.float32)], axis=1)


def unpack_attr_rows(rows):
    """[..., 16] gathered rows -> the closest_hit attrs dict."""
    return dict(
        kind=rows[..., 0].astype(jnp.int32),
        center=rows[..., 1:4],
        half_extents=rows[..., 4:7],
        inv_rot=rows[..., 7:11],
        absorption=rows[..., 11],
        echo=rows[..., 12],
    )


# ---------------------------------------------------------------------------
# Reflection
# ---------------------------------------------------------------------------


def _box_axis_normal(local_point: Array, half_extents: Array) -> Array:
    """Face normal from the closest axis, replicating the reference's
    strict-< axis selection where ties fall through to z
    (AudioRaytracerJobBatched.cs:471-482,497-508). local_point/half: [R,3].
    """
    delta = half_extents - jnp.abs(local_point)
    dx, dy, dz = delta[..., 0], delta[..., 1], delta[..., 2]
    pick_x = (dx < dy) & (dx < dz)
    pick_y = (~pick_x) & (dy < dx) & (dy < dz)
    sign = jnp.sign(local_point)
    normal = jnp.zeros_like(local_point)
    normal = normal.at[..., 0].set(jnp.where(pick_x, sign[..., 0], 0.0))
    normal = normal.at[..., 1].set(jnp.where(pick_y, sign[..., 1], 0.0))
    normal = normal.at[..., 2].set(
        jnp.where(~(pick_x | pick_y), sign[..., 2], 0.0))
    return normal


def reflection_normal(hit_point: Array, kind: Array, center: Array,
                      half_extents: Array, inv_rot: Array) -> Array:
    """Surface normal at the hit point for the selected primitive.

    hit_point: [R,3]; kind/center/half/inv_rot: gathered per-ray attributes.

    NOTE (parity quirk): for OBBs the reference's ReflectRay treats the
    stored inverse quaternion as if it were the forward orientation — it
    maps the hit point to "local" with inverse(stored) and maps the local
    normal back with stored (AudioRaytracerJobBatched.cs:489,510), the
    opposite pairing of its own intersection test. We replicate that
    behavior bit-for-concept so bounce trajectories match the reference.
    """
    # Sphere: radial normal (cs:516).
    sphere_n = safe_normalize(hit_point - center)

    # AABB: closest-axis face normal (cs:465-482).
    aabb_n = _box_axis_normal(hit_point - center, half_extents)

    # OBB: reference's swapped-rotation pairing (cs:487-510).
    fwd_rot = quaternion.inverse(inv_rot)
    local_hit = quaternion.rotate(fwd_rot, hit_point - center)
    obb_local_n = _box_axis_normal(local_hit, half_extents)
    obb_n = quaternion.rotate(inv_rot, obb_local_n)

    is_sphere = (kind == 0)[..., None]
    is_aabb = (kind == 1)[..., None]
    return jnp.where(is_sphere, sphere_n, jnp.where(is_aabb, aabb_n, obb_n))


def reflect(d: Array, normal: Array) -> Array:
    """math.reflect: d - 2 * dot(d, n) * n (cs:525)."""
    return d - 2.0 * jnp.sum(d * normal, axis=-1, keepdims=True) * normal
