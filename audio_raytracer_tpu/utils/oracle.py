"""CPU oracle: slow scalar NumPy implementation of the full pipeline.

This is the trusted reference the device path must match allclose
(BASELINE.md "Forward correctness"). It mirrors the reference kernels'
control flow ray-by-ray, bounce-by-bounce, primitive-by-primitive —
including scan order, strict-< tie-breaking, epsilon offsets, the
permeation overwrite quirk, and the reverb zero-counting quirk — at f32
-independent precision (computed in float64 internally unless asked).

Reference provenance (behavior, not code):
- trace loop:     Jobs/AudioRaytracerJobBatched.cs:61-215
- intersections:  Jobs/AudioRaytracerJobBatched.cs:284-355
- occlusion:      Jobs/AudioRaytracerJobBatched.cs:365-449
- reflection:     Jobs/AudioRaytracerJobBatched.cs:456-532
- permeation:     Jobs/AudioPermeationJobBatched.cs
- reduce:         Jobs/ProcessAudioDataJob.cs
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

EPSILON_DEFAULT = 1e-4


@dataclasses.dataclass
class OracleScene:
    """Plain-NumPy scene mirror (host-side; no JAX)."""

    sphere_center: np.ndarray  # [Ns,3]
    sphere_radius: np.ndarray  # [Ns]
    sphere_material: np.ndarray  # [Ns,3] (absorption, density, echo)
    sphere_target: np.ndarray  # [Ns]

    aabb_center: np.ndarray  # [Na,3]
    aabb_half: np.ndarray  # [Na,3]
    aabb_material: np.ndarray  # [Na,3]
    aabb_target: np.ndarray  # [Na]

    obb_center: np.ndarray  # [No,3]
    obb_half: np.ndarray  # [No,3]
    obb_inv_rot: np.ndarray  # [No,4] xyzw (stored pre-inverted)
    obb_material: np.ndarray  # [No,3]
    obb_target: np.ndarray  # [No]

    target_positions: np.ndarray  # [T,3]


def _rot(q, v):
    xyz, w = q[:3], q[3]
    t = 2.0 * np.cross(xyz, v)
    return v + w * t + np.cross(xyz, t)


def _inv(q):
    return np.array([-q[0], -q[1], -q[2], q[3]])


def _ray_aabb(o, d, center, half):
    # Same zero-axis nudge as ops/intersect._aabb_slab (canonical semantics).
    d = np.where(np.abs(d) < 1e-12, np.copysign(1e-12, d), d)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv_d = 1.0 / d
        t0 = (center - half - o) * inv_d
        t1 = (center + half - o) * inv_d
    tmin = np.minimum(t0, t1)
    tmax = np.maximum(t0, t1)
    t_near = tmin.max()
    t_far = tmax.min()
    if t_near > t_far or t_far < 0:
        return None
    return t_near if t_near > 0 else t_far


def _ray_obb(o, d, center, half, inv_rot):
    lo = _rot(inv_rot, o - center)
    ld = _rot(inv_rot, d)
    return _ray_aabb(lo, ld, np.zeros(3), half)


def _ray_sphere(o, d, center, radius):
    oc = o - center
    a = float(d @ d)
    b = 2.0 * float(oc @ d)
    c = float(oc @ oc) - radius * radius
    disc = b * b - 4 * a * c
    if disc < 0:
        return None
    s = math.sqrt(disc)
    t0 = (-b - s) / (2 * a)
    t1 = (-b + s) / (2 * a)
    if t0 >= 0:
        return t0
    if t1 >= 0:
        return t1
    return None


def _closest_hit(scene: OracleScene, o, d):
    """Scan order sphere -> AABB -> OBB with strict < (parity tie-break).

    Returns (kind, local_index, t) or None. kind: 0 sphere, 1 aabb, 2 obb.
    """
    best = (None, -1, np.inf)
    for i in range(len(scene.sphere_radius)):
        t = _ray_sphere(o, d, scene.sphere_center[i], scene.sphere_radius[i])
        if t is not None and t < best[2]:
            best = (0, i, t)
    for i in range(len(scene.aabb_center)):
        t = _ray_aabb(o, d, scene.aabb_center[i], scene.aabb_half[i])
        if t is not None and t < best[2]:
            best = (1, i, t)
    for i in range(len(scene.obb_center)):
        t = _ray_obb(o, d, scene.obb_center[i], scene.obb_half[i],
                     scene.obb_inv_rot[i])
        if t is not None and t < best[2]:
            best = (2, i, t)
    return None if best[0] is None else best


def _occluded(scene: OracleScene, o, d, limit, skip_target=None):
    for i in range(len(scene.sphere_radius)):
        if skip_target is not None and scene.sphere_target[i] == skip_target:
            continue
        t = _ray_sphere(o, d, scene.sphere_center[i], scene.sphere_radius[i])
        if t is not None and t < limit:
            return True
    for i in range(len(scene.aabb_center)):
        if skip_target is not None and scene.aabb_target[i] == skip_target:
            continue
        t = _ray_aabb(o, d, scene.aabb_center[i], scene.aabb_half[i])
        if t is not None and t < limit:
            return True
    for i in range(len(scene.obb_center)):
        if skip_target is not None and scene.obb_target[i] == skip_target:
            continue
        t = _ray_obb(o, d, scene.obb_center[i], scene.obb_half[i],
                     scene.obb_inv_rot[i])
        if t is not None and t < limit:
            return True
    return False


def _box_axis_normal(local_point, half):
    delta = half - np.abs(local_point)
    n = np.zeros(3)
    if delta[0] < delta[1] and delta[0] < delta[2]:
        n[0] = np.sign(local_point[0])
    elif delta[1] < delta[0] and delta[1] < delta[2]:
        n[1] = np.sign(local_point[1])
    else:
        n[2] = np.sign(local_point[2])
    return n


def _reflect_ray(scene: OracleScene, kind, idx, p, d, life, max_ray_life):
    """Returns (new_dir, new_origin, new_life). Replicates the reference's
    OBB rotation pairing quirk (see ops/intersect.reflection_normal)."""
    if kind == 0:
        n = p - scene.sphere_center[idx]
        n = n / np.linalg.norm(n)
        absorption = scene.sphere_material[idx, 0]
    elif kind == 1:
        n = _box_axis_normal(p - scene.aabb_center[idx], scene.aabb_half[idx])
        absorption = scene.aabb_material[idx, 0]
    else:
        inv_rot = scene.obb_inv_rot[idx]
        local = _rot(_inv(inv_rot), p - scene.obb_center[idx])
        ln = _box_axis_normal(local, scene.obb_half[idx])
        n = _rot(inv_rot, ln)
        absorption = scene.obb_material[idx, 0]

    d_new = d - 2.0 * float(d @ n) * n
    p_new = p + d_new * EPSILON_DEFAULT
    life_new = life - max_ray_life * absorption
    return d_new, p_new, life_new


def _chord_loss(scene: OracleScene, o, d, skip_target):
    total = 0.0
    for i in range(len(scene.sphere_radius)):
        if scene.sphere_target[i] == skip_target:
            continue
        oc = o - scene.sphere_center[i]
        b = float(oc @ d)
        c = float(oc @ oc) - scene.sphere_radius[i] ** 2
        disc = b * b - c
        if disc < 0:
            continue
        s = math.sqrt(disc)
        t_exit = -b + s
        if t_exit < 0:
            continue
        enter = max(-b - s, 0.0)
        total += max(0.0, t_exit - enter) * scene.sphere_material[i, 1]

    def box_loss(o2, d2, half, density):
        nonlocal total
        d2 = np.where(np.abs(d2) < 1e-12, np.copysign(1e-12, d2), d2)
        with np.errstate(divide="ignore", invalid="ignore"):
            inv_d = 1.0 / d2
            t0 = (-half - o2) * inv_d
            t1 = (half - o2) * inv_d
        t_enter = np.minimum(t0, t1).max()
        t_exit = np.maximum(t0, t1).min()
        if t_enter > t_exit or t_exit < 0:
            return
        enter = max(t_enter, 0.0)
        total += max(0.0, t_exit - enter) * density

    for i in range(len(scene.aabb_center)):
        if scene.aabb_target[i] == skip_target:
            continue
        box_loss(o - scene.aabb_center[i], d, scene.aabb_half[i],
                 scene.aabb_material[i, 1])
    for i in range(len(scene.obb_center)):
        if scene.obb_target[i] == skip_target:
            continue
        lo = _rot(scene.obb_inv_rot[i], o - scene.obb_center[i])
        ld = _rot(scene.obb_inv_rot[i], d)
        box_loss(lo, ld, scene.obb_half[i], scene.obb_material[i, 1])
    return total


def _accum_batch_id(ray_index, ray_count, num_batches):
    batch_size = -(-ray_count // num_batches)
    ray_start = (ray_index // batch_size) * batch_size
    return (ray_start * num_batches) // ray_count


def oracle_trace(scene: OracleScene, origin, directions, max_hits, max_ray_life,
                 max_muffle_hit_distance, num_accum_batches=1):
    """Full main-kernel oracle. Returns dict with echo [R,H],
    muffle_hits [B,T], hit_counts [R], hit_points [R,H,3]."""
    origin = np.asarray(origin, float)
    directions = np.asarray(directions, float)
    R = len(directions)
    T = len(scene.target_positions)
    echo = np.zeros((R, max_hits))
    muffle = np.zeros((num_accum_batches, T), np.int64)
    hit_counts = np.zeros(R, np.int64)
    hit_points = np.zeros((R, max_hits, 3))

    for r in range(R):
        b = _accum_batch_id(r, R, num_accum_batches)
        o = origin.copy()
        d = directions[r].copy()
        life = max_ray_life
        hits = 0
        alive = True
        while alive:
            res = _closest_hit(scene, o, d)
            if res is None:
                break
            kind, idx, t = res
            o = o + d * t
            life -= t
            hits += 1
            hit_points[r, hits - 1] = o

            offset = o - d * EPSILON_DEFAULT
            ret_dir = origin - offset
            ret_dir = ret_dir / np.linalg.norm(ret_dir)
            dist_to_origin = float(np.linalg.norm(origin - o))
            if not _occluded(scene, offset, ret_dir, dist_to_origin):
                echo_mat = [scene.sphere_material, scene.aabb_material,
                            scene.obb_material][kind][idx, 2]
                echo[r, hits - 1] = dist_to_origin * echo_mat

            for ti in range(T):
                offset2 = o - d * EPSILON_DEFAULT
                to_t = scene.target_positions[ti] - offset2
                dist = float(np.linalg.norm(to_t))
                dir_t = to_t / dist
                if dist < max_muffle_hit_distance and not _occluded(
                        scene, offset2, dir_t, dist, skip_target=ti):
                    muffle[b, ti] += 1

            if hits >= max_hits or life <= 0:
                alive = False
            else:
                d, o, life = _reflect_ray(scene, kind, idx, o, d, life,
                                          max_ray_life)
                if life < 0:
                    alive = False
        hit_counts[r] = hits

    return dict(echo=echo, muffle_hits=muffle, hit_counts=hit_counts,
                hit_points=hit_points)


def oracle_permeation(scene: OracleScene, origin, directions,
                      permeation_strength_per_ray, num_accum_batches=1):
    """[B, T] permeation power remains, with the last-ray-overwrite quirk."""
    origin = np.asarray(origin, float)
    directions = np.asarray(directions, float)
    R = len(directions)
    T = len(scene.target_positions)
    out = np.zeros((num_accum_batches, T))

    for r in range(R):
        b = _accum_batch_id(r, R, num_accum_batches)
        o = origin.copy()
        d = directions[r].copy()
        res = _closest_hit(scene, o, d)
        if res is None:
            continue
        _, _, t = res
        p = o + d * t
        offset = p - d * EPSILON_DEFAULT
        for ti in range(T):
            to_t = scene.target_positions[ti] - offset
            dist = float(np.linalg.norm(to_t))
            dir_t = to_t / dist
            loss = _chord_loss(scene, offset, dir_t, ti)
            out[b, ti] = R * permeation_strength_per_ray - loss
    return out


def oracle_process(echo, muffle_hits, permeation, target_positions,
                   ray_count, max_hits, muffle_effectiveness,
                   permeation_strength_per_ray, permeation_effectiveness,
                   max_reverb_distance):
    """Reduce to per-target settings, mirroring ProcessAudioDataJob."""
    max_ray_hits = ray_count * max_hits
    flat = np.asarray(echo).reshape(-1)
    zero_entries = float(np.sum(flat == 0))
    reverb_total = float(np.sum(flat))
    avg = reverb_total / max_ray_hits
    strength = avg / max_reverb_distance
    volume = zero_entries / max_ray_hits

    T = len(target_positions)
    muffle_out = np.zeros(T)
    for ti in range(T):
        tot_hits = float(np.sum(muffle_hits[:, ti]))
        tot_perm = float(np.sum(permeation[:, ti]))
        m = 1.0 - tot_hits / (ray_count * max_hits) * muffle_effectiveness
        perm = (tot_perm / ray_count / permeation_strength_per_ray
                * permeation_effectiveness)
        muffle_out[ti] = np.clip(m - perm, 0.0, 1.0)

    return dict(
        muffle=np.clip(muffle_out, 0, 1),
        reverb_strength=float(np.clip(strength, 0, 1)),
        reverb_volume=float(np.clip(volume, 0, 1)),
    )


def from_scene(scene) -> OracleScene:
    """Convert an audio_raytracer_tpu.types.Scene to the oracle mirror
    (drops padding via the active masks)."""
    import numpy as _np

    def np_(x):
        return _np.asarray(x, float)

    sp, ab, ob = scene.spheres, scene.aabbs, scene.obbs
    sm = _np.asarray(sp.active)
    am = _np.asarray(ab.active)
    om = _np.asarray(ob.active)
    return OracleScene(
        sphere_center=np_(sp.center)[sm],
        sphere_radius=np_(sp.radius)[sm],
        sphere_material=_np.stack(
            [np_(sp.material.absorption), np_(sp.material.density),
             np_(sp.material.echo)], axis=-1)[sm],
        sphere_target=_np.asarray(sp.target_id)[sm],
        aabb_center=np_(ab.center)[am],
        aabb_half=np_(ab.half_extents)[am],
        aabb_material=_np.stack(
            [np_(ab.material.absorption), np_(ab.material.density),
             np_(ab.material.echo)], axis=-1)[am],
        aabb_target=_np.asarray(ab.target_id)[am],
        obb_center=np_(ob.center)[om],
        obb_half=np_(ob.half_extents)[om],
        obb_inv_rot=np_(ob.inv_rot)[om],
        obb_material=_np.stack(
            [np_(ob.material.absorption), np_(ob.material.density),
             np_(ob.material.echo)], axis=-1)[om],
        obb_target=_np.asarray(ob.target_id)[om],
        target_positions=np_(scene.target_positions),
    )
