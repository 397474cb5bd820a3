"""Quaternion math (xyzw layout, matching Unity.Mathematics).

The reference leans on Unity.Mathematics quaternion ops (math.mul,
math.inverse) plus a bake-time inverse-rotation optimization
(Audio/Colliders/AudioOBBCollider.cs:59, DataTypes/halfQuaternion.cs).
These are pure jnp functions, batch-broadcastable over leading axes.
"""

from __future__ import annotations

import jax.numpy as jnp

Array = jnp.ndarray


def rotate(q: Array, v: Array) -> Array:
    """Rotate vector(s) v by unit quaternion(s) q (xyzw).

    Equivalent to Unity's ``math.mul(quaternion, float3)``:
    v' = v + 2 * cross(q.xyz, cross(q.xyz, v) + q.w * v).
    Broadcasts over leading dims of q [..., 4] and v [..., 3].
    """
    xyz = q[..., :3]
    w = q[..., 3:4]
    t = 2.0 * jnp.cross(xyz, v)
    return v + w * t + jnp.cross(xyz, t)


def to_matrix(q: Array) -> Array:
    """Rotation matrix M [..., 3, 3] with M @ v == rotate(q, v).

    Used to pre-bake the per-OBB inverse rotation into 9 table entries
    so the kernels rotate with 15 mul-adds per vector instead of the
    ~27-op quaternion sandwich (the analog of the reference's bake-time
    inverse-quaternion trick, AudioOBBCollider.cs:59).
    """
    x, y, z, w = (q[..., i] for i in range(4))
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    row0 = jnp.stack([1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz),
                      2.0 * (xz + wy)], axis=-1)
    row1 = jnp.stack([2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz),
                      2.0 * (yz - wx)], axis=-1)
    row2 = jnp.stack([2.0 * (xz - wy), 2.0 * (yz + wx),
                      1.0 - 2.0 * (xx + yy)], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2)


def inverse(q: Array) -> Array:
    """Inverse of a unit quaternion: conjugate (xyzw)."""
    return q * jnp.asarray([-1.0, -1.0, -1.0, 1.0], q.dtype)


def multiply(a: Array, b: Array) -> Array:
    """Hamilton product a*b (xyzw), broadcasting over leading dims."""
    ax, ay, az, aw = (a[..., i] for i in range(4))
    bx, by, bz, bw = (b[..., i] for i in range(4))
    return jnp.stack(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ],
        axis=-1,
    )


def from_axis_angle(axis: Array, angle: Array) -> Array:
    """Unit quaternion (xyzw) for rotation of ``angle`` radians about ``axis``."""
    axis = jnp.asarray(axis, jnp.float32)
    axis = axis / jnp.linalg.norm(axis, axis=-1, keepdims=True)
    half = jnp.asarray(angle, jnp.float32)[..., None] * 0.5
    return jnp.concatenate([axis * jnp.sin(half), jnp.cos(half)], axis=-1)


def from_euler_zxy(euler_rad: Array) -> Array:
    """Unity-convention euler (ZXY intrinsic, radians, xyz component order).

    Matches Unity's ``quaternion.Euler`` default rotation order used when
    authoring OBB rotation offsets.
    """
    e = jnp.asarray(euler_rad, jnp.float32) * 0.5
    sx, cx = jnp.sin(e[..., 0]), jnp.cos(e[..., 0])
    sy, cy = jnp.sin(e[..., 1]), jnp.cos(e[..., 1])
    sz, cz = jnp.sin(e[..., 2]), jnp.cos(e[..., 2])
    # ZXY order: q = qy * qx * qz
    return jnp.stack(
        [
            sx * cy * cz + sy * sz * cx,
            sy * cx * cz - sx * sz * cy,
            sz * cx * cy - sx * sy * cz,
            cx * cy * cz + sy * sz * sx,
        ],
        axis=-1,
    )


def normalize(q: Array) -> Array:
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True)


def pack_xyz(q: Array) -> Array:
    """Store a unit quaternion as xyz only, w reconstructed on unpack.

    The reference's halfQuaternion bandwidth trick
    (DataTypes/halfQuaternion.cs:7-63): w is recoverable as
    sqrt(1 - |xyz|^2) once its sign is canonicalized to +; when w < 0 the
    equivalent quaternion -q is stored instead. Returns [..., 3]
    (optionally cast to bfloat16 by the caller for the half-width layout).
    """
    sign = jnp.where(q[..., 3:4] < 0.0, -1.0, 1.0)
    return q[..., :3] * sign


def unpack_xyz(xyz: Array) -> Array:
    """Inverse of pack_xyz: [..., 3] -> [..., 4] with w = sqrt(1-|xyz|^2)."""
    w2 = jnp.maximum(0.0, 1.0 - jnp.sum(xyz * xyz, axis=-1, keepdims=True))
    return jnp.concatenate([xyz, jnp.sqrt(w2)], axis=-1)
