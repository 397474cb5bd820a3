"""Device-mesh construction + scene padding for primitive sharding.

The reference scales by splitting the ray range over CPU job-worker
threads (Audio/AudioRayTracer.cs:161; SURVEY.md §2.7). The device analog is
a 2-D ``Mesh(('rays', 'prims'))``: rays are data-parallel shards, and for
large collider counts the primitive axis is sharded too, with closest-hit
merged by mesh collectives (the ring-attention-like axis of this workload).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from audio_raytracer_tpu.types import Aabbs, Materials, Obbs, Scene, Spheres


def make_mesh(ray_shards: int | None = None, prim_shards: int = 1,
              devices=None) -> jax.sharding.Mesh:
    """Build a ('rays', 'prims') mesh over the available devices."""
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if ray_shards is None:
        ray_shards = n // prim_shards
    assert ray_shards * prim_shards == n, (
        f"mesh {ray_shards}x{prim_shards} != {n} devices")
    dev_array = np.asarray(devices).reshape(ray_shards, prim_shards)
    return jax.sharding.Mesh(dev_array, ("rays", "prims"))


def _pad_axis(x, n, fill=0.0):
    if n == 0:
        return x
    pad_shape = (n,) + x.shape[1:]
    return jnp.concatenate([x, jnp.full(pad_shape, fill, x.dtype)], axis=0)


def _pad_materials(m: Materials, n: int) -> Materials:
    return Materials(
        absorption=_pad_axis(m.absorption, n),
        density=_pad_axis(m.density, n),
        echo=_pad_axis(m.echo, n),
    )


def pad_scene_for_prim_shards(scene: Scene, prim_shards: int) -> Scene:
    """Pad each primitive array with inactive entries so every type count
    divides evenly by ``prim_shards`` (static-shape even split)."""

    def pad_to(count):
        return (-count) % prim_shards

    ns = pad_to(scene.spheres.count)
    na = pad_to(scene.aabbs.count)
    nb = pad_to(scene.obbs.count)

    spheres = Spheres(
        center=_pad_axis(scene.spheres.center, ns),
        radius=_pad_axis(scene.spheres.radius, ns),
        material=_pad_materials(scene.spheres.material, ns),
        target_id=_pad_axis(scene.spheres.target_id, ns, -1),
        active=_pad_axis(scene.spheres.active, ns, False),
    )
    aabbs = Aabbs(
        center=_pad_axis(scene.aabbs.center, na),
        half_extents=_pad_axis(scene.aabbs.half_extents, na),
        material=_pad_materials(scene.aabbs.material, na),
        target_id=_pad_axis(scene.aabbs.target_id, na, -1),
        active=_pad_axis(scene.aabbs.active, na, False),
    )
    identity = jnp.zeros((nb, 4), scene.obbs.inv_rot.dtype
                         ) if nb else scene.obbs.inv_rot[:0]
    if nb:
        identity = identity.at[:, 3].set(1.0)
    obbs = Obbs(
        center=_pad_axis(scene.obbs.center, nb),
        half_extents=_pad_axis(scene.obbs.half_extents, nb),
        inv_rot=jnp.concatenate([scene.obbs.inv_rot, identity], axis=0)
        if nb else scene.obbs.inv_rot,
        material=_pad_materials(scene.obbs.material, nb),
        target_id=_pad_axis(scene.obbs.target_id, nb, -1),
        active=_pad_axis(scene.obbs.active, nb, False),
    )
    return dataclasses.replace(scene, spheres=spheres, aabbs=aabbs, obbs=obbs)
