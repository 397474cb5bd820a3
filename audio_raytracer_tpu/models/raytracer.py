"""The flagship model: full audio-raytrace forward step.

Composes the per-frame pipeline of the reference orchestrator
(Audio/AudioRayTracer.cs:92-238): main trace + permeation run as one XLA
dataflow graph (the reference's fork-join job graph becomes compiler
-scheduled parallelism), then the reduce to per-target settings.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from audio_raytracer_tpu.ops import permeation as permeation_op
from audio_raytracer_tpu.ops import process as process_op
from audio_raytracer_tpu.ops import reverb as reverb_op
from audio_raytracer_tpu.ops import trace as trace_op
from audio_raytracer_tpu.ops import quaternion
from audio_raytracer_tpu.ops.fibonacci import fibonacci_directions
from audio_raytracer_tpu.types import (
    Aabbs,
    Materials,
    Obbs,
    Scene,
    Spheres,
    TargetSettings,
    TraceConfig,
    TraceResult,
)

Array = jnp.ndarray


def _make_backend(scene: Scene, backend: str, cfg: TraceConfig | None = None):
    if backend == "jnp" or scene.num_primitives == 0:
        return None  # trace/permeation default to DenseBackend
    if backend in ("pallas", "pallas_interpret"):
        from audio_raytracer_tpu.ops.pallas import PallasBackend

        dtype = cfg.compute_jnp_dtype if cfg is not None else None
        return PallasBackend(
            scene, interpret=(backend == "pallas_interpret"),
            **({} if dtype is None else {"compute_dtype": dtype}))
    raise ValueError(f"unknown backend {backend!r}")


def forward(origin: Array, directions: Array, scene: Scene, cfg: TraceConfig,
            collect_debug: bool = False,
            backend: str = "jnp") -> tuple[TraceResult, TargetSettings]:
    """One full frame: trace + permeation + reduce.

    Equivalent to one cycle of AudioRaytracerJobBatched ||
    AudioPermeationJobBatched -> ProcessAudioDataJob.

    ``backend``: "jnp" (the plain engine XLA compiles) or "pallas" (the
    Triton-route kernels; "pallas_interpret" for CPU debugging).
    """
    be = _make_backend(scene, backend, cfg)
    result = trace_op.trace(origin, directions, scene, cfg,
                            collect_debug=collect_debug, backend=be)
    perm = permeation_op.permeation(origin, directions, scene, cfg,
                                    backend=be, first_t=result.first_hit_t)
    result = dataclasses.replace(result, permeation=perm)
    if cfg.num_reverb_bins > 0:
        result = dataclasses.replace(
            result, reverb_ir=reverb_op.impulse_response(
                result.echo_distances, cfg))
    settings = process_op.process(result, scene, cfg)
    return result, settings


def make_forward(cfg: TraceConfig, collect_debug: bool = False,
                 backend: str = "jnp"):
    """Jitted forward with the static config closed over."""

    @jax.jit
    def step(origin, directions, scene):
        return forward(origin, directions, scene, cfg, collect_debug, backend)

    return step


# ---------------------------------------------------------------------------
# Scene construction helpers (demo / test / benchmark content)
# ---------------------------------------------------------------------------


def random_scene(key, num_spheres=8, num_aabbs=8, num_obbs=8, num_targets=2,
                 extent=30.0, size_range=(0.5, 3.0), dtype=jnp.float32,
                 target_owned_colliders=False) -> Scene:
    """Random mixed scene in a cube of +/- extent around the origin,
    statistically similar to the reference demo scene (~58 AABB + ~45 OBB
    + ~8 spheres in Sample Scene.unity)."""
    ks = jax.random.split(key, 12)
    lo, hi = size_range

    def upos(k, n):
        return jax.random.uniform(k, (n, 3), minval=-extent, maxval=extent)

    def umat(k, n):
        a = jax.random.uniform(k, (n,), minval=0.0, maxval=0.3)
        d = jax.random.uniform(jax.random.fold_in(k, 1), (n,),
                               minval=0.2, maxval=2.0)
        e = jax.random.uniform(jax.random.fold_in(k, 2), (n,),
                               minval=0.5, maxval=2.0)
        return Materials(a.astype(dtype), d.astype(dtype), e.astype(dtype))

    spheres = Spheres.build(
        upos(ks[0], num_spheres),
        jax.random.uniform(ks[1], (num_spheres,), minval=lo, maxval=hi),
        material=umat(ks[2], num_spheres), dtype=dtype)

    aabbs = Aabbs.build(
        upos(ks[3], num_aabbs),
        jax.random.uniform(ks[4], (num_aabbs, 3), minval=lo, maxval=hi),
        material=umat(ks[5], num_aabbs), dtype=dtype)

    axis = jax.random.normal(ks[6], (num_obbs, 3))
    angle = jax.random.uniform(ks[7], (num_obbs,), minval=0.0,
                               maxval=2.0 * np.pi)
    rot = quaternion.from_axis_angle(axis, angle)
    obbs = Obbs.build(
        upos(ks[8], num_obbs),
        jax.random.uniform(ks[9], (num_obbs, 3), minval=lo, maxval=hi),
        quaternion.inverse(rot),  # stored pre-inverted, like the bake
        material=umat(ks[10], num_obbs), dtype=dtype)

    targets = jax.random.uniform(ks[11], (num_targets, 3),
                                 minval=-extent * 0.8, maxval=extent * 0.8)

    if target_owned_colliders and num_targets > 0:
        # Give each target an owning sphere collider around its position,
        # exercising the AudioTargetId skip path (AudioCollider.cs:30-37).
        own = Spheres.build(
            targets, jnp.full((num_targets,), 0.5),
            target_id=jnp.arange(num_targets, dtype=jnp.int32), dtype=dtype)
        spheres = Spheres(
            center=jnp.concatenate([spheres.center, own.center]),
            radius=jnp.concatenate([spheres.radius, own.radius]),
            material=Materials(
                jnp.concatenate([spheres.material.absorption,
                                 own.material.absorption]),
                jnp.concatenate([spheres.material.density,
                                 own.material.density]),
                jnp.concatenate([spheres.material.echo, own.material.echo]),
            ),
            target_id=jnp.concatenate([spheres.target_id, own.target_id]),
            active=jnp.concatenate([spheres.active, own.active]),
        )

    return Scene(spheres=spheres, aabbs=aabbs, obbs=obbs,
                 target_positions=targets.astype(dtype))


def demo_inputs(cfg: TraceConfig, key=None, dtype=jnp.float32):
    """(origin, directions) matching the reference Player.prefab defaults."""
    origin = jnp.zeros((3,), dtype)
    directions = fibonacci_directions(cfg.ray_count, dtype)
    return origin, directions
