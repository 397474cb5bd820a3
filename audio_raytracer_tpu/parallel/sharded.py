"""Sharded forward: shard_map over a ('rays', 'prims') mesh.

The distributed design (SURVEY.md §2.7): rays are data-parallel shards
(the analog of the reference's thread batches, Audio/AudioRayTracer.cs:161);
primitives optionally shard over a second mesh axis with closest-hit
merged by pmin + scan-rank tie-break (ops/backend.PrimShardedBackend).
Reduce-side accumulators ride XLA collectives between devices:

- muffle / permeation / echo statistics: psum over 'rays' — the collective
  form of ProcessAudioDataJob.cs:55-75's serial per-batch reduce
- closest-hit / occlusion merges: pmin / pmax / psum over 'prims'

Each ray shard IS one accumulation batch (num_accum_batches == ray_shards),
exactly the reference's per-thread-batch accumulator rows.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from audio_raytracer_tpu.ops import permeation as permeation_op
from audio_raytracer_tpu.ops import reverb as reverb_op
from audio_raytracer_tpu.ops import trace as trace_op
from audio_raytracer_tpu.ops.backend import DenseBackend, PrimShardedBackend
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


def scene_pspec(prim_sharded: bool) -> Scene:
    """A Scene-shaped pytree of PartitionSpecs."""
    prim = P("prims") if prim_sharded else P()
    rep = P()
    mat = Materials(absorption=prim, density=prim, echo=prim)
    return Scene(
        spheres=Spheres(center=prim, radius=prim, material=mat,
                        target_id=prim, active=prim),
        aabbs=Aabbs(center=prim, half_extents=prim, material=mat,
                    target_id=prim, active=prim),
        obbs=Obbs(center=prim, half_extents=prim, inv_rot=prim, material=mat,
                  target_id=prim, active=prim),
        target_positions=rep,
    )


def _settings_from_partials(zero_entries, reverb_total, total_hits,
                            total_perm, scene, cfg: TraceConfig,
                            R: int, H: int) -> TargetSettings:
    """Final reduce math of ProcessAudioDataJob.cs:31-76, from globally
    psum-reduced partial sums."""
    max_ray_hits = R * H
    avg_reverb_dist = reverb_total / max_ray_hits
    reverb_strength = avg_reverb_dist / cfg.max_reverb_distance
    reverb_volume = zero_entries / max_ray_hits

    muffle = 1.0 - total_hits / max_ray_hits * cfg.muffle_effectiveness
    perm_term = (total_perm / R / cfg.permeation_strength_per_ray
                 * cfg.permeation_effectiveness)
    muffle = jnp.clip(muffle - perm_term, 0.0, 1.0)

    return TargetSettings(
        muffle=muffle,
        reverb_strength=jnp.clip(reverb_strength, 0.0, 1.0),
        reverb_volume=jnp.clip(reverb_volume, 0.0, 1.0),
        perceived_position=scene.target_positions,
    )


def make_local_engine(scene_local, backend: str, differentiable=False):
    """Local intersection engine for one shard: 'jnp' (DenseBackend) or
    'pallas' / 'pallas_interpret' (the kernel engine per shard)."""
    if backend == "jnp":
        return DenseBackend(scene_local)
    if backend in ("pallas", "pallas_interpret"):
        from audio_raytracer_tpu.ops.pallas import PallasBackend

        return PallasBackend(scene_local,
                             interpret=(backend == "pallas_interpret"),
                             differentiable=differentiable)
    raise ValueError(f"unknown backend {backend!r}")


def make_sharded_forward(cfg: TraceConfig, mesh: jax.sharding.Mesh,
                         return_result: bool = False,
                         backend: str = "jnp",
                         elide_collectives: bool = False,
                         return_ir: bool = False):
    """Build the jitted sharded forward step.

    Returns ``step(origin, directions, scene) -> TargetSettings`` (or
    ``(TraceResult, TargetSettings)`` with per-shard accumulator rows
    gathered on axis 0 when ``return_result``; or
    ``(TargetSettings, reverb_ir)`` when ``return_ir`` — the serving
    shape AsyncRaytraceLoop harvests, with the IR already psum-reduced
    over the ray axis and replicated; a [0]-shaped placeholder when
    ``cfg.num_reverb_bins == 0``).

    ``backend`` selects the per-shard intersection engine: "jnp" or
    "pallas" (each device streams its ray/primitive shard through the
    Pallas kernels; "pallas_interpret" for CPU-mesh testing).

    ``elide_collectives`` is a BENCHMARKING DIAGNOSTIC only: the
    ray-axis psums are replaced by identity, so every device does the
    identical local work but no cross-device reduction happens and the
    returned settings are per-shard partials (globally WRONG numbers).
    Timing the normal step against this variant decomposes scaling
    overhead into collective cost vs shard_map/dispatch overhead
    (bench.py --mesh). Requires return_result=False.

    Requirements: ray_count divisible by the 'rays' axis size; per-type
    primitive counts divisible by the 'prims' axis size (use
    parallel.mesh.pad_scene_for_prim_shards); non-empty scene when
    prim-sharded.
    """
    ray_shards = mesh.shape["rays"]
    prim_shards = mesh.shape["prims"]
    assert cfg.ray_count % ray_shards == 0, (
        f"ray_count {cfg.ray_count} not divisible by {ray_shards} ray shards")
    assert not (elide_collectives and (return_result or return_ir))
    assert not (return_result and return_ir)
    local_cfg = dataclasses.replace(cfg, num_accum_batches=1)
    prim_sharded = prim_shards > 1
    # Values computed inside a pallas kernel from its whole-array table
    # inputs carry no varying-manual-axes type, which breaks the kernel's
    # fori carry typing — disable shard_map's vma checking for the
    # kernel engines. The jnp tier type-checks fully. The elided
    # diagnostic returns shard-varying values through replicated
    # out_specs, so it must skip the check too.
    check_vma = backend == "jnp" and not elide_collectives
    pvary_axes = ("rays",) if check_vma else ()
    if elide_collectives:
        def ray_psum(x, axis_name):
            return x
        ir_axis_name = None
    else:
        ray_psum = jax.lax.psum
        ir_axis_name = "rays"

    def local_step(origin, dirs_local, scene_local):
        engine = make_local_engine(scene_local, backend)
        if prim_sharded:
            backend_ = PrimShardedBackend(scene_local, "prims", prim_shards,
                                          engine=engine)
        else:
            backend_ = engine

        result = trace_op.trace(origin, dirs_local, scene_local, local_cfg,
                                backend=backend_, pvary_axes=pvary_axes)
        perm = permeation_op.permeation(origin, dirs_local, scene_local,
                                        local_cfg, backend=backend_,
                                        total_ray_count=cfg.ray_count,
                                        first_t=result.first_hit_t)
        result = dataclasses.replace(result, permeation=perm)
        if cfg.num_reverb_bins > 0:
            # Per-shard IR histogram psum-reduced over the ray axis
            # (exactly like the muffle/permeation accumulators).
            result = dataclasses.replace(
                result, reverb_ir=reverb_op.impulse_response(
                    result.echo_distances, cfg, axis_name=ir_axis_name))

        echo = result.echo_distances
        dt = echo.dtype
        # Partial sums -> global psum over the ray axis.
        zero_entries = ray_psum(
            jnp.sum((echo == 0.0).astype(dt)), "rays")
        reverb_total = ray_psum(jnp.sum(echo), "rays")
        total_hits = ray_psum(
            jnp.sum(result.muffle_hits, axis=0).astype(dt), "rays")
        total_perm = ray_psum(jnp.sum(perm, axis=0), "rays")

        settings = _settings_from_partials(
            zero_entries, reverb_total, total_hits, total_perm, scene_local,
            cfg, cfg.ray_count, cfg.max_hits_per_ray)
        if return_result:
            return result, settings
        if return_ir:
            ir = (result.reverb_ir if cfg.num_reverb_bins > 0
                  else jnp.zeros((0,), echo.dtype))
            return settings, ir
        return settings

    out_result_spec = TraceResult(
        echo_distances=P("rays"),
        muffle_hits=P("rays"),  # [ray_shards, T] accum-batch rows
        permeation=P("rays"),
        first_hit_t=P("rays"),
        reverb_ir=P() if cfg.num_reverb_bins > 0 else None,
        hit_points=None,
        hit_counts=None,
    )
    if return_result:
        out_specs = (out_result_spec, P())
    elif return_ir:
        out_specs = (P(), P())
    else:
        out_specs = P()

    f = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P(), P("rays"), scene_pspec(prim_sharded)),
        out_specs=out_specs,
        check_vma=check_vma,
    )
    return jax.jit(f)


def sharded_forward(origin, directions, scene, cfg: TraceConfig,
                    mesh: jax.sharding.Mesh, return_result: bool = False):
    """One-shot convenience wrapper around make_sharded_forward."""
    step = make_sharded_forward(cfg, mesh, return_result)
    return step(origin, directions, scene)
