"""Async per-frame orchestration: dispatch tracing, harvest when done.

The reference's frame driver (Audio/AudioRayTracer.cs:92-238) schedules
its job graph and harvests it a frame (or more) later, skipping frames
while jobs run (``computeAsync``, AudioRaytracingManager.cs:13). Here the
analog is XLA async dispatch: ``tick()`` snapshots the registry (the
double-buffer publish), dispatches the jitted step without blocking, and
returns the most recent *completed* frame's settings. The fork-join
raytrace || permeation -> reduce graph lives inside one jitted function,
scheduled by XLA.
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp

from audio_raytracer_tpu.models.raytracer import forward
from audio_raytracer_tpu.ops.fibonacci import fibonacci_directions
from audio_raytracer_tpu.types import TargetSettings, TraceConfig


def _ready(tree) -> bool:
    """Non-blocking completion probe (the JobHandle.IsCompleted analog,
    Audio/AudioRayTracer.cs:95)."""
    return all(leaf.is_ready() for leaf in jax.tree.leaves(tree))


class AsyncRaytraceLoop:
    """Owns ray buffers + the jitted step; one instance per listener.

    Usage per frame: ``settings = loop.tick(origin)``; returns None until
    the first frame completes (async mode), then always the latest
    completed TargetSettings (device arrays).
    """

    def __init__(self, registry, cfg: TraceConfig, backend: str = "jnp",
                 compute_async: bool = True,
                 mesh: "jax.sharding.Mesh | None" = None):
        """``mesh``: drive the live loop over a ('rays', 'prims') device
        mesh instead of a single device — the serving composition of the
        orchestrator and the parallel tier (the reference's driver runs
        the WHOLE job system, Audio/AudioRayTracer.cs:92-238; this is
        its multi-chip analog). The step is built via
        parallel.sharded.make_sharded_forward and every registry
        snapshot is padded so each primitive type divides evenly over
        the 'prims' axis (pad_scene_for_prim_shards); registry
        mutations flow through mid-run exactly as on one device."""
        self.registry = registry
        self.compute_async = compute_async
        self._backend = backend
        self.mesh = mesh
        self._adopt_config(cfg)
        self._in_flight = None
        self._dispatched_at = 0.0
        self._latest = None
        # Latest completed frame's [num_reverb_bins] impulse response
        # (None until harvested / when cfg.num_reverb_bins == 0).
        self.reverb_ir = None

        # Instrumentation (the raytracerMs / batchCycleMs stopwatches,
        # AudioRayTracer.cs:58-59,100-104,158). ``raytracer_ms`` is the
        # dispatch-to-harvest time of the latest harvested frame.
        self.raytracer_ms = 0.0
        self.batch_cycle_ms = 0.0
        self.frames_dispatched = 0
        self.frames_harvested = 0

    def _adopt_config(self, cfg: TraceConfig):
        """(Re)build the ray buffers + jitted step for ``cfg``."""
        self.cfg = cfg
        self._directions = fibonacci_directions(cfg.ray_count)
        backend = self._backend

        if self.mesh is not None:
            import dataclasses

            from audio_raytracer_tpu.parallel.sharded import (
                make_sharded_forward,
            )

            ray_shards = self.mesh.shape["rays"]
            assert cfg.ray_count % ray_shards == 0, (
                f"ray_count {cfg.ray_count} not divisible by "
                f"{ray_shards} ray shards")
            # Each ray shard is one accumulation batch, exactly the
            # reference's per-thread-batch accumulator rows.
            cfg_m = dataclasses.replace(cfg,
                                        num_accum_batches=ray_shards)
            self._step = make_sharded_forward(cfg_m, self.mesh,
                                              backend=backend,
                                              return_ir=True)
            return

        def step(origin, directions, scene):
            result, settings = forward(origin, directions, scene, cfg,
                                       backend=backend)
            # The IR histogram rides along when enabled so the DSP tail
            # stage (models/spatializer.spatialize(reverb_ir=...)) can
            # consume it per frame.
            return settings, result.reverb_ir

        self._step = jax.jit(step)

    def reconfigure(self, cfg: TraceConfig):
        """Adopt a changed TraceConfig mid-run — the reference's editor
        failsafe that re-allocates ray buffers when inspector params
        change (Audio/AudioRayTracer.cs:110-133). The in-flight frame
        (traced under the old config) is dropped, directions and the
        jitted step are rebuilt, and the next ``tick`` dispatches under
        the new config; the latest completed settings stay available so
        the DSP never starves. No-op when nothing changed."""
        if cfg == self.cfg:
            return
        self._adopt_config(cfg)
        self._in_flight = None

    def tick(self, origin) -> TargetSettings | None:
        """One frame: harvest if complete, re-sync scene, dispatch next."""
        # 1. Harvest (the mainJobHandle.Complete() analog).
        if self._in_flight is not None:
            if self.compute_async and not _ready(self._in_flight):
                # Frame-skip: job still running (AudioRayTracer.cs:95).
                return self._latest
            jax.block_until_ready(self._in_flight)
            self.raytracer_ms = (time.perf_counter()
                                 - self._dispatched_at) * 1e3
            self._latest, self.reverb_ir = self._in_flight
            if self.reverb_ir is not None and self.reverb_ir.size == 0:
                self.reverb_ir = None  # meshed step's disabled-IR shape
            self._in_flight = None
            self.frames_harvested += 1

        # 2. Publish scene mutations (UpdateJobBatch, cs:154-155).
        t0 = time.perf_counter()
        scene = self.registry.snapshot()
        if self.mesh is not None:
            from audio_raytracer_tpu.parallel.mesh import (
                pad_scene_for_prim_shards,
            )

            scene = pad_scene_for_prim_shards(scene,
                                              self.mesh.shape["prims"])
        self.batch_cycle_ms = (time.perf_counter() - t0) * 1e3

        # 3. Dispatch (async; XLA queues the fork-join graph).
        if scene.num_targets > 0:
            self._dispatched_at = time.perf_counter()
            self._in_flight = self._step(
                jnp.asarray(origin, jnp.float32), self._directions, scene)
            self.frames_dispatched += 1
        return self._latest
