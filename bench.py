"""Benchmark harness: rays/s/chip on the flagship forward and fwd+bwd.

Prints ONE JSON line per record:
  {"metric": "...", "value": N, "unit": "...", "vs_baseline": N}

Default workload is the BASELINE north-star headline: 1M rays x 4K mixed
primitives x 5 hits x 4 targets, forward AND forward+backward (--mode
both). Override with --rays/--prims/--mode.

Baseline note: the reference (FirePixel8422/Audio-Raytracer) publishes no
benchmark numbers (BASELINE.md). The only throughput its defaults define
is the real-time envelope: 500 rays/frame at 60 fps = 30,000 rays/s on a
desktop CPU (Player.prefab rayCount, Unity frame loop). ``vs_baseline``
is measured rays/s against that envelope.

--mesh RxP runs the shard_map'd forward over an R x P ('rays','prims')
device mesh and reports rays/s plus scaling efficiency vs the single
-device run AND vs a collectives-elided variant of the identical step
(the overhead decomposition).

The benchmark measures a GPU: it exits non-zero when JAX finds none.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

REFERENCE_ENVELOPE_RAYS_PER_S = 30_000.0  # 500 rays x 60 fps (see above)


def _spread_ms(times):
    """[min, median, max] over per-step seconds, in ms — every record
    carries its dispersion."""
    s = sorted(times)
    return [round(s[0] * 1e3, 2), round(s[len(s) // 2] * 1e3, 2),
            round(s[-1] * 1e3, 2)]


def _time_step(step, origin, dirs, scene, iters):
    """Returns (median_seconds, all_times)."""
    import jax
    import jax.numpy as jnp

    jax.block_until_ready(step(origin, dirs, scene))  # warmup / compile
    times = []
    for i in range(iters):
        o_i = origin + jnp.float32(i) * 1e-6
        t0 = time.perf_counter()
        jax.block_until_ready(step(o_i, dirs, scene))
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2], times


def _record(metric, rays_per_s, extra=None, times=None):
    rec = {
        "metric": metric,
        "value": round(rays_per_s, 1),
        "unit": "rays/s",
        "vs_baseline": round(rays_per_s / REFERENCE_ENVELOPE_RAYS_PER_S, 2),
    }
    if times:
        rec["spread_ms"] = _spread_ms(times)
    if extra:
        rec.update(extra)
    return rec


def _emit(metric, rays_per_s, extra=None):
    print(json.dumps(_record(metric, rays_per_s, extra)), flush=True)


def _selfcheck(backend):
    """Refuse to post perf records from a silently-broken kernel tier:
    before timing, the kernel engine must agree with the plain forward
    on a small workload (fuzz-test tolerances — razor-edge lanes may
    flip, structure may not)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from audio_raytracer_tpu.models.raytracer import forward, random_scene
    from audio_raytracer_tpu.ops.fibonacci import fibonacci_directions
    from audio_raytracer_tpu.types import TraceConfig

    cfg = TraceConfig(ray_count=4096, max_bounces=3, max_ray_life=150.0,
                      compact_rays=True, compact_unordered=True)
    scene = random_scene(jax.random.key(7), num_spheres=32, num_aabbs=64,
                         num_obbs=32, num_targets=4, extent=40.0,
                         size_range=(0.5, 4.0))
    o = jnp.zeros(3)
    d = fibonacci_directions(cfg.ray_count)
    _, s_ref = forward(o, d, scene, cfg, backend="jnp")
    _, s_be = forward(o, d, scene, cfg, backend=backend)
    np.testing.assert_allclose(np.asarray(s_ref.muffle),
                               np.asarray(s_be.muffle), rtol=1e-3,
                               atol=5e-3)
    np.testing.assert_allclose(float(s_ref.reverb_volume),
                               float(s_be.reverb_volume), rtol=1e-3,
                               atol=2e-3)
    print(f"# selfcheck ok: {backend} == jnp on 4096x128 "
          f"(muffle {np.asarray(s_be.muffle).round(3).tolist()})",
          file=sys.stderr)


def _selfcheck_bwd(backend, pose_grads=False):
    """Gate the fwd_bwd lanes the way _selfcheck gates the forward: the
    kernel tier's gradients (materials; plus poses when pose_grads) must
    match the jnp autodiff gradients on a small workload before any
    backward record is posted."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from audio_raytracer_tpu.models.differentiable import (
        Loudness,
        SceneParams,
        loudness_loss,
    )
    from audio_raytracer_tpu.models.raytracer import random_scene
    from audio_raytracer_tpu.ops.fibonacci import fibonacci_directions
    from audio_raytracer_tpu.ops.pallas import PallasBackend
    from audio_raytracer_tpu.types import TraceConfig

    cfg = TraceConfig(ray_count=1024, max_bounces=3, max_ray_life=150.0)
    scene = random_scene(jax.random.key(9), num_spheres=24, num_aabbs=48,
                         num_obbs=24, num_targets=4, extent=30.0,
                         size_range=(0.5, 4.0))
    params = SceneParams.from_scene(scene)
    target = Loudness(muffle=jnp.full((4,), 0.3),
                      permeation=jnp.full((4,), 0.2),
                      reverb_energy=jnp.asarray(0.05))
    origin = jnp.zeros(3)
    dirs = fibonacci_directions(cfg.ray_count)

    def backend_fn(s):
        return PallasBackend(s, differentiable=True,
                             pose_grads=pose_grads)

    argnums = (0, 2) if pose_grads else 0

    @jax.jit
    def g_ref_fn(params, scene, origin, dirs):
        return jax.grad(loudness_loss, argnums=argnums)(
            params, scene, origin, dirs, cfg, target)

    @jax.jit
    def g_ker_fn(params, scene, origin, dirs):
        return jax.grad(loudness_loss, argnums=argnums)(
            params, scene, origin, dirs, cfg, target,
            backend_fn=backend_fn)

    g_ref = g_ref_fn(params, scene, origin, dirs)
    g_ker = g_ker_fn(params, scene, origin, dirs)
    for a, b in zip(jax.tree.leaves(g_ref), jax.tree.leaves(g_ker)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-3, atol=2e-5)
    n = len(jax.tree.leaves(g_ref))
    print(f"# selfcheck_bwd ok: {backend} gradients == jnp autodiff on "
          f"1024x96 ({n} grad leaves, pose_grads={pose_grads})",
          file=sys.stderr)


def build_inputs(rays, prims, targets, bounces, dtype="float32"):
    """The BASELINE workload: ``rays`` Fibonacci rays from the origin into
    a random scene of ``prims`` mixed colliders (1/4 spheres, 1/2 AABBs,
    1/4 OBBs) in a 120 m cube, ``targets`` audio sources."""
    import jax
    import jax.numpy as jnp

    from audio_raytracer_tpu.models.raytracer import random_scene
    from audio_raytracer_tpu.ops.fibonacci import fibonacci_directions
    from audio_raytracer_tpu.types import TraceConfig

    n_s = prims // 4
    n_o = prims // 4
    n_a = prims - n_s - n_o
    cfg = TraceConfig(ray_count=rays, max_bounces=bounces,
                      max_ray_life=300.0, max_muffle_hit_distance=250.0,
                      compute_dtype=dtype)
    scene = random_scene(jax.random.key(0), num_spheres=n_s, num_aabbs=n_a,
                         num_obbs=n_o, num_targets=targets,
                         extent=60.0, size_range=(0.5, 4.0))
    origin = jnp.zeros((3,), jnp.float32)
    dirs = fibonacci_directions(rays)
    return cfg, scene, origin, dirs


def _production_cfg(cfg):
    """The serving configuration: unordered ray compaction on. Same
    user-visible outputs (settings / IR are permutation-invariant
    reductions; tests/test_pallas.py::test_unordered_tier_invariants)."""
    import dataclasses

    return dataclasses.replace(cfg, compact_rays=True,
                               compact_unordered=True)


def _bench_fwd(args, cfg, scene, origin, dirs, backend):
    import jax

    from audio_raytracer_tpu.models.raytracer import forward

    cfg_p = _production_cfg(cfg)

    @jax.jit
    def step(origin, dirs, scene):
        _, settings = forward(origin, dirs, scene, cfg_p, backend=backend)
        return settings

    dt, times = _time_step(step, origin, dirs, scene, args.iters)
    return _record("rays_per_s_per_chip_fwd", args.rays / dt,
                   {"step_ms": round(dt * 1e3, 2), "compact_rays": True,
                    "compact_unordered": True}, times=times)


def _bench_fwd_uncompacted(args, cfg, scene, origin, dirs, backend):
    """The default forward configuration: no ray compaction
    (``TraceConfig.compact_rays`` is off by default), kept beside the
    production (compacted) lanes so a config change and a kernel change
    never conflate."""
    import jax

    from audio_raytracer_tpu.models.raytracer import forward

    @jax.jit
    def step(origin, dirs, scene):
        _, settings = forward(origin, dirs, scene, cfg, backend=backend)
        return settings

    dt, times = _time_step(step, origin, dirs, scene, args.iters)
    return _record("rays_per_s_per_chip_fwd_uncompacted", args.rays / dt,
                   {"step_ms": round(dt * 1e3, 2), "compact_rays": False},
                   times=times)


def _bench_fwd_pipelined(args, cfg, scene, origin, dirs, backend,
                         metric="rays_per_s_per_chip_fwd_pipelined",
                         extra=None):
    """Steady-state serving throughput: K frames dispatched back-to-back
    (the orchestrator's async production pattern,
    runtime/orchestrator.py) so host dispatch latency amortizes; wall
    time of the drained pipeline / K. The single-step record includes
    one full dispatch+drain round trip per frame and is the honest
    LATENCY number; this is the honest THROUGHPUT number."""
    import jax
    import jax.numpy as jnp

    from audio_raytracer_tpu.models.raytracer import forward

    cfg_p = _production_cfg(cfg)

    @jax.jit
    def step(origin, dirs, scene):
        _, settings = forward(origin, dirs, scene, cfg_p, backend=backend)
        return settings

    jax.block_until_ready(step(origin, dirs, scene))  # warmup / compile
    K = 8  # deep enough that the one drain round-trip amortizes to <2%
    times = []
    for trial in range(max(2, args.iters // 2)):
        t0 = time.perf_counter()
        outs = [step(origin + jnp.float32(i) * 1e-6, dirs, scene)
                for i in range(K)]
        jax.block_until_ready(outs[-1])
        times.append((time.perf_counter() - t0) / K)
    dt = sorted(times)[len(times) // 2]
    rec_extra = {"step_ms": round(dt * 1e3, 2), "pipeline_depth": K,
                 "compact_rays": True, "compact_unordered": True}
    if extra:
        rec_extra.update(extra)
    return _record(metric, args.rays / dt, rec_extra, times=times)


def _bench_fwd_reflife(args, cfg, scene, origin, dirs, backend):
    """Forward at the REFERENCE's own default ray budget: maxRayLife
    125 m (Player.prefab / Audio/AudioRayTracer.cs:20) instead of this
    harness's historical 300 m. Rays die fast enough that the aliveness
    compaction + dead-block skipping (ops/trace.alive_partition,
    TraceConfig.compact_rays) pays for its data movement — the workload
    where the reference's per-ray early exit mattered most."""
    import dataclasses

    import jax

    from audio_raytracer_tpu.models.raytracer import forward

    # compact_unordered: the production forward consumes only
    # permutation-invariant reductions of the trace outputs, so the
    # per-bounce inverse-permutation restore is skipped (settings/IR
    # bit-identical — tests/test_pallas.py::TestRayCompaction::
    # test_unordered_tier_invariants).
    cfg_ref = dataclasses.replace(cfg, max_ray_life=125.0,
                                  compact_rays=True,
                                  compact_unordered=True)

    @jax.jit
    def step(origin, dirs, scene):
        _, settings = forward(origin, dirs, scene, cfg_ref, backend=backend)
        return settings

    dt, times = _time_step(step, origin, dirs, scene, args.iters)
    return _record("rays_per_s_per_chip_fwd_reflife", args.rays / dt,
                   {"step_ms": round(dt * 1e3, 2), "max_ray_life": 125.0,
                    "compact_rays": True, "compact_unordered": True},
                   times=times)


def _bench_fwd_bwd(args, cfg, scene, origin, dirs, backend,
                   pose_grads=False):
    """fwd+bwd throughput. pose_grads=False = the materials-training
    backward (positions are material-independent, so the chord
    backward's ray cotangents are pruned); pose_grads=True = the
    source/listener-pose gradient workload."""
    import jax
    import jax.numpy as jnp

    from audio_raytracer_tpu.models.differentiable import (
        Loudness,
        SceneParams,
        loudness_loss,
    )

    params = SceneParams.from_scene(scene)
    target = Loudness(muffle=jnp.full((args.targets,), 0.3),
                      permeation=jnp.full((args.targets,), 0.2),
                      reverb_energy=jnp.asarray(0.05))

    backend_fn = None
    if backend == "pallas":
        from audio_raytracer_tpu.ops.pallas import PallasBackend

        def backend_fn(s):
            return PallasBackend(s, differentiable=True,
                                 pose_grads=pose_grads)

    if pose_grads:
        # Differentiate w.r.t. the listener origin too, so the full
        # adjoint's ray cotangents are actually consumed.
        @jax.jit
        def step(origin, dirs, scene):
            return jax.grad(loudness_loss, argnums=(0, 2))(
                params, scene, origin, dirs, cfg, target,
                backend_fn=backend_fn)
    else:
        @jax.jit
        def step(origin, dirs, scene):
            return jax.grad(loudness_loss)(params, scene, origin, dirs, cfg,
                                           target, backend_fn=backend_fn)

    dt, times = _time_step(step, origin, dirs, scene, args.iters)
    suffix = "_posegrads" if pose_grads else ""
    return _record(f"rays_per_s_per_chip_fwd_bwd{suffix}", args.rays / dt,
                   {"step_ms": round(dt * 1e3, 2)}, times=times)


def _bench_mesh(args, cfg, scene, origin, dirs, backend):
    """Sharded forward over an R x P mesh + efficiency vs one device."""
    import dataclasses

    import jax

    from audio_raytracer_tpu.models.raytracer import forward
    from audio_raytracer_tpu.parallel.mesh import (
        make_mesh,
        pad_scene_for_prim_shards,
    )
    from audio_raytracer_tpu.parallel.sharded import make_sharded_forward

    ray_shards, prim_shards = (int(x) for x in args.mesh.split("x"))
    n_dev = ray_shards * prim_shards
    devs = jax.devices()
    assert len(devs) >= n_dev, f"need {n_dev} devices, have {len(devs)}"

    # Single-device reference (same engine tier as the mesh run).
    @jax.jit
    def one_dev(origin, dirs, scene):
        _, settings = forward(origin, dirs, scene, cfg, backend=backend)
        return settings

    dt1, times1 = _time_step(one_dev, origin, dirs, scene, args.iters)

    mesh = make_mesh(ray_shards=ray_shards, prim_shards=prim_shards,
                     devices=devs[:n_dev])
    scene_p = pad_scene_for_prim_shards(scene, prim_shards)
    cfg_m = dataclasses.replace(cfg, num_accum_batches=ray_shards)
    step = make_sharded_forward(cfg_m, mesh, backend=backend)

    # Diagnostic: the identical sharded step with the ray-axis psums
    # replaced by identity (same local work per device, zero cross
    # -device reduction; results are per-shard partials and discarded).
    # Decomposes the same-work gap into collective cost vs shard_map
    # overhead. The two variants are timed INTERLEAVED (A,B,A,B,...) so
    # slow host-load drift hits both medians equally.
    step_nc = make_sharded_forward(cfg_m, mesh, backend=backend,
                                   elide_collectives=True)
    import jax.numpy as jnp

    jax.block_until_ready(step(origin, dirs, scene_p))  # warmup / compile
    jax.block_until_ready(step_nc(origin, dirs, scene_p))
    # 3 measurement repeats of the interleaved loop (same compiled
    # step; no recompiles): the per-repeat medians expose run-level
    # drift.
    REPEATS = 3
    times, times_nc, repeat_medians = [], [], []
    for rep in range(REPEATS):
        rep_times = []
        for i in range(args.iters):
            o_i = origin + jnp.float32(rep * args.iters + i) * 1e-6
            t0 = time.perf_counter()
            jax.block_until_ready(step(o_i, dirs, scene_p))
            rep_times.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            jax.block_until_ready(step_nc(o_i, dirs, scene_p))
            times_nc.append(time.perf_counter() - t0)
        times.extend(rep_times)
        repeat_medians.append(
            round(sorted(rep_times)[len(rep_times) // 2] * 1e3, 2))
    dtn = sorted(times)[len(times) // 2]
    dtn_nc = sorted(times_nc)[len(times_nc) // 2]

    eff = dt1 / (dtn * n_dev)
    tier = "_kernel" if backend.startswith("pallas") else ""
    _emit(f"rays_per_s_mesh_{ray_shards}x{prim_shards}{tier}",
          args.rays / dtn,
          {"step_ms": round(dtn * 1e3, 2),
           "spread_ms": _spread_ms(times),
           "repeat_medians_ms": repeat_medians,
           "one_dev_ms": round(dt1 * 1e3, 2),
           "one_dev_spread_ms": _spread_ms(times1),
           "scaling_efficiency_vs_1dev": round(eff, 4),
           "same_work_efficiency_vs_1dev": round(dt1 / dtn, 4),
           "same_work_efficiency_no_collectives": round(dt1 / dtn_nc, 4),
           "collective_cost_ms": round((dtn - dtn_nc) * 1e3, 2),
           "backend": backend,
           "platform": devs[0].platform})


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--rays", type=int, default=1_048_576)
    p.add_argument("--prims", type=int, default=4096)
    p.add_argument("--targets", type=int, default=4)
    p.add_argument("--bounces", type=int, default=4)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--mode", choices=["both", "fwd", "fwd_bwd"],
                   default="both")
    p.add_argument("--backend", choices=["auto", "jnp", "pallas"],
                   default="auto")
    p.add_argument("--dtype", choices=["float32", "bfloat16"],
                   default="float32")
    p.add_argument("--mesh", type=str, default=None,
                   help="RxP device mesh, e.g. 4x2 (reports scaling "
                        "efficiency vs 1 device)")
    p.add_argument("--pose-grads", dest="pose_grads", action="store_true",
                   help="also bench the pose-gradient backward")
    args = p.parse_args(argv)

    import jax

    from audio_raytracer_tpu.utils.compile_cache import enable_compile_cache

    if jax.devices()[0].platform != "gpu":
        print(f"bench.py measures a GPU; JAX found "
              f"{jax.devices()[0].platform}", file=sys.stderr)
        return 1
    enable_compile_cache()
    backend = "pallas" if args.backend == "auto" else args.backend

    cfg, scene, origin, dirs = build_inputs(args.rays, args.prims,
                                            args.targets, args.bounces,
                                            args.dtype)

    if backend != "jnp" and not args.mesh:
        _selfcheck(backend)
        if args.mode in ("both", "fwd_bwd") or args.pose_grads:
            # Backward lanes are gated like the forward: a silently
            # -broken compiled adjoint must not post records.
            _selfcheck_bwd(backend)
            if args.mode == "both" or args.pose_grads:
                _selfcheck_bwd(backend, pose_grads=True)

    if args.mesh:
        _bench_mesh(args, cfg, scene, origin, dirs, backend)
        return 0

    # The forward lanes measure FIRST, in fresh device state (the large
    # backward allocations can slow later forward timings); emission puts
    # auxiliary records first and the per-chip headline LAST.
    fwd_recs, bwd_recs = [], []
    # A crash in a late lane must not discard the already-measured
    # records: flush whatever was collected (aux first, headline last)
    # before re-raising.
    try:
        if args.mode in ("both", "fwd"):
            # Same measurement order as a standalone --mode fwd run.
            fwd_recs.append(_bench_fwd_reflife(args, cfg, scene, origin,
                                               dirs, backend))
            # Serving throughput at the reference's own ray budget (the
            # production pairing: reference maxRayLife 125 + pipelined
            # dispatch + unordered compaction).
            import dataclasses as _dc

            cfg_ref = _dc.replace(cfg, max_ray_life=125.0)
            fwd_recs.insert(0, _bench_fwd_pipelined(
                args, cfg_ref, scene, origin, dirs, backend,
                metric="rays_per_s_per_chip_fwd_reflife_pipelined",
                extra={"max_ray_life": 125.0}))
            fwd_recs.insert(1, _bench_fwd_pipelined(args, cfg, scene,
                                                    origin, dirs, backend))
            fwd_recs.append(_bench_fwd(args, cfg, scene, origin, dirs,
                                       backend))
            # Default (uncompacted) config, measured after the headline
            # lanes, emitted as an auxiliary record.
            fwd_recs.insert(len(fwd_recs) - 1, _bench_fwd_uncompacted(
                args, cfg, scene, origin, dirs, backend))
        if args.mode == "both" or args.pose_grads:
            bwd_recs.append(_bench_fwd_bwd(args, cfg, scene, origin, dirs,
                                           backend, pose_grads=True))
        if args.mode in ("both", "fwd_bwd"):
            bwd_recs.append(_bench_fwd_bwd(args, cfg, scene, origin, dirs,
                                           backend))
    finally:
        for rec in bwd_recs + fwd_recs:
            print(json.dumps(rec), flush=True)

    print(f"# {args.rays} rays x {args.prims} prims x {args.bounces + 1} "
          f"hits x {args.targets} targets | backend {backend} | "
          f"device {jax.devices()[0].device_kind}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
