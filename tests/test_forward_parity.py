"""End-to-end forward parity: jitted JAX pipeline vs the NumPy oracle.

These are the allclose gates from BASELINE.md: intersections, echo
accumulation, muffle counts, permeation-attenuated loudness, reverb
energy — on random mixed scenes and on the enumerated BASELINE configs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from audio_raytracer_tpu.models.raytracer import forward, random_scene
from audio_raytracer_tpu.ops.fibonacci import fibonacci_directions
from audio_raytracer_tpu.types import TraceConfig
from audio_raytracer_tpu.utils import oracle


def run_both(scene, cfg, seed=0):
    origin = jnp.zeros((3,), jnp.float32)
    dirs = fibonacci_directions(cfg.ray_count)
    result, settings = jax.jit(
        lambda o, d, s: forward(o, d, s, cfg, collect_debug=True)
    )(origin, dirs, scene)

    osc = oracle.from_scene(scene)
    otr = oracle.oracle_trace(
        osc, np.zeros(3), np.asarray(dirs), cfg.max_hits_per_ray,
        cfg.max_ray_life, cfg.max_muffle_hit_distance,
        cfg.num_accum_batches)
    operm = oracle.oracle_permeation(
        osc, np.zeros(3), np.asarray(dirs), cfg.permeation_strength_per_ray,
        cfg.num_accum_batches)
    oproc = oracle.oracle_process(
        otr["echo"], otr["muffle_hits"], operm, osc.target_positions,
        cfg.ray_count, cfg.max_hits_per_ray, cfg.muffle_effectiveness,
        cfg.permeation_strength_per_ray, cfg.permeation_effectiveness,
        cfg.max_reverb_distance)
    return result, settings, otr, operm, oproc


def assert_parity(result, settings, otr, operm, oproc, echo_rtol=1e-4):
    echo = np.asarray(result.echo_distances, np.float64)
    # Bounce trajectories can diverge on razor-edge hits in f32 vs f64;
    # demand near-total agreement rather than bitwise equality.
    match = np.isclose(echo, otr["echo"], rtol=echo_rtol, atol=1e-3)
    assert match.mean() > 0.995, f"echo mismatch rate {1 - match.mean():.4f}"

    # f32 kernel vs f64 oracle: razor-edge hits may diverge a ray's whole
    # trajectory; demand near-total agreement on bounce counts.
    hc_match = (np.asarray(result.hit_counts) == otr["hit_counts"])
    assert hc_match.mean() > 0.99, f"hit_count mismatch {1 - hc_match.mean():.4f}"

    muffle = np.asarray(result.muffle_hits)
    assert np.abs(muffle - otr["muffle_hits"]).sum() <= max(
        1, 0.002 * muffle.sum())

    perm = np.asarray(result.permeation, np.float64)
    np.testing.assert_allclose(perm, operm, rtol=1e-4, atol=1e-2)

    np.testing.assert_allclose(np.asarray(settings.muffle),
                               oproc["muffle"], rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(float(settings.reverb_strength),
                               oproc["reverb_strength"], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(float(settings.reverb_volume),
                               oproc["reverb_volume"], rtol=1e-3, atol=1e-4)


class TestForwardParity:
    def test_spheres_only_direct_path(self):
        # BASELINE config 1 (shrunk): sphere scene, single target, 1 bounce.
        cfg = TraceConfig(ray_count=256, max_bounces=0, max_ray_life=200.0,
                          max_muffle_hit_distance=250.0)
        scene = random_scene(jax.random.key(1), num_spheres=16, num_aabbs=0,
                             num_obbs=0, num_targets=1)
        assert_parity(*run_both(scene, cfg))

    def test_mixed_scene_multibounce(self):
        # BASELINE config 2/3 (shrunk): mixed primitives, 4 bounces.
        cfg = TraceConfig(ray_count=128, max_bounces=4, max_ray_life=150.0)
        scene = random_scene(jax.random.key(2), num_spheres=6, num_aabbs=10,
                             num_obbs=8, num_targets=2)
        assert_parity(*run_both(scene, cfg))

    def test_multi_batch_accumulators(self):
        # Exercise the per-thread-batch accumulator rows + permeation
        # overwrite quirk with 4 accumulation batches.
        cfg = TraceConfig(ray_count=100, max_bounces=2, max_ray_life=150.0,
                          num_accum_batches=4)
        scene = random_scene(jax.random.key(3), num_spheres=5, num_aabbs=7,
                             num_obbs=5, num_targets=3)
        assert_parity(*run_both(scene, cfg))

    def test_target_owned_colliders_skipped(self):
        cfg = TraceConfig(ray_count=64, max_bounces=2, max_ray_life=150.0)
        scene = random_scene(jax.random.key(4), num_spheres=4, num_aabbs=6,
                             num_obbs=4, num_targets=2,
                             target_owned_colliders=True)
        assert_parity(*run_both(scene, cfg))

    def test_absorption_drains_life(self):
        # High absorption should terminate rays early; parity on hit counts
        # verifies the life-drain bounce-termination path.
        import dataclasses
        cfg = TraceConfig(ray_count=64, max_bounces=6, max_ray_life=100.0)
        scene = random_scene(jax.random.key(5), num_spheres=4, num_aabbs=8,
                             num_obbs=4, num_targets=1)
        # Crank absorption up.
        new_mats = dataclasses.replace(
            scene.aabbs.material,
            absorption=jnp.full_like(scene.aabbs.material.absorption, 0.45))
        scene = scene.replace(aabbs=dataclasses.replace(
            scene.aabbs, material=new_mats))
        result, settings, otr, operm, oproc = run_both(scene, cfg)
        assert int(np.asarray(result.hit_counts).max()) < cfg.max_hits_per_ray
        assert_parity(result, settings, otr, operm, oproc)

    def test_empty_scene(self):
        cfg = TraceConfig(ray_count=32, max_bounces=2)
        scene = random_scene(jax.random.key(6), num_spheres=0, num_aabbs=0,
                             num_obbs=0, num_targets=1)
        result, settings, otr, operm, oproc = run_both(scene, cfg)
        assert np.asarray(result.echo_distances).sum() == 0
        assert np.asarray(result.hit_counts).sum() == 0
        assert_parity(result, settings, otr, operm, oproc)


class TestFixedSeedExactRegression:
    """Exact-count pin on one committed scene.

    The statistical parity gates above admit up to 0.5% echo mismatch
    (razor-edge f32-vs-f64 trajectory divergence vs the oracle); this
    pin freezes one fixed seed's exact integer outputs so silent drift
    INSIDE that tolerance band — a changed tie-break, an epsilon tweak,
    a reordered reduction — fails loudly. Each engine is pinned with its
    OWN recorded values (the kernels' formulas differ from the jnp grid's
    — sign-domain sphere occlusion, baked rotation matrices — so razor
    -edge lanes may flip between engines; on this seed they agree).
    """

    # [batch, target] counts / nonzero entries / rays-by-bounce-count.
    PINS = {
        "jnp": ([[42, 58], [26, 25]], 88, [176, 57, 16, 4, 0, 3]),
        "pallas_interpret": ([[42, 58], [26, 25]], 88,
                             [176, 57, 16, 4, 0, 3]),
    }

    def _check(self, backend):
        cfg = TraceConfig(ray_count=256, max_bounces=4, max_ray_life=150.0,
                          num_accum_batches=2)
        scene = random_scene(jax.random.key(7), num_spheres=8, num_aabbs=16,
                             num_obbs=8, num_targets=2, extent=18.0,
                             size_range=(1.0, 4.0))
        result, _ = jax.jit(
            lambda o, d, s: forward(o, d, s, cfg, backend=backend,
                                    collect_debug=True))(
            jnp.zeros(3), fibonacci_directions(256), scene)
        muffle_hits, echo_nonzero, hist = self.PINS[backend]
        np.testing.assert_array_equal(
            np.asarray(result.muffle_hits).astype(int),
            np.asarray(muffle_hits))
        assert int((np.asarray(result.echo_distances) != 0).sum()) \
            == echo_nonzero
        np.testing.assert_array_equal(
            np.bincount(np.asarray(result.hit_counts), minlength=6),
            np.asarray(hist))

    def test_jnp_engine_pinned(self):
        self._check("jnp")

    def test_kernel_tier_pinned(self):
        self._check("pallas_interpret")


class TestFibonacci:
    def test_unit_norm_interior(self):
        d = np.asarray(fibonacci_directions(500))
        norms = np.linalg.norm(d, axis=-1)
        np.testing.assert_allclose(norms, 1.0, atol=1e-5)

    def test_poles(self):
        d = np.asarray(fibonacci_directions(100))
        np.testing.assert_allclose(d[0], [0, 1, 0], atol=1e-6)
        np.testing.assert_allclose(d[-1], [0, -1, 0], atol=1e-6)

    def test_reference_formula(self):
        n = 37
        d = np.asarray(fibonacci_directions(n), np.float64)
        phi = np.pi * (3 - np.sqrt(5))
        for i in [0, 5, 17, 36]:
            y = 1 - (i / (n - 1)) * 2
            r = np.sqrt(max(1 - y * y, 0))
            expect = [np.cos(phi * i) * r, y, np.sin(phi * i) * r]
            np.testing.assert_allclose(d[i], expect, atol=1e-5)

    def test_uniformity(self):
        # Mean direction of a uniform sphere sampling ~ 0.
        d = np.asarray(fibonacci_directions(2000))
        assert np.abs(d.mean(axis=0)).max() < 0.01


class TestEightSources:
    """BASELINE config 5 names 8 sources: the target axis must scale —
    8 muffle ray sets fused into the per-bounce stream, 8-column
    accumulators, 8 per-target settings."""

    def test_eight_targets_forward_parity(self):
        from audio_raytracer_tpu.models.raytracer import (
            forward,
            random_scene,
        )
        from audio_raytracer_tpu.ops.fibonacci import fibonacci_directions
        from audio_raytracer_tpu.types import TraceConfig

        scene = random_scene(jax.random.key(21), num_spheres=8,
                             num_aabbs=16, num_obbs=8, num_targets=8)
        cfg = TraceConfig(ray_count=128, max_bounces=3, max_ray_life=150.0,
                          num_accum_batches=2)
        origin = jnp.zeros(3)
        dirs = fibonacci_directions(128)
        r_d, s_d = forward(origin, dirs, scene, cfg, backend="jnp")
        r_p, s_p = forward(origin, dirs, scene, cfg,
                           backend="pallas_interpret")
        assert s_d.muffle.shape == (8,)
        np.testing.assert_array_equal(np.asarray(r_d.muffle_hits),
                                      np.asarray(r_p.muffle_hits))
        np.testing.assert_allclose(np.asarray(s_d.muffle),
                                   np.asarray(s_p.muffle), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(np.asarray(r_d.permeation),
                                   np.asarray(r_p.permeation),
                                   rtol=1e-5, atol=1e-3)


def test_max_bounce_depth_26_hits():
    """The reference's inspector-capped workload: 26 hits/ray
    (Audio/AudioRayTracer.cs:11-15). The fixed-depth masked scan and the
    kernel tier must stay stable and in parity at that depth."""
    from audio_raytracer_tpu.models.raytracer import forward, random_scene
    from audio_raytracer_tpu.ops.fibonacci import fibonacci_directions
    from audio_raytracer_tpu.types import TraceConfig

    scene = random_scene(jax.random.key(3), num_spheres=4, num_aabbs=10,
                         num_obbs=4, num_targets=2)
    cfg = TraceConfig(ray_count=64, max_bounces=25, max_ray_life=500.0,
                      num_accum_batches=2)
    assert cfg.max_hits_per_ray == 26
    origin = jnp.zeros(3)
    dirs = fibonacci_directions(64)
    r_d, s_d = forward(origin, dirs, scene, cfg, backend="jnp")
    r_p, s_p = forward(origin, dirs, scene, cfg,
                       backend="pallas_interpret")
    assert r_d.echo_distances.shape == (64, 26)
    assert np.isfinite(np.asarray(s_d.muffle)).all()
    np.testing.assert_array_equal(np.asarray(r_d.muffle_hits),
                                  np.asarray(r_p.muffle_hits))
    np.testing.assert_allclose(np.asarray(s_d.muffle),
                               np.asarray(s_p.muffle), rtol=1e-4,
                               atol=1e-4)


def test_accum_batch_ids_reference_formula():
    """accum_batch_ids must reproduce the reference's thread-batch
    mapping exactly: batchSize = ceil(rayCount / threads), batchId =
    rayStartIndex * batchCount / rayCount with integer math
    (Audio/AudioRayTracer.cs:161, AudioRaytracerJobBatched.cs:63-64) —
    including non-dividing ray counts."""
    from audio_raytracer_tpu.ops.trace import accum_batch_ids

    for R, B in [(130, 2), (100, 3), (7, 4), (512, 8), (33, 5)]:
        got = np.asarray(accum_batch_ids(R, B))
        batch_size = -(-R // B)
        want = np.array([((r // batch_size) * batch_size) * B // R
                         for r in range(R)])
        np.testing.assert_array_equal(got, want, err_msg=f"R={R} B={B}")
        # Ids stay in range even when ceil-batching leaves trailing
        # batches empty.
        assert got.min() >= 0 and got.max() < B
