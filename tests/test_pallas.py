"""Pallas kernel parity: interpreter-mode kernels vs the dense jnp tier.

The kernels must reproduce the dense backend bit-for-decision: same
closest-hit winners (scan-order tie-breaks included), same occlusion
booleans, same chord sums — so the whole forward matches.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from audio_raytracer_tpu.models.raytracer import forward, random_scene
from audio_raytracer_tpu.ops.backend import DenseBackend
from audio_raytracer_tpu.ops.fibonacci import fibonacci_directions
from audio_raytracer_tpu.ops.pallas import PallasBackend
from audio_raytracer_tpu.types import Aabbs, Scene, Spheres, TraceConfig


@pytest.fixture(scope="module")
def scene():
    return random_scene(jax.random.key(21), num_spheres=9, num_aabbs=13,
                        num_obbs=11, num_targets=2, extent=15.0,
                        size_range=(1.0, 4.0), target_owned_colliders=True)


@pytest.fixture(scope="module")
def rays():
    dirs = fibonacci_directions(96)
    o = jnp.zeros((96, 3), jnp.float32)
    return o, dirs


class TestKernelParity:
    def test_closest_hit(self, scene, rays):
        o, d = rays
        dense = DenseBackend(scene)
        pal = PallasBackend(scene, interpret=True)

        hit_d, t_d, attrs_d = dense.closest_hit(o, d)
        hit_p, t_p, attrs_p = pal.closest_hit(o, d)

        np.testing.assert_array_equal(np.asarray(hit_d), np.asarray(hit_p))
        np.testing.assert_allclose(
            np.where(np.asarray(hit_d), np.asarray(t_d), 0.0),
            np.where(np.asarray(hit_p), np.asarray(t_p), 0.0),
            rtol=1e-5, atol=1e-5)
        for k in ("kind", "absorption", "echo"):
            np.testing.assert_allclose(
                np.where(np.asarray(hit_d), np.asarray(attrs_d[k]), 0),
                np.where(np.asarray(hit_p), np.asarray(attrs_p[k]), 0),
                rtol=1e-6, atol=1e-6, err_msg=k)

    def test_closest_hit_tie_break(self):
        # Identical overlapping primitives across types: the sphere
        # (lowest scan rank) must win in both backends.
        spheres = Spheres.build([[0, 0, 5]], [1.0])
        aabbs = Aabbs.build([[0, 0, 6], [0, 0, 6]], [[2, 2, 1], [2, 2, 1]])
        scene = Scene.build(spheres, aabbs, None, [[0, 9, 0]])
        o = jnp.zeros((8, 3))
        d = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), (8, 3))
        dense = DenseBackend(scene)
        pal = PallasBackend(scene, interpret=True)
        _, t_d, a_d = dense.closest_hit(o, d)
        _, t_p, a_p = pal.closest_hit(o, d)
        np.testing.assert_allclose(np.asarray(t_d), np.asarray(t_p),
                                   rtol=1e-6)
        np.testing.assert_array_equal(np.asarray(a_d["kind"]),
                                      np.asarray(a_p["kind"]))

    def test_occlusion(self, scene, rays):
        o, d = rays
        dense = DenseBackend(scene)
        pal = PallasBackend(scene, interpret=True)
        limit = jnp.full((96,), 20.0)
        for skip in (None, 0, 1):
            occ_d = dense.occluded(o, d, limit, skip_target_id=skip)
            occ_p = pal.occluded(o, d, limit, skip_target_id=skip)
            np.testing.assert_array_equal(np.asarray(occ_d),
                                          np.asarray(occ_p),
                                          err_msg=f"skip={skip}")

    def test_chord_loss(self, scene, rays):
        o, d = rays
        dense = DenseBackend(scene)
        pal = PallasBackend(scene, interpret=True)
        for skip in (0, 1):
            l_d = dense.permeation_loss(o, d, skip_target_id=skip)
            l_p = pal.permeation_loss(o, d, skip_target_id=skip)
            np.testing.assert_allclose(np.asarray(l_d), np.asarray(l_p),
                                       rtol=1e-5, atol=1e-4,
                                       err_msg=f"skip={skip}")

    def test_single_type_scenes(self):
        # Each primitive type alone (others empty) exercises the
        # phase-skipping paths.
        o = jnp.zeros((16, 3))
        d = fibonacci_directions(16)
        for kind in ("s", "a", "o"):
            sc = random_scene(jax.random.key(5),
                              num_spheres=6 if kind == "s" else 0,
                              num_aabbs=6 if kind == "a" else 0,
                              num_obbs=6 if kind == "o" else 0,
                              num_targets=1, extent=10.0)
            dense = DenseBackend(sc)
            pal = PallasBackend(sc, interpret=True)
            _, t_d, _ = dense.closest_hit(o, d)
            _, t_p, _ = pal.closest_hit(o, d)
            np.testing.assert_allclose(
                np.nan_to_num(np.asarray(t_d), posinf=-1),
                np.nan_to_num(np.asarray(t_p), posinf=-1),
                rtol=1e-5, err_msg=kind)


class TestFusedKernels:
    """The fused multi-ray-set kernels (ops.pallas.fused) vs the composed
    dense per-set tests: identical occlusion decisions and chord sums."""

    def _sets(self, scene, rays):
        o, d = rays
        R = o.shape[0]
        origin_pt = jnp.asarray([1.0, 2.0, 0.5])
        # Ray sets from a bounce-like offset point: one echo + per-target.
        off = o + d * 3.0
        from audio_raytracer_tpu.ops import intersect
        from audio_raytracer_tpu.ops.backend import NO_SKIP

        dirs = [intersect.safe_normalize(origin_pt - off)]
        limits = [intersect.safe_norm(origin_pt - off)]
        skips = [NO_SKIP]
        for t in range(scene.num_targets):
            to_t = scene.target_positions[t] - off
            dist = intersect.safe_norm(to_t)
            dirs.append(to_t / dist[..., None])
            limits.append(dist)
            skips.append(t)
        return off, dirs, jnp.stack(limits, -1), tuple(skips)

    def test_multi_any_hit(self, scene, rays):
        off, dirs, limits, skips = self._sets(scene, rays)
        R, S = limits.shape
        dense = DenseBackend(scene)
        pal = PallasBackend(scene, interpret=True)
        init = jnp.zeros((R, S), bool)
        occ_d = dense.multi_occluded(off, dirs, limits, skips, init)
        occ_p = pal.multi_occluded(off, dirs, limits, skips, init)
        np.testing.assert_array_equal(np.asarray(occ_d), np.asarray(occ_p))
        # Pre-resolved lanes must come back occluded in both tiers.
        init2 = jnp.zeros((R, S), bool).at[::3, 0].set(True)
        occ_d2 = dense.multi_occluded(off, dirs, limits, skips, init2)
        occ_p2 = pal.multi_occluded(off, dirs, limits, skips, init2)
        np.testing.assert_array_equal(np.asarray(occ_d2), np.asarray(occ_p2))
        assert bool(jnp.all(occ_p2[::3, 0]))

    def test_multi_any_hit_block_skip(self, scene, rays):
        # A fully pre-resolved block returns init bits untouched.
        off, dirs, limits, skips = self._sets(scene, rays)
        R, S = limits.shape
        init = jnp.ones((R, S), bool)
        pal = PallasBackend(scene, interpret=True)
        occ = pal.multi_occluded(off, dirs, limits, skips, init)
        np.testing.assert_array_equal(np.asarray(occ), np.ones((R, S), bool))

    def test_multi_chord(self, scene, rays):
        off, dirs, _, _ = self._sets(scene, rays)
        skips = tuple(range(scene.num_targets))
        dirs = dirs[1:]  # target sets only, like ops.permeation
        dense = DenseBackend(scene)
        pal = PallasBackend(scene, interpret=True)
        l_d = dense.multi_permeation_loss(off, dirs, skips)
        l_p = pal.multi_permeation_loss(off, dirs, skips)
        np.testing.assert_allclose(np.asarray(l_d), np.asarray(l_p),
                                   rtol=1e-5, atol=1e-4)

    def test_multi_chord_bwd_matches_dense_ad(self, scene, rays):
        """Chord kernel's custom VJP vs jax.grad through the jnp tier."""
        off, dirs, _, _ = self._sets(scene, rays)
        skips = tuple(range(scene.num_targets))
        dirs = tuple(dirs[1:])
        key = jax.random.key(3)
        gbar = jax.random.normal(key, (off.shape[0], len(dirs)))

        def dense_sum(o, ds, dens_s, dens_a, dens_o):
            import dataclasses as dc
            sc = scene.replace(
                spheres=dc.replace(
                    scene.spheres,
                    material=dc.replace(scene.spheres.material,
                                        density=dens_s)),
                aabbs=dc.replace(
                    scene.aabbs,
                    material=dc.replace(scene.aabbs.material,
                                        density=dens_a)),
                obbs=dc.replace(
                    scene.obbs,
                    material=dc.replace(scene.obbs.material,
                                        density=dens_o)))
            loss = DenseBackend(sc).multi_permeation_loss(o, list(ds), skips)
            return jnp.sum(loss * gbar)

        def pallas_sum(o, ds, dens_s, dens_a, dens_o):
            import dataclasses as dc
            sc = scene.replace(
                spheres=dc.replace(
                    scene.spheres,
                    material=dc.replace(scene.spheres.material,
                                        density=dens_s)),
                aabbs=dc.replace(
                    scene.aabbs,
                    material=dc.replace(scene.aabbs.material,
                                        density=dens_a)),
                obbs=dc.replace(
                    scene.obbs,
                    material=dc.replace(scene.obbs.material,
                                        density=dens_o)))
            be = PallasBackend(sc, interpret=True, differentiable=True)
            loss = be.multi_permeation_loss(o, list(ds), skips)
            return jnp.sum(loss * gbar)

        args = (off, dirs, scene.spheres.material.density,
                scene.aabbs.material.density, scene.obbs.material.density)
        g_d = jax.grad(dense_sum, argnums=(0, 1, 2, 3, 4))(*args)
        g_p = jax.grad(pallas_sum, argnums=(0, 1, 2, 3, 4))(*args)
        for a, b in zip(jax.tree.leaves(g_d), jax.tree.leaves(g_p)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=2e-4, atol=2e-5)


class TestForwardParity:
    def test_full_forward_matches_dense(self, scene):
        cfg = TraceConfig(ray_count=64, max_bounces=3, max_ray_life=150.0,
                          num_accum_batches=2)
        origin = jnp.zeros(3)
        dirs = fibonacci_directions(64)
        r_d, s_d = forward(origin, dirs, scene, cfg, collect_debug=True,
                           backend="jnp")
        r_p, s_p = forward(origin, dirs, scene, cfg, collect_debug=True,
                           backend="pallas_interpret")

        np.testing.assert_array_equal(np.asarray(r_d.hit_counts),
                                      np.asarray(r_p.hit_counts))
        np.testing.assert_allclose(np.asarray(r_d.echo_distances),
                                   np.asarray(r_p.echo_distances),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(np.asarray(r_d.muffle_hits),
                                      np.asarray(r_p.muffle_hits))
        np.testing.assert_allclose(np.asarray(r_d.permeation),
                                   np.asarray(r_p.permeation),
                                   rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(np.asarray(s_d.muffle),
                                   np.asarray(s_p.muffle), rtol=1e-5,
                                   atol=1e-6)


class TestRayCompaction:
    """cfg.compact_rays: alive-first reorder + dead-block skip must be
    invisible in the results (ops/trace.alive_partition; the reference's
    per-ray early exit analog, AudioRaytracerJobBatched.cs:104)."""

    def test_alive_partition_is_stable_inverse_pair(self):
        alive = jnp.asarray(
            [True, False, True, True, False, False, True, False])
        order, pos = __import__(
            "audio_raytracer_tpu.ops.trace", fromlist=["x"]
        ).alive_partition(alive)
        x = jnp.arange(8)
        packed = x[order]
        # Alive lanes first, both groups in original relative order.
        np.testing.assert_array_equal(np.asarray(packed),
                                      [0, 2, 3, 6, 1, 4, 5, 7])
        # pos inverts order: y[pos] undoes y -> y[order].
        np.testing.assert_array_equal(np.asarray(packed[pos]), np.asarray(x))

    def test_compacted_forward_identical_to_uncompacted(self, scene):
        """The reorder must be INVISIBLE: bit-identical results on the
        same kernel tier with and without compact_rays (each ray's math
        is per-lane; outputs are un-permuted before leaving the scan).
        Short ray life so lanes actually die and the reorder engages."""
        import dataclasses

        cfg = TraceConfig(ray_count=256, max_bounces=3, max_ray_life=40.0,
                          num_accum_batches=4, compact_rays=False)
        cfg_c = dataclasses.replace(cfg, compact_rays=True)
        origin = jnp.zeros(3)
        dirs = fibonacci_directions(256)
        r_p, s_p = forward(origin, dirs, scene, cfg, collect_debug=True,
                           backend="pallas_interpret")
        r_c, s_c = forward(origin, dirs, scene, cfg_c, collect_debug=True,
                           backend="pallas_interpret")
        # Ints exactly; floats to a few ulp (XLA fuses the surrounding
        # elementwise ops differently in the two programs — the
        # compacted one also unrolls bounce 0 out of the scan to elide
        # its identity reorder — so per-lane rounding can differ by a
        # couple of ulp even though the trace logic is identical).
        np.testing.assert_array_equal(np.asarray(r_p.muffle_hits),
                                      np.asarray(r_c.muffle_hits))
        np.testing.assert_array_equal(np.asarray(r_p.hit_counts),
                                      np.asarray(r_c.hit_counts))
        for a, b in [(r_p.echo_distances, r_c.echo_distances),
                     (r_p.first_hit_t, r_c.first_hit_t),
                     (s_p.muffle, s_c.muffle)]:
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-5, atol=1e-6)

    def test_unordered_tier_invariants(self, scene):
        """cfg.compact_unordered skips the per-bounce restore: echo rows
        are permuted WITHIN each bounce column, but every reduction the
        pipeline consumes must be bit-identical to the ordered tier —
        muffle_hits, per-column echo sums and zero counts, first_hit_t
        (bounce 0's partition is the identity), and the final settings."""
        import dataclasses

        cfg = TraceConfig(ray_count=256, max_bounces=3, max_ray_life=40.0,
                          num_accum_batches=4, compact_rays=True)
        cfg_u = dataclasses.replace(cfg, compact_unordered=True)
        origin = jnp.zeros(3)
        dirs = fibonacci_directions(256)
        r_o, s_o = forward(origin, dirs, scene, cfg,
                           backend="pallas_interpret")
        r_u, s_u = forward(origin, dirs, scene, cfg_u,
                           backend="pallas_interpret")
        np.testing.assert_array_equal(np.asarray(r_o.muffle_hits),
                                      np.asarray(r_u.muffle_hits))
        np.testing.assert_allclose(np.asarray(r_o.first_hit_t),
                                   np.asarray(r_u.first_hit_t),
                                   rtol=1e-6, atol=1e-6)
        # Column-wise (per bounce slot) permutation invariants.
        e_o = np.asarray(r_o.echo_distances, np.float64)
        e_u = np.asarray(r_u.echo_distances, np.float64)
        np.testing.assert_allclose(e_o.sum(axis=0), e_u.sum(axis=0),
                                   rtol=1e-6, atol=1e-4)
        np.testing.assert_array_equal((e_o == 0).sum(axis=0),
                                      (e_u == 0).sum(axis=0))
        # Each column is literally a permutation of the ordered column.
        for h in range(e_o.shape[1]):
            np.testing.assert_allclose(np.sort(e_o[:, h]),
                                       np.sort(e_u[:, h]),
                                       rtol=1e-6, atol=1e-6)
        for a, b in [(s_o.muffle, s_u.muffle),
                     (s_o.reverb_strength, s_u.reverb_strength),
                     (s_o.reverb_volume, s_u.reverb_volume)]:
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-6, atol=1e-6)
        # collect_debug needs ordered rows: the flag must yield to it.
        r_dbg, _ = forward(origin, dirs, scene, cfg_u, collect_debug=True,
                           backend="pallas_interpret")
        r_ref, _ = forward(origin, dirs, scene, cfg, collect_debug=True,
                           backend="pallas_interpret")
        np.testing.assert_array_equal(np.asarray(r_dbg.hit_counts),
                                      np.asarray(r_ref.hit_counts))

    def test_compacted_forward_matches_dense_settings(self, scene):
        """Aggregate parity vs the dense tier with compaction on (a few
        razor's-edge life crossings may flip per-lane booleans between
        the kernels' formulas and the jnp grid's; the per-target
        settings stay within a few lanes' worth)."""
        cfg = TraceConfig(ray_count=256, max_bounces=3, max_ray_life=60.0,
                          num_accum_batches=4, compact_rays=True)
        origin = jnp.zeros(3)
        dirs = fibonacci_directions(256)
        _, s_d = forward(origin, dirs, scene, cfg, backend="jnp")
        _, s_p = forward(origin, dirs, scene, cfg,
                         backend="pallas_interpret")
        np.testing.assert_allclose(np.asarray(s_d.muffle),
                                   np.asarray(s_p.muffle), rtol=1e-4,
                                   atol=5e-3)


class TestChunkedBackend:
    """Scenes far beyond one primitive chunk: the kernels read every
    primitive from device memory (no per-call cap), and the plain engine
    they are checked against folds the primitive axis in chunks (the
    reference registry grows without limit, AudioColliderManager.cs:42-62)."""

    def _big_scene(self):
        # ~36K mixed primitives.
        return random_scene(jax.random.key(11), num_spheres=12_000,
                            num_aabbs=12_000, num_obbs=12_000,
                            num_targets=2, extent=120.0,
                            size_range=(0.5, 3.0))

    def test_chunked_matches_dense_closest_and_occlusion(self):
        from audio_raytracer_tpu.ops.backend import NO_SKIP, DenseBackend

        big = self._big_scene()
        R = 128
        o = jnp.zeros((R, 3)) + jnp.asarray([0.3, -0.2, 0.4])
        d = fibonacci_directions(R)
        be = PallasBackend(big, interpret=True)
        dense = DenseBackend(big)
        assert dense.chunked

        hit, t, attrs = be.closest_hit(o, d)
        hit_d, t_d, attrs_d = dense.closest_hit(o, d)
        np.testing.assert_array_equal(np.asarray(hit), np.asarray(hit_d))
        m = np.asarray(hit)
        np.testing.assert_allclose(np.asarray(t)[m], np.asarray(t_d)[m],
                                   rtol=1e-5, atol=1e-4)
        # Winner attrs (scan-rank tie-break across the whole scene).
        np.testing.assert_allclose(np.asarray(attrs["echo"])[m],
                                   np.asarray(attrs_d["echo"])[m],
                                   rtol=1e-6, atol=1e-6)

        dirs = [d, -d]
        limits = jnp.full((R, 2), 60.0)
        init = jnp.zeros((R, 2), bool)
        occ = be.multi_occluded(o, dirs, limits, (NO_SKIP, 0), init)
        occ_d = dense.multi_occluded(o, dirs, limits, (NO_SKIP, 0), init)
        assert (np.asarray(occ) == np.asarray(occ_d)).mean() > 0.999

        loss = be.multi_permeation_loss(o, dirs, (0, 1))
        loss_d = dense.multi_permeation_loss(o, dirs, (0, 1))
        # Sums over ~hundreds of chords at 36K prims: f32 association
        # differences (sequential kernel sum vs per-chunk sums).
        np.testing.assert_allclose(np.asarray(loss), np.asarray(loss_d),
                                   rtol=5e-3, atol=5e-2)

    def test_chunked_full_forward_and_gradients(self):
        from audio_raytracer_tpu.models.differentiable import (
            Loudness,
            SceneParams,
            loudness_loss,
        )
        big = self._big_scene()
        cfg = TraceConfig(ray_count=64, max_bounces=2, max_ray_life=200.0,
                          num_accum_batches=2)
        origin = jnp.zeros(3)
        dirs = fibonacci_directions(64)
        _, s_d = forward(origin, dirs, big, cfg, backend="jnp")
        _, s_p = forward(origin, dirs, big, cfg,
                         backend="pallas_interpret")
        np.testing.assert_allclose(np.asarray(s_d.muffle),
                                   np.asarray(s_p.muffle), rtol=1e-4,
                                   atol=5e-3)

        params = SceneParams.from_scene(big)
        target = Loudness(muffle=jnp.full((2,), 0.3),
                          permeation=jnp.full((2,), 0.2),
                          reverb_energy=jnp.asarray(0.05))

        def backend_fn(s):
            return PallasBackend(s, interpret=True,
                                 differentiable=True)

        g = jax.grad(loudness_loss)(params, big, origin, dirs, cfg,
                                    target, backend_fn=backend_fn)
        leaves = jax.tree.leaves(g)
        assert leaves and all(np.isfinite(np.asarray(x)).all()
                              for x in leaves)
        assert any(float(jnp.abs(x).sum()) > 0 for x in leaves)


def test_chunked_bf16_tier_composes():
    """compute_dtype reaches the kernels on a scene of many chunks (bf16
    forward runs; accuracy per the documented bf16 contract)."""
    big = random_scene(jax.random.key(12), num_spheres=6_000,
                       num_aabbs=9_000, num_obbs=6_000, num_targets=2,
                       extent=120.0, size_range=(1.0, 4.0))
    be = PallasBackend(big, interpret=True, compute_dtype=jnp.bfloat16)
    R = 64
    o = jnp.zeros((R, 3)) + 0.1
    d = fibonacci_directions(R)
    hit, t, attrs = be.closest_hit(o, d)
    assert np.asarray(hit).any()
    assert np.isfinite(np.asarray(t)[np.asarray(hit)]).all()


# Ray counts off the BLOCK_R grid; primitive counts that are not powers
# of two, with empty types.
_SHAPES = [(200, (3, 5, 7)), (129, (0, 11, 0)), (61, (6, 0, 9))]


@pytest.mark.parametrize("shape", _SHAPES, ids=lambda s: f"R{s[0]}")
@pytest.mark.parametrize("kernel", ["closest_hit", "occlusion", "chords"])
def test_kernel_shapes_match_plain(kernel, shape):
    """Each kernel's wrapper pads rays to whole blocks and passes the
    primitive tables whole: results equal DenseBackend lane for lane."""
    from audio_raytracer_tpu.ops import intersect
    from audio_raytracer_tpu.ops.backend import NO_SKIP, DenseBackend
    from audio_raytracer_tpu.ops.pallas import kernels as K

    R, (ns, na, no) = shape
    assert R % K.BLOCK_R
    sc = random_scene(jax.random.key(R), num_spheres=ns, num_aabbs=na,
                      num_obbs=no, num_targets=2, extent=10.0,
                      size_range=(1.0, 3.0), target_owned_colliders=True)
    o = jax.random.uniform(jax.random.key(1), (R, 3), minval=-2.0,
                           maxval=2.0)
    d = fibonacci_directions(R)
    pal, dense = PallasBackend(sc, interpret=True), DenseBackend(sc)
    if kernel == "closest_hit":
        t, idx = pal.local_closest(o, d)
        t_d, idx_d = dense.local_closest(o, d)
        hit = np.isfinite(np.asarray(t_d))
        np.testing.assert_array_equal(np.isfinite(np.asarray(t)), hit)
        np.testing.assert_array_equal(np.asarray(idx)[hit],
                                      np.asarray(idx_d)[hit])
        np.testing.assert_allclose(np.asarray(t)[hit],
                                   np.asarray(t_d)[hit], rtol=1e-5,
                                   atol=1e-5)
        return
    targets = [sc.target_positions[i] for i in range(2)]
    dirs = [intersect.safe_normalize(p - o) for p in targets]
    if kernel == "occlusion":
        dirs = [-d] + dirs
        limits = jnp.stack([jnp.full((R,), 8.0)]
                           + [intersect.safe_norm(p - o) for p in targets],
                           -1)
        skips = (NO_SKIP, 0, 1)
        init = jnp.zeros((R, 3), bool).at[::5, 1].set(True)
        np.testing.assert_array_equal(
            np.asarray(pal.multi_occluded(o, dirs, limits, skips, init)),
            np.asarray(dense.multi_occluded(o, dirs, limits, skips, init)))
    else:
        np.testing.assert_allclose(
            np.asarray(pal.multi_permeation_loss(o, dirs, (0, 1))),
            np.asarray(dense.multi_permeation_loss(o, dirs, (0, 1))),
            rtol=1e-5, atol=1e-4)
