"""The plain engine's chunked fold against its one-grid form.

DenseBackend folds the primitive axis in CHUNK-sized scan steps once a
scene has more than CHUNK primitives. Shrinking CHUNK makes a small
scene fold, so the fold and the one [R, P] grid run on the same input:
closest hit is a running (t, scan rank) min whose earlier rank wins
ties across chunk boundaries, occlusion a running OR, chord sums add.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from audio_raytracer_tpu.models.differentiable import (
    Loudness,
    SceneParams,
    loudness_loss,
)
from audio_raytracer_tpu.models.raytracer import random_scene
from audio_raytracer_tpu.ops import backend as B
from audio_raytracer_tpu.ops.fibonacci import fibonacci_directions
from audio_raytracer_tpu.types import Aabbs, Scene, Spheres, TraceConfig

R = 96


@pytest.fixture(scope="module")
def scene():
    return random_scene(jax.random.key(21), num_spheres=9, num_aabbs=13,
                        num_obbs=11, num_targets=2, extent=15.0,
                        size_range=(1.0, 4.0), target_owned_colliders=True)


def _engines(scene, monkeypatch):
    grid = B.DenseBackend(scene)
    monkeypatch.setattr(B, "CHUNK", 4)
    fold = B.DenseBackend(scene)
    assert fold.chunked and not grid.chunked
    return grid, fold


def _rays():
    return jnp.zeros((R, 3)) + 0.3, fibonacci_directions(R)


def test_closest_tie_straddling_chunk_boundary(monkeypatch):
    """Identical spheres at scan ranks 3 and 4 (the last slot of chunk 0
    and the first of chunk 1) plus an identical AABB face: the earliest
    rank wins, exactly as the grid's argmin."""
    c = [[0.0, 0.0, 5.0]] * 6
    spheres = Spheres.build(c, [1.0, 1.0, 1.0, 0.5, 0.5, 0.5],
                            active=[False, False, False, True, True, True])
    aabbs = Aabbs.build([[0.0, 0.0, 5.0]], [[0.5, 0.5, 0.5]])
    sc = Scene.build(spheres, aabbs, None, [[0.0, 9.0, 0.0]])
    grid, fold = _engines(sc, monkeypatch)
    o = jnp.zeros((8, 3))
    d = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), (8, 3))
    t_g, i_g = grid.local_closest(o, d)
    t_f, i_f = fold.local_closest(o, d)
    np.testing.assert_array_equal(np.asarray(i_g), 3)
    np.testing.assert_array_equal(np.asarray(i_f), np.asarray(i_g))
    np.testing.assert_array_equal(np.asarray(t_f), np.asarray(t_g))


@pytest.mark.parametrize("op", ["closest_hit", "occlusion", "chords"])
def test_fold_matches_grid(scene, monkeypatch, op):
    grid, fold = _engines(scene, monkeypatch)
    o, d = _rays()
    if op == "closest_hit":
        (h_g, t_g, a_g), (h_f, t_f, a_f) = (grid.closest_hit(o, d),
                                            fold.closest_hit(o, d))
        np.testing.assert_array_equal(np.asarray(h_f), np.asarray(h_g))
        m = np.asarray(h_g)
        np.testing.assert_allclose(np.asarray(t_f)[m], np.asarray(t_g)[m],
                                   rtol=1e-5, atol=1e-5)
        for k in ("kind", "absorption", "echo"):
            np.testing.assert_array_equal(np.asarray(a_f[k])[m],
                                          np.asarray(a_g[k])[m])
    elif op == "occlusion":
        dirs, limits = [d, -d], jnp.full((R, 2), 12.0)
        init = jnp.zeros((R, 2), bool).at[::4, 1].set(True)
        skips = (B.NO_SKIP, 0)
        np.testing.assert_array_equal(
            np.asarray(fold.multi_occluded(o, dirs, limits, skips, init)),
            np.asarray(grid.multi_occluded(o, dirs, limits, skips, init)))
        lim = jnp.full((R,), 12.0)
        np.testing.assert_array_equal(
            np.asarray(fold.occluded(o, d, lim, 1)),
            np.asarray(grid.occluded(o, d, lim, 1)))
    else:
        dirs = [d, -d]
        np.testing.assert_allclose(
            np.asarray(fold.multi_permeation_loss(o, dirs, (0, 1))),
            np.asarray(grid.multi_permeation_loss(o, dirs, (0, 1))),
            rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(
            np.asarray(fold.permeation_loss(o, d, None)),
            np.asarray(grid.permeation_loss(o, d, None)),
            rtol=1e-5, atol=1e-4)


def test_fold_gradients_match_grid(scene, monkeypatch):
    """Winner recompute (closest-hit tangents) and the rematerialised
    chord fold give the grid's gradients: materials and listener pose."""
    cfg = TraceConfig(ray_count=48, max_bounces=2, max_ray_life=200.0)
    origin, dirs = jnp.zeros(3), fibonacci_directions(48)
    params = SceneParams.from_scene(scene)
    target = Loudness(muffle=jnp.full((2,), 0.3),
                      permeation=jnp.full((2,), 0.2),
                      reverb_energy=jnp.asarray(0.05))

    def grads():
        return jax.grad(loudness_loss, argnums=(0, 2))(
            params, scene, origin, dirs, cfg, target)

    g_grid = grads()
    monkeypatch.setattr(B, "CHUNK", 4)
    g_fold = grads()
    assert sum(float(jnp.abs(x).sum()) for x in jax.tree.leaves(g_fold)) > 0
    for a, b in zip(jax.tree.leaves(g_grid), jax.tree.leaves(g_fold)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=2e-4,
                                   atol=2e-6)
