"""Hardware lane: compiled Triton-route kernels on an NVIDIA GPU.

Run with ``ART_GPU_TESTS=1 python -m pytest -m gpu -q`` (chip_smoke.py
runs it as its last phase). Everything here executes the COMPILED Pallas
path (interpret=False) — the thing that actually ships — so a kernel
that misbehaves only when Triton compiles it fails this lane even though
the CPU interpret suite stays green: kernel parity vs DenseBackend on
the device, a sharded step on one card, the orchestrator tick, and the
bf16 tier's lowering. Without a GPU every test here skips.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from audio_raytracer_tpu.models.raytracer import forward, random_scene
from audio_raytracer_tpu.ops.backend import NO_SKIP, DenseBackend
from audio_raytracer_tpu.ops.fibonacci import fibonacci_directions
from audio_raytracer_tpu.ops.pallas import PallasBackend
from audio_raytracer_tpu.types import TraceConfig

pytestmark = pytest.mark.gpu

R = 8192
P = 128


@pytest.fixture(scope="module", autouse=True)
def _require_gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run with ART_GPU_TESTS=1 -m gpu)")


@pytest.fixture(scope="module")
def scene():
    return random_scene(jax.random.key(3), num_spheres=P // 4,
                        num_aabbs=P // 2, num_obbs=P // 4, num_targets=3,
                        extent=40.0, size_range=(0.5, 4.0))


@pytest.fixture(scope="module")
def rays():
    o = jnp.zeros((R, 3)) + jnp.array([0.2, -0.3, 0.1])
    return o, fibonacci_directions(R)


def test_compiled_closest_hit_matches_dense(scene, rays):
    o, d = rays
    be = PallasBackend(scene)  # interpret=False: compiled by Triton
    t, rank = jax.jit(be.local_closest)(o, d)
    hit_d, t_d, _ = DenseBackend(scene).closest_hit(o, d)
    t, t_d = np.asarray(t), np.asarray(t_d)
    np.testing.assert_array_equal(np.isfinite(t), np.asarray(hit_d))
    m = np.isfinite(t)
    np.testing.assert_allclose(t[m], t_d[m], rtol=1e-5, atol=1e-4)


def test_compiled_multi_any_hit_matches_dense(scene, rays):
    o, d = rays
    be = PallasBackend(scene)
    dense = DenseBackend(scene)
    dirs = [d, -d, jnp.roll(d, 1, axis=0)]
    limits = jnp.full((R, 3), 25.0)
    init = jnp.zeros((R, 3), bool)
    skips = (NO_SKIP, 0, 1)
    occ = jax.jit(lambda o: be.multi_occluded(o, dirs, limits, skips,
                                              init))(o)
    occ_d = dense.multi_occluded(o, dirs, limits, skips, init)
    agree = (np.asarray(occ) == np.asarray(occ_d)).mean()
    # Compiled f32 kernels vs the XLA grid may disagree only on
    # razor's-edge lanes (different fma contractions).
    assert agree > 0.9999, agree


def test_compiled_multi_chord_matches_dense(scene, rays):
    o, d = rays
    be = PallasBackend(scene)
    dense = DenseBackend(scene)
    dirs = [d, -d]
    loss = jax.jit(lambda o: be.multi_permeation_loss(o, dirs, (0, 1)))(o)
    loss_d = dense.multi_permeation_loss(o, dirs, (0, 1))
    np.testing.assert_allclose(np.asarray(loss), np.asarray(loss_d),
                               rtol=1e-4, atol=1e-3)


def test_compiled_forward_pallas_vs_dense(scene):
    origin = jnp.array([0.2, -0.3, 0.1])
    dirs = fibonacci_directions(4096)
    cfg = TraceConfig(ray_count=4096, max_bounces=3, max_ray_life=120.0,
                      max_muffle_hit_distance=100.0, num_reverb_bins=16)
    res_p, set_p = jax.jit(
        lambda o, d, s: forward(o, d, s, cfg, backend="pallas"))(
            origin, dirs, scene)
    res_j, set_j = jax.jit(
        lambda o, d, s: forward(o, d, s, cfg, backend="jnp"))(
            origin, dirs, scene)
    # On device the compiled kernels and the XLA grid contract fma
    # differently; razor's-edge visibility booleans may flip on a
    # handful of (ray, bounce) lanes.
    mh_p = np.asarray(res_p.muffle_hits).astype(np.int64)
    mh_j = np.asarray(res_j.muffle_hits).astype(np.int64)
    assert (np.abs(mh_p - mh_j) <= np.maximum(5, 0.01 * mh_j)).all(), (
        mh_p, mh_j)
    np.testing.assert_allclose(np.asarray(res_p.permeation),
                               np.asarray(res_j.permeation),
                               rtol=1e-4, atol=1e-2)
    # Echo-visibility edge flips move a few rays' energy between bins.
    np.testing.assert_allclose(np.asarray(res_p.reverb_ir),
                               np.asarray(res_j.reverb_ir),
                               rtol=0.02, atol=1.0)
    # Settings tolerance matches the muffle_hits bound above: up to ~5
    # edge-flipped (ray, bounce) visibility lanes out of R*H move muffle
    # by 5 / (R * H) ~= 3e-4.
    np.testing.assert_allclose(np.asarray(set_p.muffle),
                               np.asarray(set_j.muffle),
                               rtol=1e-4, atol=5e-4)


def test_compiled_bf16_tier_lowers_and_runs(scene, rays):
    """The bf16 tier compiled by Triton (bf16 geometry arithmetic, f32
    reciprocals / square roots / decisions) — breaks loudly if the
    lowering regresses."""
    o, d = rays
    be = PallasBackend(scene, compute_dtype=jnp.bfloat16)
    t16, _ = jax.jit(be.local_closest)(o, d)
    _, t_d, _ = DenseBackend(scene).closest_hit(o, d)
    t16, t_d = np.asarray(t16), np.asarray(t_d)
    agree = (np.isfinite(t16) == np.isfinite(t_d)).mean()
    assert agree > 0.95, agree
    m = np.isfinite(t16) & np.isfinite(t_d)
    assert np.median(np.abs(t16[m] - t_d[m]) / np.abs(t_d[m])) < 0.01

    dirs = [d, -d]
    occ = jax.jit(lambda o: be.multi_occluded(
        o, dirs, jnp.full((R, 2), 25.0), (NO_SKIP, 0),
        jnp.zeros((R, 2), bool)))(o)
    assert np.asarray(occ).dtype == np.bool_
    loss = jax.jit(lambda o: be.multi_permeation_loss(o, dirs, (0, 1)))(o)
    assert np.isfinite(np.asarray(loss)).all()


def test_sharded_step_on_single_chip(scene):
    """shard_map'd forward over a 1x1 device mesh on one card."""
    from audio_raytracer_tpu.parallel.mesh import make_mesh
    from audio_raytracer_tpu.parallel.sharded import make_sharded_forward

    cfg = TraceConfig(ray_count=4096, max_bounces=2, max_ray_life=120.0,
                      max_muffle_hit_distance=100.0)
    mesh = make_mesh(ray_shards=1, prim_shards=1,
                     devices=jax.devices()[:1])
    step = make_sharded_forward(cfg, mesh, backend="pallas")
    origin = jnp.array([0.2, -0.3, 0.1])
    dirs = fibonacci_directions(4096)
    settings = step(origin, dirs, scene)
    ref = jax.jit(lambda o, d, s: forward(o, d, s, cfg,
                                          backend="pallas")[1])(
        origin, dirs, scene)
    np.testing.assert_allclose(np.asarray(settings.muffle),
                               np.asarray(ref.muffle), rtol=1e-5,
                               atol=1e-5)


def test_compiled_gradient_step(scene):
    """Differentiable tier (chord kernel + plain-fold VJP) compiled."""
    from audio_raytracer_tpu.models.differentiable import (
        Loudness,
        SceneParams,
        loudness_loss,
    )

    cfg = TraceConfig(ray_count=2048, max_bounces=2, max_ray_life=120.0,
                      max_muffle_hit_distance=100.0)
    origin = jnp.array([0.2, -0.3, 0.1])
    dirs = fibonacci_directions(2048)
    params = SceneParams.from_scene(scene)
    target = Loudness(muffle=jnp.full((3,), 0.3),
                      permeation=jnp.full((3,), 0.2),
                      reverb_energy=jnp.asarray(0.05))

    def backend_fn(s):
        return PallasBackend(s, differentiable=True)

    g = jax.jit(lambda p: jax.grad(loudness_loss)(
        p, scene, origin, dirs, cfg, target, backend_fn=backend_fn))(params)
    leaves = jax.tree.leaves(g)
    assert leaves and all(np.isfinite(np.asarray(x)).all() for x in leaves)
    assert any(float(jnp.abs(x).sum()) > 0 for x in leaves)


def test_compiled_gradient_parity_vs_dense(scene):
    """NUMERIC gradient parity on the card: the compiled kernel tier —
    materials AND the pose_grads tier — must match the DenseBackend
    autodiff gradients on the same f32 workload, not merely be finite.
    The gate splits by gradient PATH:

    - DENSITY grads flow through the chord kernel's custom VJP (the plain
      chord fold's VJP) and must match tightly: allclose at rtol 2e-3 /
      atol 1e-5 AND relative L2 < 1e-4.
    - ABSORPTION / ECHO / pose grads route through the closest-hit
      WINNER selection: compiled kernels contract fma differently than
      the XLA grid, so a razor-edge closest-hit tie can flip which
      primitive wins a bounce for a handful of rays, re-routing those
      rays' whole contribution between primitives. The atol is
      therefore a few single-ray contribution quanta (~4e-5 at R=2048):
      allclose at rtol 2e-3 / atol 1e-4.
    """
    from audio_raytracer_tpu.models.differentiable import (
        Loudness,
        SceneParams,
        loudness_loss,
    )

    cfg = TraceConfig(ray_count=2048, max_bounces=2, max_ray_life=120.0,
                      max_muffle_hit_distance=100.0)
    origin = jnp.array([0.2, -0.3, 0.1])
    dirs = fibonacci_directions(2048)
    params = SceneParams.from_scene(scene)
    target = Loudness(muffle=jnp.full((3,), 0.3),
                      permeation=jnp.full((3,), 0.2),
                      reverb_energy=jnp.asarray(0.05))

    import jax.tree_util as jtu

    for pose_grads in (False, True):
        argnums = (0, 2) if pose_grads else 0

        def backend_fn(s, _pg=pose_grads):
            return PallasBackend(s, differentiable=True, pose_grads=_pg)

        g_ker = jax.jit(lambda p: jax.grad(loudness_loss,
                                           argnums=argnums)(
            p, scene, origin, dirs, cfg, target,
            backend_fn=backend_fn))(params)
        g_ref = jax.jit(lambda p: jax.grad(loudness_loss,
                                           argnums=argnums)(
            p, scene, origin, dirs, cfg, target))(params)

        ker = jtu.tree_leaves_with_path(g_ker)
        ref = jtu.tree_leaves_with_path(g_ref)
        assert len(ker) == len(ref) and ker
        for (path, a), (_, b) in zip(ref, ker):
            name = jtu.keystr(path)
            a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
            if "density" in name:
                np.testing.assert_allclose(
                    b, a, rtol=2e-3, atol=1e-5,
                    err_msg=f"chord-adjoint leaf {name} "
                            f"(pose_grads={pose_grads})")
                rel_l2 = (np.linalg.norm(a - b)
                          / max(float(np.linalg.norm(a)), 1e-12))
                assert rel_l2 < 1e-4, (name, pose_grads, rel_l2)
            else:
                np.testing.assert_allclose(
                    b, a, rtol=2e-3, atol=1e-4,
                    err_msg=f"winner-routed leaf {name} "
                            f"(pose_grads={pose_grads})")


def test_sharded_train_step_compiled_pallas(scene):
    """shard_map x COMPILED Pallas x backward on the 1x1 device mesh —
    the multi-card gradient composition (BASELINE configs 4+5):
    make_sharded_train_step with backend='pallas' must trace (check_vma
    disabled for kernel tiers), compile, and produce finite moving
    gradients."""
    from audio_raytracer_tpu.models.differentiable import (
        Loudness,
        SceneParams,
    )
    from audio_raytracer_tpu.parallel.mesh import make_mesh
    from audio_raytracer_tpu.parallel.train import make_sharded_train_step

    cfg = TraceConfig(ray_count=2048, max_bounces=2, max_ray_life=120.0,
                      max_muffle_hit_distance=100.0)
    mesh = make_mesh(ray_shards=1, prim_shards=1,
                     devices=jax.devices()[:1])
    params = SceneParams.from_scene(scene)
    target = Loudness(muffle=jnp.full((3,), 0.3),
                      permeation=jnp.full((3,), 0.2),
                      reverb_energy=jnp.asarray(0.05))
    step, opt = make_sharded_train_step(cfg, mesh, backend="pallas")
    opt_state = opt.init(params)
    dirs = fibonacci_directions(cfg.ray_count)
    origin = jnp.array([0.2, -0.3, 0.1])
    p1, opt_state, loss1 = step(params, opt_state, scene, origin, dirs,
                                target)
    p2, _, loss2 = step(p1, opt_state, scene, origin, dirs, target)
    assert np.isfinite(float(loss1)) and np.isfinite(float(loss2))
    moved = any(
        not np.allclose(np.asarray(a), np.asarray(b))
        for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(p1)))
    assert moved


def test_compacted_forward_compiled_matches_uncompacted(scene):
    """compact_rays with COMPILED kernels: the alive-first
    reorder + dead-block skip must be invisible vs the same compiled
    kernels without it (short ray life so lanes actually die)."""
    origin = jnp.array([0.2, -0.3, 0.1])
    dirs = fibonacci_directions(8192)
    cfg = TraceConfig(ray_count=8192, max_bounces=3, max_ray_life=40.0,
                      max_muffle_hit_distance=100.0)
    cfg_c = dataclasses.replace(cfg, compact_rays=True)
    res, st = jax.jit(lambda o, d, s: forward(o, d, s, cfg,
                                              backend="pallas"))(
        origin, dirs, scene)
    res_c, st_c = jax.jit(lambda o, d, s: forward(o, d, s, cfg_c,
                                                  backend="pallas"))(
        origin, dirs, scene)
    np.testing.assert_array_equal(np.asarray(res.muffle_hits),
                                  np.asarray(res_c.muffle_hits))
    np.testing.assert_allclose(np.asarray(res.echo_distances),
                               np.asarray(res_c.echo_distances),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.asarray(st.muffle),
                               np.asarray(st_c.muffle),
                               rtol=1e-6, atol=1e-6)


def test_unordered_compaction_compiled_invariants(scene):
    """compact_unordered with COMPILED kernels (the production
    bench tier): per-bounce outputs arrive permuted within columns, but
    muffle_hits, per-column echo sums, first_hit_t, and settings must
    be identical to the ordered compiled tier."""
    origin = jnp.array([0.2, -0.3, 0.1])
    dirs = fibonacci_directions(8192)
    cfg = TraceConfig(ray_count=8192, max_bounces=3, max_ray_life=40.0,
                      max_muffle_hit_distance=100.0, compact_rays=True)
    cfg_u = dataclasses.replace(cfg, compact_unordered=True)
    res, st = jax.jit(lambda o, d, s: forward(o, d, s, cfg,
                                              backend="pallas"))(
        origin, dirs, scene)
    res_u, st_u = jax.jit(lambda o, d, s: forward(o, d, s, cfg_u,
                                                  backend="pallas"))(
        origin, dirs, scene)
    np.testing.assert_array_equal(np.asarray(res.muffle_hits),
                                  np.asarray(res_u.muffle_hits))
    np.testing.assert_allclose(np.asarray(res.first_hit_t),
                               np.asarray(res_u.first_hit_t),
                               rtol=1e-6, atol=1e-6)
    e_o = np.asarray(res.echo_distances, np.float64)
    e_u = np.asarray(res_u.echo_distances, np.float64)
    np.testing.assert_allclose(e_o.sum(axis=0), e_u.sum(axis=0),
                               rtol=1e-6, atol=1e-4)
    for h in range(e_o.shape[1]):
        np.testing.assert_allclose(np.sort(e_o[:, h]), np.sort(e_u[:, h]),
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.asarray(st.muffle),
                               np.asarray(st_u.muffle),
                               rtol=1e-6, atol=1e-6)


def test_orchestrator_tick_on_device():
    """AsyncRaytraceLoop on the card: frames dispatch asynchronously,
    complete (is_ready / block_until_ready), and harvest with a measured
    dispatch-to-harvest raytracer_ms."""
    import time

    from audio_raytracer_tpu.runtime import AsyncRaytraceLoop, SceneRegistry

    reg = SceneRegistry()
    try:
        reg.add_aabb((0.0, 0.0, 5.0), (1.0, 1.0, 1.0))
        reg.add_sphere((3.0, 0.0, 0.0), 1.0)
        reg.add_target((0.0, 0.0, 3.0))
        cfg = TraceConfig(ray_count=4096, max_bounces=2,
                          max_ray_life=60.0,
                          max_muffle_hit_distance=50.0,
                          num_reverb_bins=8, ir_max_distance=60.0)
        loop = AsyncRaytraceLoop(reg, cfg, backend="pallas",
                                 compute_async=True)
        origin = np.zeros(3)
        settings = None
        deadline = time.time() + 120.0
        ticks = 0
        while time.time() < deadline:
            settings = loop.tick(origin)
            ticks += 1
            if loop.frames_harvested >= 2:
                break
            time.sleep(0.01)
        assert loop.frames_harvested >= 2, (ticks, loop.frames_dispatched)
        assert settings is not None
        assert loop.raytracer_ms > 0.0
        m = np.asarray(settings.muffle)
        assert np.isfinite(m).all() and (m >= 0).all() and (m <= 1).all()
        # The impulse response rode along with the harvest (feeds the
        # DSP tail stage).
        assert loop.reverb_ir is not None
        ir = np.asarray(loop.reverb_ir)
        assert ir.shape == (8,) and np.isfinite(ir).all()
        # Async frame-skip engaged: more ticks than harvests.
        assert ticks > loop.frames_harvested
    finally:
        reg.close()


def test_large_scene_compiled():
    """~36K mixed primitives through the COMPILED kernels (no per-call
    primitive cap: tables live in device memory) against the plain
    engine's chunked fold on a subsample of rays — the single-card
    answer to the reference's unbounded registry growth
    (AudioColliderManager.cs:42-62)."""
    big = random_scene(jax.random.key(11), num_spheres=12_000,
                       num_aabbs=12_000, num_obbs=12_000, num_targets=2,
                       extent=120.0, size_range=(0.5, 3.0))
    be = PallasBackend(big)
    Rs = 8192
    o = jnp.zeros((Rs, 3)) + jnp.asarray([0.3, -0.2, 0.4])
    d = fibonacci_directions(Rs)
    hit, t, attrs = jax.jit(lambda o, d: be.closest_hit(o, d))(o, d)
    hit_d, t_d, _ = DenseBackend(big).closest_hit(o[:1024], d[:1024])
    np.testing.assert_array_equal(np.asarray(hit)[:1024],
                                  np.asarray(hit_d))
    m = np.asarray(hit_d)
    np.testing.assert_allclose(np.asarray(t)[:1024][m],
                               np.asarray(t_d)[m], rtol=1e-5, atol=1e-3)

    cfg = TraceConfig(ray_count=Rs, max_bounces=2, max_ray_life=200.0,
                      max_muffle_hit_distance=150.0)
    res, settings = jax.jit(
        lambda o, d, s: forward(o, d, s, cfg, backend="pallas"))(
            jnp.asarray([0.3, -0.2, 0.4]), d, big)
    mu = np.asarray(settings.muffle)
    assert np.isfinite(mu).all() and (mu >= 0).all() and (mu <= 1).all()


def test_reverb_tail_dsp_on_device():
    """The IR-driven convolution tail (rfft/irfft overlap-add) lowers
    and runs on the card, matching the CPU NumPy oracle."""
    import dataclasses as dc

    from audio_raytracer_tpu.models.spatializer import (
        DSPState,
        SpatializerSettings,
        ir_kernel_length,
        ir_to_fir,
        spatialize,
    )
    from audio_raytracer_tpu.types import TargetSettings

    sr = 8000.0
    settings = dc.replace(
        SpatializerSettings.default(), render_reverb_tail=True,
        reverb_ir_max_distance=jnp.float32(40.0),
        pan_strength=jnp.float32(0.0),
        rear_attenuation_strength=jnp.float32(0.0),
        low_pass_volume=jnp.float32(1.0),
        high_pass_volume=jnp.float32(1.0))
    L = ir_kernel_length(8, 40.0, sr)
    ir = jnp.asarray([1.0, 0.5, 0.0, 0.2, 0.0, 0.0, 0.0, 0.0])
    rt = TargetSettings(muffle=jnp.zeros((1,)),
                        reverb_strength=jnp.asarray(1.0),
                        reverb_volume=jnp.asarray(0.0),
                        perceived_position=jnp.zeros((1, 3)))
    local = jnp.asarray([0.0, 0.0, 1.0])
    state = DSPState.zero(tail_len=L - 1)
    rng = np.random.default_rng(3)
    buf = jnp.asarray(rng.standard_normal((256, 2)).astype(np.float32))
    jit_sp = jax.jit(spatialize, static_argnames=("sample_rate",))
    out, state2, _ = jit_sp(buf, state, settings, rt, jnp.int32(0), local,
                            jnp.asarray(5.0), sample_rate=sr, reverb_ir=ir)
    out = np.asarray(out)
    assert np.isfinite(out).all() and np.abs(out).max() > 0
    assert np.isfinite(np.asarray(state2.reverb_tail)).all()
    # Tail carry charged by the convolution stage.
    assert float(jnp.abs(state2.reverb_tail).sum()) > 0.0


def test_orchestrator_survives_registry_growth():
    """Live registry growth from 64 to ~4K colliders: the reference's
    registry grows without limit (AudioColliderManager.cs:42-62); the
    grown snapshot re-traces (new padded shapes) and keeps ticking."""
    from audio_raytracer_tpu.runtime import AsyncRaytraceLoop, SceneRegistry

    reg = SceneRegistry()
    try:
        rng = np.random.default_rng(0)
        for _ in range(64):
            reg.add_aabb(rng.uniform(-40, 40, 3), rng.uniform(0.5, 3.0, 3))
        reg.add_target((0.0, 0.0, 3.0))
        cfg = TraceConfig(ray_count=2048, max_bounces=2, max_ray_life=60.0,
                          max_muffle_hit_distance=50.0)
        loop = AsyncRaytraceLoop(reg, cfg, backend="pallas",
                                 compute_async=False)
        s_small = loop.tick(np.zeros(3))
        s_small = loop.tick(np.zeros(3))
        assert s_small is not None
        n_small = reg.snapshot().num_primitives

        for c, h in zip(rng.uniform(-60, 60, (3750, 3)),
                        rng.uniform(0.5, 2.0, (3750, 3))):
            reg.add_aabb(c, h)  # snapshot pads to 4096
        assert reg.snapshot().num_primitives > 16 * n_small

        s_big = loop.tick(np.zeros(3))  # re-traces at the grown shapes
        s_big = loop.tick(np.zeros(3))
        m = np.asarray(s_big.muffle)
        assert np.isfinite(m).all() and (m >= 0).all() and (m <= 1).all()
    finally:
        reg.close()
