"""Differentiable loudness model + gradient workload (BASELINE config 4).

The reference forward is full of discrete events (closest-hit argmin,
visibility booleans, ray-death thresholds) whose gradients are zero or
undefined. This module defines the *differentiable extension*: the same
trajectories (hard closest-hit and visibility — matching forward parity),
but with accumulation weighted by a continuous per-ray energy so gradients
flow to every material parameter:

- energy: e_0 = 1, e_{k+1} = e_k * (1 - absorption_hit_k) — the smooth
  counterpart of the reference's life drain
  (AudioRaytracerJobBatched.cs:531), differentiable in absorption.
- muffle loudness[t]   = sum_{r,k} e_k * visible(r,k,t) / (R*H)
- reverb energy        = sum_{r,k} e_k * echo_dist(r,k) / (R*H*max_reverb)
- permeation loudness[t] = mean_r (strength - chord_loss(r,t)) * perm_eff
  — differentiable in density (chord length x density is linear).

Gradients to source/listener poses flow through hit distances, echo
distances, and chord lengths (piecewise-smooth a.e.). Discrete selections
(which primitive, which visibility branch) are treated as constants of the
trajectory — the straight-through convention; finite-difference checks in
tests/test_gradients.py validate the continuous paths.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import optax

from audio_raytracer_tpu.ops import intersect, reverb
from audio_raytracer_tpu.ops.backend import DenseBackend
from audio_raytracer_tpu.ops.trace import _secondary_occlusion
from audio_raytracer_tpu.types import Materials, Scene, TraceConfig
from audio_raytracer_tpu.tree import pytree_dataclass

Array = jnp.ndarray


@pytree_dataclass
class Loudness:
    """Differentiable outputs of the acoustic field model."""

    muffle: Array  # [T] energy-weighted visibility fraction
    permeation: Array  # [T] mean transmitted power
    reverb_energy: Array  # [] scalar
    # [n_bins] energy-weighted impulse response over arrival-time bins
    # (ops/reverb.py; populated when cfg.num_reverb_bins > 0).
    reverb_ir: Array | None = None


@pytree_dataclass
class SceneParams:
    """The learnable parameter pytree: per-type materials.

    (The learnable fields of AudioMaterialProperties.cs, lifted out of the
    scene so optimizers and grads see exactly the trainable leaves.)
    """

    sphere: Materials
    aabb: Materials
    obb: Materials

    @staticmethod
    def from_scene(scene: Scene) -> "SceneParams":
        return SceneParams(sphere=scene.spheres.material,
                           aabb=scene.aabbs.material,
                           obb=scene.obbs.material)

    def into_scene(self, scene: Scene) -> Scene:
        return dataclasses.replace(
            scene,
            spheres=dataclasses.replace(scene.spheres, material=self.sphere),
            aabbs=dataclasses.replace(scene.aabbs, material=self.aabb),
            obbs=dataclasses.replace(scene.obbs, material=self.obb),
        )


def loudness_map(origin: Array, directions: Array, scene: Scene,
                 cfg: TraceConfig, backend=None,
                 total_ray_count: int | None = None,
                 axis_name: str | None = None,
                 pvary_axes: tuple = ()) -> Loudness:
    """Differentiable loudness field. With ``axis_name`` set, ray-axis
    partial sums are psum-reduced (for shard_map'd training)."""
    R = directions.shape[0]
    R_total = total_ray_count if total_ray_count is not None else R
    T = scene.num_targets
    H = cfg.max_hits_per_ray
    eps = cfg.epsilon
    if backend is None:
        backend = DenseBackend(scene)

    # Kernel engines skip fully-dead ray blocks when given the alive
    # mask (free; same as ops.trace).
    block_skip = getattr(backend, "supports_block_skip", False)

    def bounce(carry, step):
        o, d, life, alive, energy = carry
        hit, t, attrs = backend.closest_hit(
            o, d, alive=alive if block_skip else None)
        live_hit = alive & hit
        t_safe = jnp.where(live_hit, t, 0.0)

        p = o + d * t_safe[..., None]
        life = life - jax.lax.stop_gradient(t_safe)
        offset_point = p - d * eps

        # Echo + muffle visibility, fused into one primitive stream.
        # Visibility booleans are straight-through (no tangents); the
        # energy / distance factors below carry the gradients.
        dist_to_origin, echo_visible, muffle_visible = _secondary_occlusion(
            backend, scene, cfg, offset_point, p, origin, live_hit)
        # Echo value (distance x material echo) and its energy weight,
        # kept separate so the IR histogram can bin value-by-weight.
        echo_val = jnp.where(live_hit & echo_visible,
                             dist_to_origin * attrs["echo"], 0.0)
        echo_w = jnp.where(live_hit & echo_visible, energy, 0.0)
        muffle_contrib = jnp.where(muffle_visible & live_hit[..., None],
                                   energy[..., None], 0.0)  # [R, T]

        bounces_done = step + 1
        can_continue = live_hit & (bounces_done < H) & (life > 0.0)

        normal = intersect.reflection_normal(
            p, attrs["kind"], attrs["center"], attrs["half_extents"],
            attrs["inv_rot"])
        d_new = intersect.reflect(d, normal)
        o_new = p + d_new * eps
        life_new = life - cfg.max_ray_life * jax.lax.stop_gradient(
            attrs["absorption"])
        alive_next = can_continue & (life_new >= 0.0)

        energy_next = jnp.where(live_hit,
                                energy * (1.0 - attrs["absorption"]), energy)

        o = jnp.where(can_continue[..., None], o_new, p)
        d = jnp.where(can_continue[..., None], d_new, d)
        life = jnp.where(can_continue, life_new, life)
        return ((o, d, life, alive_next, energy_next),
                (t, echo_val, echo_w, muffle_contrib))

    o0 = jnp.broadcast_to(jnp.asarray(origin, directions.dtype), (R, 3))
    life0 = jnp.full((R,), cfg.max_ray_life, directions.dtype)
    alive0 = jnp.ones((R,), bool)
    e0 = jnp.ones((R,), directions.dtype)
    if pvary_axes:
        # shard_map scan carries must enter with their steady-state
        # varying-manifest-axes type (see ops/trace.py).
        o0, life0, alive0, e0 = (
            jax.lax.pcast(x, pvary_axes, to="varying")
            for x in (o0, life0, alive0, e0))

    _, (t_all, echo_v, echo_w, muffle_c) = jax.lax.scan(
        bounce, (o0, directions, life0, alive0, e0), jnp.arange(H),
        length=H)

    # Permeation (differentiable, per-ray mean — no overwrite quirk here).
    # The primary-ray first hit is the scan's bounce-0 distance: no second
    # scene scan, and (via winner-recompute) it carries pose tangents.
    t_first = t_all[0]
    hit_first = jnp.isfinite(t_first)
    t_sf = jnp.where(hit_first, t_first, 0.0)
    p_first = o0 + directions * t_sf[..., None]
    off = p_first - directions * eps

    if T > 0:
        dirs = []
        for ti in range(T):
            to_t = scene.target_positions[ti] - off
            dist = intersect.safe_norm(to_t)
            dirs.append(to_t / dist[..., None])
        losses = backend.multi_permeation_loss(off, dirs,
                                               tuple(range(T)))  # [R, T]
        vals = cfg.permeation_strength_per_ray - losses / R_total
        perm_sum = jnp.sum(jnp.where(hit_first[..., None], vals, 0.0), axis=0)
    else:
        perm_sum = jnp.zeros((0,), directions.dtype)

    muffle_sum = jnp.sum(muffle_c, axis=(0, 1))  # [T]
    echo_sum = jnp.sum(echo_v * echo_w)

    reverb_ir = None
    if cfg.num_reverb_bins > 0:
        # Energy-weighted IR histogram (BASELINE config 3), normalized
        # per ray so it is invariant to the ray budget.
        reverb_ir = reverb.impulse_response(
            echo_v, cfg, weights=echo_w, axis_name=axis_name) / R_total

    if axis_name is not None:
        muffle_sum = jax.lax.psum(muffle_sum, axis_name)
        echo_sum = jax.lax.psum(echo_sum, axis_name)
        perm_sum = jax.lax.psum(perm_sum, axis_name)

    return Loudness(
        muffle=muffle_sum / (R_total * H),
        permeation=perm_sum / R_total * cfg.permeation_effectiveness,
        reverb_energy=echo_sum / (R_total * H * cfg.max_reverb_distance),
        reverb_ir=reverb_ir,
    )


# ---------------------------------------------------------------------------
# Training: optimize materials to match a target loudness map
# ---------------------------------------------------------------------------


def _make_backend_fn(backend: str, pose_grads: bool):
    """Resolve a backend name to a scene -> engine factory for the
    differentiable train/recovery steps: None for "jnp" (the plain
    engine), else the kernel tier (``pose_grads=False`` prunes the
    chord backward's ray cotangents)."""
    if backend == "jnp":
        return None
    if backend not in ("pallas", "pallas_interpret"):
        raise ValueError(f"unknown backend {backend!r}")
    from audio_raytracer_tpu.ops.pallas import PallasBackend

    def backend_fn(s):
        return PallasBackend(
            s, interpret=(backend == "pallas_interpret"),
            differentiable=True, pose_grads=pose_grads)

    return backend_fn


def _loudness_mse(pred: Loudness, target: Loudness) -> Array:
    loss = (jnp.mean((pred.muffle - target.muffle) ** 2)
            + jnp.mean((pred.permeation - target.permeation) ** 2)
            + (pred.reverb_energy - target.reverb_energy) ** 2)
    if pred.reverb_ir is not None and target.reverb_ir is not None:
        loss = loss + jnp.mean((pred.reverb_ir - target.reverb_ir) ** 2)
    return loss


def loudness_loss(params: SceneParams, scene: Scene, origin, directions,
                  cfg: TraceConfig, target: Loudness, backend_fn=None,
                  axis_name=None, total_ray_count=None) -> Array:
    """MSE between the predicted and target loudness maps."""
    full_scene = params.into_scene(scene)
    backend = backend_fn(full_scene) if backend_fn else None
    pred = loudness_map(origin, directions, full_scene, cfg, backend=backend,
                        axis_name=axis_name, total_ray_count=total_ray_count)
    return _loudness_mse(pred, target)


def make_train_step(cfg: TraceConfig, optimizer=None,
                    backend: str = "jnp", pose_grads: bool = False):
    """Jitted single-device training step (full backward).

    ``backend``: "jnp" (the plain engine) or "pallas"/"pallas_interpret"
    (the differentiable kernel tier; set ``pose_grads`` when the loss
    also differentiates w.r.t. poses)."""
    if optimizer is None:
        optimizer = optax.adam(1e-2)
    backend_fn = _make_backend_fn(backend, pose_grads=pose_grads)

    @jax.jit
    def train_step(params, opt_state, scene, origin, directions, target):
        loss, grads = jax.value_and_grad(loudness_loss)(
            params, scene, origin, directions, cfg, target,
            backend_fn=backend_fn)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return train_step, optimizer


# ---------------------------------------------------------------------------
# Pose recovery: optimize source / listener positions from a recording
# ---------------------------------------------------------------------------


@pytree_dataclass
class PoseParams:
    """The learnable pose pytree: listener origin + audio-source
    positions. The north star's "gradients flow to source/listener
    poses" made USEFUL: given a target loudness map (the "recording"),
    gradient descent recovers where the sources / the listener actually
    were. Pose tangents ride hit distances, echo distances, and
    permeation chord lengths (piecewise-smooth a.e.); discrete
    selections are straight-through, as in loudness_map."""

    origin: Array  # [3] listener position
    target_positions: Array  # [T, 3] audio-source positions


def pose_loss(pose: PoseParams, scene: Scene, directions,
              cfg: TraceConfig, target: Loudness, backend_fn=None,
              axis_name=None, total_ray_count=None) -> Array:
    """MSE between the loudness map traced AT ``pose`` and the target
    map; materials stay fixed at the scene's authored values."""
    scene_p = dataclasses.replace(scene,
                                  target_positions=pose.target_positions)
    backend = backend_fn(scene_p) if backend_fn else None
    pred = loudness_map(pose.origin, directions, scene_p, cfg,
                        backend=backend, axis_name=axis_name,
                        total_ray_count=total_ray_count)
    return _loudness_mse(pred, target)


def make_pose_recovery_step(cfg: TraceConfig, optimizer=None,
                            backend: str = "jnp",
                            recover: tuple = ("origin", "targets")):
    """Jitted pose-recovery training step.

    ``recover`` selects which pose leaves receive updates ("origin",
    "targets", or both); the others keep their value (their gradients
    are zeroed before the optimizer, so optimizer moments stay clean).
    Kernel-tier backends are built with pose_grads=True (ray
    cotangents of the chord backward kept)."""
    if optimizer is None:
        optimizer = optax.adam(1e-2)
    backend_fn = _make_backend_fn(backend, pose_grads=True)

    @jax.jit
    def step(pose, opt_state, scene, directions, target):
        loss, grads = jax.value_and_grad(pose_loss)(
            pose, scene, directions, cfg, target, backend_fn=backend_fn)
        grads = PoseParams(
            origin=(grads.origin if "origin" in recover
                    else jnp.zeros_like(grads.origin)),
            target_positions=(grads.target_positions
                              if "targets" in recover
                              else jnp.zeros_like(grads.target_positions)))
        updates, opt_state = optimizer.update(grads, opt_state, pose)
        pose = optax.apply_updates(pose, updates)
        return pose, opt_state, loss

    return step, optimizer


def stack_loudness(recordings: list) -> Loudness:
    """Stack per-listener Loudness maps on a leading axis (the recording
    batch make_source_recovery_step consumes)."""
    return jax.tree.map(lambda *xs: jnp.stack(xs), *recordings)


def make_source_recovery_step(cfg: TraceConfig, num_listeners: int,
                              optimizer=None, backend: str = "jnp"):
    """Source localization by triangulation: recover audio-target
    POSITIONS from loudness recordings taken at ``num_listeners`` known
    listener positions.

    A single recording's observables (muffle / permeation / reverb
    scalars) are too low-dimensional to pin a 3-D source position —
    gradient descent matches the scalars at a wrong pose (measured:
    local minimum ~1.3 units off truth). Several listeners make the
    problem overdetermined, exactly like acoustic triangulation: each
    listener's permeation chords and visibility energy constrain the
    source along different directions, and their joint MSE has its
    minimum at the true position (recovery test:
    tests/test_gradients.py::TestPoseRecovery).

    Returns ``step(target_positions, opt_state, scene, origins,
    directions, recordings) -> (target_positions, opt_state, loss)``
    where ``origins`` is [L, 3] and ``recordings`` a Loudness pytree
    with leading axis L (see stack_loudness).
    """
    if optimizer is None:
        optimizer = optax.adam(1e-2)
    backend_fn = _make_backend_fn(backend, pose_grads=True)

    def multi_loss(tp, scene, origins, directions, recordings):
        scene_p = dataclasses.replace(scene, target_positions=tp)
        backend_ = backend_fn(scene_p) if backend_fn else None
        total = 0.0
        for li in range(num_listeners):
            rec = jax.tree.map(lambda x, _l=li: x[_l], recordings)
            pred = loudness_map(origins[li], directions, scene_p, cfg,
                                backend=backend_)
            total = total + _loudness_mse(pred, rec)
        return total / num_listeners

    @jax.jit
    def step(target_positions, opt_state, scene, origins, directions,
             recordings):
        loss, grads = jax.value_and_grad(multi_loss)(
            target_positions, scene, origins, directions, recordings)
        updates, opt_state = optimizer.update(grads, opt_state,
                                              target_positions)
        target_positions = optax.apply_updates(target_positions, updates)
        return target_positions, opt_state, loss

    return step, optimizer
