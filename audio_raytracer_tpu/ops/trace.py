"""Multi-bounce trace: the main raytracer kernel as a fixed-depth masked scan.

The reference's divergent per-ray ``while (isRayAlive)`` loop
(Jobs/AudioRaytracerJobBatched.cs:61-215) becomes a ``lax.scan`` of
``max_hits_per_ray`` bounce steps over the whole ray batch, with an alive
mask instead of early exit — dead lanes produce zeros and must never
corrupt accumulators. The per-bounce ordering replicates the reference:

  1. closest hit over all primitives; a miss kills the ray immediately
  2. advance origin, drain life by hit distance, increment bounce count
  3. echo ray from epsilon-offset hit point back to the listener origin;
     if unoccluded, record dist x material.Echo in slot (ray, bounce)
  4. muffle ray from the offset hit point to each audio target within
     MaxMuffleHitDistance, skipping the target's own colliders; visible
     -> per-(accum-batch, target) hit counter += 1
  5. kill if bounce count == max or life <= 0; otherwise reflect off the
     face normal, offset along the new direction, drain life by
     MaxRayLife * absorption, and kill if life went < 0

Intersection work goes through an ops.backend engine, so the same loop
serves the dense jnp tier, the prim-sharded collective tier, and the
Pallas kernel tier.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from audio_raytracer_tpu.ops import intersect
from audio_raytracer_tpu.ops.backend import NO_SKIP, DenseBackend
from audio_raytracer_tpu.types import Scene, TraceConfig, TraceResult

Array = jnp.ndarray


def accum_batch_ids(ray_count: int, num_batches: int) -> jnp.ndarray:
    """Per-ray accumulation-batch id, replicating the reference's thread
    batch mapping: batchSize = ceil(rayCount / threads), and
    batchId = rayStartIndex * batchCount / rayCount
    (Audio/AudioRayTracer.cs:161, AudioRaytracerJobBatched.cs:63-64).
    """
    batch_size = -(-ray_count // num_batches)
    r = jnp.arange(ray_count, dtype=jnp.int32)
    ray_start = (r // batch_size) * batch_size
    return (ray_start * num_batches) // ray_count


def alive_partition(alive: Array,
                    with_inverse: bool = True) -> tuple[Array, Array | None]:
    """Stable alive-first permutation and its inverse: ``(order, pos)``
    with x[order] packing the alive lanes into a dense prefix (relative
    order preserved on both sides) and y[pos] undoing it
    (y[pos][order] == y... i.e. pos[i] is where lane i lands).
    ``with_inverse=False`` skips the pos cumsums (returns None) for the
    unordered compaction tier that never restores.

    ``order`` comes from XLA's stable boolean sort; ``pos`` from two
    cumsums. Both directions are applied as gathers, never as a scatter.

    This is the between-bounce ray compaction that makes the kernel
    tier's fully-dead-block skipping actually fire (the reference's
    per-ray early exit, AudioRaytracerJobBatched.cs:104, has no per-lane
    analog in a block-parallel kernel — but pooling dead lanes into whole
    skippable blocks recovers the work saving at block granularity).
    """
    order = jnp.argsort(~alive, stable=True).astype(jnp.int32)
    if not with_inverse:
        return order, None
    a = alive.astype(jnp.int32)
    pos_alive = jnp.cumsum(a) - a  # rank among alive lanes
    n_alive = pos_alive[-1] + a[-1]
    dead = 1 - a
    pos_dead = jnp.cumsum(dead) - dead + n_alive
    pos = jnp.where(alive, pos_alive, pos_dead).astype(jnp.int32)
    return order, pos


def _pack_rows(*cols) -> Array:
    """Pack per-ray columns ([R] or [R, k], f32/int32/bool) into one
    [R, K] f32 row matrix. Ints are bitcast (exact); bools go via f32.

    Permuting ray state moves WHOLE ROWS: one coalesced [R, K] row
    gather instead of K separate 4-byte random-access [R] gathers.
    """
    parts = []
    for c in cols:
        if c.dtype == jnp.int32:
            c = jax.lax.bitcast_convert_type(c, jnp.float32)
        elif c.dtype == jnp.bool_:
            c = c.astype(jnp.float32)
        else:
            c = c.astype(jnp.float32)
        parts.append(c[:, None] if c.ndim == 1 else c)
    return jnp.concatenate(parts, axis=1)


def _unpack_col(rows: Array, sl, dtype=jnp.float32):
    """Inverse of _pack_rows for one column slice."""
    c = rows[:, sl]
    dtype = jnp.dtype(dtype)
    if dtype == jnp.int32:
        return jax.lax.bitcast_convert_type(c, jnp.int32)
    if dtype == jnp.bool_:
        return c > 0.5
    return c.astype(dtype)


def _secondary_occlusion(backend, scene: Scene, cfg: TraceConfig,
                         offset_point: Array, p: Array, origin: Array,
                         live_hit: Array):
    """Fused per-bounce secondary rays: echo ray back to the listener +
    one muffle ray per audio target, resolved in ONE backend call (a
    single primitive stream on the Pallas tier — the structure of the
    reference's one-pass bounce body, AudioRaytracerJobBatched.cs:104-207).

    Returns (dist_to_origin [R], echo_visible [R], muffle_visible [R, T]).
    Lanes whose test is moot (dead ray; target beyond
    MaxMuffleHitDistance) are pre-marked occluded so fully-resolved ray
    blocks skip the primitive stream.
    """
    T = scene.num_targets
    dist_echo = intersect.safe_norm(origin - p)
    dirs = [intersect.safe_normalize(origin - offset_point)]
    limits = [dist_echo]
    skips = [NO_SKIP]
    moot = [~live_hit]
    for t in range(T):
        to_target = scene.target_positions[t] - offset_point  # [R, 3]
        dist = intersect.safe_norm(to_target)
        dirs.append(to_target / dist[..., None])
        limits.append(dist)
        skips.append(t)  # skip the target's own colliders (cs:405-449)
        moot.append(~live_hit | (dist >= cfg.max_muffle_hit_distance))
    limits = jnp.stack(limits, axis=-1)  # [R, 1 + T]
    occ = backend.multi_occluded(offset_point, dirs, limits, tuple(skips),
                                 jnp.stack(moot, axis=-1))
    echo_visible = ~occ[..., 0]
    muffle_visible = ((limits[..., 1:] < cfg.max_muffle_hit_distance)
                      & ~occ[..., 1:])
    return dist_echo, echo_visible, muffle_visible


def _empty_result(R, T, H, cfg, dt, collect_debug):
    result = TraceResult(
        echo_distances=jnp.zeros((R, H), dt),
        muffle_hits=jnp.zeros((cfg.num_accum_batches, T), jnp.int32),
        permeation=jnp.zeros((cfg.num_accum_batches, T), dt),
    )
    if collect_debug:
        result = TraceResult(
            echo_distances=result.echo_distances,
            muffle_hits=result.muffle_hits,
            permeation=result.permeation,
            hit_points=jnp.zeros((R, H, 3), dt),
            hit_counts=jnp.zeros((R,), jnp.int32),
        )
    return result


def trace(origin: Array, directions: Array, scene: Scene, cfg: TraceConfig,
          collect_debug: bool = False, backend=None,
          pvary_axes: tuple = ()) -> TraceResult:
    """Run the full multi-bounce trace.

    origin: [3] listener/ray origin. directions: [R, 3].
    Returns a TraceResult with echo [R, H], muffle_hits [B, T],
    permeation [B, T] left zeroed (filled by ops.permeation).
    """
    R = directions.shape[0]
    T = scene.num_targets
    H = cfg.max_hits_per_ray
    eps = cfg.epsilon

    if backend is None:
        if scene.num_primitives == 0:
            return _empty_result(R, T, H, cfg, directions.dtype, collect_debug)
        backend = DenseBackend(scene)

    batch_ids = accum_batch_ids(R, cfg.num_accum_batches)
    # Block-skip aliveness is free on engines that support it: the kernel
    # skips fully-dead ray blocks outright (deaths cluster along the
    # Fibonacci latitude bands, so whole contiguous blocks do die). The
    # explicit alive-first reorder (cfg.compact_rays) additionally pools
    # scattered dead lanes into skippable blocks, at the cost of moving
    # the ray state every bounce.
    block_skip = getattr(backend, "supports_block_skip", False)
    compact = cfg.compact_rays and block_skip
    # Unordered tier: skip the inverse-permutation restore entirely —
    # sound because every consumer of the non-debug outputs is a
    # permutation-invariant reduction (see TraceConfig.compact_unordered)
    # and the carry never needs original order at all. The accum-batch
    # ids ride the forward row gather so the muffle segment-reduce can
    # happen per bounce on the compacted lanes.
    unordered = compact and cfg.compact_unordered and not collect_debug
    B = cfg.num_accum_batches
    # With one accum batch the muffle reduce is a plain sum — no batch
    # ids need to ride the compaction at all.
    carry_bids = unordered and B > 1

    dt = directions.dtype

    def bounce(carry, step, do_compact=compact):
        bids = batch_ids
        if unordered:
            if carry_bids:
                o, d, life, alive, bids, muffle_acc = carry
            else:
                o, d, life, alive, muffle_acc = carry
        else:
            o, d, life, alive = carry
        pos = None
        if do_compact:
            # Stable alive-first reorder: carry in and (unless
            # unordered) everything back out via the inverse gather at
            # the end of the bounce. One packed row gather each way
            # (see _pack_rows) keeps the movement coalesced.
            order, pos = alive_partition(alive,
                                         with_inverse=not unordered)
            cols = (o, d, life, alive) + ((bids,) if carry_bids else ())
            rows = _pack_rows(*cols)[order]
            o = _unpack_col(rows, slice(0, 3), dt)
            d = _unpack_col(rows, slice(3, 6), dt)
            life = _unpack_col(rows, 6, dt)
            alive = rows[:, 7] > 0.5
            if carry_bids:
                bids = _unpack_col(rows, 8, jnp.int32)

        hit, t, attrs = backend.closest_hit(
            o, d, alive=alive if block_skip else None)
        live_hit = alive & hit
        # Guard t for dead/miss lanes so position math stays finite.
        t_safe = jnp.where(live_hit, t, 0.0)

        p = o + d * t_safe[..., None]
        life = life - t_safe

        offset_point = p - d * eps

        # --- Echo ray (cs:121-147) + muffle rays (cs:150-175), fused ---
        dist_to_origin, echo_visible, muffle_visible = _secondary_occlusion(
            backend, scene, cfg, offset_point, p, origin, live_hit)
        echo_val = jnp.where(live_hit & echo_visible,
                             dist_to_origin * attrs["echo"], 0.0)
        muffle_inc = muffle_visible & live_hit[..., None]

        # --- Termination + reflection (cs:179-193, 456-532) ---
        bounces_done = step + 1
        can_continue = live_hit & (bounces_done < H) & (life > 0.0)

        normal = intersect.reflection_normal(
            p, attrs["kind"], attrs["center"], attrs["half_extents"],
            attrs["inv_rot"])
        d_new = intersect.reflect(d, normal)
        o_new = p + d_new * eps
        life_new = life - cfg.max_ray_life * attrs["absorption"]
        alive_next = can_continue & (life_new >= 0.0)

        o = jnp.where(can_continue[..., None], o_new, p)
        d = jnp.where(can_continue[..., None], d_new, d)
        life = jnp.where(can_continue, life_new, life)

        if unordered:
            # No restore: lanes stay compacted into the next bounce; the
            # muffle counts reduce to [B, T] right here on the compacted
            # batch ids, and the echo column feeds only sums/histograms.
            # A plain sum (B == 1) or a one-hot matmul (small B) instead
            # of a [R] -> [B] scatter-add inside the loop.
            m = muffle_inc.astype(jnp.float32)
            if B == 1:
                seg = jnp.sum(m, axis=0, keepdims=True)
            else:
                one_hot = (bids[:, None] == jnp.arange(B)[None, :]
                           ).astype(jnp.float32)
                # 0/1 operands: exact even when the matmul runs in TF32.
                seg = jnp.einsum("rb,rt->bt", one_hot, m)
            muffle_acc = muffle_acc + seg.astype(jnp.int32)
            carry = ((o, d, life, alive_next, bids, muffle_acc)
                     if carry_bids
                     else (o, d, life, alive_next, muffle_acc))
            return carry, (t, echo_val)

        outputs = (t, echo_val, muffle_inc, live_hit, p)
        if do_compact:
            # Restore original ray order with ONE packed inverse-perm
            # GATHER over outputs + next-bounce carry (see alive_partition).
            out_rows = _pack_rows(t, echo_val, live_hit, p, muffle_inc,
                                  o, d, life, alive_next)[pos]
            T_ = muffle_inc.shape[-1]
            outputs = (
                _unpack_col(out_rows, 0, t.dtype),
                _unpack_col(out_rows, 1, echo_val.dtype),
                out_rows[:, 6:6 + T_] > 0.5,  # muffle_inc [R, T]
                out_rows[:, 2] > 0.5,  # live_hit
                _unpack_col(out_rows, slice(3, 6), p.dtype),
            )
            o = _unpack_col(out_rows, slice(6 + T_, 9 + T_), dt)
            d = _unpack_col(out_rows, slice(9 + T_, 12 + T_), dt)
            life = _unpack_col(out_rows, 12 + T_, dt)
            alive_next = out_rows[:, 13 + T_] > 0.5
        return (o, d, life, alive_next), outputs

    o0 = jnp.broadcast_to(jnp.asarray(origin, directions.dtype), (R, 3))
    d0 = directions
    life0 = jnp.full((R,), cfg.max_ray_life, directions.dtype)
    alive0 = jnp.ones((R,), bool)
    if pvary_axes:
        # Under shard_map, scan carries must enter with the same
        # varying-manifest-axes type they leave with.
        o0, life0, alive0 = (
            jax.lax.pcast(x, pvary_axes, to="varying")
            for x in (o0, life0, alive0))

    def scan_bounces(carry0):
        """Scan all H bounces; with compaction on, bounce 0 runs OUTSIDE
        the scan with the reorder elided — every ray starts alive, so
        its alive-first partition is the identity permutation and the
        argsort + packed row gathers there are pure cost (exactness
        pinned by the compaction-invariance tests, which compare against
        the uncompacted engine)."""
        if not compact:
            return jax.lax.scan(bounce, carry0, jnp.arange(H), length=H)
        carry1, out0 = bounce(carry0, jnp.int32(0), do_compact=False)
        if H == 1:
            return carry1, jax.tree.map(lambda a: a[None], out0)
        carry_out, outs = jax.lax.scan(bounce, carry1,
                                       jnp.arange(1, H), length=H - 1)
        outs = jax.tree.map(
            lambda a, b: jnp.concatenate([a[None], b], axis=0), out0,
            outs)
        return carry_out, outs

    if unordered:
        acc0 = jnp.zeros((B, T), jnp.int32)
        carry0 = ((o0, d0, life0, alive0, batch_ids, acc0) if carry_bids
                  else (o0, d0, life0, alive0, acc0))
        carry_out, (t_all, echo) = scan_bounces(carry0)
        muffle_hits = carry_out[-1]
        hit_mask = None
    else:
        _, (t_all, echo, muffle_inc, hit_mask, hit_points) = \
            scan_bounces((o0, d0, life0, alive0))
        hit_mask = jnp.moveaxis(hit_mask, 0, 1)  # [R, H]
        # Per-(accum batch, target) muffle counts (the per-thread-batch
        # rows of AudioTargetManager.MuffleRayHits reduced over bounces
        # and rays).
        muffle_per_ray = jnp.sum(muffle_inc.astype(jnp.int32),
                                 axis=0)  # [R, T]
        muffle_hits = jax.ops.segment_sum(
            muffle_per_ray, batch_ids, num_segments=cfg.num_accum_batches)

    # scan stacks outputs on axis 0 = bounce slot; reorder to [R, H].
    echo = jnp.moveaxis(echo, 0, 1)  # [R, H]

    result = TraceResult(
        echo_distances=echo,
        muffle_hits=muffle_hits,
        permeation=jnp.zeros((cfg.num_accum_batches, T), directions.dtype),
        # Primary-ray first hit: reused by ops.permeation so the
        # permeation job does not re-scan the scene for it
        # (AudioPermeationJobBatched.cs:101-141 recomputes; we share).
        # Valid in the unordered tier too: bounce 0's alive mask is all
        # -True, so its partition is the identity permutation.
        first_hit_t=t_all[0],
    )
    if collect_debug:
        result = dataclasses.replace(
            result,
            hit_points=jnp.moveaxis(hit_points, 0, 1),
            hit_counts=jnp.sum(hit_mask.astype(jnp.int32), axis=-1),
        )
    return result
