"""Intersection backends: one trace loop, swappable closest-hit engines.

``trace``/``permeation`` are written against this protocol so the same
bounce-loop semantics run on:

- ``DenseBackend``   — the plain engine: every device sees all
                       primitives. Scenes up to ``CHUNK`` primitives are
                       one [R, P] grid; larger scenes fold the primitive
                       axis in ``CHUNK``-sized steps of a ``lax.scan``,
                       so no [R, P] grid is ever live (forward or
                       backward). It is what XLA makes of the plain
                       semantics, and the reference every kernel engine
                       (ops.pallas) is compared and timed against.
- ``PrimShardedBackend`` — primitives sharded over a mesh axis; closest-hit
                       is a pmin merge with scan-order tie-breaking, hit
                       attributes are recovered with a one-shard psum
                       broadcast, occlusion is a pmax-any, permeation loss
                       a psum. This is the 2-D rays x prims sharding of
                       SURVEY.md §2.7 (the reference's analog: every thread
                       reads the full collider arrays; here we split them).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from audio_raytracer_tpu.ops import intersect
from audio_raytracer_tpu.types import Scene

Array = jnp.ndarray

_ATTR_KEYS = ("kind", "center", "half_extents", "inv_rot", "absorption", "echo")
# Python int, NOT a module-level jnp constant: device constants created
# at import cache the first shard_map mesh they're traced under and
# poison later traces over different meshes.
_INT_MAX = 2**31 - 1

# "Skip no audio target" sentinel for multi-set occlusion / permeation
# (real target ids are >= 0; -1 means "prim not owned", so the sentinel
# must be far below -1 to never match).
NO_SKIP = -(2**31)

# Primitives per fold step of the plain engine. XLA stores a step's
# [R, CHUNK] intermediates rather than fusing them into the reductions
# (at 1M rays and CHUNK = 1024 the 5-set occlusion step asked for 108 GB
# of temporaries on an H100), so the chunk bounds those grids.
CHUNK = 128


def _skip_or_none(skip: int):
    return None if skip < 0 else skip


def vma_of(*trees) -> frozenset:
    """Union of the varying-manual-axes types of every array in ``trees``
    (empty outside shard_map)."""
    vma = frozenset()
    for a in jax.tree.leaves(trees):
        vma |= getattr(jax.typeof(a), "vma", None) or frozenset()
    return vma


def vary_like(x: Array, *like) -> Array:
    """Give ``x`` the varying-manual-axes type of every array in ``like``
    (a no-op outside shard_map). Scan carries built from constants must
    enter with the type the body gives them back."""
    missing = tuple(sorted(vma_of(like) - vma_of(x)))
    return jax.lax.pcast(x, missing, to="varying") if missing else x


def _type_chunks(scene: Scene):
    """Per non-empty primitive type: (kind, chunks, base). ``chunks`` is
    the type's pytree padded with inactive zero slots to a CHUNK multiple
    and reshaped [n_chunks, CHUNK, ...]; ``base`` is [n_chunks] scan rank
    of each chunk's first slot ([sphere, aabb, obb] order)."""
    out, base = [], 0
    for kind, prims in enumerate((scene.spheres, scene.aabbs, scene.obbs)):
        n = prims.count
        if n:
            k = -(-n // CHUNK)
            pad = k * CHUNK - n

            def split(x, pad=pad, k=k):
                x = jnp.concatenate(
                    [x, jnp.zeros((pad,) + x.shape[1:], x.dtype)])
                return x.reshape((k, CHUNK) + x.shape[1:])

            out.append((kind, jax.tree.map(split, prims),
                        base + CHUNK * jnp.arange(k, dtype=jnp.int32)))
        base += n
    return out


def _type_t(kind: int, prims, o: Array, d: Array, skip=None) -> Array:
    """[R, C] hit distances (+inf miss) of one type's primitive chunk."""
    if kind == 0:
        t = intersect.sphere_t(o, d, prims.center, prims.radius, prims.active)
    elif kind == 1:
        t = intersect.aabb_t(o, d, prims.center, prims.half_extents,
                             prims.active)
    else:
        t = intersect.obb_t(o, d, prims.center, prims.half_extents,
                            prims.inv_rot, prims.active)
    if skip is not None:
        t = jnp.where(skip == prims.target_id, jnp.inf, t)
    return t


def _min_argmin(t: Array):
    """(min, first argmin) over the last axis in ONE variadic reduction,
    so the [R, C] grid feeding it is fused, never stored."""
    idx = jax.lax.broadcasted_iota(jnp.int32, t.shape, t.ndim - 1)

    def pick(a, b):
        (av, ai), (bv, bi) = a, b
        first = (av < bv) | ((av == bv) & (ai < bi))
        return jnp.where(first, av, bv), jnp.where(first, ai, bi)

    return jax.lax.reduce((t, idx), (jnp.array(jnp.inf, t.dtype),
                                     jnp.int32(0)), pick, (t.ndim - 1,))


_TYPE_CHORDS = (intersect.sphere_chords, intersect.aabb_chords,
                intersect.obb_chords)


class DenseBackend:
    """All primitives visible locally (single device or replicated)."""

    # Closest-hit t carries tangents itself (the grid natively; the fold
    # through its winner recompute), so a PrimShardedBackend wrapper
    # needs no second recompute.
    recompute_winner_t = False

    def __init__(self, scene: Scene):
        self.scene = scene
        self._uni = intersect.unified_arrays(scene) \
            if scene.num_primitives else None
        self._packed = (intersect.packed_unified_table(self._uni)
                        if self._uni is not None else None)
        self.chunked = scene.num_primitives > CHUNK
        # Built here, in the caller's trace: engines live outside the
        # bounce scan that uses them.
        self._types = _type_chunks(scene) if self.chunked else ()

    def _fold(self, step, carry, remat=False):
        """Thread ``carry`` through step(carry, kind, chunk, base) over
        every primitive chunk in scan order. ``remat`` recomputes each
        chunk in the backward pass, so AD keeps only the [R, ...] carries
        per chunk, never a grid."""
        for kind, chunks, base in self._types:
            def body(c, xs, kind=kind):
                return step(c, kind, *xs), None
            if remat:
                body = jax.checkpoint(body)
            carry, _ = jax.lax.scan(body, carry, (chunks, base))
        return carry

    def _closest_fold(self, o: Array, d: Array):
        """(t [R] +inf miss, idx [R]) with the strict-< scan-order
        tie-break: chunks arrive in rank order, so a later chunk wins
        only when strictly closer — the argmin of the one grid."""
        sg = jax.lax.stop_gradient
        o, d = sg(o), sg(d)
        like = (o, d, self.scene)
        init = (vary_like(jnp.full(o.shape[:-1], jnp.inf, o.dtype), *like),
                vary_like(jnp.zeros(o.shape[:-1], jnp.int32), *like))

        def step(carry, kind, chunk, base):
            best_t, best_i = carry
            t_min, i = _min_argmin(_type_t(kind, sg(chunk), o, d))
            upd = t_min < best_t
            return (jnp.where(upd, t_min, best_t),
                    jnp.where(upd, base + i, best_i))

        return self._fold(step, init)

    def _closest(self, o: Array, d: Array):
        """(hit [R], t [R] carrying tangents, idx [R] scan rank)."""
        if not self.chunked:
            return intersect.closest_hit(o, d, self.scene)
        t, idx = self._closest_fold(o, d)
        hit = jnp.isfinite(t)
        u = self._uni
        t_rec = intersect.primitive_t_per_ray(
            o, d, u["kind"][idx], u["center"][idx], u["half_extents"][idx],
            u["inv_rot"][idx])
        # Forward value: the fold's t, exactly. Tangents: the winner's
        # recomputed distance (same derivative as the grid's min).
        t = jnp.where(hit, t + (t_rec - jax.lax.stop_gradient(t_rec)),
                      jnp.inf)
        return hit, t, idx

    def local_closest(self, o: Array, d: Array, alive: Array | None = None):
        """(t [R] (+inf miss), idx [R] int32 in [sphere,aabb,obb] order).

        The local-engine protocol consumed by PrimShardedBackend.
        ``alive`` is accepted for protocol parity and ignored — the plain
        engine computes every lane regardless; callers mask."""
        _, t, idx = self._closest(o, d)
        return t, idx

    def attr_rows(self, idx: Array) -> Array:
        """[..., 16] packed winner-attribute rows for local indices."""
        return self._packed[idx]

    def closest_hit(self, o: Array, d: Array, alive: Array | None = None):
        """Returns (hit [R], t [R], attrs dict of per-ray hit attributes).

        ``alive`` is ignored here (see local_closest)."""
        if self._uni is None:
            t = jnp.full(o.shape[:-1], jnp.inf, o.dtype)
            z3 = jnp.zeros(o.shape, o.dtype)
            attrs = dict(kind=jnp.zeros(t.shape, jnp.int32), center=z3,
                         half_extents=z3,
                         inv_rot=jnp.zeros(o.shape[:-1] + (4,), o.dtype),
                         absorption=jnp.zeros_like(t),
                         echo=jnp.zeros_like(t))
            return jnp.zeros(t.shape, bool), t, attrs
        hit, t, idx = self._closest(o, d)
        attrs = {k: self._uni[k][idx] for k in _ATTR_KEYS}
        return hit, t, attrs

    def closest_t(self, o: Array, d: Array) -> Array:
        if self.scene.num_primitives == 0:
            return jnp.full(o.shape[:-1], jnp.inf, o.dtype)
        if self.chunked:
            return self._closest(o, d)[1]
        t_grid = intersect.scene_t_grid(o, d, self.scene)
        return jnp.min(t_grid, axis=-1)

    @property
    def fused_sets(self) -> bool:
        """Whether the multi-set methods stream the primitives once for
        all ray sets (the fold, the kernels); single-set queries then run
        as one set of them, otherwise the multi-set methods run one
        single-set grid per set."""
        return self.chunked

    def occluded(self, o, d, limit, skip_target_id=None) -> Array:
        if self.scene.num_primitives == 0:
            return jnp.zeros(o.shape[:-1], bool)
        if not self.fused_sets:
            return intersect.any_hit_within(o, d, limit, self.scene,
                                            skip_target_id)
        skip = NO_SKIP if skip_target_id is None else skip_target_id
        limit = jnp.broadcast_to(limit, o.shape[:-1])
        init = jnp.zeros(o.shape[:-1] + (1,), bool)
        return self.multi_occluded(o, [d], limit[..., None], (skip,),
                                   init)[..., 0]

    def permeation_loss(self, o, d, skip_target_id) -> Array:
        if self.scene.num_primitives == 0:
            return jnp.zeros(o.shape[:-1], o.dtype)
        if not self.fused_sets:
            return intersect.permeation_loss(o, d, self.scene,
                                             skip_target_id)
        skip = NO_SKIP if skip_target_id is None else skip_target_id
        return self.multi_permeation_loss(o, [d], (skip,))[..., 0]

    def multi_occluded(self, o, dirs, limits, skips, init_occ) -> Array:
        """Occlusion over S ray sets sharing one origin.

        o: [R,3]; dirs: list of S [R,3]; limits: [R,S]; skips: static
        tuple (NO_SKIP or a target id per set); init_occ: [R,S] bool
        pre-resolved lanes. Returns [R,S] bool (init lanes come back
        True). Occlusion is a running OR over the primitive chunks."""
        if not self.chunked:
            cols = [
                self.occluded(o, dirs[s], limits[..., s],
                              skip_target_id=_skip_or_none(skips[s]))
                | init_occ[..., s]
                for s in range(len(dirs))
            ]
            return jnp.stack(cols, axis=-1)
        sg = jax.lax.stop_gradient
        o, dirs, limits = sg(o), [sg(d) for d in dirs], sg(limits)

        def step(occ, kind, chunk, base):
            cols = []
            for s, d in enumerate(dirs):
                t = _type_t(kind, sg(chunk), o, d, _skip_or_none(skips[s]))
                cols.append(occ[..., s]
                            | jnp.any(t < limits[..., s, None], axis=-1))
            return jnp.stack(cols, axis=-1)

        return self._fold(step, vary_like(init_occ, o, dirs, limits,
                                          self.scene))

    def multi_permeation_loss(self, o, dirs, skips) -> Array:
        """[R, S] permeation chord-loss sums for S target ray sets; chord
        sums add up over the primitive chunks."""
        if not self.chunked:
            cols = [
                self.permeation_loss(o, dirs[s],
                                     skip_target_id=_skip_or_none(skips[s]))
                for s in range(len(dirs))
            ]
            return jnp.stack(cols, axis=-1)
        like = (o, dirs, self.scene)
        init = vary_like(jnp.zeros(o.shape[:-1] + (len(dirs),), o.dtype),
                         *like)

        def step(acc, kind, chunk, base):
            return acc + jnp.stack(
                [jnp.sum(_TYPE_CHORDS[kind](o, d, chunk,
                                            _skip_or_none(skips[s])),
                         axis=-1)
                 for s, d in enumerate(dirs)], axis=-1)

        return self._fold(step, init, remat=True)


class PrimShardedBackend:
    """Primitive axis sharded over mesh axis ``axis_name``.

    ``scene`` is the LOCAL shard (even per-type split; pad with inactive
    primitives via parallel.mesh.pad_scene_for_prim_shards). Tie-breaking
    reproduces the reference scan order globally: local concat order is
    type-major ([sphere, aabb, obb]) and each shard holds a contiguous
    slice of each type array, so a global "scan rank" is local rank +
    per-type shard offset; the cross-shard winner is the min (t, rank).

    Local intersection work is delegated to an ``engine`` (the local-
    engine protocol: local_closest / attr_rows / closest_t / occluded /
    permeation_loss) — DenseBackend by default, or a PallasBackend so
    each shard streams its primitive slice through the kernels; this
    class only owns the cross-shard collectives.
    """

    def __init__(self, scene: Scene, axis_name: str, num_shards: int,
                 engine=None):
        self.scene = scene
        self.axis = axis_name
        self.num_shards = num_shards
        self.engine = DenseBackend(scene) if engine is None else engine

    def _global_ranks(self):
        """[P_local] global scan rank of each local primitive."""
        s = jax.lax.axis_index(self.axis)
        ns, na, nb = (self.scene.spheres.count, self.scene.aabbs.count,
                      self.scene.obbs.count)
        gs, ga = ns * self.num_shards, na * self.num_shards
        ranks = jnp.concatenate([
            s * ns + jnp.arange(ns, dtype=jnp.int32),
            gs + s * na + jnp.arange(na, dtype=jnp.int32),
            gs + ga + s * nb + jnp.arange(nb, dtype=jnp.int32),
        ])
        return ranks

    def _merge_min(self, t_loc: Array, rank_loc: Array):
        """Cross-shard (t, global-rank) min with scan-order tie-break.

        The pmin votes run on stop-gradded values (pmin has no AD rule);
        returns (t_min sg'd, winner mask, t_diff) where ``t_diff`` equals
        t_min in value but carries the winning shard's tangents.
        """
        ts = jax.lax.stop_gradient(t_loc)
        t_min = jax.lax.pmin(ts, self.axis)
        cand = (ts == t_min) & jnp.isfinite(ts)
        rank = jnp.where(cand, rank_loc, _INT_MAX)
        rank_min = jax.lax.pmin(rank, self.axis)
        winner = cand & (rank_loc == rank_min)
        t_diff = t_min + jax.lax.psum(
            jnp.where(winner, t_loc - ts, 0.0), self.axis)
        return t_min, winner, t_diff

    @property
    def supports_block_skip(self) -> bool:
        """Delegated: aliveness compaction helps iff the local engine's
        kernels can skip fully-dead ray blocks."""
        return getattr(self.engine, "supports_block_skip", False)

    def closest_hit(self, o: Array, d: Array, alive: Array | None = None):
        t_loc, idx = self.engine.local_closest(o, d, alive=alive)
        rank_loc = self._global_ranks()[idx]
        t_min, winner, t_diff = self._merge_min(t_loc, rank_loc)

        # One psum broadcast of the winner's packed attribute row
        # (zeros contributed by losing shards).
        rows_loc = self.engine.attr_rows(idx).astype(jnp.float32)
        rows = jax.lax.psum(jnp.where(winner[..., None], rows_loc, 0.0),
                            self.axis)
        attrs = intersect.unpack_attr_rows(rows)
        hit = jnp.isfinite(t_min)
        if getattr(self.engine, "recompute_winner_t", False):
            # Winner-recompute so the merged distance carries tangents to
            # poses even when the local engine's t is stop-gradded
            # (PallasBackend kernels).
            t_rec = intersect.primitive_t_per_ray(
                o.astype(jnp.float32), d.astype(jnp.float32), attrs["kind"],
                attrs["center"], attrs["half_extents"], attrs["inv_rot"])
            t_out = jnp.where(hit, t_rec, jnp.inf)
        else:
            t_out = t_diff  # local t already carries tangents
        return hit, t_out, attrs

    def closest_t(self, o: Array, d: Array) -> Array:
        if getattr(self.engine, "recompute_winner_t", False):
            _, t, _ = self.closest_hit(o, d)
            return t
        t_loc, idx = self.engine.local_closest(o, d)
        _, _, t_diff = self._merge_min(t_loc, self._global_ranks()[idx])
        return t_diff

    def occluded(self, o, d, limit, skip_target_id=None) -> Array:
        local = self.engine.occluded(o, d, limit, skip_target_id)
        return jax.lax.pmax(local.astype(jnp.int32), self.axis) > 0

    def permeation_loss(self, o, d, skip_target_id) -> Array:
        local = self.engine.permeation_loss(o, d, skip_target_id)
        return jax.lax.psum(local, self.axis)

    def multi_occluded(self, o, dirs, limits, skips, init_occ) -> Array:
        local = self.engine.multi_occluded(o, dirs, limits, skips, init_occ)
        return jax.lax.pmax(local.astype(jnp.int32), self.axis) > 0

    def multi_permeation_loss(self, o, dirs, skips) -> Array:
        local = self.engine.multi_permeation_loss(o, dirs, skips)
        return jax.lax.psum(local, self.axis)
