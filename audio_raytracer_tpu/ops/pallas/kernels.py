"""Pallas kernels for the rays x primitives hot loops, on the Triton route.

Replaces the Burst SIMD tier of the reference
(Jobs/AudioRaytracerJobBatched.cs:225-449, AudioPermeationJobBatched.cs)
with three kernels shaped for an NVIDIA Hopper card, one result each:

- ``closest_hit``: running (t, scan rank) minimum per ray.
- ``multi_any_hit``: occlusion of S ray sets that share one origin (the
  bounce's echo ray and one muffle ray per audio target). Each
  primitive's fields and origin-only terms are loaded and computed once
  and reused by all S sets.
- ``multi_chord``: permeation chord x density sums for S target sets.

Layout:

- A program owns ``BLOCK_R`` rays as 1-D blocks, one thread per ray
  (``NUM_WARPS`` x 32 = ``BLOCK_R``). Rays are padded to a block
  multiple by the wrappers; padding lanes are dead / pre-resolved.
- Primitives stay in global memory as row-packed per-type tables
  (``pack_tables``: one sphere is one 32-byte row, one AABB 64 bytes,
  one OBB 128 bytes). The in-kernel ``fori_loop`` reads a primitive's
  fields as scalars: every thread of a program loads the same address,
  so a load is an L1 broadcast, and the whole scene (~300 KB at 4K
  primitives) stays resident in L2. No primitive count cap, no [R, P]
  grid in device memory.
- The sequential primitive loop reproduces the reference's scan order
  (spheres, then AABBs, then OBBs, strict ``<`` update — earlier rank
  wins ties) exactly, because it IS a sequential scan.
- Inactive slots encode guaranteed misses (negative squared radius for
  spheres, a +inf ``miss`` add for boxes).

Reduced precision (``dtype=bfloat16``): ray blocks and primitive fields
enter the per-pair geometry arithmetic in bf16; reciprocals, square
roots, hit distances, decisions and sums stay f32. It degrades
secondary-ray semantics at world scales >> 1 (the reference's 1e-4
hit-point offset, AudioRaytracerJobBatched.cs:57, is below bf16
resolution at ~100 m coordinates), so f32 is the default; bf16 is
parity-tested at documented tolerances (tests/test_bf16.py) — set
``TraceConfig.epsilon >= world_scale * 2**-8`` with it.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from audio_raytracer_tpu.ops import quaternion
from audio_raytracer_tpu.ops.backend import NO_SKIP, vma_of

# Rays per program, one per thread. A power of two (Triton blocks are).
BLOCK_R = 128
NUM_WARPS = BLOCK_R // 32
NUM_STAGES = 2
# The occlusion kernel checks every this many primitives whether all of
# its lanes are resolved, and leaves the primitive loop if so.
EXIT_EVERY = 32
# Python literals (not jnp constants): the kernel must not capture arrays.
INT_MAX = 2**31 - 1
BIG = 3.0e38

# Row layouts of the per-type primitive tables (column name -> index).
SPHERE_COLS = {k: i for i, k in enumerate(
    ("cx", "cy", "cz", "r2", "tgt", "dens"))}
AABB_COLS = {k: i for i, k in enumerate(
    ("minx", "miny", "minz", "maxx", "maxy", "maxz", "miss", "tgt",
     "dens"))}
OBB_COLS = {k: i for i, k in enumerate(
    ("cx", "cy", "cz", "hx", "hy", "hz",
     "m00", "m01", "m02", "m10", "m11", "m12", "m20", "m21", "m22",
     "miss", "tgt", "dens"))}
_WIDTHS = (8, 16, 32)


def _table(cols: dict, width: int) -> jax.Array:
    n = next(iter(cols.values())).shape[0]
    tab = jnp.stack([jnp.asarray(v, jnp.float32).reshape(n)
                     for v in cols.values()], axis=1)
    return jnp.pad(tab, ((0, 0), (0, width - tab.shape[1])))


def pack_tables(scene) -> tuple:
    """(spheres [ns, 8], aabbs [na, 16], obbs [no, 32]) f32 row tables in
    the *_COLS layouts; None for an empty type. Target ids are stored
    as floats (exact for |id| < 2**24)."""
    sp, ab, ob = scene.spheres, scene.aabbs, scene.obbs
    tabs = [None, None, None]
    if sp.count:
        tabs[0] = _table(dict(
            cx=sp.center[:, 0], cy=sp.center[:, 1], cz=sp.center[:, 2],
            r2=jnp.where(sp.active, sp.radius * sp.radius, -1e30),
            tgt=sp.target_id, dens=sp.material.density), _WIDTHS[0])
    if ab.count:
        lo = ab.center - ab.half_extents
        hi = ab.center + ab.half_extents
        tabs[1] = _table(dict(
            minx=lo[:, 0], miny=lo[:, 1], minz=lo[:, 2],
            maxx=hi[:, 0], maxy=hi[:, 1], maxz=hi[:, 2],
            miss=jnp.where(ab.active, 0.0, jnp.inf),
            tgt=ab.target_id, dens=ab.material.density), _WIDTHS[1])
    if ob.count:
        # World->local rotation baked to matrix rows (quaternion.to_matrix
        # of the pre-inverted quaternion, mirroring AudioOBBCollider.cs:59's
        # bake-time inverse): 15 mul-adds per vector.
        m = quaternion.to_matrix(jnp.asarray(ob.inv_rot, jnp.float32))
        tabs[2] = _table(dict(
            cx=ob.center[:, 0], cy=ob.center[:, 1], cz=ob.center[:, 2],
            hx=ob.half_extents[:, 0], hy=ob.half_extents[:, 1],
            hz=ob.half_extents[:, 2],
            **{f"m{i}{j}": m[:, i, j] for i in range(3) for j in range(3)},
            miss=jnp.where(ob.active, 0.0, jnp.inf),
            tgt=ob.target_id, dens=ob.material.density), _WIDTHS[2])
    return tuple(tabs)


def table_counts(tabs) -> tuple:
    return tuple(0 if t is None else t.shape[0] for t in tabs)


# ---------------------------------------------------------------------------
# Per-pair math (one scalar primitive vs a [BLOCK_R] ray block)
# ---------------------------------------------------------------------------


def _f32(x):
    return x.astype(jnp.float32)


def _safe_dir(d):
    # Zero-axis nudge, mirroring ops/intersect._aabb_slab.
    return jnp.where(jnp.abs(d) < 1e-12, jnp.where(d >= 0, 1e-12, -1e-12), d)


def _recip(d, cdt):
    """1 / safe_dir(d), divided in f32, returned in the compute dtype."""
    return (1.0 / _safe_dir(_f32(d))).astype(cdt)


class _Row:
    """Scalar field loader for primitive ``p`` of one table."""

    def __init__(self, ref, cols, p, cdt):
        self._ref, self._cols, self._p, self._cdt = ref, cols, p, cdt

    def raw(self, name):
        return self._ref[self._p, self._cols[name]]

    def __getitem__(self, name):
        return self.raw(name).astype(self._cdt)

    def rotate(self, vx, vy, vz):
        """World -> OBB-local rotation by the baked matrix rows."""
        m = self.__getitem__
        return (m("m00") * vx + m("m01") * vy + m("m02") * vz,
                m("m10") * vx + m("m11") * vy + m("m12") * vz,
                m("m20") * vx + m("m21") * vy + m("m22") * vz)


def _slab(mnx, mny, mnz, mxx, mxy, mxz, ix, iy, iz):
    """(t_near, t_far) f32 from (bound - origin) terms and inverse dirs."""
    t0x, t1x = mnx * ix, mxx * ix
    t0y, t1y = mny * iy, mxy * iy
    t0z, t1z = mnz * iz, mxz * iz
    t_near = jnp.maximum(jnp.maximum(jnp.minimum(t0x, t1x),
                                     jnp.minimum(t0y, t1y)),
                         jnp.minimum(t0z, t1z))
    t_far = jnp.minimum(jnp.minimum(jnp.maximum(t0x, t1x),
                                    jnp.maximum(t0y, t1y)),
                        jnp.maximum(t0z, t1z))
    return _f32(t_near), _f32(t_far)


def _slab_hit_t(t_near, t_far):
    """Reference select (AudioRaytracerJobBatched.cs:284-308): t_near if
    > 0 else t_far; BIG on miss."""
    miss = (t_near > t_far) | (t_far < 0.0)
    return jnp.where(miss, BIG, jnp.where(t_near > 0.0, t_near, t_far))


def _aabb_bounds(row, ox, oy, oz):
    return (row["minx"] - ox, row["miny"] - oy, row["minz"] - oz,
            row["maxx"] - ox, row["maxy"] - oy, row["maxz"] - oz)


def _obb_bounds(row, ox, oy, oz):
    """(bound - local origin) terms of OBB ``row``."""
    lox, loy, loz = row.rotate(ox - row["cx"], oy - row["cy"],
                               oz - row["cz"])
    hx, hy, hz = row["hx"], row["hy"], row["hz"]
    return (-hx - lox, -hy - loy, -hz - loz, hx - lox, hy - loy, hz - loz)


def _obb_inv_dir(row, dx, dy, dz, cdt):
    ldx, ldy, ldz = row.rotate(dx, dy, dz)
    return _recip(ldx, cdt), _recip(ldy, cdt), _recip(ldz, cdt)


# ---------------------------------------------------------------------------
# Loop drivers
# ---------------------------------------------------------------------------


def _type_loops(counts, tab_refs, cdt, bodies, carry, n_scale=1):
    """Run each non-empty type's primitive loop in scan order. ``bodies``
    are (row, rank, carry) -> carry per type; ``n_scale`` (0 or 1, may be
    traced) lets a program skip every loop."""
    base = 0
    for n, ref, body, cols in zip(counts, tab_refs, bodies,
                                  (SPHERE_COLS, AABB_COLS, OBB_COLS)):
        if n:
            def step(p, c, ref=ref, body=body, cols=cols, base=base):
                return body(_Row(ref, cols, p, cdt), base + p, c)
            carry = jax.lax.fori_loop(0, n * n_scale, step, carry)
        base += n
    return carry


def _unresolved(accs):
    """int32 scalar: 1 while any lane of any set still needs primitives."""
    return (jnp.min(functools.reduce(jnp.minimum, accs)) < 0.5).astype(
        jnp.int32)


def _stream_until_resolved(counts, tab_refs, cdt, bodies, accs):
    """_type_loops in EXIT_EVERY-primitive steps; once every lane of the
    program is resolved the remaining steps run empty inner loops."""
    for n, ref, body, cols in zip(counts, tab_refs, bodies,
                                  (SPHERE_COLS, AABB_COLS, OBB_COLS)):
        if not n:
            continue

        def step(p, c, ref=ref, body=body, cols=cols):
            return body(_Row(ref, cols, p, cdt), p, c)

        def chunk(k, state, n=n, step=step):
            live, c = state
            lo = k * EXIT_EVERY
            hi = lo + live * (jnp.minimum(lo + EXIT_EVERY, n) - lo)
            c = jax.lax.fori_loop(lo, hi, step, c)
            return _unresolved(c), c

        _, accs = jax.lax.fori_loop(0, pl.cdiv(n, EXIT_EVERY), chunk,
                                    (_unresolved(accs), accs))
    return accs


# ---------------------------------------------------------------------------
# Kernel bodies
# ---------------------------------------------------------------------------


def closest_hit_kernel(counts, cdt, *refs):
    """One ray block vs all primitives -> (t_min f32 (BIG miss), rank).

    The loops ARE the reference scan (sphere -> AABB -> OBB, strict <
    update: AudioRaytracerJobBatched.cs:225-280). ``av`` is per-lane
    aliveness: a block with no live lane skips every primitive loop and
    reports all-miss (the reference's per-ray early exit,
    AudioRaytracerJobBatched.cs:104, at block granularity; ops.trace
    compacts rays by aliveness so dead lanes pool into whole blocks)."""
    ox, oy, oz, dx, dy, dz = (r[...] for r in refs[:6])
    av = refs[6][...]
    tab_refs = _with_gaps(counts, refs[7:-2])
    t_out, i_out = refs[-2:]

    ix, iy, iz = _recip(dx, cdt), _recip(dy, cdt), _recip(dz, cdt)
    a2 = 2.0 * _f32(dx * dx + dy * dy + dz * dz)
    inv2a = 1.0 / a2

    def update(rank, t, carry):
        bt, bi = carry
        upd = t < bt
        return jnp.where(upd, t, bt), jnp.where(upd, rank, bi)

    def sphere(row, rank, carry):
        # Full quadratic with a = dot(d, d), near root preferred
        # (AudioRaytracerJobBatched.cs:323-355).
        ocx, ocy, ocz = ox - row["cx"], oy - row["cy"], oz - row["cz"]
        b = 2.0 * _f32(ocx * dx + ocy * dy + ocz * dz)
        cc = _f32(ocx * ocx + ocy * ocy + ocz * ocz) - row.raw("r2")
        disc = b * b - a2 * 2.0 * cc
        hit = disc >= 0.0
        sq = jnp.sqrt(jnp.where(hit, disc, 1.0))
        t0 = (-b - sq) * inv2a
        t1 = (-b + sq) * inv2a
        t = jnp.where(t0 >= 0.0, t0, jnp.where(t1 >= 0.0, t1, BIG))
        return update(rank, jnp.where(hit, t, BIG), carry)

    def aabb(row, rank, carry):
        t = _slab_hit_t(*_slab(*_aabb_bounds(row, ox, oy, oz), ix, iy, iz))
        return update(rank, t + row.raw("miss"), carry)

    def obb(row, rank, carry):
        inv = _obb_inv_dir(row, dx, dy, dz, cdt)
        t = _slab_hit_t(*_slab(*_obb_bounds(row, ox, oy, oz), *inv))
        return update(rank, t + row.raw("miss"), carry)

    live = (jnp.max(av) > 0.5).astype(jnp.int32)
    init = (jnp.full(av.shape, BIG, jnp.float32),
            jnp.full(av.shape, INT_MAX, jnp.int32))
    t, idx = _type_loops(counts, tab_refs, cdt, (sphere, aabb, obb), init,
                         n_scale=live)
    t_out[...] = t
    i_out[...] = idx


def multi_any_hit_kernel(counts, skips, cdt, *refs):
    """Per ray block: S occlusion flags (1.0 = ray set s occluded).

    ``skips`` is a static tuple of per-set audio-target ids whose own
    colliders are skipped (CanRaySeeAudioTarget's AudioTargetId
    exclusion, AudioRaytracerJobBatched.cs:405-449); NO_SKIP for the
    echo set. Lanes enter with their ``init`` bit (1.0 = moot: dead ray,
    target out of range); a program leaves the primitive loop once all
    of its lanes are resolved.

    Directions MUST be normalized (they are: safe_normalize in
    ops.trace) — the sphere test exploits |d| == 1 to resolve the
    reference's root-select semantics (cs:323-355: t = t0 if t0 >= 0
    else t1 if t1 >= 0 else miss; occluded iff t < lim) entirely in the
    sign domain, with no sqrt and no division:
      h = oc . d, c = |oc|^2 - r^2, roots t0/t1 = -h -/+ sqrt(h^2 - c)
      t0 >= 0        <=> h <= 0 and c >= 0
      t0 <  lim      <=> h + lim > 0  or  q(lim) < 0
      t1 in [0, lim) <=> c < 0 branch: h + lim > 0 and q(lim) > 0
    where q(lim) = lim^2 + 2 h lim + c is the quadratic at t = lim.
    """
    S = len(skips)
    ox, oy, oz = (r[...] for r in refs[:3])
    sets = []
    for s in range(S):
        dx, dy, dz, lim, ini = (r[...] for r in refs[3 + 5 * s:8 + 5 * s])
        sets.append(dict(dx=dx, dy=dy, dz=dz, lim=lim, ini=ini,
                         ix=_recip(dx, cdt), iy=_recip(dy, cdt),
                         iz=_recip(dz, cdt)))
    tab_refs = _with_gaps(counts, refs[3 + 5 * S:-S])
    outs = refs[-S:]

    def mark(accs, occ, row):
        new = []
        for s, acc in enumerate(accs):
            o = occ[s]
            if skips[s] != NO_SKIP:
                o = o & (row.raw("tgt") != float(skips[s]))
            new.append(jnp.where(o, 1.0, acc))
        return tuple(new)

    def sphere(row, rank, accs):
        ocx, ocy, ocz = ox - row["cx"], oy - row["cy"], oz - row["cz"]
        c = _f32(ocx * ocx + ocy * ocy + ocz * ocz) - row.raw("r2")
        occ = []
        for st in sets:
            h = _f32(ocx * st["dx"] + ocy * st["dy"] + ocz * st["dz"])
            lim = st["lim"]
            hl = h + lim
            q = lim * (hl + h) + c  # lim^2 + 2 h lim + c
            entering = (c >= 0.0) & (h <= 0.0) & ((hl > 0.0) | (q < 0.0))
            inside = (c < 0.0) & (hl > 0.0) & (q > 0.0)
            occ.append((h * h >= c) & (entering | inside))
        return mark(accs, occ, row)

    def aabb(row, rank, accs):
        b = _aabb_bounds(row, ox, oy, oz)
        miss = row.raw("miss")
        occ = [_slab_hit_t(*_slab(*b, st["ix"], st["iy"], st["iz"])) + miss
               < st["lim"] for st in sets]
        return mark(accs, occ, row)

    def obb(row, rank, accs):
        b = _obb_bounds(row, ox, oy, oz)
        miss = row.raw("miss")
        occ = []
        for st in sets:
            inv = _obb_inv_dir(row, st["dx"], st["dy"], st["dz"], cdt)
            occ.append(_slab_hit_t(*_slab(*b, *inv)) + miss < st["lim"])
        return mark(accs, occ, row)

    accs = _stream_until_resolved(counts, tab_refs, cdt, (sphere, aabb, obb),
                                  tuple(st["ini"] for st in sets))
    for out, acc in zip(outs, accs):
        out[...] = acc


def multi_chord_kernel(counts, skips, cdt, *refs):
    """Per ray block: S permeation chord x density sums in one primitive
    stream (AudioPermeationJobBatched.cs:225-328 for all targets at
    once). Directions are normalized (half-b sphere quadratic); the sums
    accumulate in f32."""
    S = len(skips)
    ox, oy, oz = (r[...] for r in refs[:3])
    sets = []
    for s in range(S):
        dx, dy, dz = (r[...] for r in refs[3 + 3 * s:6 + 3 * s])
        sets.append(dict(dx=dx, dy=dy, dz=dz, ix=_recip(dx, cdt),
                         iy=_recip(dy, cdt), iz=_recip(dz, cdt)))
    tab_refs = _with_gaps(counts, refs[3 + 3 * S:-S])
    outs = refs[-S:]

    def add(accs, chords, row):
        tgt, dens = row.raw("tgt"), row.raw("dens")
        return tuple(acc + jnp.where(ok & (tgt != float(skips[s])), ch, 0.0)
                     * dens for s, (acc, (ok, ch)) in
                     enumerate(zip(accs, chords)))

    def box_chord(t_near, t_far, live):
        ok = (t_near <= t_far) & (t_far >= 0.0) & live
        return ok, jnp.maximum(0.0, t_far - jnp.maximum(t_near, 0.0))

    def sphere(row, rank, accs):
        ocx, ocy, ocz = ox - row["cx"], oy - row["cy"], oz - row["cz"]
        cc = _f32(ocx * ocx + ocy * ocy + ocz * ocz) - row.raw("r2")
        chords = []
        for st in sets:
            b = _f32(ocx * st["dx"] + ocy * st["dy"] + ocz * st["dz"])
            disc = b * b - cc
            hit = disc >= 0.0
            sq = jnp.sqrt(jnp.where(hit, disc, 1.0))
            t_exit = -b + sq
            chord = jnp.maximum(0.0, t_exit - jnp.maximum(-b - sq, 0.0))
            chords.append((hit & (t_exit >= 0.0), chord))
        return add(accs, chords, row)

    def aabb(row, rank, accs):
        b = _aabb_bounds(row, ox, oy, oz)
        live = row.raw("miss") == 0.0
        return add(accs, [box_chord(*_slab(*b, st["ix"], st["iy"],
                                           st["iz"]), live)
                          for st in sets], row)

    def obb(row, rank, accs):
        b = _obb_bounds(row, ox, oy, oz)
        live = row.raw("miss") == 0.0
        chords = []
        for st in sets:
            inv = _obb_inv_dir(row, st["dx"], st["dy"], st["dz"], cdt)
            chords.append(box_chord(*_slab(*b, *inv), live))
        return add(accs, chords, row)

    zero = jnp.zeros(ox.shape, jnp.float32)
    accs = _type_loops(counts, tab_refs, cdt, (sphere, aabb, obb),
                       (zero,) * S)
    for out, acc in zip(outs, accs):
        out[...] = acc


def _with_gaps(counts, present):
    """Table refs in [sphere, aabb, obb] slots (None for empty types)."""
    it = iter(present)
    return [next(it) if n else None for n in counts]


# ---------------------------------------------------------------------------
# Host-side wrappers
# ---------------------------------------------------------------------------


def _padded_rays(R: int) -> int:
    return -(-R // BLOCK_R) * BLOCK_R


def _pad(x, rp, fill=0.0, dtype=None):
    """[R] -> [rp] with ``fill`` in the padding lanes."""
    if dtype is not None:
        x = x.astype(dtype)
    if x.shape[0] != rp:
        x = jnp.concatenate([x, jnp.full((rp - x.shape[0],), fill, x.dtype)])
    return x


def _call(kernel, rays, tabs, out_dtypes, interpret):
    """pallas_call over ray blocks; tables are passed whole."""
    rp = rays[0].shape[0]
    tabs = [t for t in tabs if t is not None]
    # Outputs vary over every mesh axis any input varies over, so the
    # call type-checks under shard_map.
    vma = vma_of(rays, tabs)
    ray_spec = pl.BlockSpec((BLOCK_R,), lambda i: (i,))
    return pl.pallas_call(
        kernel,
        grid=(rp // BLOCK_R,),
        in_specs=[ray_spec] * len(rays) + [pl.no_block_spec] * len(tabs),
        out_specs=[ray_spec] * len(out_dtypes),
        out_shape=[jax.ShapeDtypeStruct((rp,), dt, vma=vma)
                   for dt in out_dtypes],
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=NUM_WARPS,
                                                num_stages=NUM_STAGES),
        interpret=interpret,
    )(*rays, *tabs)


def _xyz(v, rp, dtype):
    return [_pad(v[:, k], rp, dtype=dtype) for k in range(3)]


def run_closest_hit(tabs, o, d, alive=None, interpret=False,
                    dtype=jnp.float32):
    """o, d: [R, 3] -> (t [R] f32 (+inf miss), rank [R] int32; INT_MAX
    on miss). ``alive``: optional [R] bool — blocks whose lanes are ALL
    dead skip the primitive loops and report miss (callers mask dead
    lanes of mixed blocks themselves)."""
    R = o.shape[0]
    rp = _padded_rays(R)
    av = jnp.ones((R,), jnp.float32) if alive is None else alive.astype(
        jnp.float32)
    rays = _xyz(o, rp, dtype) + _xyz(d, rp, dtype) + [_pad(av, rp)]
    kernel = functools.partial(closest_hit_kernel, table_counts(tabs),
                               dtype)
    t, idx = _call(kernel, rays, tabs, (jnp.float32, jnp.int32), interpret)
    t = t[:R]
    return jnp.where(t >= BIG, jnp.inf, t), idx[:R]


def run_multi_any_hit(tabs, o, dirs, limits, skips, init_occ,
                      interpret=False, dtype=jnp.float32):
    """Occlusion over S ray sets sharing one origin.

    o: [R, 3]; dirs: list of S [R, 3] (MUST be normalized — the sphere
    test assumes |d| == 1); limits: [R, S]; skips: static tuple of S
    ints (NO_SKIP = no exclusion); init_occ: [R, S] bool lanes whose
    test is moot (pre-marked occluded). Returns occ [R, S] bool
    (init_occ lanes come back True)."""
    R = o.shape[0]
    rp = _padded_rays(R)
    rays = _xyz(o, rp, dtype)
    for s, d in enumerate(dirs):
        # Padding lanes enter resolved so they never hold a program in
        # its primitive loop.
        rays += _xyz(d, rp, dtype) + [
            _pad(limits[:, s].astype(jnp.float32), rp),
            _pad(init_occ[:, s].astype(jnp.float32), rp, fill=1.0)]
    kernel = functools.partial(multi_any_hit_kernel, table_counts(tabs),
                               tuple(skips), dtype)
    outs = _call(kernel, rays, tabs, (jnp.float32,) * len(dirs), interpret)
    return jnp.stack([x[:R] > 0.5 for x in outs], axis=-1)


def run_multi_chord(tabs, o, dirs, skips, interpret=False,
                    dtype=jnp.float32):
    """[R, S] f32 permeation chord-loss sums for S target ray sets
    (dirs normalized; ``dtype`` is the chord-test compute dtype)."""
    R = o.shape[0]
    rp = _padded_rays(R)
    rays = _xyz(o, rp, dtype)
    for d in dirs:
        rays += _xyz(d, rp, dtype)
    kernel = functools.partial(multi_chord_kernel, table_counts(tabs),
                               tuple(skips), dtype)
    outs = _call(kernel, rays, tabs, (jnp.float32,) * len(dirs), interpret)
    return jnp.stack([x[:R] for x in outs], axis=-1)
