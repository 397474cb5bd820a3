"""Sharded training step: the full backward over a ('rays','prims') mesh.

Gradient workload (BASELINE config 4) at scale: the loudness-map loss runs
under shard_map — rays data-parallel, primitive arrays (and thus the
learnable material parameters) tensor-parallel over 'prims' — and the
parameter gradients emerge sharded over 'prims' (the reduce-scatter-style
layout; XLA overlaps the psum tree with the backward pass).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import optax
from jax.sharding import PartitionSpec as P

from audio_raytracer_tpu.models.differentiable import (
    Loudness,
    SceneParams,
    loudness_map,
)
from audio_raytracer_tpu.ops.backend import PrimShardedBackend
from audio_raytracer_tpu.parallel.sharded import (
    make_local_engine,
    scene_pspec,
)
from audio_raytracer_tpu.types import Materials, Scene, TraceConfig


def params_pspec(prim_sharded: bool) -> SceneParams:
    prim = P("prims") if prim_sharded else P()
    mat = Materials(absorption=prim, density=prim, echo=prim)
    return SceneParams(sphere=mat, aabb=mat, obb=mat)


def loudness_pspec(with_ir: bool = False) -> Loudness:
    return Loudness(muffle=P(), permeation=P(), reverb_energy=P(),
                    reverb_ir=P() if with_ir else None)


def make_sharded_train_step(cfg: TraceConfig, mesh: jax.sharding.Mesh,
                            optimizer=None, backend: str = "jnp"):
    """Build ``train_step(params, opt_state, scene, origin, dirs, target)``
    jitted over the mesh. ``scene`` carries geometry (materials are taken
    from ``params``); primitive leaves and params are sharded over 'prims',
    directions over 'rays', targets replicated. ``backend``: per-shard
    engine, "jnp" or "pallas" (differentiable kernel tier per shard)."""
    if optimizer is None:
        optimizer = optax.adam(1e-2)
    prim_shards = mesh.shape["prims"]
    prim_sharded = prim_shards > 1
    # Same condition as sharded.py: the kernel engines (compiled and
    # interpreted) break shard_map's vma typing on their fori carries,
    # so vma checking is only enabled for the pure-jnp engine.
    check_vma = backend == "jnp"
    pvary_axes = ("rays",) if check_vma else ()

    def local_loss(params, scene_geom, origin, dirs_local, target):
        scene_local = params.into_scene(scene_geom)
        engine = make_local_engine(scene_local, backend, differentiable=True)
        if prim_sharded:
            backend_ = PrimShardedBackend(scene_local, "prims", prim_shards,
                                          engine=engine)
        else:
            backend_ = engine
        pred = loudness_map(origin, dirs_local, scene_local, cfg,
                            backend=backend_, axis_name="rays",
                            total_ray_count=cfg.ray_count,
                            pvary_axes=pvary_axes)
        loss = (jnp.mean((pred.muffle - target.muffle) ** 2)
                + jnp.mean((pred.permeation - target.permeation) ** 2)
                + (pred.reverb_energy - target.reverb_energy) ** 2)
        # IR term, matching the single-device loudness_loss: pred.reverb_ir
        # is already psum'd over 'rays' inside loudness_map, so the term is
        # shard-invariant.
        if pred.reverb_ir is not None and target.reverb_ir is not None:
            loss = loss + jnp.mean((pred.reverb_ir - target.reverb_ir) ** 2)
        return loss

    loss_fn = jax.shard_map(
        local_loss,
        mesh=mesh,
        in_specs=(params_pspec(prim_sharded), scene_pspec(prim_sharded),
                  P(), P("rays"), loudness_pspec(cfg.num_reverb_bins > 0)),
        out_specs=P(),
        check_vma=check_vma,
    )

    @jax.jit
    def train_step(params, opt_state, scene_geom, origin, directions, target):
        loss, grads = jax.value_and_grad(loss_fn)(
            params, scene_geom, origin, directions, target)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return train_step, optimizer
