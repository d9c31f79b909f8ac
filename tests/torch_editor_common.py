"""Shared helpers of the editor tests (tests/test_torch_editor*.py): the
comparable form of an editor document of either package, and the port's
streamed-runtime render of a saved sector."""

import time

import numpy as np


def entity_key(e):
    """Every field of an EditorEntity of either package, float arrays as
    their f32 bytes (bit-equal or not equal)."""
    arr = lambda a: np.asarray(a, np.float32).tobytes()
    return (e.id, e.name, e.model_id, e.mesh_id, e.material_id, e.albedo_texture_id,
            e.material_flags, e.tags, arr(e.position), arr(e.rotation), arr(e.scale),
            arr(e.aabb_min), arr(e.aabb_max))


def doc_key(doc):
    """An EditorDocument of either package as comparable plain values."""
    return (tuple(doc.sector), [entity_key(doc.entities[i]) for i in doc.entities],
            list(doc.selection), doc.grid_snap, doc.next_id, doc.dirty)


def stack_key(stack):
    return ([type(c).__name__ for c in stack.undo_stack],
            [type(c).__name__ for c in stack.redo_stack])


def streamed_runtime_rgb(world_root, focus, vp, raster, max_draws, n_entities,
                         device="cpu"):
    """The port's runtime path over a saved world: stream its sectors into
    a WorldPartition (capacity 64) around `focus`, cull against vp and
    render at most `max_draws` draws. Returns the rgb [H, W, 3] tensor."""
    from scx_torch.core.config import StreamingBudgets, WorldPartitionConfig
    from scx_torch.render.mesh import build_mesh_pool
    from scx_torch.render.pipeline import DrawList, render_frame
    from scx_torch.state import entity as ent
    from scx_torch.world.culling import cull_entities, emit_draws
    from scx_torch.world.streaming import WorldPartition

    cfg = WorldPartitionConfig(load_radius=0, unload_radius=1)
    wp = WorldPartition(cfg, StreamingBudgets(), capacity=64, world_root=str(world_root))
    state = ent.alloc_entity_state(64, envs=1, device=device)
    try:
        for _ in range(50):
            state = wp.update(state, np.asarray(focus, np.float64),
                              np.asarray([0.0, 0.0, -1.0]))
            if wp.stats.entities == n_entities:
                break
            time.sleep(0.01)
        assert wp.stats.entities == n_entities
    finally:
        wp.shutdown()
    visible, mats = cull_entities(state, vp[None])
    d = emit_draws(state, visible, mats, max_draws)
    draws = DrawList(mesh_id=d.mesh_id[0], material_id=d.material_id[0], model=d.model[0],
                     valid=d.valid[0])
    rgb, _, _ = render_frame(draws, build_mesh_pool(device=device), vp, raster)
    return rgb
