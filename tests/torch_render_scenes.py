"""Small render scenes shared by the port's render tests (not a test file).

`scene_arrays`: a ground slab that runs behind the camera (so it crosses
the near plane and is clipped) under a few cubes at seeded positions and
yaws, as numpy arrays, so that scx and the port can be given the same
inputs. `city_setup`: a small cut of the city frame."""

import numpy as np

from scx_torch.ops import raster_clusters as trc
from scx_torch.render import city
from scx_torch.render import pipeline as tp

EYE, TARGET, UP = (1.5, 1.2, 2.5), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0)


def _trs(pos, yaw, scale):
    c, s = np.cos(yaw), np.sin(yaw)
    m = np.eye(4)
    m[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]]) * np.asarray(scale)[None, :]
    m[:3, 3] = pos
    return m.astype(np.float32)


def scene_arrays(n_cubes=6, seed=3):
    """(mesh_id, material_id, model [D,4,4] f32, valid) of a slab + cubes."""
    rng = np.random.default_rng(seed)
    models = [_trs((0.0, -0.55, -10.0), 0.0, (40.0, 0.1, 40.0))]
    for _ in range(n_cubes):
        pos = (rng.uniform(-1.6, 1.6), rng.uniform(-0.2, 0.4), rng.uniform(-1.6, 1.0))
        models.append(_trs(pos, rng.uniform(0, 3), rng.uniform(0.4, 0.9, 3)))
    d = len(models)
    return (np.zeros(d, np.int32), np.arange(d, dtype=np.int32) % 3,
            np.stack(models), np.ones(d, bool))


def params(width=256, height=64, tile_h=16, tile_w=64, **kw):
    base = dict(width=width, height=height, tile_h=tile_h, tile_w=tile_w, max_tris=512,
                max_tris_per_tile=64, max_clusters_per_tile=8, clip_extra=128)
    return tp.RasterParams(**{**base, **kw})


def city_setup(width=256, height=128, tile_h=32, tile_w=64, grid=3, subdiv=2, ground=4,
               max_tris=2048, kc=16, k=128, device="cpu"):
    """(params, setup, aabb, valid) of a small city frame through the port's
    setup: long tile lists, occlusion, so the hierarchical-z exit fires."""
    fr = city.build_city_frame(device, grid=grid, subdiv=subdiv, ground=ground, width=width,
                               height=height, tile_h=tile_h, tile_w=tile_w,
                               max_tris=max_tris, max_clusters_per_tile=kc)
    p = fr.params.replace(max_tris_per_tile=k)
    return (p, *tp.setup_triangles(fr.draws, fr.pool, fr.view_proj, p))


def cluster_lists(params, setup, aabb, valid, zsort=True):
    """(ids, counts, cl_zmin) as a frame builds them (zsort: near-to-far)."""
    ids, counts, cl_zmin, _ = trc.frame_cluster_lists(setup, aabb, valid,
                                                      params.replace(sort_draws=zsort))
    return ids, counts, cl_zmin
