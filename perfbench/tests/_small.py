"""A cell of the benchmark cut to a size the CPU runs in seconds: the
cell's own traffic mix, limits and metrics with a small configuration of
the same family (widths 32, 16 x 8 rays of 8 steps, 64 x 32 images; a
training cell at MAP3DBN_TINY's batch 2 on its 4 synthetic items)."""

import dataclasses

from perfbench import harness

SMALL_TRAFFIC = {"pool": 4, "sample": 2, "smpl_vertices": 384, "smpl_faces": 512}


def small_config(config, **over):
    from threedhumangan_tpu_torch import configs

    cfg = dict(configs.MAP3DBN_TINY, smpl_model="synthetic")
    for k in ("map3d_mode", "legacy_mode", "mod_blocks"):
        if k in config:
            cfg[k] = config[k]
    cfg.update(over)
    return cfg


def small_cell(name="gen.map3dbn512l.b8", **over):
    cell = harness.Spec().cell(name)
    traffic = dict(cell.traffic, **SMALL_TRAFFIC)
    if "batch" in traffic:
        traffic["batch"] = min(cell.traffic["batch"], 2)
    return dataclasses.replace(cell, config=small_config(cell.config, **over), traffic=traffic)
