"""A cell of BENCHMARK.json cut to a size the CPU runs in seconds: the
configuration's model at tiny widths (fused from 64 px, so the fused
stages' plain versions run), its traffic at 2 pairs a batch and 4 batches,
and the cell's own limits."""

import dataclasses

from harness import spec

TINY = {
    "name": "tiny", "grd_size": [64, 128], "sat_size": [128, 128],
    "grd_desc_channels": [64, 32, 16, 8, 4, 2], "sat_desc_dim": 256, "sat_grid": 2,
    "num_bins": 4, "roll_shifts": [64, 32, 16, 8, 4, 2],
    "loc_deconv_out": [128, 64, 32, 16, 8, 16], "loc_conv_out": [128, 64, 32, 16, 8],
    "ori_deconv_out": [128, 64, 32, 16, 8, 16], "ori_conv_out": [128, 64, 32, 16, 8],
    "lmu_fused_min_res": 64,
}


def tiny_cell(name: str, **model) -> spec.Cell:
    c = spec.cell(name)
    m = dict(c.model, **TINY, **model)
    return dataclasses.replace(c, config=dict(c.config, model=m),
                               traffic=dict(c.traffic, batch=2, pool=4))
