"""serve.py's export_program / load_program, the counterpart of
ccvpe_tpu/serve.py::export_stablehlo, on tiny() on the CPU:

- the program goes to bytes and back and gives the eager forward and pose
  decode of the same weights to the bit; exported on the CPU it holds no B1
  node (the correlation is plain torch there) and, with the fused stages,
  one B2 node (ccvpe_tpu_torch::lmu_fwd) a fused stage;
- against the JAX package's export_stablehlo, deserialized and called on
  the same variables and inputs (JAX weights carried across by
  state_dict_from_jax): rows and cols equal (ties as
  _torch_helpers.same_peaks), angle within ANGLE_ATOL degrees, heatmap
  within HEATMAP_EXPORT_ATOL.
"""

import dataclasses
import io

import jax
import numpy as np
import pytest
import torch

from _torch_helpers import jax_variables, one_intra_op_thread, same_peaks  # noqa: F401
from ccvpe_tpu.core import config as jcfg
from ccvpe_tpu.models.cvm import CVM as JaxCVM
from ccvpe_tpu.serve import export_stablehlo
from ccvpe_tpu_torch.core import config as tcfg
from ccvpe_tpu_torch.core.precision import float32_matmuls
from ccvpe_tpu_torch.models.cvm import build_cvm
from ccvpe_tpu_torch.ops import pose
from ccvpe_tpu_torch.serve import export_program, load_program
from ccvpe_tpu_torch.utils.convert import state_dict_from_jax

BATCH = 2
ANGLE_ATOL = 1e-3
HEATMAP_EXPORT_ATOL = 5e-4


@pytest.fixture(scope="module")
def setup():
    cfg = jcfg.tiny()
    model = JaxCVM(cfg)
    hg, wg = cfg.grd_size
    hs, ws = cfg.sat_size
    variables = jax_variables(model, np.zeros((1, hg, wg, 3), np.float32),
                              np.zeros((1, hs, ws, 3), np.float32), False, seed=41)
    rng = np.random.default_rng(42)
    grd = rng.normal(size=(BATCH, hg, wg, 3)).astype(np.float32)
    sat = rng.normal(size=(BATCH, hs, ws, 3)).astype(np.float32)
    sd = state_dict_from_jax(variables["params"], variables["batch_stats"])
    return dict(cfg=cfg, variables=variables, grd=grd, sat=sat, state_dict=sd)


def op_nodes(blob):
    ep = torch.export.load(io.BytesIO(blob))
    targets = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
    return {op: sum(t.startswith(f"ccvpe_tpu_torch.{op}.") for t in targets)
            for op in ("corr_fwd", "lmu_fwd")}


@pytest.mark.parametrize("fused", [0, 64], ids=["plain", "fused from 64 px"])
def test_program_equals_the_eager_forward(setup, fused):
    cfg = dataclasses.replace(tcfg.tiny(), lmu_fused_min_res=fused)
    blob = export_program(cfg, setup["state_dict"], batch_size=BATCH, device="cpu")
    assert isinstance(blob, bytes)
    assert op_nodes(blob) == {"corr_fwd": 0, "lmu_fwd": 4 if fused else 0}
    g, s = torch.from_numpy(setup["grd"]), torch.from_numpy(setup["sat"])
    got = load_program(blob)(g, s)
    model = build_cvm(cfg, "cpu", state_dict=setup["state_dict"])
    with torch.inference_mode(), float32_matmuls():
        out = model(g, s)
        want = (*pose.decode_pose(out.heatmap, out.ori), out.heatmap)
    assert len(got) == 4
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_program_matches_export_stablehlo(setup):
    jax_cfg = setup["cfg"]
    v = setup["variables"]
    blob = export_stablehlo(jax_cfg, v["params"], v["batch_stats"], batch_size=BATCH)
    rows, cols, angle, heatmap = (np.asarray(t) for t in jax.export.deserialize(blob).call(
        v["params"], v["batch_stats"], setup["grd"], setup["sat"]))
    program = load_program(export_program(tcfg.tiny(), setup["state_dict"], batch_size=BATCH,
                                          device="cpu"))
    got = [t.numpy() for t in program(torch.from_numpy(setup["grd"]),
                                      torch.from_numpy(setup["sat"]))]
    heat = heatmap[..., 0]
    same_peaks(got[0], got[1], rows, cols, lambda idx: heat[idx])
    same = (got[0] == rows) & (got[1] == cols)
    d = np.abs(got[2] - angle)[same]
    assert np.minimum(d, 360.0 - d).max() <= ANGLE_ATOL
    np.testing.assert_allclose(got[3], heatmap, atol=HEATMAP_EXPORT_ATOL, rtol=0)

