"""Serving: a warm, fixed-shape inference engine for pose estimation (the
port of ccvpe_tpu/serve.py:30-94).

Requests run in chunks of `batch_size`, the tail zero-padded to the same
shape; pose decoding runs on the card and only scalars come back. Each
batch runs in float32, TF32 off (core/precision.py).

    engine = InferenceEngine.from_checkpoint(vigor(), "model.pt")
    poses = engine.predict(grd_batch, sat_batch)   # list of PoseResult

`export_stablehlo` has no counterpart yet (ROADMAP: torch.export).
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from ccvpe_tpu_torch.core.config import ModelConfig
from ccvpe_tpu_torch.core.precision import float32_matmuls
from ccvpe_tpu_torch.models.cvm import build_cvm, resolve_device
from ccvpe_tpu_torch.ops import pose
from ccvpe_tpu_torch.train.step import device_normalize


@dataclasses.dataclass
class PoseResult:
    row: int                 # heatmap argmax row on the aerial patch
    col: int
    angle_deg: float         # decoded orientation
    probability: float       # heatmap peak value


class InferenceEngine:
    def __init__(self, model_cfg: ModelConfig, state_dict, batch_size: int = 8,
                 device=None):
        self.model_cfg = model_cfg
        self.batch_size = batch_size
        self.device = resolve_device(device)
        self.model = build_cvm(model_cfg, self.device, state_dict=state_dict)

    @classmethod
    def from_checkpoint(cls, model_cfg: ModelConfig, checkpoint: str,
                        batch_size: int = 8, device=None) -> "InferenceEngine":
        """checkpoint: a reference-format .pt/.pth file or an .npz of the
        same keys (an Orbax run directory raises: utils/convert.py)."""
        from ccvpe_tpu_torch.utils.convert import load_state_dict_file
        return cls(model_cfg, load_state_dict_file(checkpoint), batch_size, device)

    @torch.inference_mode()
    @float32_matmuls()
    def _run(self, grd: np.ndarray, sat: np.ndarray):
        g = device_normalize(torch.from_numpy(grd).to(self.device))
        s = device_normalize(torch.from_numpy(sat).to(self.device))
        out = self.model(g, s)
        rows, cols, angle = pose.decode_pose(out.heatmap, out.ori)
        peak = out.heatmap.reshape(out.heatmap.shape[0], -1).amax(dim=-1)
        return rows.tolist(), cols.tolist(), angle.tolist(), peak.tolist()

    def warmup(self) -> None:
        hg, wg = self.model_cfg.grd_size
        hs, ws = self.model_cfg.sat_size
        self._run(np.zeros((self.batch_size, hg, wg, 3), np.float32),
                  np.zeros((self.batch_size, hs, ws, 3), np.float32))

    def predict(self, grd: np.ndarray, sat: np.ndarray) -> List[PoseResult]:
        """grd [N,Hg,Wg,3], sat [N,Hs,Ws,3] (any N, uint8 or normalized
        f32): fixed-size chunks, the tail zero-padded."""
        n = grd.shape[0]
        results: List[PoseResult] = []
        for start in range(0, n, self.batch_size):
            g = grd[start:start + self.batch_size]
            s = sat[start:start + self.batch_size]
            valid = g.shape[0]
            if valid < self.batch_size:
                pad = self.batch_size - valid
                g = np.concatenate([g, np.zeros((pad, *g.shape[1:]), g.dtype)])
                s = np.concatenate([s, np.zeros((pad, *s.shape[1:]), s.dtype)])
            rows, cols, angle, peak = self._run(np.ascontiguousarray(g),
                                                np.ascontiguousarray(s))
            for i in range(valid):
                results.append(PoseResult(rows[i], cols[i], angle[i], peak[i]))
        return results
