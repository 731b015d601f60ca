"""Serving: a warm, fixed-shape inference engine for pose estimation (the
port of ccvpe_tpu/serve.py:30-94), and the exported program (the
counterpart of export_stablehlo, :97-117).

Requests run in chunks of `batch_size`, the tail zero-padded to the same
shape; pose decoding runs on the card and only scalars come back. Each
batch runs in float32, TF32 off (core/precision.py).

    engine = InferenceEngine.from_checkpoint(vigor(), "model.pt")
    poses = engine.predict(grd_batch, sat_batch)   # list of PoseResult

On the card the engine keeps one CUDA graph per (batch shape, input
dtype), the counterpart of the JAX engine's one jitted executable: the
first batch of a shape runs eagerly (it builds the kernels, cuDNN's plans
and the workspaces), then normalisation, forward, pose decode and peak are
captured into static buffers (core/graphs.py); every later batch is one
copy into the static inputs from pinned staging, one replay and one copy
of the four [B] vectors back. `cuda_graph=False` keeps every batch eager.

    blob = export_program(vigor(), state_dict, batch_size=8)  # bytes
    program = load_program(blob)          # rows, cols, angle, heatmap
"""

from __future__ import annotations

import dataclasses
import io
import warnings
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from ccvpe_tpu_torch.core.config import ModelConfig
from ccvpe_tpu_torch.core.graphs import Graph
from ccvpe_tpu_torch.core.precision import float32_matmuls
from ccvpe_tpu_torch.models.cvm import CVM, build_cvm, resolve_device
from ccvpe_tpu_torch.ops import pose
from ccvpe_tpu_torch.train.step import device_normalize


@dataclasses.dataclass
class PoseResult:
    row: int                 # heatmap argmax row on the aerial patch
    col: int
    angle_deg: float         # decoded orientation
    probability: float       # heatmap peak value


class _Captured:
    """One batch shape's graph: its static device inputs, their pinned
    staging, and the static [4, B] output."""

    def __init__(self, graph: Graph, inputs, staging, output):
        self.graph, self.inputs, self.staging, self.output = graph, inputs, staging, output


class InferenceEngine:
    def __init__(self, model_cfg: ModelConfig, state_dict, batch_size: int = 8,
                 device=None, cuda_graph: bool = True):
        """`cuda_graph` (the counterpart of JAX's donate=True on
        make_train_step: on by default, off for a reference run) captures
        one CUDA graph per batch shape on the card; a failed capture raises.
        On the CPU every batch runs eagerly."""
        self.model_cfg = model_cfg
        self.batch_size = batch_size
        self.device = resolve_device(device)
        self.model = build_cvm(model_cfg, self.device, state_dict=state_dict)
        self.cuda_graph = cuda_graph and self.device.type == "cuda"
        self._graphs: Dict[Tuple, _Captured] = {}
        self.captures = 0

    @classmethod
    def from_checkpoint(cls, model_cfg: ModelConfig, checkpoint: str,
                        batch_size: int = 8, device=None) -> "InferenceEngine":
        """checkpoint: a reference-format .pt/.pth file or an .npz of the
        same keys (an Orbax run directory raises: utils/convert.py)."""
        from ccvpe_tpu_torch.utils.convert import load_state_dict_file
        return cls(model_cfg, load_state_dict_file(checkpoint), batch_size, device)

    def _forward(self, grd: torch.Tensor, sat: torch.Tensor) -> torch.Tensor:
        """[4, B] float64 (exact for each): rows, cols, angle, peak."""
        out = self.model(device_normalize(grd), device_normalize(sat))
        rows, cols, angle = pose.decode_pose(out.heatmap, out.ori)
        peak = out.heatmap.reshape(out.heatmap.shape[0], -1).amax(dim=-1)
        return torch.stack([rows.double(), cols.double(), angle.double(), peak.double()])

    def _capture(self, grd: torch.Tensor, sat: torch.Tensor) -> _Captured:
        inputs = [torch.empty(t.shape, dtype=t.dtype, device=self.device) for t in (grd, sat)]
        staging = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in (grd, sat)]
        for dst, src in zip(inputs, (grd, sat)):
            dst.copy_(src)
        graph = Graph()
        output = graph.capture(lambda: self._forward(*inputs))
        self.captures += 1
        return _Captured(graph, inputs, staging, output)

    @torch.inference_mode()
    @float32_matmuls()
    def _run(self, grd: np.ndarray, sat: np.ndarray) -> List[List[float]]:
        host = (torch.from_numpy(grd), torch.from_numpy(sat))
        key = tuple((a.shape, a.dtype.str) for a in (grd, sat))
        entry = self._graphs.get(key) if self.cuda_graph else None
        if entry is None:
            out = self._forward(*(t.to(self.device) for t in host)).tolist()
            if self.cuda_graph:     # this batch warmed the shape up: capture it
                self._graphs[key] = self._capture(*host)
            return out
        for pinned, dst, src in zip(entry.staging, entry.inputs, host):
            pinned.copy_(src)
            dst.copy_(pinned, non_blocking=True)
        entry.graph.replay()
        return entry.output.tolist()

    def warmup(self, dtype=np.uint8) -> None:
        """One batch of zeros of the dtype the engine will serve (uint8, as
        the loaders send; np.float32 for images normalized on the host):
        builds the kernels and, on the card, captures the graph that this
        traffic replays."""
        hg, wg = self.model_cfg.grd_size
        hs, ws = self.model_cfg.sat_size
        self._run(np.zeros((self.batch_size, hg, wg, 3), dtype),
                  np.zeros((self.batch_size, hs, ws, 3), dtype))

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
                results.append(PoseResult(int(rows[i]), int(cols[i]), angle[i], peak[i]))
        return results


class _Program(torch.nn.Module):
    """What export_program exports: normalized float32 NHWC images ->
    eval-mode forward + pose decode -> (rows, cols, angle, heatmap)."""

    def __init__(self, model: CVM):
        super().__init__()
        self.model = model

    def forward(self, grd: torch.Tensor, sat: torch.Tensor):
        out = self.model(grd, sat)
        rows, cols, angle = pose.decode_pose(out.heatmap, out.ori)
        return rows, cols, angle, out.heatmap


def export_program(model_cfg: ModelConfig, state_dict, batch_size: int = 1,
                   device=None) -> bytes:
    """The inference function (eval-mode forward + pose decode) on
    `batch_size` normalized float32 NHWC ground and aerial images, as a
    torch.export program serialized by torch.export.save: the counterpart
    of ccvpe_tpu/serve.py::export_stablehlo. On the card B1 and B2 are the
    registered ops ccvpe_tpu_torch::corr_fwd (six nodes) and ::lmu_fwd (one
    a fused stage); on the CPU the correlation is plain torch, so a program
    exported there holds no B1 node. Two differences from the JAX artifact:
    the weights live inside the program (jax.export takes params and
    batch_stats as arguments), and the loader must import ccvpe_tpu_torch,
    which registers the two ops (load_program does), though no other model
    code. `device` None means the card."""
    device = resolve_device(device)
    model = build_cvm(model_cfg, device, state_dict=state_dict).requires_grad_(False)
    hg, wg = model_cfg.grd_size
    hs, ws = model_cfg.sat_size
    args = (torch.zeros((batch_size, hg, wg, 3), device=device),
            torch.zeros((batch_size, hs, ws, 3), device=device))
    exported = torch.export.export(_Program(model), args)
    buf = io.BytesIO()
    with warnings.catch_warnings():
        # channels_last weights are not contiguous, so the archive calls
        # none of them complete; each is written whole all the same
        warnings.filterwarnings("ignore", message="No complete tensor found")
        torch.export.save(exported, buf)
    return buf.getvalue()


def load_program(blob: bytes) -> Callable[[torch.Tensor, torch.Tensor], Tuple[torch.Tensor, ...]]:
    """export_program's bytes -> program(grd, sat) -> (rows, cols, angle,
    heatmap), on the device the program was exported on. TF32 is read by
    cuDNN when a convolution runs, not when it is exported, so the program
    runs under float32_matmuls (TF32 off), as every entry point of the port
    does, and without autograd. The ops it calls are registered by
    importing ccvpe_tpu_torch, which importing this module does."""
    module = torch.export.load(io.BytesIO(blob)).module()

    def program(grd: torch.Tensor, sat: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        with torch.no_grad(), float32_matmuls():
            return tuple(module(grd, sat))

    return program
