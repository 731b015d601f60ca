"""Checkpoints of the full train state with keep-N retention and exact
resume, the port of ccvpe_tpu/core/checkpoint.py without Orbax.

The reference saves a bare state_dict per epoch and cannot resume (no
optimizer state, training restarts at epoch 0: reference
train_VIGOR.py:159-163, :252). Here one file per step,
`<directory>/step_<step:08d>.pt`, holds the model's state_dict (parameters
and BN running stats), the optimizer's state_dict (Adam's moments) and its
update count (the learning-rate schedule reads it), the step, and the data
cursor {"epoch", "batch"}.

Saving is asynchronous, like Orbax's: `save` copies every tensor to the
host on the caller's thread and hands the payload to a background thread,
which writes it with torch.save to a hidden temporary name, flushes it to
disk and renames it into place with os.replace, so a run killed mid-write
never leaves a torn step file; then it deletes all but the newest `keep`.
`wait()` joins the write and re-raises its error; every `save` waits for the
one before it.
"""

from __future__ import annotations

import os
import re
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from ccvpe_tpu_torch.utils.convert import load_state_dict_file

_STEP_FILE = re.compile(r"^step_(\d+)\.pt$")


def step_file(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}.pt")


def saved_steps(directory: str) -> List[int]:
    """The steps with a complete file under `directory`, ascending."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(_STEP_FILE.match, os.listdir(directory)) if m)


def _to_host(tree: Any) -> Any:
    """A copy of `tree` with every tensor copied to the host, so the write
    sees the values of this step while training goes on."""
    if torch.is_tensor(tree):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def load_payload(path: str) -> Dict[str, Any]:
    return torch.load(path, map_location="cpu", weights_only=True)


def latest_model_state(directory: str) -> Optional[Dict[str, torch.Tensor]]:
    """The model state_dict of the newest step under `directory` (a
    CheckpointManager's), on the host, or None if it holds no step file."""
    steps = saved_steps(directory)
    if not steps:
        return None
    return load_payload(step_file(directory, steps[-1]))["model"]


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self._dir = os.path.abspath(directory)
        os.makedirs(self._dir, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        # per save: step, bytes, host-copy and write seconds
        self.timings: List[Dict[str, float]] = []

    def save(self, step: int, state, cursor: Optional[dict] = None) -> None:
        """Save `state` (train/step.py::TrainState) and the data cursor:
        {"epoch": E, "batch": B} means "resume at batch index B of epoch E
        under that epoch's deterministic shuffle", which makes mid-epoch
        resume exact. A save at the step of the newest file replaces it."""
        self.wait()
        cursor = cursor or {}
        t0 = time.perf_counter()
        payload = {
            "step": int(state.step),
            "model": _to_host(state.model.state_dict()),
            "optimizer": _to_host(state.optimizer.state_dict()),
            "count": int(state.optimizer.count),
            "cursor": {"epoch": int(cursor.get("epoch", 0)),
                       "batch": int(cursor.get("batch", 0))},
        }
        copy_s = time.perf_counter() - t0
        self._thread = threading.Thread(target=self._write, args=(step, payload, copy_s),
                                        name=f"checkpoint-{step}", daemon=True)
        self._thread.start()

    def _write(self, step: int, payload: Dict[str, Any], copy_s: float) -> None:
        try:
            t0 = time.perf_counter()
            final = step_file(self._dir, step)
            tmp = os.path.join(self._dir, f".{os.path.basename(final)}.tmp")
            with open(tmp, "wb") as f:
                torch.save(payload, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, final)
            for old in saved_steps(self._dir)[:-self.keep]:
                os.remove(step_file(self._dir, old))
            self.timings.append(dict(step=step, bytes=os.path.getsize(final), copy_s=copy_s,
                                     write_s=time.perf_counter() - t0))
        except Exception as e:   # handed to wait(), which raises it
            self._error = e

    def wait(self) -> None:
        """Join the write in flight; re-raise its error, if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise RuntimeError(f"checkpoint write under {self._dir} failed") from error

    def latest_step(self) -> Optional[int]:
        self.wait()
        steps = saved_steps(self._dir)
        return steps[-1] if steps else None

    def restore_latest(self, state) -> Optional[Tuple[Any, dict]]:
        """Load the newest step into `state` (a TrainState: its model, its
        optimizer's moments and count, its step). Returns (state, cursor),
        or None if the directory holds no step file.

        The file is read to the host: load_state_dict copies the model's
        tensors onto its device, and the optimizer's puts each moment on its
        parameter's device and Adam's per-parameter step counts where this
        optimizer keeps them: on the card for the capturable optimizer of a
        model on the card, on the host otherwise (train/step.py::Optimizer).
        The learning rate is saved as a float and restored into either form."""
        step = self.latest_step()
        if step is None:
            return None
        payload = load_payload(step_file(self._dir, step))
        state.model.load_state_dict(payload["model"], strict=True)
        state.optimizer.load_state_dict(payload["optimizer"])
        state.optimizer.count = payload["count"]
        state.step = payload["step"]
        return state, dict(payload["cursor"])


def load_reference_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A reference PyTorch .pt checkpoint (train_VIGOR.py:252), or an .npz
    of the same keys, as a state dict the port's CVM loads strictly (the
    modules carry the reference names, so nothing is converted)."""
    return load_state_dict_file(path)
