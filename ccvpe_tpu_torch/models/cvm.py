"""The CVM model family, eval- and train-mode forward (the port of
ccvpe_tpu/models/cvm.py:30-259).

Forward contract as in the JAX package (NHWC at the boundary):
  logits [B, H*W], heatmap [B, H, W, 1] (softmax over all sat pixels),
  ori [B, H, W, 2] (per-pixel L2-normalized (cos, sin)),
  matching_scores[s] [B, h_s, w_s, K],
  ori_offsets [B, 2] or None: with a train-time ori window (ori_window=
  (r0, c0) and ModelConfig.ori_window), ori is [B, win, win, 2], the field
  at rows r0.., cols c0.. of the full map.
Inside, activations are NCHW in channels_last memory, so the NHWC view the
correlation kernel reads is contiguous without a copy.

Module names are the reference CCVPE state-dict names (grd_efficientnet,
sat_efficientnet, grd_feature_to_descriptorN, sat_feature_to_descriptors,
deconvN / convN and deconvN_ori / convN_ori, N = 6 coarse .. 1 fine, conv1
and conv1_ori being the heads), so `load_state_dict(strict=True)` takes a
reference .pt or `utils.convert.state_dict_from_jax` output as it is.

With ModelConfig.lmu_fused_min_res set, decoder stages whose output
resolution reaches it run as fused stages (nn/decoder.py::fused_stage_nchw,
float32 or bf16 kernels by compute_dtype), and a fused final stage takes
the head's two convs with it (reference models.py:125-127: deconv1 -> conv1
is one chain), as in the JAX package. With phase_space_min_res set
instead (the two are exclusive), such stages run in phase space
(ops/phase_space.py) and a phased final stage hands its packed deconv
output to the packed head. ModelConfig.compute_dtype, deconv_impl,
circular_impl and the remat options reach the modules of nn/;
remat_decoder checkpoints each decoder stage in train mode.

ModelConfig.spatial_axis and ori_axis name the mesh's model axis
(core/mesh.py): the decoders' rows, or the correlations' bins, are split
over its processes and every output is gathered whole (CVM.forward says
where). The numbers are the unsharded model's, as a sharding constraint
changes none in the JAX package.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from ccvpe_tpu_torch.core import mesh
from ccvpe_tpu_torch.core.profiling import marked
from ccvpe_tpu_torch.core.config import (CIRCULAR_IMPLS, COMPUTE_DTYPES, CORR_IMPLS,
                                         DECONV_IMPLS, REMAT_POLICIES, ModelConfig)
from ccvpe_tpu_torch.nn.decoder import (Deconv2x2, DoubleConv, HeadConv, decoder_stage,
                                        decoder_stage_rows, fused_stage_nchw)
from ccvpe_tpu_torch.nn.efficientnet import B0_BLOCK_SPECS, EfficientNetB0
from ccvpe_tpu_torch.nn.heads import GroundDescriptorHead, SatDescriptorHead, l2_normalize
from ccvpe_tpu_torch.ops.corr import rolled_corr_dispatch
from ccvpe_tpu_torch.ops.padding import b0_layer_sizes


class CVMOutput(NamedTuple):
    logits: torch.Tensor                          # [B, H*W]
    heatmap: torch.Tensor                         # [B, H, W, 1]
    ori: torch.Tensor                             # [B, H, W, 2] (or the window)
    matching_scores: Tuple[torch.Tensor, ...]     # per scale [B, h_s, w_s, K]
    ori_offsets: Optional[torch.Tensor] = None    # [B, 2] window (row0, col0)


def _batch_crop(t: torch.Tensor, r0: torch.Tensor, c0: torch.Tensor,
                size: int) -> torch.Tensor:
    """Per-sample spatial window of NCHW t: rows r0.., cols c0.. ([B]
    integer, clamped to fit as lax.dynamic_slice clamps) -> [B, C, size,
    size], one gather over the NHWC view."""
    b, _, h, w = t.shape
    span = torch.arange(size, device=t.device)
    rows = r0.long().clamp(0, h - size)[:, None] + span
    cols = c0.long().clamp(0, w - size)[:, None] + span
    idx = torch.arange(b, device=t.device)[:, None, None]
    return t.permute(0, 2, 3, 1)[idx, rows[:, :, None], cols[:, None, :]].permute(0, 3, 1, 2)


def check_supported(cfg: ModelConfig) -> None:
    """Raise ValueError for an option value no package takes, or a
    combination the JAX package refuses."""
    for field, allowed in (("corr_impl", CORR_IMPLS), ("deconv_impl", DECONV_IMPLS),
                           ("remat_policy", REMAT_POLICIES),
                           ("compute_dtype", COMPUTE_DTYPES),
                           ("circular_impl", CIRCULAR_IMPLS)):
        if getattr(cfg, field) not in allowed:
            raise ValueError(f"{field} must be one of {allowed}, got {getattr(cfg, field)!r}")
    win = cfg.ori_window
    if win and not (win >= 160 and win % 4 == 0 and win <= cfg.sat_size[0]):
        raise ValueError(f"ori_window must be 0 or a multiple of 4 from 160 to the aerial "
                         f"height {cfg.sat_size[0]}, got {win}")
    if cfg.phase_space_min_res and cfg.lmu_fused_min_res:
        raise ValueError("phase_space_min_res and lmu_fused_min_res are exclusive, got "
                         f"{cfg.phase_space_min_res} and {cfg.lmu_fused_min_res}")
    if cfg.lmu_fused_min_res and cfg.spatial_axis is not None:
        # ccvpe_tpu/models/cvm.py:113-116
        raise ValueError("lmu_fused_min_res cannot combine with spatial_axis sharding")


class CVM(nn.Module):
    """Convolutional cross-view pose estimator. Built on the meta device
    (no memory, no RNG); use `build_cvm` to place and fill it."""

    def __init__(self, config: ModelConfig):
        super().__init__()
        check_supported(config)
        self.config = cfg = config
        self._row_block_params = {}       # id -> parameter: row_block_params
        n = cfg.num_scales
        dtype = getattr(torch, cfg.compute_dtype)
        remat = dict(compute_dtype=dtype, remat=cfg.remat_backbone,
                     remat_skip=cfg.remat_skip_blocks, remat_policy=cfg.remat_policy)
        with torch.device("meta"):
            self.grd_efficientnet = EfficientNetB0(cfg.circular, cfg.backbone_features,
                                                   circular_impl=cfg.circular_impl, **remat)
            self.sat_efficientnet = EfficientNetB0(False, cfg.backbone_features, **remat)
            grd_h = cfg.grd_feat_hw[0]
            for s, c in enumerate(cfg.grd_desc_channels):
                self.add_module(f"grd_feature_to_descriptor{s + 1}",
                                GroundDescriptorHead(cfg.backbone_features, c, grd_h))
            gh, gw = cfg.sat_feat_hw
            chunk = (gh // cfg.sat_grid) * (gw // cfg.sat_grid)
            self.sat_feature_to_descriptors = SatDescriptorHead(
                cfg.backbone_features, chunk, cfg.sat_desc_dim, cfg.sat_grid)

            # Skip channels by resolution: the last backbone block at each
            # size (for 512^2 blocks 15, 10, 4, 2, 0 -> 320, 112, 40, 24, 16).
            skip_ch = {hw[0]: spec[2] for hw, spec in
                       zip(b0_layer_sizes(cfg.sat_size)[1:], B0_BLOCK_SPECS)}

            for branch, suffix, k_in, deconv_out, conv_out, head_out in (
                    ("loc", "", 1, cfg.loc_deconv_out, cfg.loc_conv_out, 1),
                    ("ori", "_ori", cfg.num_bins, cfg.ori_deconv_out,
                     cfg.ori_conv_out, 2)):
                cin = k_in + cfg.sat_desc_dim
                res = cfg.sat_grid
                for s in range(n):
                    ref_n = n - s
                    self.add_module(f"deconv{ref_n}{suffix}",
                                    Deconv2x2(cin, deconv_out[s], dtype, cfg.deconv_impl))
                    res *= 2
                    if s < n - 1:
                        c_cat = deconv_out[s] + skip_ch.get(res, 0)
                        self.add_module(f"conv{ref_n}{suffix}",
                                        DoubleConv(c_cat, conv_out[s], compute_dtype=dtype))
                        cin = conv_out[s] + (1 if branch == "loc" else 0)
                self.add_module(f"conv1{suffix}",
                                HeadConv(deconv_out[-1], cfg.head_hidden, head_out, dtype))

    def _stage(self, branch_suffix: str, s: int):
        ref_n = self.config.num_scales - s
        deconv = getattr(self, f"deconv{ref_n}{branch_suffix}")
        conv = getattr(self, f"conv{ref_n}{branch_suffix}") if ref_n > 1 else None
        return deconv, conv

    def _run_stage(self, branch_suffix: str, s: int, x: torch.Tensor,
                   skip: Optional[torch.Tensor], fused: bool, phase: bool,
                   rows: Optional[List[int]] = None) -> torch.Tensor:
        """decoder_stage (on this model rank's row block where `rows` is
        set: decoder_stage_rows, the skip map's rows of the output block),
        checkpointed under remat_decoder in train mode."""
        deconv, conv = self._stage(branch_suffix, s)
        if rows is None:
            fn, args = decoder_stage, (deconv, conv, x, skip, fused, phase)
        else:
            self._on_rows(deconv, conv)
            if skip is not None:
                skip = mesh.take_rows(skip, [2 * r for r in rows])
            fn, args = decoder_stage_rows, (deconv, conv, x, skip)
        if self.config.remat_decoder and self.training and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
        return fn(*args)

    def _sharded_stage(self, branch_suffix: str, s: int, x: torch.Tensor,
                       rows: Optional[List[int]], skip: Optional[torch.Tensor],
                       fused: bool, phase: bool, parts: int,
                       last: bool) -> Tuple[torch.Tensor, Optional[List[int]]]:
        """Stage s under ModelConfig.spatial_axis over `parts` model ranks
        (1: no sharding). x is this rank's row block where `rows` (the
        blocks' heights in model-index order) is set, else the whole map.
        The output is row-sharded from the first stage whose output height
        is at least 8 on (JAX's spatial_constraint, ccvpe_tpu/models/
        cvm.py:68-76): a stage on a row block gives the doubled block, a
        stage on the whole map hands on this rank's rows of its output
        (mesh.blocks). A phase-space stage gathers its input and runs whole
        (its output is then sharded again), and a phased final stage keeps
        its packed output whole for the packed head. Returns the output and
        its row blocks."""
        if rows is not None and phase:
            x, rows = mesh.gather_model(x, 2, rows), None
        if rows is not None:
            return self._run_stage(branch_suffix, s, x, skip, fused, phase, rows), \
                [2 * r for r in rows]
        y = self._run_stage(branch_suffix, s, x, skip, fused, phase)
        if parts == 1 or y.shape[2] < 8 or (phase and last):
            return y, None
        out_rows = mesh.blocks(y.shape[2], parts)
        if not all(out_rows):
            raise ValueError(f"spatial_axis: {parts} model ranks cannot shard the decoder's "
                             f"{y.shape[2]} rows without an empty block")
        return mesh.take_rows(y, out_rows), out_rows

    def _head(self, suffix: str, x: torch.Tensor, rows: Optional[List[int]],
              packed: bool) -> torch.Tensor:
        """The head on the whole map, or on this rank's row block gathered
        over the model group."""
        head = getattr(self, f"conv1{suffix}")
        if rows is None:
            return head(x, packed=packed)
        self._on_rows(head)
        return mesh.gather_model(head.forward_rows(x), 2, rows)

    def _on_rows(self, *modules) -> None:
        for mod in modules:
            if mod is not None:
                for p in mod.parameters():
                    self._row_block_params[id(p)] = p

    def row_block_params(self) -> List[nn.Parameter]:
        """The parameters the last forward used only on row blocks
        (ModelConfig.spatial_axis over a model axis of size > 1): their
        gradients are partial, one block's part each, which the train
        step's gradient mean weights by the model size (core/mesh.py's
        note). Empty otherwise."""
        return list(self._row_block_params.values())

    def forward(self, grd: torch.Tensor, sat: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                ori_window: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> CVMOutput:
        """grd [B, Hg, Wg, 3], sat [B, Hs, Ws, 3], normalized float32 NHWC.
        In train mode `generator` (on the inputs' device) draws the
        encoders' drop-connect masks. `ori_window` (r0, c0), [B] integer
        fine-resolution origins (train/step.py::ori_window_starts), makes
        the two finest ori stages decode only the ModelConfig.ori_window
        window there (with ori_window 0, the full field).

        Under a mesh with a model axis of M > 1 processes (core/mesh.py::
        set_mesh), ModelConfig.spatial_axis shards the decoders' rows over
        it from the first stage output of height 8 on (not the ori window's
        stages, which run whole on the gathered map), and B1 runs on each
        rank's row block with all the bins; ModelConfig.ori_axis shards the
        bins of every correlation of a map that is not row-sharded (the
        bottleneck's, or every scale's without spatial_axis): B1 on each
        rank's bin block. The encoders run replicated, and every output is
        gathered whole on every model rank. With M = 1 both axes run the
        unsharded code, with the same bits."""
        cfg = self.config
        n = cfg.num_scales
        parts = mesh.shard_size(cfg.spatial_axis)
        mesh.shard_size(cfg.ori_axis)           # raises for an axis the mesh lacks
        self._row_block_params = {}
        grd = grd.permute(0, 3, 1, 2)   # NCHW views of NHWC = channels_last
        sat = sat.permute(0, 3, 1, 2)
        with marked("encoders"):        # a device mark inside the entry points' marking()
            grd_feat, _ = self.grd_efficientnet(grd, generator)
            sat_feat, sat_multiscale = self.sat_efficientnet(sat, generator)
        skip_by_size = {m.shape[2]: m for m in sat_multiscale}

        grd_descs = [getattr(self, f"grd_feature_to_descriptor{s + 1}")(grd_feat)
                     for s in range(n)]
        sat_desc = self.sat_feature_to_descriptors(sat_feat)       # [B,g,g,D]
        sat_desc = sat_desc.permute(0, 3, 1, 2)                      # NCHW view

        def match(x, s, bins=None, rows=None):
            """The scores of x: on a row block with all the bins, else on
            the bins' blocks under ori_axis."""
            g = grd_descs[s] if rows is None else mesh.to_model(grd_descs[s])
            return rolled_corr_dispatch(
                x.permute(0, 2, 3, 1), g, cfg.roll_shifts[s], cfg.num_bins,
                cfg.center_window, bins, cfg.corr_impl, cfg.corr_bf16,
                None if rows is not None else cfg.ori_axis)

        def fused(res_out: int) -> bool:
            return bool(cfg.lmu_fused_min_res) and res_out >= cfg.lmu_fused_min_res

        def phased(res_out: int) -> bool:
            return bool(cfg.phase_space_min_res) and res_out >= cfg.phase_space_min_res

        # Under an orientation prior the bottleneck RETURNS the full K-bin
        # stack (the restricted one only feeds the max), while scales 2..6
        # return restricted stacks (reference models.py:489-511).
        restricted = cfg.restricted_bins
        scores_full = match(sat_desc, 0)
        scores_loc = match(sat_desc, 0, restricted) if restricted else scores_full
        all_scores = [scores_full]

        x, rows = sat_desc, None    # rows: x's row blocks where it is row-sharded
        for s in range(n):
            if s > 0:
                scores_s = match(x, s, restricted, rows)
                all_scores.append(scores_s if rows is None
                                  else mesh.gather_model(scores_s, 1, rows))
            else:
                scores_s = scores_loc
            score_max = scores_s.amax(dim=-1, keepdim=True).permute(0, 3, 1, 2)
            x = torch.cat([score_max, l2_normalize(x, dim=1)], dim=1)
            h = x.shape[2] if rows is None else sum(rows)
            skip = skip_by_size.get(h * 2) if s < n - 1 else None
            last = s == n - 1
            if last and fused(2 * h):
                logits_map = fused_stage_nchw(self.deconv1, self.conv1, x, None)
            else:
                phase = phased(2 * h)
                x, rows = self._sharded_stage("", s, x, rows, skip, fused(2 * h), phase,
                                              parts, last)
                if last:
                    logits_map = self._head("", x, rows, phase)      # [B,1,H,W]
        b, _, h, w = logits_map.shape
        logits = logits_map.reshape(b, h * w)
        heatmap = torch.softmax(logits, dim=-1).reshape(b, h, w, 1)

        # Train-time ori window: from the second-to-last stage on, only a
        # window around the GT is decoded; the ori loss weight (the sigma-4
        # Gaussian) is exactly 0.0f outside it, so losses and gradients are
        # the full field's (train/step.py). Eval never windows.
        win = cfg.ori_window if ori_window is not None else 0
        if win:
            r0, c0 = ori_window
        y = torch.cat([scores_full.permute(0, 3, 1, 2),
                       l2_normalize(sat_desc, dim=1)], dim=1)
        rows = None
        for s in range(n):
            windowed = bool(win) and s >= n - 2
            if win and s == n - 2:
                if rows is not None:
                    y, rows = mesh.gather_model(y, 2, rows), None
                y = _batch_crop(y, r0 // 4, c0 // 4, win // 4)
            h = y.shape[2] if rows is None else sum(rows)
            full_res = cfg.sat_grid * 2 ** s if windowed else h
            skip = skip_by_size.get(full_res * 2) if s < n - 1 else None
            if windowed and skip is not None:
                skip = _batch_crop(skip, r0 // 2, c0 // 2, win // 2)
            last = s == n - 1
            if last and fused(2 * h):
                ori_raw = fused_stage_nchw(self.deconv1_ori, self.conv1_ori, y, None)
            else:
                phase = phased(2 * h)
                y, rows = self._sharded_stage("_ori", s, y, rows, skip, fused(2 * h), phase,
                                              1 if windowed else parts, last)
                if last:
                    ori_raw = self._head("_ori", y, rows, phase)     # [B,2,H,W]
        ori = l2_normalize(ori_raw, dim=1).permute(0, 2, 3, 1)
        offsets = torch.stack([r0, c0], dim=-1) if win else None
        return CVMOutput(logits, heatmap, ori, tuple(all_scores), offsets)


@torch.no_grad()
def random_init_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter and BN buffer from `generator` (CPU), in
    named order: conv/linear weights ~ N(0, 1/fan_in), biases ~ N(0, 0.01),
    BN scale ~ U(0.5, 1.5), shift ~ N(0, 0.1), mean ~ N(0, 0.1),
    var ~ U(0.5, 1.5). For smoke runs at full width without weights."""
    def normal(shape, std):
        return torch.randn(shape, generator=generator) * std

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=generator) * (hi - lo) + lo

    for mod in model.modules():
        if isinstance(mod, nn.BatchNorm2d):
            c = mod.num_features
            mod.weight.copy_(uniform(c, 0.5, 1.5))
            mod.bias.copy_(normal(c, 0.1))
            mod.running_mean.copy_(normal(c, 0.1))
            mod.running_var.copy_(uniform(c, 0.5, 1.5))
            mod.num_batches_tracked.zero_()
        elif isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            w = mod.weight
            if isinstance(mod, nn.ConvTranspose2d):
                fan_in = w.shape[0]     # one tap per output pixel
            else:
                fan_in = w[0].numel()
            w.copy_(normal(w.shape, fan_in ** -0.5))
            if mod.bias is not None:
                mod.bias.copy_(normal(mod.bias.shape, 0.01))
    return model


def resolve_device(device=None) -> torch.device:
    """None means the card; without one it raises rather than run on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
        device = "cuda"
    return torch.device(device)


def build_cvm(config: ModelConfig, device, state_dict=None,
              generator: Optional[torch.Generator] = None) -> CVM:
    """A CVM on `device` in eval mode and channels_last memory, with weights
    from `state_dict` (strict) or, failing that, drawn from `generator`."""
    if state_dict is None and generator is None:
        raise ValueError("build_cvm needs a state_dict or a torch.Generator")
    model = CVM(config).to_empty(device=device)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    else:
        random_init_(model, generator)
    return model.to(memory_format=torch.channels_last).eval()
