"""ModelConfig, TrainConfig and the reference presets, the port's own copy
of ccvpe_tpu/core/config.py (no import of the JAX package).

Every field of the JAX ModelConfig and TrainConfig is kept so that a config
describes the same model and run in both packages; the port's CVM raises
NotImplementedError for the options it does not run yet
(models/cvm.py::check_supported).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

CORR_IMPLS = ("auto", "plain", "cuda")
DECONV_IMPLS = ("einsum", "conv")
REMAT_POLICIES = ("none", "save_dw")
COMPUTE_DTYPES = ("float32", "bfloat16")
CIRCULAR_IMPLS = ("wrap", "edgefix")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Configuration of one CVM variant (reference models.py:49 VIGOR,
    :346 VIGOR ori-prior, :655 KITTI, :954 Oxford)."""

    name: str = "vigor"

    # --- input geometry ---
    grd_size: Tuple[int, int] = (320, 640)   # ground image H, W
    sat_size: Tuple[int, int] = (512, 512)   # aerial image H, W

    # --- backbone ---
    circular: bool = True        # horizontal circular padding, ground encoder
    circular_impl: str = "wrap"  # or 'edgefix' (value-equal, no wrapped copy)
    backbone_features: int = 1280

    # --- ground descriptor heads: 1x1 compress channels per scale ---
    grd_desc_channels: Sequence[int] = (64, 32, 16, 8, 4, 2)

    # --- aerial descriptor head ---
    sat_desc_dim: int = 1280     # D; 2048 for KITTI
    sat_grid: int = 8            # chunk grid over the bottleneck feature map

    # --- orientation-rolled matching ---
    num_bins: int = 20                                  # K; 16 for KITTI
    roll_shifts: Sequence[int] = (64, 32, 16, 8, 4, 2)  # channel shift per scale
    center_window: bool = False  # Oxford centre-window matching

    # --- decoders (stage order coarse -> fine) ---
    loc_deconv_out: Sequence[int] = (1024, 320, 160, 80, 40, 16)
    loc_conv_out: Sequence[int] = (640, 320, 160, 80, 40)
    ori_deconv_out: Sequence[int] = (1024, 256, 128, 64, 32, 16)
    ori_conv_out: Sequence[int] = (640, 256, 128, 64, 32)
    head_hidden: int = 16

    # correlation implementation: 'auto' (the CUDA kernel for CUDA tensors,
    # the plain version for CPU tensors, at every D), 'plain' (two einsums,
    # the JAX 'xla' counterpart) or 'cuda' (the kernel; raises on a CPU
    # tensor, the JAX 'pallas' counterpart)
    corr_impl: str = "auto"

    # fused LMU decoder stages (ops/lmu_cuda.py, csrc/lmu.cu): 0 = off;
    # otherwise stages whose output resolution is >= this value, and the
    # final stage with its head, run as one fused kernel forward and one
    # backward (256 fuses the two finest stages of both decoders)
    lmu_fused_min_res: int = 0

    # bf16 operands in the correlation of a bf16 map with D < 128 (the
    # scales the JAX package's TPU dispatch leaves to XLA): the ground
    # descriptor and the squared map round to bf16 (ops/corr.py)
    corr_bf16: bool = False
    # the 2x2 deconv: 'einsum' (f32 products of bf16-rounded operands, f32
    # out) or 'conv' (a bf16 transposed conv, rounded, then the f32 bias);
    # one function in float32 (nn/decoder.py::Deconv2x2)
    deconv_impl: str = "einsum"
    # the convs of the encoders and decoders: 'float32' or 'bfloat16' (BN
    # statistics, the descriptor heads and so scale 0 of the correlation,
    # softmax, GT, losses, parameters and Adam stay float32)
    compute_dtype: str = "float32"
    # torch.utils.checkpoint around each MBConv block from index
    # remat_skip_blocks on; 'save_dw' keeps each depthwise conv's output
    remat_backbone: bool = False
    remat_skip_blocks: int = 0
    remat_policy: str = "none"
    # torch.utils.checkpoint around each decoder stage
    remat_decoder: bool = False
    # train-time ori-decoder window (px, >= 160, a multiple of 4): the two
    # finest ori stages decode only a window around the GT, exact because
    # the sigma-4 Gaussian loss weight underflows to 0.0f beyond ~58 px
    ori_window: int = 0

    # phase-space (space-to-depth) fine stages: 0 = off, else the stages
    # (and the final head) whose output resolution reaches it run on 2x2
    # packed maps (ops/phase_space.py); exclusive with lmu_fused_min_res
    phase_space_min_res: int = 0

    # --- options of the JAX package the port does not run yet ---
    spatial_axis: Optional[str] = None
    ori_axis: Optional[str] = None

    # --- ori-prior restricted search: degrees of orientation noise ---
    ori_noise: Optional[float] = None

    @property
    def bin_degrees(self) -> float:
        return 360.0 / self.num_bins

    @property
    def grd_feat_hw(self) -> Tuple[int, int]:
        """Backbone output H, W of the ground branch (static-224 SAME)."""
        from ccvpe_tpu_torch.ops.padding import b0_output_size
        return b0_output_size(self.grd_size)

    @property
    def sat_feat_hw(self) -> Tuple[int, int]:
        from ccvpe_tpu_torch.ops.padding import b0_output_size
        return b0_output_size(self.sat_size)

    @property
    def grd_desc_lens(self) -> Tuple[int, ...]:
        w = self.grd_feat_hw[1]
        return tuple(w * c for c in self.grd_desc_channels)

    @property
    def num_scales(self) -> int:
        return len(self.roll_shifts)

    @property
    def restricted_bins(self) -> Optional[Tuple[int, ...]]:
        """Bin offsets of the localization search under an orientation
        prior: range(-n, n+1), n = int(ori_noise / bin_degrees)."""
        if self.ori_noise is None:
            return None
        n = int(self.ori_noise / self.bin_degrees)
        return tuple(range(-n, n + 1))


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters (the port's copy of ccvpe_tpu/core/config.py
    TrainConfig, :206-261, every field kept; reference train_VIGOR.py:25-34,
    104-109).

    `flatten_optimizer` raveled the parameters into one vector for optax in
    the JAX package, which changes no numbers; the port accepts it and
    ignores it. The run-management fields are read by train/trainer.py:
    `epochs`, `seed` (the initial weights, and drop-connect's per-step seeds),
    `pretrained_backbone`, `warm_start`, `checkpoint_dir`, `keep_checkpoints`,
    `checkpoint_every_steps`, `log_every` and `fake_fail_at_step`.
    `data_axis` and `model_axis` name the mesh's two axes
    (core/mesh.py::make_mesh, which the Trainer builds): the data axis is
    every process of the run, the model axis has size 1 (ROADMAP.md, queue
    A8)."""

    learning_rate: float = 1e-4
    beta1: float = 0.9
    beta2: float = 0.999
    optimizer: str = "adam"          # 'adam' | 'adamw'
    weight_decay: float = 0.0
    schedule: str = "constant"       # 'constant' | 'warmup_cosine' (needs total_steps)
    warmup_steps: int = 0
    total_steps: Optional[int] = None
    grad_clip_norm: Optional[float] = None
    flatten_optimizer: bool = True   # accepted, ignored (see above)
    batch_size: int = 8              # global batch
    # sequential microbatches per step, gradients averaged before one
    # update; BN batch statistics are per microbatch and the running stats
    # are threaded from one microbatch to the next
    grad_accum_steps: int = 1
    epochs: int = 15                 # VIGOR 15, KITTI 6, Oxford 50
    weight_infonce: float = 1e4
    weight_ori: float = 1e1
    temperature: float = 0.1         # infoNCE temperature (losses.py:4)
    infonce_global_negatives: bool = False
    seed: int = 17
    pretrained_backbone: Optional[str] = None
    warm_start: Optional[str] = None
    data_axis: str = "data"
    model_axis: str = "model"
    checkpoint_dir: str = "checkpoints"
    keep_checkpoints: int = 3
    log_every: int = 200
    checkpoint_every_steps: Optional[int] = None
    fake_fail_at_step: Optional[int] = None


def vigor(ori_noise: Optional[float] = None, circular: bool = True) -> ModelConfig:
    """CVM_VIGOR / CVM_VIGOR_ori_prior."""
    return ModelConfig(name="vigor", circular=circular, ori_noise=ori_noise)


def kitti() -> ModelConfig:
    """CVM_KITTI: 16 bins, D=2048, level-6 roll shift 8."""
    return ModelConfig(
        name="kitti",
        grd_size=(256, 1024),
        circular=False,
        grd_desc_channels=(16, 8, 4, 2, 1, 1),
        sat_desc_dim=2048,
        num_bins=16,
        roll_shifts=(128, 64, 32, 16, 8, 8),
        loc_deconv_out=(1024, 256, 128, 64, 32, 16),
        loc_conv_out=(512, 256, 128, 128, 32),
        ori_deconv_out=(1024, 256, 128, 64, 32, 16),
        ori_conv_out=(512, 256, 128, 64, 32),
    )


def oxford() -> ModelConfig:
    """CVM_OxfordRobotCar: centre-window matching, ground 154x231."""
    return ModelConfig(
        name="oxford",
        grd_size=(154, 231),
        circular=False,
        grd_desc_channels=(32, 16, 8, 4, 2, 1),
        center_window=True,
    )


def tiny(sat: int = 128, grd: Tuple[int, int] = (64, 128)) -> ModelConfig:
    """Miniature config with the same topology, for tests: grid * 2^6 = sat,
    scale-i descriptor length equals the scale-i sat channel count."""
    return ModelConfig(
        name="tiny",
        grd_size=grd,
        sat_size=(sat, sat),
        circular=True,
        grd_desc_channels=(64, 32, 16, 8, 4, 2),
        sat_desc_dim=256,
        sat_grid=max(1, sat // 64),
        num_bins=4,
        roll_shifts=(64, 32, 16, 8, 4, 2),
        loc_deconv_out=(128, 64, 32, 16, 8, 16),
        loc_conv_out=(128, 64, 32, 16, 8),
        ori_deconv_out=(128, 64, 32, 16, 8, 16),
        ori_conv_out=(128, 64, 32, 16, 8),
    )
