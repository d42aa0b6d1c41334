"""Typed configuration with named presets: the port's own copy of
``sipmask_tpu/config.py`` (frozen dataclasses and the preset registry).

The port keeps this copy instead of loading the JAX package's module, so it
never touches a file of ``sipmask_tpu``. The two stay equal field for field
and preset for preset (``tests/test_torch_ops.py`` compares every preset).
Config objects made by either package work in both: the port only reads
their fields. Field defaults mirror the reference's
``sipmask_r50_caffe_fpn_gn_1x.py:1-139``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

INF = 1e8


@dataclass(frozen=True)
class BackboneConfig:
    """Backbone: caffe-style ResNet/ResNeXt (mmdet resnet.py:319-521,
    resnext.py) or HRNet (mmdet hrnet.py)."""

    type: str = "resnet"  # 'resnet' | 'hrnet'
    hrnet_width: int = 32  # 18/32/48 when type='hrnet'
    depth: int = 50  # 50 or 101
    num_stages: int = 4
    out_indices: Tuple[int, ...] = (0, 1, 2, 3)
    frozen_stages: int = 1
    style: str = "caffe"  # stride-2 on first 1x1 conv of bottleneck
    # DCN stages for SipMask++ (configs/sipmask/sipmask++_r101_caffe_fpn_ssd_6x.py:13-14)
    stage_with_dcn: Tuple[bool, ...] = (False, False, False, False)
    dcn_deform_groups: int = 1
    # ResNeXt (groups > 1): e.g. X-101 32x4d -> groups=32, base_width=4
    groups: int = 1
    base_width: int = 4


@dataclass(frozen=True)
class FPNConfig:
    """FPN P3..P7 (reference: mmdet/models/necks/fpn.py:10-178, config :13-21)
    or HRFPN (mmdet necks/hrfpn.py) for HRNet backbones."""

    type: str = "fpn"  # 'fpn' | 'hrfpn'
    in_channels: Tuple[int, ...] = (256, 512, 1024, 2048)
    out_channels: int = 256
    start_level: int = 1
    num_outs: int = 5
    add_extra_convs: bool = True
    extra_convs_on_inputs: bool = False  # extra conv from P5 (not C5)
    relu_before_extra_convs: bool = True


@dataclass(frozen=True)
class HeadConfig:
    """SipMask head (reference: mmdet/models/anchor_heads/sipmask_head.py:107-239)."""

    num_classes: int = 80  # foreground classes (reference num_classes=81 incl. bg)
    in_channels: int = 256
    feat_channels: int = 256
    stacked_convs: int = 4  # cls tower uses stacked_convs-1, reg tower stacked_convs
    strides: Tuple[int, ...] = (8, 16, 32, 64, 128)
    regress_ranges: Tuple[Tuple[float, float], ...] = (
        (-1, 64), (64, 128), (128, 256), (256, 512), (512, INF))
    center_sampling: bool = True
    center_sample_radius: float = 1.5
    norm: Optional[str] = "gn"  # 'gn' (GroupNorm32) or None (real-time variants)
    num_bases: int = 32  # nc in reference (:192)
    ssd_flag: bool = False  # real-time path: fast_nms + scale-factor mask resize
    rescoring: bool = False  # SipMask++ mask re-scoring module (:200-219)
    track: bool = False  # SipMask-VIS tracking branch
    # loss hyperparameters (config :29-37)
    focal_gamma: float = 2.0
    focal_alpha: float = 0.25
    loss_cls_weight: float = 1.0
    loss_bbox_weight: float = 1.0
    loss_centerness_weight: float = 1.0
    iou_loss_mode: str = "log"  # 'log' (mmdet IoULoss) or 'giou' (benchmark)
    # SipMask-benchmark fork's loss deltas (fcos_core/modeling/rpn/sipmask/
    # loss.py): NMS-0.9 dedup of mask positives (+1 IoU, ranked by cls
    # score, :452-456), the loss_mask>1 -> x0.5 cap (:487-488), no +1e-4
    # weighting-normalizer eps (:450), max(num_pos,1) cls normalizer
    # (:377-383), and fcos_core's ltrb-GIoU on relu'd normalized deltas.
    benchmark_loss_extras: bool = False


@dataclass(frozen=True)
class TestConfig:
    """Inference settings (reference test_cfg, config :51-56)."""

    nms_pre: int = 1000  # per-level top-k prefilter
    # static cap on (box, class) score pairs entering the hard multiclass
    # NMS. The reference NMSes every pair above score_thr (bbox_nms.py:110-130,
    # up to nms_pre*num_levels rows x num_classes); 5000 covers every
    # realistic crowded-scene distribution (tests/test_reference_parity.py
    # measures zero keep-set divergence), diverging only on adversarial
    # many-duplicates-high-on-all-classes inputs no trained detector emits.
    pre_nms_pairs: int = 5000
    score_thr: float = 0.05
    nms_iou_thr: float = 0.5
    nms_type: str = "nms"  # 'nms' (hard) | 'soft_nms' (linear/gaussian decay)
    soft_nms_method: str = "linear"
    soft_nms_sigma: float = 0.5
    soft_nms_min_score: float = 1e-3
    max_per_img: int = 100
    mask_thr: float = 0.4
    use_fast_nms: bool = False  # forced True when head.ssd_flag
    fast_nms_top_k: int = 200  # per-class top-k inside fast_nms (:868)


@dataclass(frozen=True)
class TrackConfig:
    """VIS tracker (reference SipMask-VIS sipmask_head.py:166,544-562)."""

    max_tracks: int = 64  # fixed-capacity track memory
    match_coeff: Tuple[float, float, float] = (1.0, 2.0, 10.0)  # det, iou, label
    embed_channels: int = 512


@dataclass(frozen=True)
class ModelConfig:
    backbone: BackboneConfig = field(default_factory=BackboneConfig)
    fpn: FPNConfig = field(default_factory=FPNConfig)
    head: HeadConfig = field(default_factory=HeadConfig)
    test: TestConfig = field(default_factory=TestConfig)
    track: TrackConfig = field(default_factory=TrackConfig)
    # compute dtype for conv towers ('float32' or 'bfloat16'); params stay fp32
    compute_dtype: str = "float32"


@dataclass(frozen=True)
class DataConfig:
    """Static-shape input pipeline settings.

    The reference pads to size_divisor=32 with dynamic shapes; on TPU we pad
    to fixed buckets (landscape/portrait for keep-ratio resize, single square
    for the real-time variant).
    """

    img_scale: Tuple[int, int] = (1333, 800)  # (long, short) keep-ratio target
    # multi-scale training: one scale sampled per image (the reference's
    # Resize with a list of img_scales); padding buckets use the largest
    ms_scales: Optional[Tuple[Tuple[int, int], ...]] = None
    # 'range' (the reference Resize/random_scale DEFAULT, used by every ms
    # config): long/short edges each drawn uniformly via randint between
    # the two scales' endpoints. 'value': pick one scale from the list.
    ms_mode: str = "range"
    keep_ratio: bool = True
    fixed_size: Optional[Tuple[int, int]] = None  # (H, W); real-time: (544, 544)
    # train-time stretch size when it differs from fixed_size: the 6x RT
    # recipe TRAINS at a 576x576 stretch and tests at 544 (ssd_6x.py:83).
    # None -> train at fixed_size (so a plain fixed_size override still
    # controls both train and test).
    train_size: Optional[Tuple[int, int]] = None
    flip_ratio: float = 0.5
    # caffe BGR means, std 1 (config :60-61)
    mean: Tuple[float, float, float] = (102.9801, 115.9465, 122.7717)
    std: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    to_rgb: bool = False  # keep BGR (caffe backbone)
    size_divisor: int = 32
    ssd_augs: bool = False  # PhotoMetricDistortion/Expand/MinIoURandomCrop
    repeat_times: int = 1  # RepeatDataset wrapper (ssd_6x uses 3)
    max_gts: int = 64  # static pad of gt instances per image
    # host loader workers (reference workers_per_gpu): threads by default;
    # set num_worker_procs > 0 for real processes when the numpy share of
    # the pipeline is GIL-bound on many-core hosts
    num_workers: int = 8
    num_worker_procs: int = 0


@dataclass(frozen=True)
class OptimConfig:
    """SGD + warmup/step schedule (reference config :108-121)."""

    lr: float = 0.01
    momentum: float = 0.9
    weight_decay: float = 1e-4
    bias_lr_mult: float = 2.0
    bias_decay_mult: float = 0.0
    warmup: str = "constant"  # 'constant' or 'linear'
    warmup_iters: int = 500
    warmup_ratio: float = 1.0 / 3
    lr_steps: Tuple[int, ...] = (8, 11)  # epochs
    total_epochs: int = 12
    grad_clip: Optional[float] = None


@dataclass(frozen=True)
class TrainConfig:
    imgs_per_device: int = 4
    # static cap of mask-loss positives per image. Measured at 800x1344
    # (center sampling r=1.5): ~9.3 positives per gt, so 512 covers ~55
    # objects/image — beyond COCO's crowded tail under the max_gts=64 pad;
    # the reference uses all positives (dynamic). When truncation does hit,
    # the top-K-by-weighting selection keeps the highest cls x IoU positives
    # that dominate the renormalized loss. Real-time presets use 256
    # (cropped SSD-style training rarely exceeds ~27 objects).
    max_pos: int = 512
    optim: OptimConfig = field(default_factory=OptimConfig)
    seed: int = 0
    log_interval: int = 50
    checkpoint_interval_epochs: int = 1


@dataclass(frozen=True)
class SipMaskConfig:
    name: str = "sipmask_r50_fpn_gn_1x"
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    def replace(self, **kw) -> "SipMaskConfig":
        return dataclasses.replace(self, **kw)


def _r(cfg, path: str, **kw):
    """Nested dataclasses.replace: _r(cfg, 'model.head', ssd_flag=True)."""
    parts = path.split(".") if path else []
    if not parts:
        return dataclasses.replace(cfg, **kw)
    head_name = parts[0]
    child = getattr(cfg, head_name)
    new_child = _r(child, ".".join(parts[1:]), **kw)
    return dataclasses.replace(cfg, **{head_name: new_child})


def apply_overrides(cfg: SipMaskConfig, options) -> SipMaskConfig:
    """CLI config overrides, the analog of the benchmark fork's YACS ``opts``
    key-value pairs (tools/train_net.py --opts) and mmdetection's limited
    argparse flags.

    ``options``: iterable of "dotted.path=value" strings; values parsed with
    ast.literal_eval (falling back to raw string), e.g.
    ``data.fixed_size=(256,256) train.optim.lr=0.005 model.head.norm=None``.
    """
    import ast

    for opt in options or []:
        path, _, raw = opt.partition("=")
        if not _:
            raise ValueError(f"override {opt!r} must be key=value")
        try:
            value = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            value = raw  # plain string (e.g. norm=gn)
        parent, _, leaf = path.strip().rpartition(".")
        # validate the leaf exists so typos fail loudly
        node = cfg
        for part in [p for p in parent.split(".") if p]:
            node = getattr(node, part)
        if not hasattr(node, leaf):
            raise AttributeError(f"config has no field {path!r}")
        cfg = _r(cfg, parent, **{leaf: value})
    return cfg


def _hi_acc_base() -> SipMaskConfig:
    return SipMaskConfig()


def _realtime_base(name: str) -> SipMaskConfig:
    """Real-time 'SSD-style' variant (configs/sipmask/sipmask_r50_caffe_fpn_ssd_6x.py)."""
    cfg = SipMaskConfig(name=name)
    cfg = _r(cfg, "model.head", stacked_convs=2, norm=None, ssd_flag=True)
    cfg = _r(cfg, "model.test", score_thr=0.1, use_fast_nms=True, nms_pre=1000)
    cfg = _r(cfg, "data", fixed_size=(544, 544), train_size=(576, 576),
             ssd_augs=True, repeat_times=3)
    cfg = _r(cfg, "train", imgs_per_device=8, max_pos=256)
    cfg = _r(cfg, "train.optim", lr_steps=(20, 23), total_epochs=24,
             warmup="linear")
    return cfg


def get_config(name: str) -> SipMaskConfig:
    """Named presets mirroring the reference's config matrix (SURVEY.md 2.5)."""
    if name == "sipmask_r50_fpn_gn_1x":
        return _hi_acc_base().replace(name=name)
    if name == "sipmask_r50_fpn_gn_ms_2x":
        cfg = _hi_acc_base().replace(name=name)
        cfg = _r(cfg, "data", ms_scales=((1333, 640), (1333, 800)))
        return _r(cfg, "train.optim", lr_steps=(16, 22), total_epochs=24)
    if name == "sipmask_r101_fpn_gn_ms_4x":
        cfg = _hi_acc_base().replace(name=name)
        cfg = _r(cfg, "model.backbone", depth=101)
        cfg = _r(cfg, "data", ms_scales=((1333, 640), (1333, 800)))
        return _r(cfg, "train.optim", lr_steps=(32, 44), total_epochs=48)
    if name == "sipmask_r50_fpn_ssd_6x":
        return _realtime_base(name)
    if name == "sipmask_r101_fpn_ssd_6x":
        cfg = _realtime_base(name)
        return _r(cfg, "model.backbone", depth=101)
    if name == "sipmask_r50_fpn_ssd_10x_gn":
        cfg = _realtime_base(name)
        cfg = _r(cfg, "model.head", norm="gn")
        return _r(cfg, "train.optim", lr_steps=(36, 40), total_epochs=42)
    if name == "sipmaskpp_r101_fpn_ssd_6x":
        # SipMask++: DCN backbone stages 2-4 + rescoring
        # (configs/sipmask/sipmask++_r101_caffe_fpn_ssd_6x.py:13-14,31)
        cfg = _realtime_base(name)
        cfg = _r(cfg, "model.backbone", depth=101,
                 stage_with_dcn=(False, True, True, True))
        return _r(cfg, "model.head", rescoring=True)
    if name == "sipmask_x101_fpn_gn_ms_2x":
        # ResNeXt-101 32x4d backbone variant (mmdet resnext.py capability)
        cfg = _hi_acc_base().replace(name=name)
        cfg = _r(cfg, "model.backbone", depth=101, groups=32, base_width=4)
        cfg = _r(cfg, "data", ms_scales=((1333, 640), (1333, 800)))
        return _r(cfg, "train.optim", lr_steps=(16, 22), total_epochs=24)
    if name == "sipmask_hrnet_w32_fpn_gn_1x":
        # HRNetV2-W32 + HRFPN variant (mmdet hrnet.py / hrfpn.py capability)
        cfg = _hi_acc_base().replace(name=name)
        cfg = _r(cfg, "model.backbone", type="hrnet", hrnet_width=32)
        return _r(cfg, "model.fpn", type="hrfpn", start_level=0)
    if name == "sipmask_benchmark_r50_fpn_1x":
        # SipMask-benchmark fork row (SipMask-benchmark/configs/sipmask/
        # sipmask_R_50_FPN_1x.yaml): GIoU box loss, ml_nms at 0.6, and the
        # fork's mask-loss extras (NMS-0.9 positive dedup + >1 -> x0.5 cap).
        # Its 90k-iter/batch-16 schedule maps to the same 1x epochs here.
        # norm_reg_targets/centerness-on-reg are unified into the shared
        # head (centerness already comes off the reg tower; box deltas are
        # stride-scaled at forward like the mmdet fork) — see PARITY.md.
        cfg = _hi_acc_base().replace(name=name)
        cfg = _r(cfg, "model.head", iou_loss_mode="giou",
                 benchmark_loss_extras=True)
        return _r(cfg, "model.test", nms_iou_thr=0.6)
    if name == "sipmask_vis_r50":
        # SipMask-VIS (SipMask-VIS/configs/sipmask/sipmask_r50_caffe_fpn_gn_1x.py:22-56)
        cfg = SipMaskConfig(name=name)
        cfg = _r(cfg, "model.head", num_classes=40, stacked_convs=3, track=True)
        cfg = _r(cfg, "model.test", nms_pre=200, score_thr=0.03, max_per_img=10,
                 use_fast_nms=True, mask_thr=0.5)
        cfg = _r(cfg, "data", img_scale=(640, 360))
        cfg = _r(cfg, "train", max_pos=256)  # 360x640, <=10 objects typical
        return _r(cfg, "train.optim", lr=0.005)
    if name == "sipmask_vis_r50_ms":
        # VIS multi-scale training row (reference README:155)
        cfg = get_config("sipmask_vis_r50").replace(name=name)
        # (649, 360) preserves the reference config's literal value
        # (SipMask-VIS/configs/sipmask/sipmask_r50_caffe_fpn_gn_ms_1x.py:69
        # — presumably a 640 typo, but it is what the recipe trains with):
        # range mode draws long in [649, 960], short in [360, 480]
        return _r(cfg, "data", ms_scales=((649, 360), (960, 480)))
    raise KeyError(f"unknown config preset: {name!r}; known: {list_configs()}")


def list_configs():
    return [
        "sipmask_r50_fpn_gn_1x",
        "sipmask_r50_fpn_gn_ms_2x",
        "sipmask_r101_fpn_gn_ms_4x",
        "sipmask_r50_fpn_ssd_6x",
        "sipmask_r101_fpn_ssd_6x",
        "sipmask_r50_fpn_ssd_10x_gn",
        "sipmaskpp_r101_fpn_ssd_6x",
        "sipmask_x101_fpn_gn_ms_2x",
        "sipmask_hrnet_w32_fpn_gn_1x",
        "sipmask_benchmark_r50_fpn_1x",
        "sipmask_vis_r50",
        "sipmask_vis_r50_ms",
    ]
