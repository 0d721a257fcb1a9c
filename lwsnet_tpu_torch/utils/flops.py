"""Analytical FLOP count of the LWSNet forward pass.

The port's copy of the JAX package's `utils/flops.py`, reading the port's
`ModelConfig`; the same convention and the same numbers.

The MFU denominator must not depend on what a profiler or compiler happens
to count, so the model cost is computed here from the architecture spec —
the same accounting whether a stage runs as cuDNN convs or as a fused
hand-written kernel.

Convention: *algorithmic* multiply-accumulates of the convolutions only
(FLOPs = 2 * MACs). Excluded, deliberately:
  * element-wise work (BN affines, ReLU, L1 cost-volume build, soft-argmin,
    bilinear resizes) — O(activations), <2% of the conv MACs;
  * the warp's gather (ops/stereo.py) — an implementation detail, not
    algorithmic work, and counting it would flatter MFU.

Architecture constants mirror the reference
(reference: models/submodules.py:113-188, 216-221, 282-326).
"""

from __future__ import annotations

from lwsnet_tpu_torch.config import ModelConfig


def _feature_extractor_macs(cfg: ModelConfig, H: int, W: int) -> int:
    """Per-image conv MACs of FeatureExtractor (models/feature.py)."""
    c = cfg.feature_channels
    p2 = (H // 2) * (W // 2)
    p4 = (H // 4) * (W // 4)
    p8 = (H // 8) * (W // 8)
    m = 0
    # dres0: 3 -> c/2 (s2), c/2 -> c
    m += p2 * (c // 2) * 3 * 9
    m += p2 * c * (c // 2) * 9
    # dres1 residual block: c -> c/2 -> c
    m += p2 * (c // 2) * c * 9
    m += p2 * c * (c // 2) * 9
    # hourglass: conv1 (s2, c->2c), conv2, conv3 (s2), conv4
    m += p4 * (2 * c) * c * 9
    m += p4 * (2 * c) * (2 * c) * 9
    m += p8 * (2 * c) * (2 * c) * 9
    m += p8 * (2 * c) * (2 * c) * 9
    # deconv5 (1/8 -> 1/4, 2c -> 2c): transposed-conv MACs = in_pixels*k^2*Ci*Co
    m += p8 * 9 * (2 * c) * (2 * c)
    # deconv6 (1/4 -> 1/2, 2c -> c)
    m += p4 * 9 * (2 * c) * c
    # classif1 head: two 3x3 c -> c convs at 1/2 res
    m += 2 * p2 * c * c * 9
    return m


def _cost_filter_macs(cfg: ModelConfig, H: int, W: int, scale: int) -> int:
    """CostFilter3D at cascade scale (0-indexed): (layers+2) 3x3x3 convs over
    the (H/s, W/s, D) volume (models/blocks.py, `CostFilter3D`)."""
    s = 8 >> scale  # 8, 4, 2
    D = cfg.max_disp_list[scale] if scale == 0 \
        else 2 * cfg.max_disp_list[scale] - 1
    C = cfg.channels_3d * cfg.growth_rate[scale]
    voxels = (H // s) * (W // s) * D
    ch_macs = 1 * C + cfg.layers_3d * C * C + C * 1
    return voxels * 27 * ch_macs


def _refinement_macs(cfg: ModelConfig, H: int, W: int) -> int:
    """Stage-4 towers + head (models/refinement.py)."""
    F = cfg.refine_channels
    P = H * W
    m = 0
    # towers: entry 3->F and 1->F 3x3 convs, then 4 dw-sep layers each
    m += P * F * 3 * 9 + P * F * 1 * 9
    m += 2 * 4 * (P * F * 9 + P * F * F)  # dw 3x3 + pw 1x1, both towers
    # head: dense 2F->F 3x3, 4 dw-sep layers, out 3x3 F->1
    m += P * F * (2 * F) * 9
    m += 4 * (P * F * 9 + P * F * F)
    m += P * 1 * F * 9
    return m


def forward_macs(cfg: ModelConfig, H: int, W: int, batch: int = 1,
                 num_stages: int = 4) -> int:
    """Conv MACs of one `num_stages` forward at (batch, H, W)."""
    m = 2 * _feature_extractor_macs(cfg, H, W)  # left + right
    for scale in range(min(num_stages, 3)):
        m += _cost_filter_macs(cfg, H, W, scale)
    if num_stages >= 4:
        m += _refinement_macs(cfg, H, W)
    return batch * m


def forward_flops(cfg: ModelConfig, H: int, W: int, batch: int = 1,
                  num_stages: int = 4) -> int:
    """Conv FLOPs (2 * MACs) of one forward."""
    return 2 * forward_macs(cfg, H, W, batch, num_stages)
