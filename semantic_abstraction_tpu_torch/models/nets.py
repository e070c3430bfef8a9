"""SemAbs3D, the OVSSC "ours" network (reference net.py:319-439).

Counterpart of ``semantic_abstraction_tpu/models/nets.py``'s
``SemAbs3DConfig``, ``init_semabs3d``, ``semabs3d_feature_vol`` and
``semabs3d_forward``: per-patch xyz repeat, the point-feature MLP on
cat(xyz, feats), the voxel scatter (f32), the cast to the compute dtype,
the optional TSDF channel, the 3D ResUNet, and the implicit decoder at the
query points. The JAX package's ``blocked_basis``, remat and
``unet_batch_chunk`` options change no value and are not ported: the port
runs the dense NCDHW form on all volumes at once. The other
nets (SemanticAware, the VOOL family) are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..clip.model import resolve_device
from ..ops.voxel import VoxelGrid
from .decoder import ImplicitDecoder, implicit_decoder, init_implicit_decoder
from .params import init_linear_, linear, linear_params
from .unet3d import (
    ResidualUNet3D,
    feature_maps_per_level,
    init_residual_unet3d,
    residual_unet3d,
)

# Fixed relation vocabulary (reference net.py:490-503 ParameterDict keys); a
# copy of the JAX package's, for the VOOL nets and the data pipeline.
RELATIONS = (
    "in",
    "behind",
    "in front of",
    "on the left of",
    "on the right of",
    "on",
    "[pad]",
)

# QUIRK (reference net.py:186-199): VirtualGrid.scatter_points ignores its
# reduce_method argument and reads the grid's own field, which SemAbs3D
# never sets, so every reference model scatters with MEAN and the released
# checkpoints were trained that way.
SCATTER_REDUCE = "mean"


@dataclasses.dataclass(frozen=True)
class SemAbs3DConfig:
    """Reference defaults from utils.py:38-100."""

    voxel_shape: Tuple[int, int, int] = (128, 128, 128)
    scene_bounds: Tuple[Tuple[float, float, float], Tuple[float, float, float]] = (
        (-1.0, -1.0, -0.1),
        (1.0, 1.0, 1.9),
    )
    unet_num_channels: int = 16
    unet_f_maps: int = 16
    unet_num_groups: int = 8
    unet_num_levels: int = 6
    network_inputs: Tuple[str, ...] = ("saliency",)
    use_pts_feat_extractor: bool = True
    pts_feat_extractor_hidden_dim: int = 128
    # the reference's configured value, checked at init; the scatter itself
    # always takes the mean (see SCATTER_REDUCE)
    reduce_method: str = "max"
    output_dim: int = 1
    decoder_concat_xyz_pts: bool = True

    @property
    def pts_feature_dim(self) -> int:
        return (("saliency" in self.network_inputs)
                + 3 * ("rgb" in self.network_inputs)
                + ("patch_masks" in self.network_inputs))

    @property
    def unet_in_channels(self) -> int:
        if self.use_pts_feat_extractor:
            return self.unet_num_channels
        return self.pts_feature_dim + ("tsdf" in self.network_inputs)

    @property
    def grid(self) -> VoxelGrid:
        return VoxelGrid(lower=self.scene_bounds[0], upper=self.scene_bounds[1],
                         grid_shape=self.voxel_shape)


class SemAbs3D(nn.Module):
    """Parameters under the reference state-dict names:
    ``pts_feat_extractor.{0,2,4}``, ``vol_feature_extractor.*``,
    ``visual_sampler.mlp.{0,2}``, and the ``steps`` buffer the reference
    keeps (a counter its forward does not read)."""

    def __init__(self, cfg: SemAbs3DConfig, unet: ResidualUNet3D,
                 decoder: ImplicitDecoder):
        super().__init__()
        if cfg.use_pts_feat_extractor:
            h = cfg.pts_feat_extractor_hidden_dim
            out = cfg.unet_num_channels - int("tsdf" in cfg.network_inputs)
            self.pts_feat_extractor = nn.Sequential(
                linear_params(cfg.pts_feature_dim + 3, h), nn.LeakyReLU(0.01),
                linear_params(h, h), nn.LeakyReLU(0.01),
                linear_params(h, out),
            )
        self.vol_feature_extractor = unet
        self.visual_sampler = decoder
        self.register_buffer("steps", torch.zeros(1))


def empty_semabs3d(cfg: SemAbs3DConfig) -> SemAbs3D:
    """A ``SemAbs3D`` of the config's shapes with uninitialized values."""
    unet = ResidualUNet3D(cfg.unet_in_channels, cfg.unet_num_channels,
                          feature_maps_per_level(cfg.unet_f_maps, cfg.unet_num_levels))
    dec = ImplicitDecoder(cfg.unet_num_channels, cfg.output_dim,
                          cfg.decoder_concat_xyz_pts)
    return SemAbs3D(cfg, unet, dec)


def init_semabs3d(seed: int, cfg: SemAbs3DConfig, device=None) -> SemAbs3D:
    """Random f32 weights with the JAX package's distributions, drawn on
    the CPU from ``torch.Generator().manual_seed(seed)`` (so one seed gives
    the same weights on every device), on ``device`` (cuda unless asked)."""
    if cfg.use_pts_feat_extractor and cfg.reduce_method != "max":
        raise ValueError("the point-feature extractor needs reduce_method "
                         "'max' (reference net.py:368)")
    dev = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    unet = init_residual_unet3d(g, cfg.unet_in_channels, cfg.unet_num_channels,
                                cfg.unet_f_maps, cfg.unet_num_levels)
    dec = init_implicit_decoder(g, cfg.unet_num_channels, cfg.output_dim,
                                cfg.decoder_concat_xyz_pts)
    model = SemAbs3D(cfg, unet, dec)
    if cfg.use_pts_feat_extractor:
        for i in (0, 2, 4):
            init_linear_(model.pts_feat_extractor[i], g)
    return model.to(dev)


def _pts_feat_mlp(seq: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
    x = F.leaky_relu(linear(seq[0], x), 0.01)
    x = F.leaky_relu(linear(seq[2], x), 0.01)
    return linear(seq[4], x)


def semabs3d_feature_vol(model: SemAbs3D, cfg: SemAbs3DConfig,
                         input_xyz_pts: torch.Tensor,
                         input_feature_pts: torch.Tensor,
                         tsdf_vol: Optional[torch.Tensor] = None,
                         valid_mask: Optional[torch.Tensor] = None,
                         compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Point features -> UNet feature volume (B*P, C, gx, gy, gz).

    input_xyz_pts (B, N, 3), input_feature_pts (B, P, N, F); ``tsdf_vol``
    (B, gx, gy, gz) when the config takes it; ``valid_mask`` (B, N) drops
    padded points from the scatter."""
    b, p, n, f = input_feature_pts.shape
    xyz = input_xyz_pts[:, None].expand(b, p, n, 3).reshape(b * p, n, 3)
    feats = input_feature_pts.reshape(b * p, n, f)
    if cfg.use_pts_feat_extractor:
        feats = _pts_feat_mlp(model.pts_feat_extractor, torch.cat([xyz, feats], -1))
    if valid_mask is not None:
        valid_mask = valid_mask[:, None].expand(b, p, n).reshape(b * p, n)
    vol = cfg.grid.scatter_points(xyz, feats, SCATTER_REDUCE, valid_mask)
    vol = vol.to(compute_dtype)
    if "tsdf" in cfg.network_inputs:
        tsdf = tsdf_vol.reshape(b, 1, *cfg.voxel_shape).expand(b, p, *cfg.voxel_shape)
        tsdf = tsdf.reshape(b * p, 1, *cfg.voxel_shape)
        vol = torch.cat([tsdf.to(vol.dtype), vol], dim=1)
    return residual_unet3d(model.vol_feature_extractor, vol, cfg.unet_num_groups,
                           compute_dtype)


def semabs3d_forward(model: SemAbs3D, cfg: SemAbs3DConfig,
                     input_xyz_pts: torch.Tensor, input_feature_pts: torch.Tensor,
                     output_xyz_pts: torch.Tensor,
                     tsdf_vol: Optional[torch.Tensor] = None,
                     valid_mask: Optional[torch.Tensor] = None,
                     compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Full SemAbs3D: output_xyz_pts (B, Q, M, 3) -> logits (B, Q, M) when
    output_dim == 1, else (B, Q, M, output_dim). With fewer patches than
    queries (one patch), the volume is shared across the queries
    (reference net.py:411-417)."""
    b, p = input_feature_pts.shape[:2]
    q, m = output_xyz_pts.shape[1:3]
    vols = semabs3d_feature_vol(model, cfg, input_xyz_pts, input_feature_pts,
                                tsdf_vol, valid_mask, compute_dtype)
    if p < q:
        vols = vols.reshape(b, p, *vols.shape[1:]).expand(b, q, *vols.shape[1:])
        vols = vols.reshape(b * q, *vols.shape[2:])
    out = implicit_decoder(model.visual_sampler, vols, cfg.grid,
                           output_xyz_pts.reshape(b * q, m, 3),
                           cfg.decoder_concat_xyz_pts)
    out = out.reshape(b, q, m, cfg.output_dim)
    return out[..., 0] if cfg.output_dim == 1 else out
