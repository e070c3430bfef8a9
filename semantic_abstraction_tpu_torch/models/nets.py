"""The five nets of the reference (net.py:319-678): SemAbs3D (OVSSC
"ours"), SemanticAwareOVSSC, SemAbsVOOL (VOOL "ours"), SemanticAwareVOOL
and ClipSpatialVOOL.

Counterpart of ``semantic_abstraction_tpu/models/nets.py``: a config, an
``nn.Module`` holding f32 parameters under the reference's state-dict
names, a seeded init (``torch.Generator``, the JAX package's
distributions) and a forward function per net. SemAbs3D's forward is the
per-patch xyz repeat, the point-feature MLP on cat(xyz, feats), the voxel
scatter (f32), the cast to the compute dtype, the optional TSDF channel,
the 3D ResUNet, and the implicit decoder at the query points.

The JAX package's ``blocked_basis``, remat, ``unet_batch_chunk`` and
VOOL's ``desc_chunk`` / ``desc_unroll`` / ``desc_lookahead`` /
``stack_streams`` schedule work or memory for a TPU and change no value;
they are not ported. The port runs the dense NCDHW form on all volumes at
once: SemAbsVOOL stacks its target and reference streams of every
description into ONE UNet pass over 2 x D volumes (one launch of each
kernel for both streams, and the batch is what the card is fast at).

The relation vocabulary is a (7, d) table indexed by integer relation
ids (``RELATIONS`` order), so its gradient is dense with zero rows, as in
JAX; the reference keeps one parameter per relation name
(``relation_embeddings.in front of``), and ``convert.py`` maps between the
two layouts.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..clip.model import resolve_device
from ..ops.voxel import VoxelGrid
from .decoder import (
    ImplicitDecoder,
    PointingAttention,
    implicit_decoder,
    init_implicit_decoder,
    init_pointing_attention,
    pointing_attention,
    pointing_attention_paired,
)
from .params import init_linear_, linear, linear_params
from .unet3d import (
    ResidualUNet3D,
    feature_maps_per_level,
    init_residual_unet3d,
    residual_unet3d,
)

# Fixed relation vocabulary (reference net.py:490-503 ParameterDict keys) and
# its ids; a copy of the JAX package's, for the VOOL nets and the data
# pipeline.
RELATIONS = (
    "in",
    "behind",
    "in front of",
    "on the left of",
    "on the right of",
    "on",
    "[pad]",
)
RELATION_TO_ID = {r: i for i, r in enumerate(RELATIONS)}

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


def _build_semabs3d(cfg: SemAbs3DConfig, g: torch.Generator, cls=SemAbs3D,
                    **extra) -> SemAbs3D:
    """A ``cls`` (SemAbs3D or a subclass taking ``extra`` modules) on the
    CPU, its weights drawn from ``g``."""
    if cfg.use_pts_feat_extractor and cfg.reduce_method != "max":
        raise ValueError("the point-feature extractor needs reduce_method "
                         "'max' (reference net.py:368)")
    fmaps = feature_maps_per_level(cfg.unet_f_maps, cfg.unet_num_levels)
    unet = init_residual_unet3d(g, cfg.unet_in_channels, cfg.unet_num_channels, fmaps)
    dec = init_implicit_decoder(g, cfg.unet_num_channels, cfg.output_dim,
                                cfg.decoder_concat_xyz_pts)
    model = cls(cfg, unet, dec, **extra)
    if cfg.use_pts_feat_extractor:
        for i in (0, 2, 4):
            init_linear_(model.pts_feat_extractor[i], g)
    return model


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


# ---------------------------------------------------------------------------
# shared pieces of the other four nets
# ---------------------------------------------------------------------------


def _completion(**kw):
    return dataclasses.field(default_factory=lambda: SemAbs3DConfig(**kw))


def _relation_table(g: torch.Generator, pointing_dim: int) -> nn.Parameter:
    """The (7, d) relation table, N(0, 1) as ``jax.random.normal``."""
    return nn.Parameter(torch.randn((len(RELATIONS), pointing_dim), generator=g))


def _relations(model: nn.Module, spatial_relation_id: torch.Tensor) -> torch.Tensor:
    """(B, D) relation ids -> (B, D, d) rows of the relation table."""
    return model.relation_embeddings[spatial_relation_id.long()]


# ---------------------------------------------------------------------------
# OVSSC: SemanticAwareOVSSC
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SemanticAwareOVSSCConfig:
    """SemAbs3D on RGB with a CLIP-wide output and a class-feature pointer
    (reference net.py:442-466)."""

    completion: SemAbs3DConfig = _completion(network_inputs=("rgb",), output_dim=512)
    pointing_method: str = "cosine_sim"
    pointing_temperature: float = 0.07
    clip_hidden_dim: int = 512


class SemanticAwareOVSSC(SemAbs3D):
    """SemAbs3D's keys at the root (the reference subclasses it), plus
    ``semantic_class_pointer``."""

    def __init__(self, cfg: SemAbs3DConfig, unet: ResidualUNet3D,
                 decoder: ImplicitDecoder, semantic_class_pointer: PointingAttention):
        super().__init__(cfg, unet, decoder)
        self.semantic_class_pointer = semantic_class_pointer


def _build_semantic_aware_ovssc(cfg: SemanticAwareOVSSCConfig, g) -> SemanticAwareOVSSC:
    pointer = init_pointing_attention(g, cfg.clip_hidden_dim, cfg.pointing_method)
    return _build_semabs3d(cfg.completion, g, SemanticAwareOVSSC,
                           semantic_class_pointer=pointer)


def semantic_aware_ovssc_forward(model: SemanticAwareOVSSC,
                                 cfg: SemanticAwareOVSSCConfig,
                                 input_xyz_pts: torch.Tensor,
                                 input_feature_pts: torch.Tensor,
                                 output_xyz_pts: torch.Tensor,
                                 semantic_class_features: torch.Tensor,
                                 tsdf_vol: Optional[torch.Tensor] = None,
                                 valid_mask: Optional[torch.Tensor] = None,
                                 compute_dtype: torch.dtype = torch.float32
                                 ) -> torch.Tensor:
    """semantic_class_features (B, P, E) -> per-point class logits (B, P, M)."""
    sampled = semabs3d_forward(model, cfg.completion, input_xyz_pts,
                               input_feature_pts, output_xyz_pts, tsdf_vol,
                               valid_mask, compute_dtype)  # (B, P, M, E)
    return pointing_attention_paired(
        model.semantic_class_pointer, semantic_class_features, sampled,
        cfg.pointing_method, cfg.clip_hidden_dim, cfg.pointing_temperature)


# ---------------------------------------------------------------------------
# VOOL: SemAbsVOOL, SemanticAwareVOOL, ClipSpatialVOOL
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SemAbsVOOLConfig:
    """Two saliency streams through one completion net, a spatial sampler
    over their channel concat, and a learned relation pointer (reference
    net.py:469-579).

    Completion-decoder quirk (kept): the reference pops
    ``decoder_concat_xyz_pts`` before building the inner SemAbs3D, whose
    own default is False (net.py:334), so the completion decoder has no xyz
    concat (its ``fc1`` is C wide) and only the spatial sampler takes the
    flag. The completion decoder is never read by the forward; the
    reference keeps it for its state-dict layout."""

    completion: SemAbs3DConfig = _completion(decoder_concat_xyz_pts=False)
    pointing_method: str = "cosine_sim"
    pointing_dim: int = 64
    pointing_temperature: float = 0.07
    decoder_concat_xyz_pts: bool = True


class SemAbsVOOL(nn.Module):
    """``completion_net.*`` (a SemAbs3D), ``spatial_sampler.mlp.{0,2}``,
    ``pointer`` and the (7, d) ``relation_embeddings`` table."""

    def __init__(self, completion_net: SemAbs3D, spatial_sampler: ImplicitDecoder,
                 pointer: PointingAttention, relation_embeddings: nn.Parameter):
        super().__init__()
        self.completion_net = completion_net
        self.spatial_sampler = spatial_sampler
        self.pointer = pointer
        self.relation_embeddings = relation_embeddings


def _build_semabs_vool(cfg: SemAbsVOOLConfig, g) -> SemAbsVOOL:
    c = cfg.completion.unet_num_channels
    return SemAbsVOOL(
        _build_semabs3d(cfg.completion, g),
        init_implicit_decoder(g, 2 * c, cfg.pointing_dim, cfg.decoder_concat_xyz_pts),
        init_pointing_attention(g, cfg.pointing_dim, cfg.pointing_method),
        _relation_table(g, cfg.pointing_dim))


def semabs_vool_forward(model: SemAbsVOOL, cfg: SemAbsVOOLConfig,
                        input_xyz_pts: torch.Tensor,
                        input_target_saliency_pts: torch.Tensor,
                        input_reference_saliency_pts: torch.Tensor,
                        output_xyz_pts: torch.Tensor,
                        spatial_relation_id: torch.Tensor,
                        tsdf_vol: Optional[torch.Tensor] = None,
                        valid_mask: Optional[torch.Tensor] = None,
                        compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Saliency streams (B, D, N, 1) + relation ids (B, D) -> logits (B, D, M).

    Both streams of every description go through one UNet pass over the
    2D stacked volumes (the UNet treats each volume on its own, so this is
    the JAX package's two passes, value for value); the sampler reads the
    channel concat, target channels first."""
    b, nd, m = output_xyz_pts.shape[:3]
    ccfg = cfg.completion
    streams = torch.cat([input_target_saliency_pts, input_reference_saliency_pts], 1)
    vols = semabs3d_feature_vol(model.completion_net, ccfg, input_xyz_pts, streams,
                                tsdf_vol, valid_mask, compute_dtype)  # (B*2D, C, ...)
    vols = vols.reshape(b, 2, nd, *vols.shape[1:])
    feature_vol = torch.cat([vols[:, 0], vols[:, 1]], dim=2)  # (B, D, 2C, ...)
    sampled = implicit_decoder(model.spatial_sampler,
                               feature_vol.reshape(b * nd, *feature_vol.shape[2:]),
                               ccfg.grid, output_xyz_pts.reshape(b * nd, m, 3),
                               cfg.decoder_concat_xyz_pts)  # (B*D, M, pd)
    rel = _relations(model, spatial_relation_id)  # (B, D, pd)
    logits = pointing_attention(model.pointer, sampled, rel.reshape(b * nd, 1, -1),
                                cfg.pointing_method, cfg.pointing_dim,
                                cfg.pointing_temperature)
    return logits.reshape(b, nd, m)


@dataclasses.dataclass(frozen=True)
class SemanticAwareVOOLConfig:
    """The RGB baseline with CLIP text-feature queries (reference
    net.py:582-636). It has SemAbsVOOL's completion-decoder quirk, and here
    the quirk changes values: the forward reads the completion decoder's
    output (net.py:623-626)."""

    completion: SemAbs3DConfig = _completion(network_inputs=("rgb",), output_dim=64,
                                             decoder_concat_xyz_pts=False)
    pointing_method: str = "cosine_sim"
    pointing_dim: int = 64
    pointing_temperature: float = 0.07
    clip_hidden_dim: int = 512


class SemanticAwareVOOL(nn.Module):
    """``completion_net.*``, ``pointer``, ``relation_embeddings`` and the
    query ``mlp`` (one Linear over cat(target, reference, relation))."""

    def __init__(self, completion_net: SemAbs3D, pointer: PointingAttention,
                 relation_embeddings: nn.Parameter, mlp: nn.Module):
        super().__init__()
        self.completion_net = completion_net
        self.pointer = pointer
        self.relation_embeddings = relation_embeddings
        self.mlp = mlp


def _build_semantic_aware_vool(cfg: SemanticAwareVOOLConfig, g) -> SemanticAwareVOOL:
    completion = _build_semabs3d(cfg.completion, g)
    pointer = init_pointing_attention(g, cfg.pointing_dim, cfg.pointing_method)
    table = _relation_table(g, cfg.pointing_dim)
    mlp = linear_params(2 * cfg.clip_hidden_dim + cfg.pointing_dim, cfg.pointing_dim)
    init_linear_(mlp, g)
    return SemanticAwareVOOL(completion, pointer, table, mlp)


def semantic_aware_vool_forward(model: SemanticAwareVOOL,
                                cfg: SemanticAwareVOOLConfig,
                                input_xyz_pts: torch.Tensor,
                                input_rgb_pts: torch.Tensor,
                                output_xyz_pts: torch.Tensor,
                                spatial_relation_id: torch.Tensor,
                                target_obj_features: torch.Tensor,
                                reference_obj_features: torch.Tensor,
                                tsdf_vol: Optional[torch.Tensor] = None,
                                valid_mask: Optional[torch.Tensor] = None,
                                compute_dtype: torch.dtype = torch.float32
                                ) -> torch.Tensor:
    """input_rgb_pts (B, D, N, 3); target/reference_obj_features (B, D, E),
    CLIP text features computed beforehand -> logits (B, D, M)."""
    b, nd, m = output_xyz_pts.shape[:3]
    sampled = semabs3d_forward(model.completion_net, cfg.completion, input_xyz_pts,
                               input_rgb_pts, output_xyz_pts, tsdf_vol, valid_mask,
                               compute_dtype)  # (B, D, M, pd)
    rel = _relations(model, spatial_relation_id)
    query = linear(model.mlp, torch.cat([target_obj_features.to(rel.dtype),
                                         reference_obj_features.to(rel.dtype), rel], -1))
    logits = pointing_attention(model.pointer, sampled.reshape(b * nd, m, -1),
                                query.reshape(b * nd, 1, -1), cfg.pointing_method,
                                cfg.pointing_dim, cfg.pointing_temperature)
    return logits.reshape(b, nd, m)


@dataclasses.dataclass(frozen=True)
class ClipSpatialVOOLConfig:
    """The full-description relevancy baseline, no learned relations
    (reference net.py:639-678), with SemAbsVOOL's completion-decoder quirk
    (the completion decoder is built without xyz concat and never read)."""

    completion: SemAbs3DConfig = _completion(decoder_concat_xyz_pts=False)
    decoder_concat_xyz_pts: bool = True


class ClipSpatialVOOL(nn.Module):
    """``completion_net.*`` and ``spatial_sampler.mlp.{0,2}``."""

    def __init__(self, completion_net: SemAbs3D, spatial_sampler: ImplicitDecoder):
        super().__init__()
        self.completion_net = completion_net
        self.spatial_sampler = spatial_sampler


def _build_clip_spatial_vool(cfg: ClipSpatialVOOLConfig, g) -> ClipSpatialVOOL:
    return ClipSpatialVOOL(
        _build_semabs3d(cfg.completion, g),
        init_implicit_decoder(g, cfg.completion.unet_num_channels, 1,
                              cfg.decoder_concat_xyz_pts))


def clip_spatial_vool_forward(model: ClipSpatialVOOL, cfg: ClipSpatialVOOLConfig,
                              input_xyz_pts: torch.Tensor,
                              input_description_saliency_pts: torch.Tensor,
                              output_xyz_pts: torch.Tensor,
                              tsdf_vol: Optional[torch.Tensor] = None,
                              valid_mask: Optional[torch.Tensor] = None,
                              compute_dtype: torch.dtype = torch.float32
                              ) -> torch.Tensor:
    """Description saliency (B, D, N, 1) -> logits (B, D, M)."""
    b, nd, m = output_xyz_pts.shape[:3]
    vol = semabs3d_feature_vol(model.completion_net, cfg.completion, input_xyz_pts,
                               input_description_saliency_pts, tsdf_vol, valid_mask,
                               compute_dtype)
    out = implicit_decoder(model.spatial_sampler, vol, cfg.completion.grid,
                           output_xyz_pts.reshape(b * nd, m, 3),
                           cfg.decoder_concat_xyz_pts)
    return out.reshape(b, nd, m)


# ---------------------------------------------------------------------------
# any of the five nets, by its config
# ---------------------------------------------------------------------------

_BUILD = {
    SemAbs3DConfig: _build_semabs3d,
    SemanticAwareOVSSCConfig: _build_semantic_aware_ovssc,
    SemAbsVOOLConfig: _build_semabs_vool,
    SemanticAwareVOOLConfig: _build_semantic_aware_vool,
    ClipSpatialVOOLConfig: _build_clip_spatial_vool,
}


def init_net(seed: int, cfg, device=None) -> nn.Module:
    """The net of ``cfg``'s type with random f32 weights drawn on the CPU
    from ``torch.Generator().manual_seed(seed)`` (the JAX package's
    distributions), on ``device`` (cuda unless asked)."""
    dev = resolve_device(device)
    if type(cfg) not in _BUILD:
        raise TypeError(f"no net for a {type(cfg).__name__}")
    return _BUILD[type(cfg)](cfg, torch.Generator().manual_seed(seed)).to(dev)
