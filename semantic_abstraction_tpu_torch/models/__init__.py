"""The OVSSC SemAbs3D model of the port: UNet, implicit decoder, the net,
its weight loaders and the LAMB optimizer."""
from .convert import from_jax_params, from_state_dict, strip_ddp_prefix
from .decoder import ImplicitDecoder, implicit_decoder, init_implicit_decoder
from .lamb import Lamb
from .nets import (
    RELATIONS,
    SemAbs3D,
    SemAbs3DConfig,
    init_semabs3d,
    semabs3d_feature_vol,
    semabs3d_forward,
)
from .unet3d import (
    ResidualUNet3D,
    feature_maps_per_level,
    group_norm,
    init_residual_unet3d,
    residual_unet3d,
)

__all__ = [
    "from_jax_params",
    "from_state_dict",
    "strip_ddp_prefix",
    "ImplicitDecoder",
    "implicit_decoder",
    "init_implicit_decoder",
    "Lamb",
    "RELATIONS",
    "SemAbs3D",
    "SemAbs3DConfig",
    "init_semabs3d",
    "semabs3d_feature_vol",
    "semabs3d_forward",
    "ResidualUNet3D",
    "feature_maps_per_level",
    "group_norm",
    "init_residual_unet3d",
    "residual_unet3d",
]
