from .model import (
    CLIP,
    ClipConfig,
    VIT_B_32,
    encode_image,
    encode_text,
    init_clip_params,
    resolve_device,
    vit_forward,
)
from .resnet import ModifiedResNet, modified_resnet_forward
from .tokenizer import ClipTokenizer, default_tokenizer, tokenize
from .relevancy import gradcam, zeroshot_weights_from_features
from .convert import (
    from_jax_params,
    from_openai_state_dict,
    load_clip_checkpoint,
    to_jax_params,
)
from .saliency import (
    IMAGENET_TEMPLATES,
    ClipSaliency,
    CropSpec,
    SaliencyConfig,
    chefer_et_al_config,
    color_jitter,
    extract_tiles,
    ours_config,
    saliency_configs,
    tile_plan,
)

__all__ = [
    "CLIP",
    "ClipConfig",
    "VIT_B_32",
    "encode_image",
    "encode_text",
    "init_clip_params",
    "resolve_device",
    "vit_forward",
    "ModifiedResNet",
    "modified_resnet_forward",
    "ClipTokenizer",
    "default_tokenizer",
    "tokenize",
    "gradcam",
    "zeroshot_weights_from_features",
    "from_jax_params",
    "from_openai_state_dict",
    "load_clip_checkpoint",
    "to_jax_params",
    "IMAGENET_TEMPLATES",
    "ClipSaliency",
    "CropSpec",
    "SaliencyConfig",
    "chefer_et_al_config",
    "color_jitter",
    "extract_tiles",
    "ours_config",
    "saliency_configs",
    "tile_plan",
]
