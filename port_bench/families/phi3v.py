"""Phi-3.5-vision as the program takes it: the published config.json keys of a configuration
file turned into the program's VLMConfig, and the program's differentiable processor for it."""

from __future__ import annotations


def vlm_config(c: dict):
    """The program's VLMConfig of the configuration ``c`` (a file of configs/)."""
    from adversarialvlm_tpu_torch.models.configs import TextConfig, VisionConfig, VLMConfig

    v, rs, prog = c["vision_config"], c["rope_scaling"], c["program"]
    text = TextConfig(
        vocab_size=c["vocab_size"], hidden_size=c["hidden_size"], num_layers=c["num_hidden_layers"],
        num_heads=c["num_attention_heads"], num_kv_heads=c["num_key_value_heads"],
        intermediate_size=c["intermediate_size"], hidden_act=c["hidden_act"], rms_norm_eps=c["rms_norm_eps"],
        rope_theta=c["rope_theta"], max_position_embeddings=c["max_position_embeddings"],
        original_max_position_embeddings=c["original_max_position_embeddings"],
        rope_scaling_short_factor=tuple(rs["short_factor"]), rope_scaling_long_factor=tuple(rs["long_factor"]),
        tie_word_embeddings=c["tie_word_embeddings"],
    )
    vision = VisionConfig(
        hidden_size=v["hidden_size"], num_layers=v["num_hidden_layers"], num_heads=v["num_attention_heads"],
        intermediate_size=v["intermediate_size"], image_size=v["image_size"], patch_size=v["patch_size"],
        hidden_act=v["hidden_act"], layer_norm_eps=v["layer_norm_eps"],
    )
    return VLMConfig(family="phi3v", text=text, vision=vision, image_token_id=prog["image_token_id"],
                     pad_token_id=c["pad_token_id"], eos_token_id=prog["stop_token_id"],
                     vision_feature_layer=c["img_processor"]["layer_idx"], dtype=c["torch_dtype"])


def pad_token_id(c: dict) -> int:
    return c["pad_token_id"]


def image_processor(c: dict, in_hw, device):
    """The program's differentiable Phi-3.5-vision processor at the configuration's num_crops."""
    from adversarialvlm_tpu_torch.processors.configs import ImageProcessorConfig
    from adversarialvlm_tpu_torch.processors.phi3 import DifferentiablePhi3VImageProcessor

    p = c["processor"]
    cfg = ImageProcessorConfig(image_mean=tuple(p["image_mean"]), image_std=tuple(p["image_std"]),
                               num_crops=p["num_crops"], tile=c["vision_config"]["image_size"],
                               patch_size=c["vision_config"]["patch_size"])
    return DifferentiablePhi3VImageProcessor(cfg, in_hw, device)
