"""repro_torch.encoders — the model-agnostic feature step (port of
``repro.encoders``): the proxy MLP, DINO-style ViT and SBERT-style text
encoders.  ``repro_torch.core.milo.preprocess_with_encoder`` turns any of
them into a preprocessing artifact."""
from repro_torch.encoders.proxy import ProxyEncoder
from repro_torch.encoders.text import TextEncoderConfig, init_text_encoder, text_encode
from repro_torch.encoders.vit import ViTConfig, init_vit, params_from_jax, vit_encode

__all__ = ["ProxyEncoder", "TextEncoderConfig", "ViTConfig", "init_text_encoder", "init_vit",
           "params_from_jax", "text_encode", "vit_encode"]
