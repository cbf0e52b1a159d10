"""LLaVA-1.5 model: CLIP tower, projector, Llama decoder."""
