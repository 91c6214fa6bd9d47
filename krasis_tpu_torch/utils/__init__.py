"""Checkpoint file formats: safetensors and GGUF."""
