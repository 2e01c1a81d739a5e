"""Quantized weight formats of the port (GPTQ-INT4)."""
