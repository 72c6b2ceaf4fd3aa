"""Serving engine: paged KV cache, continuous batching, the async
pipeline and the unified ragged step, on PyTorch with hand-written
CUDA attention kernels, behind an OpenAI-compatible HTTP front end."""
