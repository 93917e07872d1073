"""Serving: batched prefill + decode over static-shape caches."""
from .engine import Engine, make_prefill_step, make_serve_step

__all__ = ["Engine", "make_prefill_step", "make_serve_step"]
