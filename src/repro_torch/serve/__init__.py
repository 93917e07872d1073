"""Serving: batched prefill + decode over static-shape caches
(:mod:`.engine`), and batched, bucketed execution of migrated NEON kernels
(:mod:`.port_engine`)."""
from .engine import Engine, make_prefill_step, make_serve_step
from .port_engine import BucketPolicy, PortEngine, Request

__all__ = ["Engine", "make_prefill_step", "make_serve_step",
           "BucketPolicy", "PortEngine", "Request"]
