"""Serving: the continuous-batching engine over the paged M2LA decode path."""

from internvideo_tpu_torch.serve.engine import Request, ServingEngine

__all__ = ["Request", "ServingEngine"]
