from internvideo_tpu_torch.ops.rmsnorm import fused_add_rms_norm, rms_norm

__all__ = ["fused_add_rms_norm", "rms_norm"]
