from gecco_tpu_torch.data.procedural import CAMERA_K, make_clouds, make_conditional_batch

__all__ = ["CAMERA_K", "make_clouds", "make_conditional_batch"]
