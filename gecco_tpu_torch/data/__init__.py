from gecco_tpu_torch.data.procedural import make_clouds

__all__ = ["make_clouds"]
