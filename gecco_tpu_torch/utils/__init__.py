from gecco_tpu_torch.utils.modules import Linear, count_parameters, resolve_device

__all__ = ["Linear", "count_parameters", "resolve_device"]
