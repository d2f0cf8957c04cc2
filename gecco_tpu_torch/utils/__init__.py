from gecco_tpu_torch.utils.modules import Frozen, Linear, count_parameters, resolve_device

__all__ = ["Frozen", "Linear", "count_parameters", "resolve_device"]
