"""Interop with the reference implementation's on-disk formats (counterpart
of ``gecco_tpu/compat``)."""

from gecco_tpu_torch.compat.eqx_io import (
    export_flagship_to_eqx_order,
    load_flagship_from_eqx,
    read_eqx_arrays,
    write_eqx_arrays,
)

__all__ = [
    "export_flagship_to_eqx_order",
    "load_flagship_from_eqx",
    "read_eqx_arrays",
    "write_eqx_arrays",
]
