"""The reference's (gecco-jax / equinox) checkpoint format (counterpart of
``gecco_tpu/compat/eqx_io.py``).

The reference saves its EMA weights with ``eqx.tree_serialise_leaves``:
consecutive ``np.save`` blobs in the pytree-flatten order of its Diffusion
module. equinox 0.10.3 (the version gecco-jax pins) serialises the array
leaves and the python-scalar fields (``Dropout.p``, ``AdaNorm.num_features``,
``Schedule.sigma_max``, ...); the parameters are float32 arrays. The reader
keeps every blob but the 0-d float64 / int64 / bool ones (the numpy dtypes
python scalars serialise to), so it does not depend on where equinox puts
its scalar fields.

The parameter order, from the reference's field declarations:

    per layer: broadcast_norm (scale w, b; bias w, b),
      pool: inducers [I, H, D], key_proj w, value_proj w, output_proj w,
      norm_1, broadcast MLP (layer 0 w, b; layer 1 w, b; activation alpha),
      norm_2, unpool: query / key / value / output_proj w,
      mlp_norm, MLP
    xyz_embed w, b; the network's reparam copy: mean, std;
    output_proj w, b; the Diffusion's reparam: mean, std

Layout deltas against the port, each checked by shape: the inducers
``[I, H, D]`` are the port's ``[H, I, D]``, and the separate key and value
projections are the rows ``[k; v]`` of the port's ``kv_proj``. The
reference applies each layer's second MLP to the un-normed stream, so the
port's model must be built with ``ref_jax_compat=True``. numpy reads the
file; the values land on the model's device.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
from torch import nn

__all__ = [
    "export_flagship_to_eqx_order",
    "load_flagship_from_eqx",
    "read_eqx_arrays",
    "write_eqx_arrays",
]

_SCALAR_FIELD_DTYPES = (np.dtype(np.float64), np.dtype(np.int64), np.dtype(np.bool_))


def read_eqx_arrays(path: str) -> List[np.ndarray]:
    """The parameter blobs of an ``.eqx`` file, in order (the python-scalar
    field blobs dropped)."""
    blobs = []
    with open(path, "rb") as f:
        while True:
            try:
                blobs.append(np.lib.format.read_array(f, allow_pickle=False))
            except Exception:  # the end of the file
                break
    return [b for b in blobs if not (b.ndim == 0 and b.dtype in _SCALAR_FIELD_DTYPES)]


def write_eqx_arrays(path: str, arrays) -> None:
    """``arrays`` as consecutive npy blobs (the ``.eqx`` on-disk format)."""
    with open(path, "wb") as f:
        for a in arrays:
            np.save(f, np.asarray(a))


class _Cursor:
    """The file's parameters taken in order, each checked by shape; the
    copies staged until every one has been read."""

    def __init__(self, arrays: List[np.ndarray]):
        self.arrays, self.i, self.staged = arrays, 0, []

    def take(self, shape, what: str) -> np.ndarray:
        if self.i >= len(self.arrays):
            raise ValueError(f"checkpoint exhausted at {what} (expected {tuple(shape)})")
        a = self.arrays[self.i]
        if tuple(a.shape) != tuple(shape):
            raise ValueError(
                f"{what}: expected shape {tuple(shape)}, got {tuple(a.shape)} "
                f"at parameter index {self.i} — architecture mismatch?"
            )
        self.i += 1
        return np.asarray(a, np.float32)

    def put(self, target: torch.Tensor, what: str) -> None:
        self.staged.append((target, self.take(target.shape, what)))

    def done(self) -> None:
        if self.i != len(self.arrays):
            raise ValueError(
                f"{len(self.arrays) - self.i} unconsumed parameters "
                f"(consumed {self.i}) — architecture mismatch?"
            )
        with torch.no_grad():
            for t, a in self.staged:
                t.copy_(torch.tensor(a).to(t.device, t.dtype))


def _linear(cur: _Cursor, lin: nn.Module, what: str) -> None:
    cur.put(lin.weight, f"{what}.weight")
    if lin.bias is not None:
        cur.put(lin.bias, f"{what}.bias")


def _adagn(cur: _Cursor, norm: nn.Module, what: str) -> None:
    _linear(cur, norm.scale_linear, f"{what}.scale")
    _linear(cur, norm.bias_linear, f"{what}.bias")


def _mlp(cur: _Cursor, mlp: nn.Module, what: str) -> None:
    for i, lin in enumerate(mlp.layers):
        _linear(cur, lin, f"{what}.layers[{i}]")
    cur.put(mlp.activation.alpha, f"{what}.activation.alpha")


def _broadcasting_layer(cur: _Cursor, layer: nn.Module, what: str) -> None:
    _adagn(cur, layer.broadcast_norm, f"{what}.broadcast_norm")
    pool = layer.broadcast.pool
    h, i, d = pool.inducers.shape
    inducers = cur.take((i, h, d), f"{what}.pool.inducers")
    cur.staged.append((pool.inducers, inducers.transpose(1, 0, 2)))
    c = h * d
    k_w = cur.take((c, c), f"{what}.pool.key_proj.weight")
    v_w = cur.take((c, c), f"{what}.pool.value_proj.weight")
    cur.staged.append((pool.kv_proj.weight, np.concatenate([k_w, v_w], axis=0)))
    cur.put(pool.out_proj.weight, f"{what}.pool.output_proj.weight")
    _adagn(cur, layer.broadcast.norm_1, f"{what}.norm_1")
    _mlp(cur, layer.broadcast.mlp, f"{what}.broadcast.mlp")
    _adagn(cur, layer.broadcast.norm_2, f"{what}.norm_2")
    unpool = layer.broadcast.unpool
    for name, lin in (("query", unpool.q_proj), ("key", unpool.k_proj),
                      ("value", unpool.v_proj), ("output", unpool.out_proj)):
        cur.put(lin.weight, f"{what}.unpool.{name}_proj")
    _adagn(cur, layer.mlp_norm, f"{what}.mlp_norm")
    _mlp(cur, layer.mlp, f"{what}.mlp")


def load_flagship_from_eqx(model: nn.Module, path: str) -> nn.Module:
    """Load a reference ``.eqx`` checkpoint (EMA weights) into the port's
    unconditional ``Diffusion`` in place, and return it. The model must
    have the checkpoint's architecture (layers, width, inducers, heads) and
    a backbone built with ``ref_jax_compat=True``. Nothing is copied unless
    every parameter is read and the file holds no other."""
    net = model.network
    backbone = net.backbone
    if not backbone.ref_jax_compat:
        raise ValueError(
            "build the SetTransformer with ref_jax_compat=True to load "
            "reference-jax checkpoints (second-MLP stream quirk)"
        )
    cur = _Cursor(read_eqx_arrays(path))
    for i, layer in enumerate(backbone.layers):
        _broadcasting_layer(cur, layer, f"layers[{i}]")
    _linear(cur, net.xyz_embed, "xyz_embed")
    # the reference network's own reparam copy: checked by shape, the same
    # values as the Diffusion's
    cur.take(model.reparam.mean.shape, "network.reparam.mean")
    cur.take(model.reparam.std.shape, "network.reparam.std")
    _linear(cur, net.output_proj, "output_proj")
    cur.put(model.reparam.mean, "reparam.mean")
    cur.put(model.reparam.std, "reparam.std")
    cur.done()
    return model


def export_flagship_to_eqx_order(model: nn.Module) -> List[np.ndarray]:
    """The inverse of ``load_flagship_from_eqx``: the model's parameters as
    float32 arrays in the reference's serialisation order."""
    out: List[np.ndarray] = []

    def put(t):
        out.append(np.asarray(t.detach().float().cpu().numpy(), np.float32))

    def put_linear(lin):
        put(lin.weight)
        if lin.bias is not None:
            put(lin.bias)

    def put_adagn(norm):
        put_linear(norm.scale_linear)
        put_linear(norm.bias_linear)

    def put_mlp(mlp):
        for lin in mlp.layers:
            put_linear(lin)
        put(mlp.activation.alpha)

    net = model.network
    for layer in net.backbone.layers:
        put_adagn(layer.broadcast_norm)
        pool = layer.broadcast.pool
        put(pool.inducers.transpose(0, 1))  # [H, I, D] -> [I, H, D]
        c = pool.kv_proj.weight.shape[1]
        put(pool.kv_proj.weight[:c])  # key_proj
        put(pool.kv_proj.weight[c:])  # value_proj
        put(pool.out_proj.weight)
        put_adagn(layer.broadcast.norm_1)
        put_mlp(layer.broadcast.mlp)
        put_adagn(layer.broadcast.norm_2)
        unpool = layer.broadcast.unpool
        for lin in (unpool.q_proj, unpool.k_proj, unpool.v_proj, unpool.out_proj):
            put(lin.weight)
        put_adagn(layer.mlp_norm)
        put_mlp(layer.mlp)
    put_linear(net.xyz_embed)
    put(model.reparam.mean)  # the network's reparam copy
    put(model.reparam.std)
    put_linear(net.output_proj)
    put(model.reparam.mean)  # the Diffusion's reparam
    put(model.reparam.std)
    return out
