"""Weight bridges into the port: JAX/Flax variables and Paddle `.pdparams`.

The port's modules carry the Flax tree's names, so a Flax leaf
`a/b/kernel` becomes the state-dict entry `a.b.weight` after a layout
flip:

  Conv2D kernel       HWIO (kh, kw, i, o)        -> OIHW (o, i, kh, kw)
  depthwise kernel    (kh, kw, 1, c)             -> (c, 1, kh, kw)
  Conv3D kernel       DHWIO (kd, kh, kw, i, o)   -> OIDHW
  DeconvBN kernel     flipped HWIO correlation    -> (i, o, kh, kw)
                      (Paddle/PyTorch transposed-conv layout, un-flipped)
  BatchNorm           scale/bias, mean/var       -> weight/bias,
                                                    running_mean/running_var

`.pdparams` load through this module's copy of the JAX package's Paddle
reader and name map (`paddle_to_flax`), then the bridge above.
"""

from __future__ import annotations

import pickle
from typing import Dict, Tuple

import numpy as np
import torch

_LEAF_NAMES = {"kernel": "weight", "dw_kernel": "dw_weight",
               "out_kernel": "out_weight", "scale": "weight", "bias": "bias",
               "mean": "running_mean", "var": "running_var"}


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _to_port(path: Tuple[str, ...], value: np.ndarray) -> np.ndarray:
    if path[-1] not in ("kernel", "dw_kernel", "out_kernel"):
        return value
    if value.ndim == 5:
        return np.transpose(value, (4, 3, 0, 1, 2))
    if path[-2].startswith("DeconvBN_"):
        return np.transpose(value[::-1, ::-1], (2, 3, 0, 1))
    return np.transpose(value, (3, 2, 0, 1))


def from_jax_variables(variables) -> Dict[str, torch.Tensor]:
    """The JAX `{"params", "batch_stats"}` tree (numpy or JAX arrays) as the
    port's `LWSNet` state dict (float32 CPU tensors). Raises on a leaf name
    the bridge does not know; `load_state_dict(strict=True)` then raises on
    any entry the model does not have or misses."""
    out = {}
    for group in ("params", "batch_stats"):
        for path, leaf in _flatten(variables[group]):
            if path[-1] not in _LEAF_NAMES:
                raise ValueError(f"unknown JAX leaf {'/'.join(path)}")
            key = ".".join(path[:-1] + (_LEAF_NAMES[path[-1]],))
            if key in out:
                raise ValueError(f"duplicate port key {key}")
            arr = _to_port(path, np.asarray(leaf, np.float32))
            out[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def to_jax_variables(state_dict: Dict[str, torch.Tensor]) -> dict:
    """Inverse of `from_jax_variables`: the port's state dict as a JAX
    `{"params", "batch_stats"}` tree of float32 numpy arrays that share no
    memory with the tensors."""
    params: dict = {}
    stats: dict = {}
    for key, value in state_dict.items():
        *mods, leaf = key.split(".")
        # a copy: numpy() of a CPU float32 tensor shares its memory
        arr = value.detach().cpu().float().numpy().copy()
        if leaf in ("running_mean", "running_var"):
            tree, name = stats, leaf[len("running_"):]
        elif leaf in ("weight", "bias") and mods[-1].startswith("BatchNorm_"):
            tree, name = params, {"weight": "scale", "bias": "bias"}[leaf]
        elif leaf in ("weight", "dw_weight", "out_weight"):
            tree, name = params, {"weight": "kernel", "dw_weight": "dw_kernel",
                                  "out_weight": "out_kernel"}[leaf]
            if arr.ndim == 5:
                arr = np.transpose(arr, (2, 3, 4, 1, 0))
            elif mods[-1].startswith("DeconvBN_"):
                arr = np.transpose(arr, (2, 3, 0, 1))[::-1, ::-1]
            else:
                arr = np.transpose(arr, (2, 3, 1, 0))
        else:
            raise ValueError(f"unknown port key {key}")
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[name] = np.ascontiguousarray(arr)
    return {"params": params, "batch_stats": stats}


# --- Paddle .pdparams (copy of the JAX package's reader and name map) ----

def load_paddle_state_dict(path: str) -> Dict[str, np.ndarray]:
    """Read a `.pdparams` pickle without Paddle. Values are coerced to
    numpy; Paddle-internal classes in the stream (older save formats wrap
    tensors) are tolerated by substituting a passthrough stub. Unpickle
    only files from a trusted source."""

    class _Stub:  # stands in for any paddle.* class in the pickle stream
        def __init__(self, *a, **k):
            self.args = a

        def __setstate__(self, state):
            self.state = state

    class _Unpickler(pickle.Unpickler):
        def find_class(self, module, name):
            if module.split(".")[0] in ("paddle", "fluid"):
                return _Stub
            return super().find_class(module, name)

    with open(path, "rb") as f:
        obj = _Unpickler(f).load()
    if not isinstance(obj, dict):
        raise ValueError(f"{path}: expected a pickled state dict, "
                         f"got {type(obj)}")
    out = {}
    for k, v in obj.items():
        if isinstance(v, _Stub):  # unwrap tensor stubs that carry an array
            arrs = [x for x in getattr(v, "args", ()) +
                    tuple(getattr(v, "state", ()) or ())
                    if isinstance(x, np.ndarray)]
            if not arrs:
                raise ValueError(f"{path}: cannot extract array for key {k}")
            v = arrs[0]
        out[str(k)] = np.asarray(v)
    return out


def _conv(w: np.ndarray) -> np.ndarray:
    """OIHW -> HWIO (also handles the depthwise (c,1,kh,kw) case)."""
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def _conv3d(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(w, (2, 3, 4, 1, 0)))


def _deconv(w: np.ndarray) -> np.ndarray:
    """(i, o, kh, kw) -> spatially flipped HWIO."""
    return np.ascontiguousarray(
        np.transpose(w, (2, 3, 0, 1))[::-1, ::-1])


def paddle_to_flax(sd: Dict[str, np.ndarray], strict: bool = True) -> dict:
    """A reference LWSNet Paddle state dict as the JAX package's Flax
    {"params", "batch_stats"} tree (float32 numpy). strict=True raises if
    any reference key goes unconsumed."""
    sd = dict(sd)  # consumed keys are popped
    params: dict = {}
    stats: dict = {}

    def put(tree, path, value):
        node = tree
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(value, np.float32)

    def put_bn(flax_prefix: str, pd_prefix: str):
        put(params, f"{flax_prefix}/scale", sd.pop(f"{pd_prefix}.weight"))
        put(params, f"{flax_prefix}/bias", sd.pop(f"{pd_prefix}.bias"))
        put(stats, f"{flax_prefix}/mean", sd.pop(f"{pd_prefix}._mean"))
        put(stats, f"{flax_prefix}/var", sd.pop(f"{pd_prefix}._variance"))

    fe, fx = "feature_extraction", "FeatureExtractor_0"
    for i, (blk, idx) in enumerate(
            [("dres0", 0), ("dres0", 2), ("dres1", 0), ("dres1", 2)]):
        put(params, f"{fx}/ConvBN_{i}/Conv_0/kernel",
            _conv(sd.pop(f"{fe}.{blk}.{idx}.0.weight")))
        put_bn(f"{fx}/ConvBN_{i}/BatchNorm_0", f"{fe}.{blk}.{idx}.1")
    put(params, f"{fx}/ConvBN_4/Conv_0/kernel",
        _conv(sd.pop(f"{fe}.classif1.0.0.weight")))
    put_bn(f"{fx}/ConvBN_4/BatchNorm_0", f"{fe}.classif1.0.1")
    put(params, f"{fx}/Conv_0/kernel", _conv(sd.pop(f"{fe}.classif1.2.weight")))
    hg = f"{fx}/Hourglass_0"
    for i in range(4):
        put(params, f"{hg}/ConvBN_{i}/Conv_0/kernel",
            _conv(sd.pop(f"{fe}.dres2.conv{i + 1}.0.0.weight")))
        put_bn(f"{hg}/ConvBN_{i}/BatchNorm_0", f"{fe}.dres2.conv{i + 1}.0.1")
    for i in range(2):
        put(params, f"{hg}/DeconvBN_{i}/kernel",
            _deconv(sd.pop(f"{fe}.dres2.conv{i + 5}.0.weight")))
        put_bn(f"{hg}/DeconvBN_{i}/BatchNorm_0", f"{fe}.dres2.conv{i + 5}.1")

    for i in range(3):
        for j in range(6):
            put(params, f"CostFilter3D_{i}/BNReLUConv3D_{j}/kernel",
                _conv3d(sd.pop(f"volume_postprocess.{i}.{j}.2.weight")))
            put_bn(f"CostFilter3D_{i}/BNReLUConv3D_{j}/BatchNorm_0",
                   f"volume_postprocess.{i}.{j}.0")

    for tower, pd in (("RefinementTower_0", "refinement1_left"),
                      ("RefinementTower_1", "refinement1_disp")):
        put(params, f"{tower}/Conv_0/kernel", _conv(sd.pop(f"{pd}.0.weight")))
        for k in range(4):
            put(params, f"{tower}/PreConvDW_{k}/dw_kernel",
                _conv(sd.pop(f"{pd}.{k + 1}.2.weight")))
            put(params, f"{tower}/PreConvDW_{k}/Conv_0/kernel",
                _conv(sd.pop(f"{pd}.{k + 1}.3.weight")))
            put_bn(f"{tower}/PreConvDW_{k}/BatchNorm_0", f"{pd}.{k + 1}.0")

    head = "RefinementHead_0"
    put(params, f"{head}/PreConv_0/Conv_0/kernel",
        _conv(sd.pop("refinement2.0.2.weight")))
    put_bn(f"{head}/PreConv_0/BatchNorm_0", "refinement2.0.0")
    for k in range(4):
        put(params, f"{head}/PreConvDW_{k}/dw_kernel",
            _conv(sd.pop(f"refinement2.{k + 1}.2.weight")))
        put(params, f"{head}/PreConvDW_{k}/Conv_0/kernel",
            _conv(sd.pop(f"refinement2.{k + 1}.3.weight")))
        put_bn(f"{head}/PreConvDW_{k}/BatchNorm_0", f"refinement2.{k + 1}.0")
    put(params, f"{head}/out_kernel", _conv(sd.pop("refinement2.5.weight")))

    if strict and sd:
        raise ValueError(f"unconsumed reference keys: {sorted(sd)[:10]}"
                         f"{' ...' if len(sd) > 10 else ''}")
    return {"params": params, "batch_stats": stats}


def load_reference_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """`.pdparams` file -> the port's `LWSNet` state dict."""
    return from_jax_variables(paddle_to_flax(load_paddle_state_dict(path)))
