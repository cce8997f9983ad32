"""use_tpu (Flax) NCSN++ params -> the port's torch state_dict.

The inverse of use_tpu/engine/convert_torch.py::convert_ncsnpp_state_dict
(convert_torch.py:40-75). use_tpu names the U-Net's submodules ``m{i}`` in
the reference's forward-walk order; the port holds them as
``all_modules.{i}``, so conversion is a re-keying plus the standard
flax->torch transpositions:

    conv  kernel [kh, kw, I, O] -> weight [O, I, kh, kw]
    dense kernel [I, O]         -> weight [O, I]
    norm  scale / bias          -> weight / bias
    NIN/GFP W, b                -> unchanged
    Conv2d_0_weight / _bias     -> Conv2d_0.weight / .bias (FIR up/down convs)

The LSGAN generator's backbone is the same NCSN++ in discriminative mode:
``lsgan_params_to_state_dict`` maps use_tpu's generator params onto
``NCSNPPWrapper.net``, and ``discriminator_params_to_state_dict`` use_tpu's
discriminator params onto the port's discriminator, whose modules carry
use_tpu's scope names (``MPD.period2.conv0``):

    2-D conv kernel [kh, kw, I, O]      -> weight [O, I, kh, kw]
    1-D conv kernel [k, I / groups, O]  -> weight [O, I / groups, k]

The input is a nested mapping of arrays (numpy, or anything np.asarray
takes); nothing of JAX is imported.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _flatten(tree: Mapping[str, Any], prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def _convert_leaf(leaf: str, arr: np.ndarray):
    if leaf == "kernel":
        if arr.ndim == 4:  # HWIO -> OIHW
            return "weight", np.transpose(arr, (3, 2, 0, 1))
        if arr.ndim == 2:  # [in, out] -> [out, in]
            return "weight", np.transpose(arr, (1, 0))
        raise ValueError(f"unhandled kernel rank {arr.ndim}")
    if leaf == "scale":
        return "weight", arr
    if leaf in ("bias", "W", "b"):
        return leaf, arr
    raise ValueError(f"unhandled leaf {leaf}")


def ncsnpp_params_to_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax NCSNpp params (use_tpu) -> state_dict of the port's NCSNpp."""
    out: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(params):
        arr = np.asarray(value)
        parts = list(path)
        if parts[0].startswith("m") and parts[0][1:].isdigit():
            parts = ["all_modules", parts[0][1:]] + parts[1:]
        if parts[-1] in ("Conv2d_0_weight", "Conv2d_0_bias"):
            leaf, arr = _convert_leaf("kernel" if parts[-1].endswith("weight") else "bias", arr)
            parts = parts[:-1] + ["Conv2d_0", leaf]
        else:
            leaf, arr = _convert_leaf(parts[-1], arr)
            parts = parts[:-1] + [leaf]
        out[".".join(parts)] = torch.from_numpy(np.ascontiguousarray(arr).copy())
    return out


def lsgan_params_to_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """use_tpu LSGAN generator params (the first of ``LSGAN.init_params``)
    -> state_dict of the port's ``NCSNPPWrapper.net``: the discriminative
    NCSN++, which holds no time embedding (no ``m0``, no ``Dense_0``) on
    either side."""
    return ncsnpp_params_to_state_dict(params)


def discriminator_params_to_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """use_tpu discriminator params (the second of ``LSGAN.init_params``,
    e.g. HifiganVocoderDiscriminator24kMVD's) -> the port's D state_dict."""
    out: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(params):
        arr = np.asarray(value)
        leaf = path[-1]
        if leaf == "kernel" and arr.ndim == 3:  # [k, I/g, O] -> [O, I/g, k]
            leaf, arr = "weight", np.transpose(arr, (2, 1, 0))
        else:
            leaf, arr = _convert_leaf(leaf, arr)
        out[".".join(path[:-1] + (leaf,))] = torch.from_numpy(np.ascontiguousarray(arr).copy())
    return out
