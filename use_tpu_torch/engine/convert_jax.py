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
    Conv2d_0_weight / _bias     -> Conv2d_0.weight / .bias (the FIR convs of
                                   Upsample / Downsample, OIHW as the
                                   reference holds them; their plain convs
                                   are Conv_0 like any other)

A net sharded over a model axis loads ``ncsnpp_params_to_shards``: the
state_dict cut to the rank's output slices (parallel/sharding.py); the
discriminator banks ``discriminator_params_to_shards`` and CSMGAN
``csmgan_params_to_shards`` (cut in the port's own channel order:
models/gan/csmgan.py).

The LSGAN generator's backbone is the same NCSN++ in discriminative mode:
``lsgan_params_to_state_dict`` maps use_tpu's generator params onto
``NCSNPPWrapper.net``, and ``discriminator_params_to_state_dict`` use_tpu's
discriminator params onto the port's discriminator, whose modules carry
use_tpu's scope names (``MPD.period2.conv0``):

    2-D conv kernel [kh, kw, I, O]      -> weight [O, I, kh, kw]
    1-D conv kernel [k, I / groups, O]  -> weight [O, I / groups, k]

The GAN zoo's generators, HifiganGenerator and BandwidthExtender, keep
use_tpu's scopes too (``hifigan_generator_params_to_state_dict``,
``bwe_params_to_state_dict``), with one more rule for a transposed conv:

    ConvTranspose kernel [k, I, O]      -> weight [I, O, k], taps reversed

The modules of the rest of the zoo keep use_tpu's scopes as well: GaGNet
(its heads built for the same bins, ``GaGNet.materialize``) and the NCSNv1
layers and norms load ``flax_params_to_state_dict(params)``, ConvTasNet
``convtasnet_params_to_state_dict`` (its ``decoder`` a transposed conv).
The walker adds

    2-D ConvTranspose kernel [kh, kw, I, O] -> [I, O, kh, kw], both taps reversed
    PReLU negative_slope ()              -> weight [1]
    PReLUC alpha, InstanceNorm++ alpha / gamma / beta -> unchanged
    Embed embedding [classes, F]         -> weight
    CumLN1d gain / bias [C]              -> [1, C, 1]

``csmgan_params_to_state_dict`` maps use_tpu's CSMGAN params onto the
port's CSMGAN, whose keys are the reference's torch module paths (the
inverse of convert_torch.py::convert_csmgan_state_dict, :358):

    conv kernel [kh, kw, I, O] / [k, I, O] -> weight [O, I, kh, kw] / [O, I, k]
    PReLU negative_slope ()               -> weight [1]
    cumulative-norm and GLFB gains [C]    -> [1, C, 1] (1-D) / [1, C, 1, 1] (2-D)
    GroupNorm scale / bias (norm='IN')    -> weight / bias

and the decoder's PixelShuffle convs get their output channels permuted:
use_tpu splits channels scale-major (o = s * C + c), torch scale-minor
(o = c * 2 + s).

The input is a nested mapping of arrays (numpy, or anything np.asarray
takes); nothing of JAX is imported. ``load_flat_params`` reads such a
mapping back from the ``.npz`` that scripts/export_use_tpu_params.py writes
where use_tpu is installed (keys: the Flax path joined with ``/``, the
discriminator's under ``D/``), and ``export_meta`` what it records of the
export (``__meta__``, JSON: experiment, task, generator, whether the
weights are the EMA ones, whether D is there).
"""
from __future__ import annotations

import json
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

META_KEY = "__meta__"


def _flatten(tree: Mapping[str, Any], prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def load_flat_params(path: str) -> Dict[str, Any]:
    """A flat ``.npz`` of Flax params (keys joined with ``/``) -> the nested
    params, numpy leaves; the discriminator's sit under ``D``."""
    out: Dict[str, Any] = {}
    with np.load(path, allow_pickle=False) as flat:
        for key in flat.files:
            if key == META_KEY:
                continue
            *scopes, leaf = key.split("/")
            node = out
            for scope in scopes:
                node = node.setdefault(scope, {})
            node[leaf] = flat[key]
    return out


def export_meta(path: str) -> Dict[str, Any]:
    """What the exporter recorded in a flat ``.npz`` ({} where nothing)."""
    with np.load(path, allow_pickle=False) as flat:
        return json.loads(str(flat[META_KEY])) if META_KEY in flat.files else {}


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


def _shards(state_dict: Dict[str, torch.Tensor], plan: Mapping[str, Any],
            world) -> Dict[str, torch.Tensor]:
    from use_tpu_torch.parallel.sharding import shard_state_dict

    return shard_state_dict(state_dict, dict(plan), world)


def ncsnpp_params_to_shards(params: Mapping[str, Any], plan: Mapping[str, Any],
                            world) -> Dict[str, torch.Tensor]:
    """Flax NCSNpp params -> this model rank's state_dict of a net that
    ``parallel/sharding.shard_params`` cut (`plan`, its shardings, over
    `world`'s model axis): each sharded weight's output slice, as use_tpu's
    ``shard_params`` places the same params on a ('data', 'model') mesh.
    The LSGAN generator's backbone loads it too."""
    return _shards(ncsnpp_params_to_state_dict(params), plan, world)


def lsgan_params_to_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """use_tpu LSGAN generator params (the first of ``LSGAN.init_params``)
    -> state_dict of the port's ``NCSNPPWrapper.net``: the discriminative
    NCSN++, which holds no time embedding (no ``m0``, no ``Dense_0``) on
    either side."""
    return ncsnpp_params_to_state_dict(params)


def flax_params_to_state_dict(params: Mapping[str, Any], transposed: Tuple[str, ...] = ()
                              ) -> Dict[str, torch.Tensor]:
    """use_tpu params of a module whose port keeps Flax's scope names as its
    module paths -> its state_dict: the path kept, each leaf converted
    (``_convert_leaf`` for the rest). A transposed conv is a scope named
    ``ConvTranspose_*`` or listed in `transposed`."""
    out: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(params):
        arr = np.asarray(value)
        leaf, scope = path[-1], path[:-1]
        if leaf == "kernel" and arr.ndim in (3, 4):
            if scope[-1].startswith("ConvTranspose") or scope[-1] in transposed:
                # [k..., I, O] -> [I, O, k...], the taps reversed
                taps = tuple(range(arr.ndim - 2))
                arr = np.transpose(np.flip(arr, taps), (arr.ndim - 2, arr.ndim - 1) + taps)
            else:  # [k..., I / groups, O] -> [O, I / groups, k...]
                arr = np.transpose(arr, (arr.ndim - 1, arr.ndim - 2) + tuple(range(arr.ndim - 2)))
            leaf = "weight"
        elif leaf == "negative_slope":  # Flax's PReLU: one slope
            arr, leaf = arr.reshape(1), "weight"
        elif leaf == "embedding":
            leaf = "weight"
        elif leaf in ("gain", "bias") and scope and scope[-1].startswith("CumLN1d"):
            arr = arr.reshape(1, -1, 1)
        elif leaf not in ("alpha", "gamma", "beta"):
            leaf, arr = _convert_leaf(leaf, arr)
        out[".".join(scope + (leaf,))] = torch.from_numpy(np.ascontiguousarray(arr).copy())
    return out


def discriminator_params_to_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """use_tpu discriminator params (the second of ``LSGAN.init_params``:
    the 24k_MVD and 24k banks', the multi-scale and spectrogram
    discriminators') -> the port's D state_dict."""
    return flax_params_to_state_dict(params)


def discriminator_params_to_shards(params: Mapping[str, Any], plan: Mapping[str, Any],
                                   world) -> Dict[str, torch.Tensor]:
    """use_tpu discriminator params -> this model rank's state_dict of a
    bank that ``shard_params`` cut (as ``ncsnpp_params_to_shards``)."""
    return _shards(discriminator_params_to_state_dict(params), plan, world)


def hifigan_generator_params_to_state_dict(params: Mapping[str, Any]
                                           ) -> Dict[str, torch.Tensor]:
    """use_tpu HifiganGenerator params -> the port's HifiganGenerator
    state_dict. Its transposed convs' kernels [k, I, O] are flipped along
    k and laid out [I, O, k]: lax.conv_transpose correlates with the kernel
    as given, torch's conv_transpose1d with it flipped."""
    return discriminator_params_to_state_dict(params)


def bwe_params_to_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """use_tpu BandwidthExtender params -> the port's BandwidthExtender
    state_dict (1-D kernels [k, I, O] -> [O, I, k])."""
    return discriminator_params_to_state_dict(params)


def convtasnet_params_to_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """use_tpu ConvTasNet params -> the port's ConvTasNet state_dict: the
    ``decoder`` is a transposed conv (taps flipped, [N, 1, win])."""
    return flax_params_to_state_dict(params, transposed=("decoder",))


# use_tpu's GLFB scopes (the path under enc{i}_glfb{d} / dec{i}_glfb{d} up to
# the leaf) -> the reference's first_block / second_block Sequential indices;
# the gate holds index 3 of the first and 2 of the second
_GLFB_KEYS = {
    (): "",  # the block's own beta / gamma
    ("CumLN2d_0",): "first_block.0.",
    ("GroupNorm_0",): "first_block.0.",
    ("Conv_0",): "first_block.1.",
    ("CausalConv2d_0", "Conv_0"): "first_block.2.conv.",
    ("SeChannelModule_0", "CausalConv2d_0", "Conv_0"): "first_block.4.conv.conv.",
    ("SeFreqModule_0", "CausalConv2d_0", "Conv_0"): "first_block.5.conv.conv.",
    ("Conv_1",): "first_block.6.",
    ("CumLN2d_1",): "second_block.0.",
    ("GroupNorm_1",): "second_block.0.",
    ("Conv_2",): "second_block.1.",
    ("Conv_3",): "second_block.3.",
}
_DEPTHCONV_KEYS = {"Conv_0": "conv1d", "PReLU_0": "nonlinearity1", "CumLN1d_0": "reg1",
                   "Conv_1": "dconv1d", "PReLU_1": "nonlinearity2", "CumLN1d_1": "reg2",
                   "Conv_2": "res_out", "Conv_3": "skip_out"}
_TCN_KEYS = {"CumLN1d_0": "LN", "Conv_0": "BN", "PReLU_0": "output.0", "Conv_1": "output.1"}


def _csmgan_key(path) -> str:
    """A use_tpu CSMGAN param path (without its leaf) -> the port's module path."""
    top, rest = path[0], tuple(path[1:])
    if top in ("in_proj", "out_proj"):
        return f"{top}.conv."
    for prefix, side in (("enc", "encoder"), ("dec", "decoder")):
        if top.startswith(prefix) and "_glfb" in top:
            i, d = top[len(prefix):].split("_glfb")
            return f"{side}.{i}.glfb.{d}." + _GLFB_KEYS[rest]
    if top.startswith("down"):
        return f"encoder.{top[4:]}.conv."
    if top.startswith("up"):
        return f"decoder.{top[2:]}.deconv.conv.conv."
    if top == "bottleneck":
        if rest[0].startswith("DepthConv1d_"):
            return f"bottleneck.TCN.{rest[0].split('_')[1]}.{_DEPTHCONV_KEYS[rest[1]]}."
        return f"bottleneck.{_TCN_KEYS[rest[0]]}."
    raise KeyError("/".join(path))


def csmgan_params_to_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """use_tpu CSMGAN params (``CSMGANWrapper.init_params``) -> state_dict of
    the port's ``CSMGANWrapper.net`` (its decoder upsamples frequency x2)."""
    out: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(params):
        arr = np.asarray(value)
        leaf, scope = path[-1], path[:-1]
        if leaf == "kernel":
            if scope[0].startswith("up"):
                # use_tpu's channel s * C + c is torch's c * 2 + s
                o = arr.shape[-1]
                arr = arr[..., [(t % 2) * (o // 2) + t // 2 for t in range(o)]]
            arr = np.transpose(arr, (3, 2, 0, 1) if arr.ndim == 4 else (2, 1, 0))
            leaf = "weight"
        elif leaf == "negative_slope":
            arr, leaf = arr.reshape(1), "weight"
        elif leaf == "scale":
            leaf = "weight"
        elif leaf in ("gain", "gamma", "beta") or (leaf == "bias" and scope
                                                   and scope[-1].startswith("CumLN")):
            arr = arr.reshape((1, -1, 1) if scope and scope[-1].startswith("CumLN1d")
                              else (1, -1, 1, 1))
        out[_csmgan_key(scope) + leaf] = torch.from_numpy(np.ascontiguousarray(arr).copy())
    return out


def csmgan_params_to_shards(params: Mapping[str, Any], plan: Mapping[str, Any],
                            world) -> Dict[str, torch.Tensor]:
    """use_tpu CSMGAN params -> this model rank's state_dict of a CSMGAN that
    ``shard_params`` cut: the output slices of the port's channel order (a
    PixelShuffle conv's slice holds other channels than use_tpu's rank's)."""
    return _shards(csmgan_params_to_state_dict(params), plan, world)
