"""NCSN++ score U-Net as a torch module, with the reference's exact topology.

Port of use_tpu/models/ncsnpp/ncsnpp.py (reference src/models/components/
sgmse/backbones/ncsnpp.py:38-559): progressive input_skip / output_skip /
residual pyramids, BigGAN or DDPM residual blocks (the DDPM ones with
Upsample / Downsample layers), FIR or plain resampling, a bottleneck
attention block, Gaussian-Fourier log-t embedding, optional 1/sigma output
scaling and the `discriminative` mode.

Layout at the boundary is use_tpu's: input ``[B, F, T, C_total]`` real
channels (per complex input: re, im) and output ``[B, F, T, D, 2]``. Inside,
activations are NCHW ``[B, C, F, T]``.

Modules sit in the flat ``all_modules`` list in the order the forward pass
walks them, plus ``output_layer``, so ``state_dict()`` keys are the
reference's ``all_modules.{i}.<attr>`` and map to use_tpu's ``m{i}`` params
(engine/convert_jax.py).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.utils.checkpoint
from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts

from use_tpu_torch.models.ncsnpp import layers
from use_tpu_torch.models.registry import BackboneRegistry
from use_tpu_torch.ops.upfirdn2d import downsample_2d, upsample_2d


@dataclass(frozen=True)
class NCSNppConfig:
    """Static architecture config (defaults = reference ncsnpp.py:42-68)."""

    scale_by_sigma: bool = True
    nonlinearity: str = "swish"
    nf: int = 128
    ch_mult: Tuple[int, ...] = (1, 2, 2, 2)
    num_res_blocks: int = 1
    attn_resolutions: Tuple[int, ...] = (0,)
    resamp_with_conv: bool = True
    conditional: bool = True
    fir: bool = True
    fir_kernel: Tuple[float, ...] = (1.0, 3.0, 3.0, 1.0)
    skip_rescale: bool = True
    resblock_type: str = "biggan"
    progressive: str = "output_skip"
    progressive_input: str = "input_skip"
    progressive_combine: str = "sum"
    init_scale: float = 0.0
    fourier_scale: float = 16.0
    image_size: int = 256
    embedding_type: str = "fourier"
    input_channels: int = 4
    spatial_channels: int = 1
    dropout: float = 0.0
    centered: bool = False
    discriminative: bool = False
    dtype: str = "float32"  # compute dtype of convs/matmuls ('bfloat16' for
    # serving); parameters and GroupNorm statistics stay float32
    quant: str = "none"  # int8 serving. 'int8_pallas': the BigGAN blocks' 3x3
    # convs run kernel K3 with the GroupNorm apply + SiLU + quantize fused in
    # (ops/fused_qconv.py); 'int8': the residual blocks' 3x3 convs run the s8
    # conv kernel on an operand that K1's apply quantized (ops/qconv.py)
    quant_min_channels: int = 128  # gate: only convs this wide quantize
    quant_k: float = 6.0  # k-sigma analytic activation range (GroupNormAct)
    remat: bool = False  # recompute each residual block in the backward pass
    # (torch.utils.checkpoint per block, as use_tpu's nn.remat); a no-op
    # where no gradient is recorded
    remat_policy: str = "full"  # 'full': save only block inputs; 'conv_outs':
    # also save the 3x3 convolutions' outputs, so the backward recomputes only
    # GroupNorm, activation, FIR and shortcut (use_tpu's "ncsnpp_conv_out")

    def resolve(self) -> "NCSNppConfig":
        """Apply the discriminative-mode overrides (ncsnpp.py:86-92)."""
        if self.discriminative:
            return dataclasses.replace(
                self, conditional=False, scale_by_sigma=False, input_channels=2
            )
        return self


class NCSNpp(nn.Module):
    """NCSN++ U-Net. Input [B, F, T, C_total]; output [B, F, T, D, 2].

    Parameters are initialized from ``seed`` with an explicit
    torch.Generator (DDPM init, as use_tpu's); ``reset_parameters`` redraws
    them from another generator."""

    def __init__(self, cfg: NCSNppConfig = NCSNppConfig(), seed: int = 0):
        super().__init__()
        cfg = cfg.resolve()
        if cfg.embedding_type != "fourier":
            raise NotImplementedError("only fourier embedding supported")
        if cfg.resblock_type not in ("biggan", "ddpm"):
            raise ValueError(f"resblock_type {cfg.resblock_type!r} (biggan | ddpm)")
        if cfg.progressive not in ("none", "output_skip", "residual"):
            raise ValueError(f"progressive {cfg.progressive!r} (none | output_skip | residual)")
        if cfg.progressive_input not in ("none", "input_skip", "residual"):
            raise ValueError(f"progressive_input {cfg.progressive_input!r} "
                             "(none | input_skip | residual)")
        if cfg.quant not in ("none", "int8", "int8_pallas"):
            raise ValueError(f"quant {cfg.quant!r} (none | int8 | int8_pallas)")
        if cfg.dtype not in ("float32", "bfloat16"):
            raise ValueError(f"dtype {cfg.dtype!r} (float32 | bfloat16)")
        if cfg.remat_policy not in ("full", "conv_outs"):
            raise ValueError(f"remat_policy {cfg.remat_policy!r} (full | conv_outs)")
        self.cfg = cfg
        self.cdtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
        cdtype = self.cdtype
        act = cfg.nonlinearity
        layers.get_act(act)  # validates the name
        nf = cfg.nf
        num_resolutions = len(cfg.ch_mult)
        self.all_resolutions = [cfg.image_size // (2 ** i) for i in range(num_resolutions)]
        total_channels = cfg.input_channels * cfg.spatial_channels

        ddpm = cfg.resblock_type == "ddpm"

        def resblock(in_ch, out_ch=None, up=False, down=False):
            common = dict(act=act, in_ch=in_ch, out_ch=out_ch, dropout=cfg.dropout,
                          skip_rescale=cfg.skip_rescale, init_scale=cfg.init_scale,
                          temb_dim=nf * 4 if cfg.conditional else None, dtype=cdtype,
                          quant=cfg.quant, quant_min_channels=cfg.quant_min_channels,
                          quant_k=cfg.quant_k)
            if ddpm:
                return layers.ResnetBlockDDPMpp(**common)
            return layers.ResnetBlockBigGANpp(up=up, down=down, fir=cfg.fir,
                                              fir_kernel=cfg.fir_kernel, **common)

        def resample(layer, in_ch, out_ch=None, with_conv=cfg.resamp_with_conv):
            return layer(in_ch, out_ch, with_conv=with_conv, fir=cfg.fir,
                         fir_kernel=cfg.fir_kernel)

        def attn(ch):
            return layers.AttnBlockpp(ch, skip_rescale=cfg.skip_rescale,
                                      init_scale=cfg.init_scale, dtype=cdtype)

        if cfg.conditional:
            mods = [layers.GaussianFourierProjection(embedding_size=nf, scale=cfg.fourier_scale),
                    layers.Linear(nf * 2, nf * 4), layers.Linear(nf * 4, nf * 4)]
        else:
            # no time embedding: nothing at index 0, so the indices stay the
            # reference's, and no Dense_0 in the blocks (use_tpu creates
            # neither parameter when nothing calls them)
            mods = [nn.Identity()]
        mods.append(layers.Conv2d(total_channels, nf, dtype=cdtype))
        hs_c = [nf]
        in_ch = nf
        pyramid_ch = total_channels  # channels of the residual pyramids
        for i_level in range(num_resolutions):
            for _ in range(cfg.num_res_blocks):
                out_ch = nf * cfg.ch_mult[i_level]
                mods.append(resblock(in_ch, out_ch))
                in_ch = out_ch
                if self.all_resolutions[i_level] in cfg.attn_resolutions:
                    mods.append(attn(in_ch))
                hs_c.append(in_ch)
            if i_level != num_resolutions - 1:
                mods.append(resample(layers.Downsample, in_ch) if ddpm
                            else resblock(in_ch, down=True))
                if cfg.progressive_input == "input_skip":
                    mods.append(layers.Combine(total_channels, in_ch,
                                               method=cfg.progressive_combine.lower(), dtype=cdtype))
                    if cfg.progressive_combine.lower() == "cat":
                        in_ch *= 2
                elif cfg.progressive_input == "residual":
                    mods.append(resample(layers.Downsample, pyramid_ch, in_ch, with_conv=True))
                    pyramid_ch = in_ch
                hs_c.append(in_ch)
        mods += [resblock(in_ch), attn(in_ch), resblock(in_ch)]
        for i_level in reversed(range(num_resolutions)):
            for _ in range(cfg.num_res_blocks + 1):
                out_ch = nf * cfg.ch_mult[i_level]
                mods.append(resblock(in_ch + hs_c.pop(), out_ch))
                in_ch = out_ch
            if self.all_resolutions[i_level] in cfg.attn_resolutions:
                mods.append(attn(in_ch))
            if cfg.progressive == "output_skip":
                mods.append(layers.GroupNormAct(in_ch, act=act, out_dtype=cdtype))
                mods.append(layers.Conv2d(in_ch, total_channels, init_scale=cfg.init_scale,
                                          dtype=cdtype))
            elif cfg.progressive == "residual":
                if i_level == num_resolutions - 1:
                    mods.append(layers.GroupNormAct(in_ch, act=act, out_dtype=cdtype))
                    mods.append(layers.Conv2d(in_ch, in_ch, dtype=cdtype))
                else:
                    mods.append(resample(layers.Upsample, pyramid_ch, in_ch, with_conv=True))
                pyramid_ch = in_ch
            if i_level != 0:
                mods.append(resample(layers.Upsample, in_ch) if ddpm else resblock(in_ch, up=True))
        if hs_c:
            raise AssertionError("skip bookkeeping out of step")
        if cfg.progressive != "output_skip":
            mods.append(layers.GroupNormAct(in_ch, act=act, out_dtype=torch.float32))
            mods.append(layers.Conv2d(in_ch, total_channels, init_scale=cfg.init_scale))
        self.all_modules = nn.ModuleList(mods)
        self.output_layer = layers.Conv2d(total_channels, 2 * cfg.spatial_channels, kernel=1,
                                          dtype=cdtype)
        self.reset_parameters(torch.Generator().manual_seed(seed))
        self.eval()  # inference is the default, as use_tpu's train=False

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Redraw every parameter (DDPM init) from `generator`, module by
        module in walk order."""
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)

    def _resblock(self, block: nn.Module, h: torch.Tensor,
                  temb: Optional[torch.Tensor]) -> torch.Tensor:
        """A residual block, rematerialized in the backward under cfg.remat
        (use_tpu/models/ncsnpp/ncsnpp.py:133-150): only the resblocks, and
        whether or not the net is in training mode, since the loss applies
        it in its inference setting and still differentiates through it."""
        if not (self.cfg.remat and torch.is_grad_enabled()):
            return block(h, temb)
        kw = {"context_fn": _save_conv_outs} if self.cfg.remat_policy == "conv_outs" else {}
        return torch.utils.checkpoint.checkpoint(block, h, temb, use_reentrant=False, **kw)

    def _resample(self, layer: nn.Module, h: torch.Tensor,
                  temb: Optional[torch.Tensor]) -> torch.Tensor:
        """A resampling step: the DDPM path's Upsample / Downsample layer, or
        the BigGAN path's resampling block."""
        if isinstance(layer, (layers.Upsample, layers.Downsample)):
            return layer(h)
        return self._resblock(layer, h, temb)

    def _skip_sum(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """The residual pyramids' sum (a + b), scaled by 1/sqrt(2) under
        skip_rescale."""
        return (a + b) * layers._SKIP_SCALE if self.cfg.skip_rescale else a + b

    def forward(self, x: torch.Tensor, time_cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.cfg
        act = layers.get_act(cfg.nonlinearity)
        total_channels = cfg.input_channels * cfg.spatial_channels
        if x.shape[-1] != total_channels:
            raise ValueError(f"input {tuple(x.shape)} needs {total_channels} channels")
        num_resolutions = len(cfg.ch_mult)
        mods = iter(self.all_modules)

        gfp = next(mods)
        temb = None
        if cfg.conditional:
            temb = next(mods)(gfp(torch.log(time_cond)))
            temb = next(mods)(act(temb))

        x = x.permute(0, 3, 1, 2)  # [B, C, F, T]
        if not cfg.centered:
            x = 2 * x - 1.0  # ncsnpp.py:372-374
        x = x.to(self.cdtype).contiguous()

        input_pyramid = x if cfg.progressive_input != "none" else None
        hs = [next(mods)(x)]
        for i_level in range(num_resolutions):
            for _ in range(cfg.num_res_blocks):
                h = self._resblock(next(mods), hs[-1], temb)
                if self.all_resolutions[i_level] in cfg.attn_resolutions:
                    h = next(mods)(h)
                hs.append(h)
            if i_level != num_resolutions - 1:
                h = self._resample(next(mods), hs[-1], temb)
                if cfg.progressive_input == "input_skip":
                    input_pyramid = downsample_2d(input_pyramid, cfg.fir_kernel, factor=2)
                    h = next(mods)(input_pyramid, h)
                elif cfg.progressive_input == "residual":
                    input_pyramid = self._skip_sum(next(mods)(input_pyramid), h)
                    h = input_pyramid
                hs.append(h)

        h = hs[-1]
        h = self._resblock(next(mods), h, temb)
        h = next(mods)(h)
        h = self._resblock(next(mods), h, temb)

        pyramid = None
        for i_level in reversed(range(num_resolutions)):
            for _ in range(cfg.num_res_blocks + 1):
                h = self._resblock(next(mods), torch.cat([h, hs.pop()], dim=1), temb)
            if self.all_resolutions[i_level] in cfg.attn_resolutions:
                h = next(mods)(h)
            if cfg.progressive == "output_skip":
                pyramid_h = next(mods)(h)
                pyramid_h = next(mods)(pyramid_h)
                if i_level == num_resolutions - 1:
                    pyramid = pyramid_h
                else:
                    pyramid = upsample_2d(pyramid, cfg.fir_kernel, factor=2) + pyramid_h
            elif cfg.progressive == "residual":
                if i_level == num_resolutions - 1:
                    pyramid = next(mods)(h)
                    pyramid = next(mods)(pyramid)
                else:
                    pyramid = self._skip_sum(next(mods)(pyramid), h)
                    h = pyramid
            if i_level != 0:
                h = self._resample(next(mods), h, temb)

        if cfg.progressive == "output_skip":
            h = pyramid
        else:
            h = next(mods)(h)
            h = next(mods)(h)

        if cfg.scale_by_sigma:
            if time_cond is None:
                raise ValueError("scale_by_sigma needs time_cond")
            inv = (1.0 / time_cond.float()).reshape(-1, 1, 1, 1)
            h = h * inv.to(h.dtype)

        h = self.output_layer(h).float()  # [B, 2D, F, T]; re-major channel split
        d = cfg.spatial_channels
        h = h.permute(0, 2, 3, 1)  # [B, F, T, 2D]
        return torch.stack([h[..., :d], h[..., d:]], dim=-1)  # [B, F, T, D, 2]


def _conv_out_policy(ctx, op, *args, **kwargs):
    """Selective remat 'conv_outs': keep the outputs of the blocks' 3x3
    convolutions (groups 1; the FIR resampling convolves depthwise) and, in
    a net sharded over a model axis (parallel/sharding.py), their gathered
    outputs, so that the recomputation gathers nothing; recompute everything
    else."""
    if op is torch.ops.aten.convolution.default and args[8] == 1:
        return CheckpointPolicy.MUST_SAVE
    if op is torch.ops.use_tpu_torch.model_all_gather.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _save_conv_outs():
    return create_selective_checkpoint_contexts(_conv_out_policy)


def cast_backbone_for_inference(net: torch.nn.Module) -> None:
    """Cast an NCSN++ backbone's weights to its compute dtype, in place.

    As use_tpu's ``cast_params_for_inference``: with a bf16 compute dtype
    every parameter except the GroupNorm affines and 1-D parameters (biases,
    the Gaussian-Fourier projection) becomes bf16 once, instead of at every
    use. The BigGAN shortcut's bias is cast too: the shortcut kernel (K2)
    takes it in the compute dtype, as the layer would cast it at every call.
    A no-op for fp32 backbones."""
    if net.cfg.dtype != "bfloat16":
        return
    with torch.no_grad():
        for name, p in net.named_parameters():
            if "GroupNorm" in name or p.dim() <= 1 or not p.is_floating_point():
                continue
            p.data = p.data.to(torch.bfloat16)
        for m in net.modules():
            if isinstance(m, layers.ResnetBlockBigGANpp) and m.Conv_2 is not None:
                m.Conv_2.bias.data = m.Conv_2.bias.data.to(torch.bfloat16)


def _variant(name: str, **overrides):
    @BackboneRegistry.register(name)
    def make(seed: int = 0, **kwargs) -> NCSNpp:
        merged = {**overrides, **kwargs}
        for key in ("ch_mult", "attn_resolutions", "fir_kernel"):
            if key in merged:
                merged[key] = tuple(merged[key])
        return NCSNpp(cfg=NCSNppConfig(**merged), seed=seed)

    make.__name__ = f"make_{name}"
    return make


# Registered variants (reference ncsnpp.py:38, 504-559)
make_ncsnpp = _variant("ncsnpp")
make_ncsnpp_large = _variant(
    "ncsnpplarge", nf=128, ch_mult=(1, 1, 2, 2, 2, 2, 2), num_res_blocks=2,
    attn_resolutions=(0,),
)
make_ncsnpp_12m = _variant(
    "ncsnpp12M", nf=96, ch_mult=(1, 2, 2, 1), num_res_blocks=1, attn_resolutions=(0,),
)
make_ncsnpp_6m = _variant(
    "ncsnpp6M", nf=96, ch_mult=(1, 1, 1, 1), num_res_blocks=1, attn_resolutions=(0,),
)
