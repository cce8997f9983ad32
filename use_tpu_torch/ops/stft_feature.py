"""Batch-dict STFT front-end (the generic feature extractor).

Port of use_tpu/ops/stft_feature.py (reference
src/models/components/feature/stft.py:66-240), on the port's ``stft`` and
``istft``: [B, F, T, 2] spectra of 'perturbed' and 'clean', optional
high-frequency zeroing, magnitude compression (sqrt / cubic / log_1x),
mag/phase splitting, subband splitting, the speech mask and spectra length;
``inverse`` undoes the compression and iSTFTs every key of inverse_keys.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

from use_tpu_torch.ops.stft import STFTConfig, istft, stft


def mag_phase(spec: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., 2] -> (magnitude, phase angle). The epsilon inside the sqrt
    keeps d|s|/ds defined at the exact-zero bins of zero-padded frames."""
    mag = torch.sqrt(spec[..., 0] ** 2 + spec[..., 1] ** 2 + 1e-24)
    return mag, torch.atan2(spec[..., 1], spec[..., 0])


def mag_unit_phase(spec: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., 2] -> (magnitude, unit-phase pair)."""
    mag = torch.sqrt(spec[..., 0] ** 2 + spec[..., 1] ** 2 + 1e-24)
    return mag, spec / (mag[..., None] + 1e-9)


def _compress(mag: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "sqrt":
        return mag ** 0.5
    if mode == "cubic":
        return mag ** 0.3
    if mode == "log_1x":
        return torch.log(mag + 1.0)
    raise ValueError(mode)


def _decompress(mag: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "sqrt":
        return mag ** 2
    if mode == "cubic":
        return mag ** (1 / 0.3)
    if mode == "log_1x":
        return torch.exp(mag) - 1.0
    raise ValueError(mode)


@dataclass
class STFTFeature:
    n_fft: int = 512
    win_length: int = 512
    hop_length: int = 128
    window: str = "hann"
    use_mag_phase: bool = False
    freq_high: Optional[float] = None
    sampling_rate: int = 16000
    compression: Optional[str] = None
    split_subbands: Optional[int] = None
    inverse_keys: List[str] = field(default_factory=lambda: ["fake"])

    def __post_init__(self):
        self.cfg = STFTConfig(n_fft=self.n_fft, hop_length=self.hop_length,
                              win_length=self.win_length, window=self.window, center=True)
        self.high_cut_index = (int(self.freq_high / self.sampling_rate * self.n_fft + 0.5)
                               if self.freq_high else None)

    def _process_key(self, batch: Dict, key: str, out: Dict) -> torch.Tensor:
        spec = stft(batch[key], self.cfg)  # [B, F, T, 2]
        if self.high_cut_index is not None:
            keep = torch.arange(spec.shape[1], device=spec.device) <= self.high_cut_index
            spec = spec * keep[None, :, None, None]
        if self.compression is not None:
            mag, unit = mag_unit_phase(spec)
            spec = _compress(mag, self.compression)[..., None] * unit
        if not self.use_mag_phase:
            out[f"{key}_spectra"] = spec
        else:
            out[f"{key}_mag"], out[f"{key}_phase"] = mag_phase(spec)
        if self.split_subbands:
            band = self.n_fft // 2 // self.split_subbands
            out[f"{key}_subband_spectra"] = torch.stack(
                [spec[:, i * band : (i + 1) * band + 1] for i in range(self.split_subbands)],
                dim=1)
        return spec

    def __call__(self, batch: Dict) -> Dict:
        out = dict(batch)
        spec = self._process_key(batch, "perturbed", out)
        if "sample_length" in batch:
            mag, _ = mag_phase(spec if not self.use_mag_phase
                               else stft(batch["perturbed"], self.cfg))
            lengths = torch.as_tensor(batch["sample_length"], device=mag.device)
            spectra_length = (lengths // self.hop_length + 1).to(torch.int32)
            t_idx = torch.arange(mag.shape[-1], device=mag.device)
            out["speech_mask"] = (t_idx[None, None, :] < spectra_length[:, None, None]
                                  ).to(mag.dtype) * torch.ones_like(mag)
            out["spectra_length"] = spectra_length
        if "clean" in batch:
            self._process_key(batch, "clean", out)
        return out

    def inverse(self, batch: Dict) -> Dict:
        out = dict(batch)
        length = batch["perturbed"].shape[-1]
        for key in self.inverse_keys:
            if self.split_subbands:
                band = self.n_fft // 2 // self.split_subbands
                sub = batch[f"{key}_subband_spectra"]
                parts = [sub[:, i, :band] if i < self.split_subbands - 1 else sub[:, i]
                         for i in range(self.split_subbands)]
                out[f"{key}_spectra"] = torch.cat(parts, dim=1)
                batch = {**batch, f"{key}_spectra": out[f"{key}_spectra"]}
            if not self.use_mag_phase:
                spec = batch[f"{key}_spectra"]
                if self.compression is not None:
                    mag, unit = mag_unit_phase(spec)
                    spec = _decompress(mag, self.compression)[..., None] * unit
            else:
                mag, phase = batch[f"{key}_mag"], batch[f"{key}_phase"]
                if self.compression is not None:
                    mag = _decompress(mag, self.compression)
                spec = torch.stack([mag * torch.cos(phase), mag * torch.sin(phase)], dim=-1)
            out[key] = istft(spec, self.cfg, length=length)
        return out
