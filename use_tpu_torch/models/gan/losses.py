"""GAN criteria: LS-GAN adversarial, feature matching, multi-resolution
spectral reconstruction.

Port of use_tpu/models/gan/losses.py (reference
loss_function/monaural_loss.py:14-321, hifigan_dicriminator.py:257-312)
over nested [bank][disc] logit and feature lists and [B, T] waveforms.
The criteria read the batch dict and return a copy with their `loss_*`
keys, as use_tpu's; ``content_criteria`` (HiFi-GAN+ BWE's) takes and
returns tensors.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from use_tpu_torch.ops.mel import MelConfig, melspectrogram, spectrogram
from use_tpu_torch.ops.stft import STFTConfig


def _mse_to(logits: torch.Tensor, target: float) -> torch.Tensor:
    return torch.mean(torch.square(logits - target))


def adv_gen_loss(fake_logits) -> torch.Tensor:
    """MSE to 1, averaged over every bank's discriminators
    (hifigan_dicriminator.py:257-272)."""
    terms = [_mse_to(lg, 1.0) for bank in fake_logits for lg in bank]
    return sum(terms) / len(terms)


def adv_dsc_loss(real_logits, fake_logits) -> torch.Tensor:
    """Real to 1, fake to 0 (hifigan_dicriminator.py:294-312)."""
    total, cnt = 0.0, 0
    for bank_r, bank_f in zip(real_logits, fake_logits):
        for lr_, lf in zip(bank_r, bank_f):
            total = total + _mse_to(lr_, 1.0) + _mse_to(lf, 0.0)
            cnt += 2
    return total / cnt


def feat_match_loss(real_feats, fake_feats) -> torch.Tensor:
    """L1 feature matching over every layer (hifigan_dicriminator.py:275-292)."""
    terms = [torch.mean(torch.abs(ff - fr))
             for bank_r, bank_f in zip(real_feats, fake_feats)
             for disc_r, disc_f in zip(bank_r, bank_f)
             for fr, ff in zip(disc_r, disc_f)]
    return sum(terms) / len(terms)


@dataclass(frozen=True)
class WavSpecConvergenceConfig:
    """Multi-resolution reconstruction (monaural_loss.py:59-116): frame
    lengths 512/1024/2048/4096 scaled by sampling_rate / 48000, hop a
    quarter, and a 128-band mel of 25 ms windows, 10 ms hops."""

    sampling_rate: int = 24000
    alpha_wav_l1: float = 1.0
    alpha_mag_l2: float = 1.0
    alpha_mag_log: float = 1.0
    alpha_mag_norm_l2: float = 1.0
    alpha_mel_log: float = 1.0
    alpha_mel_l2: float = 1.0

    @property
    def stft_cfgs(self) -> Tuple[STFTConfig, ...]:
        ratio = self.sampling_rate / 48000.0
        return tuple(STFTConfig(n_fft=int(fl * ratio), hop_length=int(fl * ratio) // 4)
                     for fl in (512, 1024, 2048, 4096))

    @property
    def mel_cfg(self) -> MelConfig:
        sr = self.sampling_rate
        return MelConfig(sample_rate=sr, f_min=0.0, f_max=sr // 2, n_fft=2048,
                         win_length=int(0.025 * sr), hop_length=int(0.010 * sr), n_mels=128)


def _log_l1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(torch.log(a * 32768 + 1e-6) - torch.log(b * 32768 + 1e-6)))


def wav_spec_convergence(clean: torch.Tensor, enhanced: torch.Tensor,
                         cfg: WavSpecConvergenceConfig) -> Dict[str, torch.Tensor]:
    """wav L1, the 4-resolution STFT terms (magnitude L2, log-magnitude L1,
    spectral convergence) and the mel terms (log L1, L2)
    (monaural_loss.py:117-151), each times its alpha."""
    wav_l1 = torch.mean(torch.abs(enhanced - clean))
    mag_l2 = mag_log = mag_norm = 0.0
    for scfg in cfg.stft_cfgs:
        me, mc = spectrogram(enhanced, scfg), spectrogram(clean, scfg)
        mag_l2 = mag_l2 + torch.mean(torch.square(me - mc))
        mag_log = mag_log + _log_l1(me, mc)
        # the eps inside both sqrts: their gradient x / ||x|| is NaN at 0
        num = torch.sqrt(torch.sum(torch.square(mc - me), dim=(-2, -1)) + 1e-12)
        den = torch.sqrt(torch.sum(torch.square(mc), dim=(-2, -1)) + 1e-12) + 1e-6
        mag_norm = mag_norm + torch.mean(num / den)
    n = len(cfg.stft_cfgs)
    mel_e, mel_c = melspectrogram(enhanced, cfg.mel_cfg), melspectrogram(clean, cfg.mel_cfg)
    return {
        "wav_l1": cfg.alpha_wav_l1 * wav_l1,
        "mag_l2": cfg.alpha_mag_l2 * mag_l2,
        "mag_log": cfg.alpha_mag_log * (mag_log / n),
        "mag_norm_l2": cfg.alpha_mag_norm_l2 * (mag_norm / n),
        "mel_log": cfg.alpha_mel_log * _log_l1(mel_e, mel_c),
        "mel_l2": cfg.alpha_mel_l2 * torch.mean(torch.square(mel_e - mel_c)),
    }


@dataclass(frozen=True)
class HifiganGLossConfig(WavSpecConvergenceConfig):
    """The LSGAN generator's whole criterion (monaural_loss.py:181-321);
    the shipped weights are LSGAN.yaml's g_loss."""

    alpha_adv_gen: float = 1.0
    alpha_adv_feat: float = 1.0
    enhanced_key: str = "fake"


def hifigan_g_loss(batch: Dict, cfg: HifiganGLossConfig) -> Dict:
    """-> the batch with loss_G_* and their sum loss_G."""
    key = cfg.enhanced_key
    parts = wav_spec_convergence(batch["clean"], batch[key], cfg)
    adv = cfg.alpha_adv_gen * adv_gen_loss(batch[f"predicted_{key}_logits"])
    feat = cfg.alpha_adv_feat * feat_match_loss(batch["predicted_clean_feature_list"],
                                                batch[f"predicted_{key}_feature_list"])
    out = dict(batch)
    for name, v in parts.items():
        out[f"loss_G_{name}"] = v
    out["loss_G_adv_gen"] = adv
    out["loss_G_adv_feat"] = feat
    out["loss_G"] = sum(parts.values()) + adv + feat
    return out


def hifigan_d_loss(batch: Dict, enhanced_key: str = "fake") -> Dict:
    """HIFIGAN_Vocoder_D_Loss (monaural_loss.py:44-56): -> the batch with
    loss_D_adv_dsc and loss_D."""
    loss = adv_dsc_loss(batch["predicted_clean_logits"],
                        batch[f"predicted_{enhanced_key}_logits"])
    out = dict(batch)
    out["loss_D_adv_dsc"] = loss
    out["loss_D"] = loss
    return out


def lsgan_g_loss(batch: Dict) -> Dict:
    """Plain LSGAN G loss (monaural_loss.py:14-24): each discriminator's
    MSE to 1, summed, not averaged; -> the batch with loss_G."""
    loss = 0.0
    for bank in batch["predicted_fake_logits"]:
        for lg in bank:
            loss = loss + _mse_to(lg, 1.0)
    out = dict(batch)
    out["loss_G"] = loss
    return out


def lsgan_d_loss(batch: Dict) -> Dict:
    """Plain LSGAN D loss (monaural_loss.py:27-41): fake to 0 and real to
    1, summed; -> the batch with loss_D."""
    loss = 0.0
    for bank_f, bank_r in zip(batch["predicted_fake_logits"], batch["predicted_clean_logits"]):
        for lf, lr_ in zip(bank_f, bank_r):
            loss = loss + _mse_to(lf, 0.0) + _mse_to(lr_, 1.0)
    out = dict(batch)
    out["loss_D"] = loss
    return out


def content_criteria(y_pred: torch.Tensor, y_true: torch.Tensor, sampling_rate: int = 48000
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """HiFi-GAN+ BWE's content losses (reference GAN/discriminator/hifigan/
    criteria.py:10-59): -> (L1 of the waveforms, the mean L1 of the
    log-magnitude STFTs at frame lengths 512 / 1024 / 2048 / 4096 with a
    quarter hop, the L1 of the log-mel: 128 bands, 25 ms windows, 10 ms
    hops, f_min 4 kHz at 48 kHz)."""
    wav_loss = torch.mean(torch.abs(y_pred - y_true))
    frame_lengths = (512, 1024, 2048, 4096)
    stft_loss = 0.0
    for fl in frame_lengths:
        scfg = STFTConfig(n_fft=fl, hop_length=fl // 4)
        s_true = torch.log(spectrogram(y_true, scfg) + 1e-5)
        s_pred = torch.log(spectrogram(y_pred, scfg) + 1e-5)
        stft_loss = stft_loss + torch.mean(torch.abs(s_pred - s_true))
    stft_loss = stft_loss / len(frame_lengths)
    mel_cfg = MelConfig(sample_rate=sampling_rate,
                        f_min=8000 // 2 if sampling_rate == 48000 else 0.0,
                        f_max=sampling_rate // 2, n_fft=2048,
                        win_length=int(0.025 * sampling_rate),
                        hop_length=int(0.010 * sampling_rate), n_mels=128)
    m_true = torch.log(melspectrogram(y_true, mel_cfg) + 1e-5)
    m_pred = torch.log(melspectrogram(y_pred, mel_cfg) + 1e-5)
    return wav_loss, stft_loss, torch.mean(torch.abs(m_pred - m_true))
