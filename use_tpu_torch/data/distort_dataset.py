"""On-the-fly distortion-simulation dataset (host-side, per-worker).

The port's copy of use_tpu/data/distort_dataset.py, bit-equal under the same seeds.

Re-implementation of the reference's ~1.9k-LoC synthesis pipeline (reference:
src/data/components/comm_distort_simu_dataset.py:592-1430): per item —
clean read + resample + multi-speaker mix + splice-to-N-seconds
-> noise read/mix/trim -> RIR reverb with early-reflection target
-> VAD-powered SNR noise mixing -> an ordered chain of Bernoulli-gated
perturbations -> synchronized random volume + clip -> length-match, optional
cut, peak normalization. Returns the mutable batch dict with 'clean',
'perturbed', 'name', 'sampling_rate', 'SNR' (+ debug intermediates).

Clean/noise sources are JSONL lists ({file_path, duration, sample_rate});
RIRs are a list of pickled dicts or wavs, or FRA-RIR synthesis.
"""
from __future__ import annotations

import json
import pickle
import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
from scipy.signal import fftconvolve

from use_tpu_torch.data import perturb as P
from use_tpu_torch.data.audio_io import read_wav, valid_audio
from use_tpu_torch.data.dsp import resample_fft, resample_poly
from use_tpu_torch.data.fra_rir import fra_rir


def vad_merge(w: np.ndarray, top_db: float = 50.0, frame: int = 2048, hop: int = 512) -> np.ndarray:
    """Concatenate non-silent intervals (librosa.effects.split semantics:
    frames within top_db of the max RMS are speech)."""
    if len(w) < frame:
        return w
    n = 1 + (len(w) - frame) // hop
    idx = np.arange(n)[:, None] * hop + np.arange(frame)[None, :]
    rms = np.sqrt(np.mean(w[idx] ** 2, axis=1) + 1e-12)
    ref = rms.max()
    if ref <= 0:
        return w
    keep = 20 * np.log10(rms / ref + 1e-12) > -top_db
    if not keep.any():
        return w
    # merge overlapping frame windows into disjoint sample intervals
    segs = []
    cur_start = cur_end = None
    for i in np.where(keep)[0]:
        s, e = i * hop, i * hop + frame
        if cur_end is not None and s <= cur_end:
            cur_end = e
        else:
            if cur_end is not None:
                segs.append(w[cur_start:cur_end])
            cur_start, cur_end = s, e
    segs.append(w[cur_start:cur_end])
    return np.concatenate(segs)


@dataclass
class DistortConfig:
    """Pipeline hyperparameters; defaults follow configs/data/distort.yaml."""

    clean_json_path: str = ""
    noise_json_path: str = ""
    rir_list_path: Optional[str] = None
    min_n_speakers: int = 1
    max_n_speakers: int = 1
    min_duration_seconds: Optional[float] = 1
    max_duration_seconds: Optional[float] = None
    remove_dc_offset: bool = True
    sampling_rate: int = 24000
    resample_method: str = "fft"
    # splice
    speech_splice: bool = True
    speech_splice_equal_volume: bool = True
    speech_splice_equal_volume_range: Sequence[float] = (-6, 6)
    speech_splice_seconds: float = 6
    speech_random_start: bool = True
    add_extra_space_prob: float = 0.3
    # reverb
    reverb_prob: float = 0.5
    reverb_use_FRA: bool = False
    min_rt60: Optional[float] = None
    max_rt60: Optional[float] = None
    # noise
    add_noise_prob: float = 0.5
    only_noise_prob: float = 0.0
    noise_repeat_splice: bool = False
    trim_noise: bool = True
    snr_min: float = 10
    snr_max: float = 30
    noise_mix_prob: float = 0.5
    # speed / pitch
    speed_perturb_prob: float = 0.0
    speed_rate_min: float = 0.8
    speed_rate_max: float = 1.2
    pitch_shift_prob: float = 0.0
    semitones_down: float = -1.5
    semitones_up: float = 1.5
    # loudness
    loudness_perturb_prob: float = 0.0
    loudness_min_factor: float = 0.1
    loudness_max_factor: float = 10
    loudness_max_n_intervals: int = 5
    # clip
    clip_prob: float = 0.2
    hard_clip_portion: float = 0.8
    hard_clip_on_rate: bool = True
    hard_clip_rate_min: float = 0.0
    hard_clip_rate_max: float = 0.2
    soft_clip_types: Sequence[str] = ("sox", "pedal", "soft", "sigmoid1", "sigmoid2")
    # eq
    eq_perturb_prob: float = 0.2
    eq_db_min: float = -40
    eq_db_max: float = 0
    eq_much_gain_prob: float = 0.1
    eq_much_gain_db_min: float = 5
    eq_much_gain_db_max: float = 30
    eq_much_gain_freq_min: float = 1500
    eq_much_gain_freq_max: float = 12000
    # band reject
    band_reject_prob: float = 0.15
    band_reject_min_center_freq: float = 100
    band_reject_max_center_freq: float = 12000
    band_reject_min_freq_bandwidth: float = 20
    band_reject_max_freq_bandwidth: float = 500
    band_reject_use_stft: bool = True
    band_reject_max_n: int = 2
    # bass boost
    bass_boost_prob: float = 0.1
    bass_boost_highpass_cutoff_min: float = 500
    bass_boost_highpass_cutoff_max: float = 2000
    bass_boost_attenuation_min_db: float = -40
    # dc offset
    dc_offset_prob: float = 0.05
    dc_offset_min: float = 0.001
    dc_offset_max: float = 0.2
    # spectral leakage
    spectral_leakage_prob: float = 0.05
    spectral_leakage_window_lengths: Sequence[int] = (1024, 2048, 4096)
    spectral_leakage_max_time_shift: int = 20
    # colored noise
    colored_noise_prob: float = 0.5
    colered_noise_snr_min: float = 0
    colered_noise_snr_max: float = 50
    colered_noise_types: Sequence[str] = ("white", "pink", "equalized")
    # lowpass
    lowpass_prob: float = 0.6
    lowpass_min_cutoff_freq: float = 800
    lowpass_max_cutoff_freq: float = 12000
    lowpass_min_order: int = 4
    lowpass_max_order: int = 20
    # tf holes
    spectral_time_freq_holes_prob: float = 0.2
    spectral_time_freq_holes_stft_frame_length: int = 1024
    spectral_time_freq_holes_stft_frame_step: int = 256
    spectral_time_freq_holes_stft_holes_num_min: int = 1
    spectral_time_freq_holes_stft_holes_num_max: int = 250
    spectral_time_freq_holes_stft_holes_width_min_freq: int = 1
    spectral_time_freq_holes_stft_holes_width_max_freq: int = 9
    spectral_time_freq_holes_stft_holes_width_min_time: int = 1
    spectral_time_freq_holes_stft_holes_width_max_time: int = 12
    spectral_time_freq_holes_cutoff_freq: float = 10000
    # webrtc
    webrtc_ns_prob: float = 0.0
    webrtc_ns_levels: Sequence[int] = (0, 1, 2, 3)
    webrtc_ns_volume_protection: bool = True
    webrtc_agc_prob: float = 0.0
    webrtc_agc_target_level_dbfs_max: float = -3
    webrtc_agc_target_level_dbfs_min: float = -31
    # drc
    drc_prob: float = 0.0
    drc_threshold_db_min: float = -50
    drc_threshold_db_max: float = 0
    drc_ratio_min: float = 1
    drc_ratio_max: float = 20
    drc_attack_ms_min: float = 0.5
    drc_attack_ms_max: float = 5.0
    drc_release_ms_min: float = 50
    drc_release_ms_max: float = 1000
    # codecs
    codecs_prob: float = 0.3
    codecs_types: Sequence[str] = ("mp3", "gsm", "opus")
    # packet loss
    packet_loss_prob: float = 0.3
    packet_loss_rate_min: float = 0.05
    packet_loss_rate_max: float = 0.15
    packet_loss_frame_time_min: float = 0.008
    packet_loss_frame_time_max: float = 0.04
    packet_loss_decay_rate_min: float = 0.0
    packet_loss_decay_rate_max: float = 0.2
    packet_loss_hard_loss_prob: float = 1.0
    packet_loss_on_vad: bool = False
    # bit crush
    bit_crush_prob: float = 0.05
    bit_crush_bit_min: int = 4
    bit_crush_bit_max: int = 32
    # post colored noise
    colored_noise_post_prob: float = 0.1
    colored_noise_post_snr_min: float = 10
    colored_noise_post_snr_max: float = 50
    colored_noise_post_types: Sequence[str] = ("white", "pink", "equalized")
    # volume
    random_volume: bool = True
    volume_min_sample: float = 0.015
    volume_max_sample: float = 0.99
    volume_min_dB: Optional[float] = None
    volume_max_dB: Optional[float] = None
    use_rms_volume: bool = False
    sync_random_volume: bool = True
    # output
    output_cut_seconds: Optional[float] = None
    output_random_cut: bool = False
    output_normalize: bool = True
    output_resample: bool = False
    output_resample_rate: int = 48000
    debug: bool = False


class DistortDataset:
    """Map-style dataset: __getitem__(i) -> batch dict (numpy)."""

    def __init__(self, cfg: DistortConfig):
        self.cfg = cfg
        self.clean_list = self._parse_jsonl(cfg.clean_json_path)
        self.noise_list = self._parse_jsonl(cfg.noise_json_path)
        self.rir_list = self._parse_list(cfg.rir_list_path) if cfg.rir_list_path else []
        c = cfg
        self.speech_splice_length = int(c.speech_splice_seconds * c.sampling_rate)

        self.speed_perturber = P.SpeedPerturb(c.sampling_rate, c.speed_rate_min, c.speed_rate_max)
        self.pitch_shifter = P.PitchPerturb(c.sampling_rate, c.semitones_down, c.semitones_up)
        self.loudness_perturber = P.LoudnessPerturb(
            c.sampling_rate, c.loudness_min_factor, c.loudness_max_factor,
            c.loudness_max_n_intervals,
        )
        if c.hard_clip_on_rate:
            self.hard_clip_perturber = P.SpeakerDistortionPerturbHardClipOnRate(
                c.sampling_rate, c.hard_clip_rate_min, c.hard_clip_rate_max
            )
        else:
            self.hard_clip_perturber = P.SpeakerDistortionPerturbHardClip(c.sampling_rate)
        soft_map = {
            "sox": P.SpeakerDistortionPerturbSox,
            "pedal": P.SpeakerDistortionPerturbPedal,
            "clip_pedal": P.SpeakerDistortionPerturbClipPedal,
            "soft": P.SpeakerDistortionPerturbSoftClip,
            "sigmoid1": P.SpeakerDistortionPerturbSigmoid1,
            "sigmoid2": P.SpeakerDistortionPerturbSigmoid2,
        }
        self.soft_clip_perturbers = [soft_map[t](c.sampling_rate) for t in c.soft_clip_types]
        self.eq_perturber = P.EQPerturb(c.sampling_rate, c.eq_db_min, c.eq_db_max)
        self.eq_much_gain_perturber = P.EQMuchGainPerturb(
            c.sampling_rate, c.eq_much_gain_db_min, c.eq_much_gain_db_max,
            c.eq_much_gain_freq_min, c.eq_much_gain_freq_max,
        )
        self.band_reject_perturber = P.BandRejectPerturb(
            c.sampling_rate, c.band_reject_min_center_freq, c.band_reject_max_center_freq,
            min_freq_bandwidth=c.band_reject_min_freq_bandwidth,
            max_freq_bandwidth=c.band_reject_max_freq_bandwidth,
            use_stft=c.band_reject_use_stft, max_n=c.band_reject_max_n,
        )
        self.bass_boost_perturber = P.BassBoostPerturb(
            c.sampling_rate, c.bass_boost_highpass_cutoff_min,
            c.bass_boost_highpass_cutoff_max, c.bass_boost_attenuation_min_db,
        )
        self.dc_offset_perturber = P.DCOffsetPerturb(
            c.sampling_rate, c.dc_offset_min, c.dc_offset_max
        )
        self.spectral_leakage_perturber = P.SpectralLeakagePerturb(
            c.sampling_rate, c.spectral_leakage_window_lengths,
            c.spectral_leakage_max_time_shift,
        )
        self.colored_noise_perturber = P.ColoredNoisePerturb(
            c.sampling_rate, c.colered_noise_snr_min, c.colered_noise_snr_max,
            c.colered_noise_types,
        )
        self.lowpass_perturber = P.LowPassPerturb(
            c.sampling_rate, c.lowpass_min_cutoff_freq, c.lowpass_max_cutoff_freq,
            c.lowpass_min_order, c.lowpass_max_order,
        )
        self.spectral_time_freq_holes_perturber = P.SpectralTimeFreqHolesPerturb(
            c.sampling_rate, c.spectral_time_freq_holes_stft_frame_length,
            c.spectral_time_freq_holes_stft_frame_step,
            c.spectral_time_freq_holes_stft_holes_num_min,
            c.spectral_time_freq_holes_stft_holes_num_max,
            c.spectral_time_freq_holes_stft_holes_width_min_freq,
            c.spectral_time_freq_holes_stft_holes_width_max_freq,
            c.spectral_time_freq_holes_stft_holes_width_min_time,
            c.spectral_time_freq_holes_stft_holes_width_max_time,
            c.spectral_time_freq_holes_cutoff_freq,
        )
        self.webrtc_ns_perturber = P.WebRTCNSPerturb(c.sampling_rate, c.webrtc_ns_levels)
        self.webrtc_agc_perturber = P.WebRTCAGCPerturb(
            c.sampling_rate, c.webrtc_agc_target_level_dbfs_min,
            c.webrtc_agc_target_level_dbfs_max,
        )
        self.drc_perturber = P.DRCPerturb(
            c.sampling_rate, c.drc_threshold_db_min, c.drc_threshold_db_max, None,
            c.drc_ratio_min, c.drc_ratio_max, None, c.drc_attack_ms_min,
            c.drc_attack_ms_max, None, c.drc_release_ms_min, c.drc_release_ms_max, None,
        )
        codec_map = {
            "mp3": P.MP3CompressorPerturb,
            "gsm": P.GSMcodecsPerturb,
            "opus": P.OPUSCodecsPerturb,
            "aac": P.AACConversionPerturb,
        }
        self.codecs_perturbers = [codec_map[t](c.sampling_rate) for t in c.codecs_types]
        # mirror the reference's weighted codec choice (dataset:482-509):
        # uniform over available codecs
        self.codecs_perturbers_prob = [1.0 / len(self.codecs_perturbers)] * len(
            self.codecs_perturbers
        ) if self.codecs_perturbers else []
        self.packet_loss_perturber = P.PacketLossPerturb(
            c.sampling_rate, c.packet_loss_rate_min, c.packet_loss_rate_max,
            c.packet_loss_frame_time_min, c.packet_loss_frame_time_max,
            c.packet_loss_decay_rate_min, c.packet_loss_decay_rate_max,
            c.packet_loss_hard_loss_prob, c.packet_loss_on_vad,
        )
        self.bit_crush_perturber = P.BitCrushPerturb(
            c.sampling_rate, c.bit_crush_bit_min, c.bit_crush_bit_max
        )
        self.colored_noise_post_perturber = P.ColoredNoisePerturb(
            c.sampling_rate, c.colored_noise_post_snr_min, c.colored_noise_post_snr_max,
            c.colored_noise_post_types,
        )

    # -- list parsing -------------------------------------------------------
    def _parse_jsonl(self, path: str) -> List[str]:
        if not path:
            return []
        out = []
        c = self.cfg
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                j = json.loads(line)
                dur = float(j.get("duration", 1e9))
                if c.min_duration_seconds and dur <= c.min_duration_seconds:
                    continue
                if c.max_duration_seconds and dur >= c.max_duration_seconds:
                    continue
                out.append(j["file_path"])
        return out

    @staticmethod
    def _parse_list(path: str) -> List[str]:
        with open(path) as f:
            return [x.strip() for x in f if x.strip()]

    def __len__(self) -> int:
        return len(self.clean_list)

    # -- audio loading --------------------------------------------------------
    def _read(self, path: str) -> np.ndarray:
        try:
            data, sr = read_wav(path)
        except Exception as e:  # per-file fallback to zeros (ref :1015-1026)
            print(path, e)
            return np.zeros(self.cfg.sampling_rate, np.float32)
        if data.ndim > 1:
            data = data[:, 0]
        if self.cfg.remove_dc_offset:
            data = data - data.mean()
        if not valid_audio(data):
            data = np.zeros_like(data)
        if sr != self.cfg.sampling_rate:
            if self.cfg.resample_method == "fft":
                data = resample_fft(data, sr, self.cfg.sampling_rate)
            else:
                data = resample_poly(data, sr, self.cfg.sampling_rate)
            if not valid_audio(np.asarray(data)):
                data = np.zeros_like(data)
        return data.astype(np.float32)

    def _read_mixed_speakers(self, path: str, n_speakers: int) -> np.ndarray:
        c = self.cfg
        data = self._read(path)
        for _ in range(n_speakers - 1):
            add = self._read(np.random.choice(self.clean_list))
            tgt = np.sqrt(np.mean(vad_merge(data) ** 2) + 1e-8)
            vol = np.sqrt(np.mean(vad_merge(add) ** 2) + 1e-8)
            dbv = np.random.uniform(*c.speech_splice_equal_volume_range)
            add = add * (tgt * 10 ** (dbv / 20)) / vol
            if len(data) < len(add):
                data = np.pad(data, (0, len(add) - len(data)))
            elif len(add) < len(data):
                add = np.pad(add, (0, len(data) - len(add)))
            data = data + add
        return data

    def _maybe_extra_space(self, data: np.ndarray) -> np.ndarray:
        c = self.cfg
        if np.random.random() >= c.add_extra_space_prob:
            return data
        head = np.random.randint(0, int(0.3 * c.sampling_rate) + 1) * int(np.random.random() < 0.8)
        tail = np.random.randint(0, int(0.3 * c.sampling_rate) + 1) * int(np.random.random() < 0.8)
        return np.pad(data, (head, tail))

    def get_clean(self, idx: int) -> Dict[str, np.ndarray]:
        """Clean read + mix + splice (ref :1000-1223)."""
        c = self.cfg
        speed_flag = np.random.random() < c.speed_perturb_prob
        pitch_flag = np.random.random() < c.pitch_shift_prob
        self.n_speakers = np.random.randint(c.min_n_speakers, c.max_n_speakers + 1)

        data = self._read_mixed_speakers(self.clean_list[idx], self.n_speakers)
        data = self._maybe_extra_space(data)

        if c.speech_splice:
            target_volume = np.sqrt(np.mean(vad_merge(data) ** 2) + 1e-8)
            while len(data) < self.speech_splice_length:
                cat = self._read_mixed_speakers(
                    np.random.choice(self.clean_list), self.n_speakers
                )
                cat = self._maybe_extra_space(cat)
                if c.speech_splice_equal_volume:
                    vol = np.sqrt(np.mean(vad_merge(cat) ** 2) + 1e-8)
                    dbv = np.random.uniform(*c.speech_splice_equal_volume_range)
                    cat = cat * (target_volume * 10 ** (dbv / 20)) / vol
                data = np.concatenate([data, cat])
            if len(data) > self.speech_splice_length:
                start = (
                    np.random.randint(0, len(data) - self.speech_splice_length + 1)
                    if c.speech_random_start else 0
                )
                data = data[start : start + self.speech_splice_length]

        out = {"no_perturbed_clean": data.astype(np.float32)}
        if speed_flag:
            data = self.speed_perturber(data)
        if pitch_flag:
            data = self.pitch_shifter(data)
        out["perturbed_clean"] = data.astype(np.float32)
        return out

    def get_noise(self, length: Optional[int] = None) -> np.ndarray:
        """Noise read, optional second-noise mix, trim/splice (ref :1225-1332)."""
        c = self.cfg
        mix_flag = np.random.random() < c.noise_mix_prob

        def read_one() -> np.ndarray:
            noise = self._read(np.random.choice(self.noise_list))
            if mix_flag:
                n2 = self._read(np.random.choice(self.noise_list))
                if len(n2) < len(noise):
                    n2 = np.pad(n2, (0, len(noise) - len(n2)))
                noise = noise + np.random.uniform(0.1, 1.0) * n2[: len(noise)]
            return noise

        noise = read_one()
        if length:
            while len(noise) < length:
                cat = noise.copy() if c.noise_repeat_splice else read_one()
                noise = np.concatenate([noise, cat])
            if len(noise) > length:
                start = np.random.randint(0, len(noise) - length + 1)
                noise = noise[start : start + length]
        return noise

    def get_rir(self):
        """File RIR (pickle/wav) or FRA-RIR; early = first 6 taps
        (ref :1334-1356)."""
        c = self.cfg
        if c.reverb_use_FRA or not self.rir_list:
            rir, _direct = fra_rir(nsource=1, sr=c.sampling_rate, max_T60=0.05)
            rir_data = rir[0].astype(np.float32)
        else:
            rir_path = np.random.choice(self.rir_list)
            if c.min_rt60 and c.max_rt60:
                rt60 = float(rir_path.split("rt")[1].split("_")[0])
                while rt60 < c.min_rt60 or rt60 > c.max_rt60:
                    rir_path = np.random.choice(self.rir_list)
                    rt60 = float(rir_path.split("rt")[1].split("_")[0])
            if rir_path.endswith(".wav"):
                rir_data, _ = read_wav(rir_path)
            else:
                with open(rir_path, "rb") as f:
                    d = pickle.load(f)
                rir_data = d.get("source_rir", d.get("rir"))
            if rir_data.ndim > 1:
                rir_data = rir_data[:, 0]
            rir_data = rir_data[np.argmax(np.abs(rir_data)) :]
            rir_data = rir_data / np.abs(rir_data).max()
        return rir_data, rir_data[:6]

    def reverberate(self, clean):
        rir, rir_early = self.get_rir()
        n = clean.shape[0]
        return (
            fftconvolve(clean, rir, mode="full")[:n],
            fftconvolve(clean, rir_early, mode="full")[:n],
        )

    def add_noise(self, clean, noise):
        c = self.cfg
        snr = np.random.uniform(c.snr_min, c.snr_max)
        clean_power = np.mean(vad_merge(clean) ** 2)
        noise_power = np.mean(vad_merge(noise) ** 2)
        scale = np.sqrt(clean_power / (noise_power + 1e-8) / 10.0 ** (snr / 10.0) + 1e-8)
        noise = noise * scale
        return clean + noise, clean, noise, snr

    # -- volume ---------------------------------------------------------------
    def _target_volume(self):
        c = self.cfg
        if c.volume_min_dB and c.volume_max_dB:
            return 10.0 ** (np.random.uniform(c.volume_min_dB, c.volume_max_dB) / 20.0)
        return np.random.uniform(c.volume_min_sample, c.volume_max_sample)

    def _measure(self, x):
        if self.cfg.use_rms_volume:
            return np.sqrt(np.mean(vad_merge(x) ** 2) + 1e-8)
        return np.abs(x).max()

    def random_volume_dual(self, noisy, clean):
        target = self._target_volume()
        vol = max(self._measure(noisy), self._measure(clean))
        scale = target / (vol + 1e-6)
        return noisy * scale, clean * scale, target

    def random_volume(self, x):
        target = self._target_volume()
        return x * (target / (self._measure(x) + 1e-6)), target

    @staticmethod
    def volume_clip_dual(noisy, clean):
        vol = max(np.abs(noisy).max(), np.abs(clean).max())
        if vol > 0.99:
            noisy = noisy * (0.99 / vol)
            clean = clean * (0.99 / vol)
        return noisy, clean

    @staticmethod
    def volume_clip(x):
        vol = np.abs(x).max()
        return x * (0.99 / vol) if vol > 0.99 else x

    # -- main -----------------------------------------------------------------
    def __getitem__(self, idx: int) -> Dict:
        c = self.cfg
        out: Dict = {}

        clean = np.nan_to_num(self.get_clean(idx)["perturbed_clean"], nan=0, posinf=0, neginf=0)
        if c.debug:
            out["original_clean"] = clean.astype(np.float32)

        add_noise_flag = np.random.random() < c.add_noise_prob
        only_noise_flag = np.random.random() < c.only_noise_prob
        if add_noise_flag or only_noise_flag:
            noise = self.get_noise(length=clean.shape[0] if c.trim_noise else None)
        else:
            noise = np.zeros_like(clean)
        noise = np.nan_to_num(noise, nan=0, posinf=0, neginf=0)

        if np.random.random() < c.reverb_prob:
            clean_reverb, clean_early = self.reverberate(clean)
            clean = clean_early
        else:
            clean_reverb = clean.copy()

        if only_noise_flag:
            noisy = noise.copy()
            clean = np.zeros_like(noise)
            snr = -1000.0
        elif add_noise_flag:
            noisy, clean_reverb, noise, snr = self.add_noise(clean_reverb, noise)
        else:
            noisy = clean_reverb.copy()
            snr = np.inf
        out["SNR"] = snr

        perturbed = noisy
        if np.random.random() < c.loudness_perturb_prob:
            perturbed = self.loudness_perturber(perturbed)
        if np.random.random() < c.clip_prob:
            if np.random.random() < c.hard_clip_portion:
                perturbed = self.hard_clip_perturber(perturbed)
            else:
                perturbed = np.random.choice(self.soft_clip_perturbers)(perturbed)
        eq_flag = np.random.random() < c.eq_perturb_prob
        if eq_flag:
            perturbed = self.eq_perturber(perturbed)
        eq_much_flag = np.random.random() < c.eq_much_gain_prob and not eq_flag
        if eq_much_flag:
            perturbed = self.eq_much_gain_perturber(perturbed)
        if np.random.random() < c.band_reject_prob:
            perturbed = self.band_reject_perturber(perturbed)
        if np.random.random() < c.bass_boost_prob and not eq_flag and not eq_much_flag:
            perturbed = self.bass_boost_perturber(perturbed)
        if np.random.random() < c.dc_offset_prob:
            perturbed = self.dc_offset_perturber(perturbed)
        if np.random.random() < c.spectral_leakage_prob:
            perturbed = self.spectral_leakage_perturber(perturbed)
        if np.random.random() < c.colored_noise_prob:
            perturbed = self.colored_noise_perturber(perturbed)
        if np.random.random() < c.lowpass_prob:
            perturbed = self.lowpass_perturber(perturbed)
        if np.random.random() < c.spectral_time_freq_holes_prob:
            perturbed = self.spectral_time_freq_holes_perturber(perturbed)
        if np.random.random() < c.webrtc_ns_prob:
            if c.webrtc_ns_volume_protection and np.abs(perturbed).max() > 0.99:
                perturbed = perturbed / np.abs(perturbed).max() * 0.99
                clean = clean / np.abs(clean).max() * 0.99
            perturbed = self.webrtc_ns_perturber(perturbed)
        if np.random.random() < c.webrtc_agc_prob:
            perturbed = self.webrtc_agc_perturber(perturbed)
        if np.random.random() < c.drc_prob:
            perturbed = self.drc_perturber(perturbed)
        if np.random.random() < c.codecs_prob and self.codecs_perturbers:
            codec = np.random.choice(self.codecs_perturbers, p=self.codecs_perturbers_prob)
            perturbed = codec(perturbed)
        if np.random.random() < c.packet_loss_prob:
            perturbed = self.packet_loss_perturber(perturbed)
        if np.random.random() < c.bit_crush_prob:
            perturbed = self.bit_crush_perturber(perturbed)
        if np.random.random() < c.colored_noise_post_prob:
            perturbed = self.colored_noise_post_perturber(perturbed)

        if c.random_volume:
            if c.sync_random_volume:
                perturbed, clean, tv = self.random_volume_dual(perturbed, clean)
                perturbed, clean = self.volume_clip_dual(perturbed, clean)
                out["target_volume_perturbed"] = out["target_volume_clean"] = tv
            else:
                perturbed, tvp = self.random_volume(perturbed)
                perturbed = self.volume_clip(perturbed)
                clean, tvc = self.random_volume(clean)
                clean = self.volume_clip(clean)
                out["target_volume_perturbed"] = tvp
                out["target_volume_clean"] = tvc

        perturbed = perturbed.astype(np.float32)
        clean = clean.astype(np.float32)
        n = min(len(perturbed), len(clean))
        perturbed, clean = perturbed[:n], clean[:n]

        if c.output_cut_seconds:
            cut = int(c.output_cut_seconds * c.sampling_rate)
            start = (
                np.random.randint(0, max(len(perturbed) - cut + 1, 1))
                if c.output_random_cut else 0
            )
            perturbed = perturbed[start : start + cut]
            clean = clean[start : start + cut]
            if len(perturbed) < cut:
                perturbed = np.pad(perturbed, (0, cut - len(perturbed)))
                clean = np.pad(clean, (0, cut - len(clean)))

        if c.output_normalize:
            norm = max(np.max(np.abs(perturbed)), np.max(np.abs(clean)), 1e-9)
            perturbed = perturbed / norm * 0.8
            clean = clean / norm * 0.8

        if c.output_resample:
            perturbed = resample_fft(
                perturbed, c.sampling_rate, c.output_resample_rate
            ).astype(np.float32)
            out["sampling_rate"] = c.output_resample_rate
        else:
            out["sampling_rate"] = c.sampling_rate

        out["perturbed"] = perturbed
        out["clean"] = clean
        out["name"] = f"index{idx}"
        out["n_speakers"] = self.n_speakers
        return out
