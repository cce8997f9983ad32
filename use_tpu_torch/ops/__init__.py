"""Signal and kernel ops of the port.

``KERNEL_WRAPPERS`` lists every wrapper that launches a hand-written CUDA
kernel; each carries an integer ``launches`` count.
"""
from use_tpu_torch.ops.fused_qconv import qconv3x3_fused
from use_tpu_torch.ops.fused_skip import fused_skip_add
from use_tpu_torch.ops.gn_stats import channel_sums, gn_apply, gn_apply_int8
from use_tpu_torch.ops.qconv import qconv3x3_s8
from use_tpu_torch.ops.stft import (
    STFTConfig,
    from_complex,
    get_window,
    istft,
    pad_spec,
    spec_back,
    spec_fwd,
    stft,
    to_complex,
)

KERNEL_WRAPPERS = (channel_sums, gn_apply, fused_skip_add, qconv3x3_fused, gn_apply_int8,
                   qconv3x3_s8)


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}


__all__ = [
    "STFTConfig",
    "stft",
    "istft",
    "spec_fwd",
    "spec_back",
    "pad_spec",
    "get_window",
    "to_complex",
    "from_complex",
    "channel_sums",
    "gn_apply",
    "fused_skip_add",
    "qconv3x3_fused",
    "gn_apply_int8",
    "qconv3x3_s8",
    "KERNEL_WRAPPERS",
    "reset_launch_counts",
    "launch_counts",
]
