"""Shared helpers of the use_tpu <-> use_tpu_torch parity tests.

Inputs and weights are drawn with numpy from a seed and handed to both
packages; tensors cross between JAX and torch as numpy arrays.
"""
from __future__ import annotations

from typing import Any, Mapping

import jax
import numpy as np
import torch


def random_params(tree: Mapping[str, Any], seed: int) -> dict:
    """A param tree of the same structure with non-degenerate random values:
    kernels ~ N(0, 1/fan_in), norm scales ~ 1 + N(0, 0.1), biases ~ N(0, 0.1),
    the Gaussian-Fourier W ~ N(0, 16^2) as its own init draws it."""
    rng = np.random.default_rng(seed)

    def walk(node):
        out = {}
        for k, v in node.items():
            if isinstance(v, Mapping):
                out[k] = walk(v)
                continue
            shape = tuple(np.shape(v))
            if k == "scale":
                arr = 1.0 + 0.1 * rng.standard_normal(shape)
            elif k in ("bias", "b") or k.endswith("_bias"):
                arr = 0.1 * rng.standard_normal(shape)
            elif k == "W" and len(shape) == 1:
                arr = 16.0 * rng.standard_normal(shape)
            else:
                arr = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
            out[k] = arr.astype(np.float32)
        return out

    return walk(tree)


def nhwc_to_nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(x), (0, 3, 1, 2))))


def nchw_to_nhwc(x: torch.Tensor) -> np.ndarray:
    return x.detach().float().permute(0, 2, 3, 1).numpy()


def assert_close(got, want, rtol: float, atol: float) -> None:
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


def jax_pc_noise(rng, n_steps: int, shape, n_corr: int) -> list:
    """use_tpu's PC sampler draws, in the order the port's `noise_fn` is
    called: per step `split(rng, 3)` -> crandn(rz) (sampling.py:151-159),
    then the corrector's `split(rc)` draws (sampling.py:98-100)."""
    from use_tpu.models.sgmse.sdes import crandn

    out = []
    for _ in range(n_steps):
        rng, rz, rc = jax.random.split(rng, 3)
        out.append(np.array(crandn(rz, shape)))
        for _ in range(n_corr):
            rc, sub = jax.random.split(rc)
            out.append(np.array(crandn(sub, shape)))
    return out


def replay(draws):
    """A `noise_fn(shape)` that hands out `draws` in order, and the iterator
    (exhausted once every draw was consumed)."""
    it = iter(draws)

    def noise_fn(shape):
        z = next(it)
        assert tuple(z.shape) == tuple(shape)
        return torch.from_numpy(z)

    return noise_fn, it


def jax_position_noise(rng, shape):
    """use_tpu's parallel PC noise as a `noise_at(p)` source: position p
    draws crandn(fold_in(rng_z, p)) with rng_z = split(rng)[0]
    (sampling.py:236-245)."""
    from use_tpu.models.sgmse.sdes import crandn

    rng_z, _ = jax.random.split(rng)

    def noise_at(p):
        return torch.from_numpy(np.array(crandn(jax.random.fold_in(rng_z, p), shape)))

    return noise_at
