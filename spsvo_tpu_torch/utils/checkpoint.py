"""Checkpoints.

Parameters: a flat name -> array dict as one .npz file, in the JAX
package's layout (`spsvo_tpu.utils.checkpoint.save_params_npz`), so either
package reads what the other wrote; `models.zoo.params_from_jax` turns the
arrays into the port's state dict.

Train state (`training.TrainState`: params, the Adam moments and count, the
step): `save_train_state` / `restore_train_state` write and read one
`torch.save` file, read back with `weights_only=True`.
`train_state_from_jax` carries a JAX `TrainState` across as numpy (params
and the optax Adam `mu`, `nu`, `count`), so training resumes in the port
where the JAX package left off.
"""

from __future__ import annotations

import os
from typing import TYPE_CHECKING, Dict, Iterable

import numpy as np
import torch

if TYPE_CHECKING:
    from spsvo_tpu_torch.training import TrainState


def save_params_npz(path: str, params: dict) -> str:
    """Save a name -> array (numpy, or torch tensor) dict."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **{k: (v.detach().cpu().numpy() if hasattr(v, "detach")
                          else np.asarray(v)) for k, v in params.items()})
    return path


def load_params_npz(path: str) -> Dict[str, np.ndarray]:
    """Load a name -> numpy array dict."""
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def save_train_state(path: str, state: TrainState) -> str:
    """Write `state` (any device) to `path`; returns the absolute path."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)

    def host(d):
        return {k: v.detach().cpu() for k, v in d.items()}

    torch.save({"params": host(state.params),
                "mu": host(state.opt_state.mu), "nu": host(state.opt_state.nu),
                "count": int(state.opt_state.count), "step": int(state.step)},
               path)
    return path


def restore_train_state(path: str, device="cuda") -> TrainState:
    """The `TrainState` `save_train_state` wrote, on `device`."""
    from spsvo_tpu_torch.training import AdamState, TrainState
    data = torch.load(path, map_location=device, weights_only=True)
    return TrainState(data["params"],
                      AdamState(data["count"], data["mu"], data["nu"]),
                      data["step"])


def train_state_from_jax(params: Dict[str, np.ndarray],
                         mu: Dict[str, np.ndarray], nu: Dict[str, np.ndarray],
                         count: int, step: int, conv_weights: Iterable[str],
                         device="cuda") -> TrainState:
    """A JAX `TrainState` as the port's: its params and the moments of its
    optax Adam state (`mu`, `nu`: numpy, JAX layout, the weights only) and
    Adam's update `count`, with `conv_weights` (HWIO there) made OIHW."""
    from spsvo_tpu_torch.models.zoo import params_from_jax
    from spsvo_tpu_torch.training import AdamState, TrainState
    conv = set(conv_weights)

    def port(d):
        return {k: v.to(device) for k, v in params_from_jax(d, conv).items()}

    return TrainState(port(params), AdamState(int(count), port(mu), port(nu)),
                      int(step))
