"""Parameter checkpoints: a flat name -> array dict as one .npz file, in
the JAX package's layout (`spsvo_tpu.utils.checkpoint.save_params_npz`), so
either package reads what the other wrote; `models.zoo.params_from_jax`
turns the arrays into the port's state dict. (Train-state snapshots wait
for the training port.)
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np


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
