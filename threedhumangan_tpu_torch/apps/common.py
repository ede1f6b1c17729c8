"""What the port's inference and eval apps share: the config with the
original repo's eval settings, and loading a generator's weights."""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch

# the original repo's eval settings (its apps/sample_from_generator.py:94-99)
EVAL_SETTINGS = dict(truncation_psi=0.7, h_stddev=0, v_stddev=0, nerf_noise=0, perturb_rays=False)


def eval_config(opt, eval_last_back: bool = True, **overrides) -> Dict:
    """The named config's string keys (every app reads the whole config as
    its meta) with ``EVAL_SETTINGS`` and ``overrides``; ``eval_last_back``
    sets ``last_back`` to the config's ``eval_last_back``, as every JAX app
    but ``eval_fid`` does."""
    from threedhumangan_tpu_torch import configs

    config = {k: v for k, v in configs.get_config(opt).items() if isinstance(k, str)}
    config.update(EVAL_SETTINGS, **overrides)
    if eval_last_back:
        config["last_back"] = config.get("eval_last_back", False)
    return config


def load_weights(gen: torch.nn.Module, path: Optional[str]) -> str:
    """Load ``path`` into ``gen``: a ``.npz`` is the port's ``Trainer``
    checkpoint (its EMA parameters), anything else a torch state_dict in the
    reference key space (the released checkpoint, or one the port saved).
    Returns what was loaded; with no path the random weights stay.  A path
    that does not exist raises."""
    from threedhumangan_tpu_torch.utils import weights

    if not path:
        return "random-init"
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    if path.endswith(".npz"):
        weights.load_trainer_checkpoint(path, gen)
        return "trainer-checkpoint-ema"
    weights.load_generator_state_dict(gen, weights.load_torch_state_dict(path))
    return "torch-state_dict"
