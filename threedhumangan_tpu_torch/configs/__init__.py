"""Config engine: curriculum dicts with int-keyed step thresholds.

The port's own copy of ``threedhumangan_tpu/configs/__init__.py`` (pure
Python, same values and behaviour; ``tests/test_torch_trainer.py`` holds
the two against each other):
  * ``extract_metadata(config, step)`` merges the entries of the largest
    int key <= step with every string-keyed entry;
  * ``next_upsample_step`` / ``last_upsample_step`` locate resolution-change
    boundaries (the trainer rebuilds its stage at each);
  * ``get_config(opt)`` resolves a named config and applies --tune variants.
    The registry dict is never mutated in place: a copy is returned and
    ``neural_field_cls`` stays a string, resolved by the model factory.
"""

from __future__ import annotations

import copy

from threedhumangan_tpu_torch.configs.map3d import (  # noqa: F401
    MAP3DBN,
    MAP3DBN512,
    MAP3DBN512L,
    MAP3DBN_NANO,
    MAP3DBN_TINY,
)

_REGISTRY = {
    "MAP3DBN": MAP3DBN,
    "MAP3DBN512": MAP3DBN512,
    "MAP3DBN512L": MAP3DBN512L,
    "MAP3DBN_TINY": MAP3DBN_TINY,
    "MAP3DBN_NANO": MAP3DBN_NANO,
}


def _int_keys(config):
    return sorted(k for k in config if isinstance(k, int))


def extract_metadata(config: dict, current_step: int) -> dict:
    """Merge the largest int-key block <= current_step with all string keys."""
    meta = {}
    for step_key in reversed(_int_keys(config)):
        if step_key <= current_step:
            meta.update(config[step_key])
            break
    for key, value in config.items():
        if not isinstance(key, int):
            meta[key] = value
    return meta


def _stage_size(entry: dict, default_w, default_h) -> int:
    return max(entry.get("render_width", default_w), entry.get("render_height", default_h))


def next_upsample_step(config: dict, current_step: int) -> float:
    """First curriculum step after ``current_step`` with a larger resolution."""
    meta = extract_metadata(config, current_step)
    current = max(
        meta.get("render_width", meta["gen_width"]),
        meta.get("render_height", meta["gen_height"]),
    )
    for step_key in _int_keys(config):
        if step_key > current_step and _stage_size(config[step_key], 512, 512) > current:
            return step_key
    return float("inf")


def last_upsample_step(config: dict, current_step: int) -> int:
    """Start step of the current resolution stage."""
    meta = extract_metadata(config, current_step)
    current = max(
        meta.get("render_width", meta["gen_width"]),
        meta.get("render_height", meta["gen_height"]),
    )
    result = 0
    for step_key in _int_keys(config):
        if step_key <= current_step:
            size = _stage_size(config[step_key], meta["gen_width"], meta["gen_height"])
            if size == current:
                result = step_key
                break
    return result


def get_config(opt) -> dict:
    """Resolve opt.config by name and apply --tune/--variant sweeps."""
    name = opt.config
    if name not in _REGISTRY:
        raise ValueError(
            f"unknown config {name!r}; available: {sorted(_REGISTRY)}")
    config = copy.deepcopy(_REGISTRY[name])

    tune = getattr(opt, "tune", "") or ""
    variant = getattr(opt, "variant", 0)

    if tune == "":
        pass
    elif tune == "lr":
        variants = [(1e-4, 4e-4), (2e-4, 2e-4), (1e-4, 2e-4), (1e-4, 1e-4)]
        gen_lr, disc_lr = variants[variant]
        for key in config:
            if isinstance(key, int) and config[key]:
                config[key]["gen_lr"] = gen_lr
                config[key]["disc_lr"] = disc_lr
        config["name"] = "{}_G_lr={}_D_lr={}".format(config["name"], gen_lr, disc_lr)
    elif tune == "map3d_mode":
        mode = ["isolated", "mixed", "all"][variant]
        config["map3d_mode"] = mode
        config["name"] = "{}_map3d_mode={}".format(config["name"], mode)
    else:
        raise NotImplementedError(f"unknown tune mode: {tune}")

    return config


def register_config(name: str, config: dict) -> None:
    _REGISTRY[name] = config
