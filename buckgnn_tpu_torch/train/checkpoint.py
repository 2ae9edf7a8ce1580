"""Checkpointing — the model, the optimizer state, the epoch, the normalizer
and the configs.

The port of buckgnn_tpu/train/checkpoint.py, with the same directory
layout: ``train_config.json``, ``config.json`` (the model's
`checkpoint_config_dict`) and ``normalizer.npz`` beside the state, which
here is ``state.pt`` (``torch.save`` of the model's ``state_dict()``, the
batch norms' running statistics included, the Adam ``state_dict()`` and
the epoch). The reference saves no optimizer state (TRAIN_FINAL.py:391-429)
and so cannot truly resume; these checkpoints can.

`load_checkpoint` also reads a directory the JAX package wrote: without a
``state.pt`` it reads its ``state.msgpack`` (params, ``batch_stats``, the
optax Adam moments and the epoch) through `convert.py`.
"""

from __future__ import annotations

import json
import os

import torch

from buckgnn_tpu_torch.config import TrainConfig
from buckgnn_tpu_torch.convert import (
    adam_state_from_optax, read_flax_msgpack, state_from_flax,
)
from buckgnn_tpu_torch.graph.normalizer import DatasetNormalizer


def save_checkpoint(
    path: str,
    state,
    train_config: TrainConfig,
    checkpoint_config: dict,
    normalizer: DatasetNormalizer | None,
) -> None:
    """Write ``state`` (a `train.trainer.TrainState`), the configs and the
    normalizer into the directory ``path``."""
    os.makedirs(path, exist_ok=True)
    torch.save({"model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "epoch": int(state.epoch)},
               os.path.join(path, "state.pt"))
    with open(os.path.join(path, "train_config.json"), "w") as f:
        f.write(train_config.to_json())
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(checkpoint_config, f, indent=2)
    if normalizer is not None:
        normalizer.save(os.path.join(path, "normalizer.npz"))


def load_checkpoint(path: str, model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer | None = None):
    """Restore ``(epoch, train_config, checkpoint_config, normalizer)``.

    ``model`` and ``optimizer`` (None: the model alone, for serving), built
    from the stored configs, are loaded in place; ``epoch`` is the number
    of epochs the state has trained. A JAX checkpoint's float32 arrays load
    bit for bit.
    """
    pt = os.path.join(path, "state.pt")
    if os.path.exists(pt):
        # to the host: loading moves the moments to their parameters'
        # device and leaves Adam's step counts on the host, where it keeps
        # them (on the card each step would read them back)
        saved = torch.load(pt, map_location="cpu")
        model.load_state_dict(saved["model"])
        if optimizer is not None:
            optimizer.load_state_dict(saved["optimizer"])
    else:
        saved = read_flax_msgpack(os.path.join(path, "state.msgpack"))
        model.load_state_dict(state_from_flax(saved["params"],
                                              saved.get("batch_stats")))
        if optimizer is not None:
            sd = optimizer.state_dict()
            sd["state"] = adam_state_from_optax(saved["opt_state"],
                                                model)["state"]
            optimizer.load_state_dict(sd)
    train_config, checkpoint_config, normalizer = load_checkpoint_configs(
        path)
    return int(saved["epoch"]), train_config, checkpoint_config, normalizer


def load_checkpoint_configs(path: str):
    """Read only the configs/normalizer (to build the model to load)."""
    with open(os.path.join(path, "train_config.json")) as f:
        train_config = TrainConfig.from_json(f.read())
    with open(os.path.join(path, "config.json")) as f:
        checkpoint_config = json.load(f)
    norm_path = os.path.join(path, "normalizer.npz")
    normalizer = (
        DatasetNormalizer.load(norm_path) if os.path.exists(norm_path) else None
    )
    return train_config, checkpoint_config, normalizer
