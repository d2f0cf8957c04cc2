"""Training CLI: ``python -m gecco_tpu_torch.train <config.py>`` (counterpart
of ``gecco_tpu/train/__main__.py``): checks the config's contract
(``make_train_loader``, ``make_val_loader``, ``make_model``, ``train``),
records the date and the git hash in ``metadata.json`` and trains with the
checkpoints and logs next to the config file, on the card unless
``--device`` names another. Multi-process training (the
JAX CLI's ``--distributed``) waits for ROADMAP A10.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import subprocess

from gecco_tpu_torch.config import load_config


def execute(config_path: str, device=None):
    """Train the config at ``config_path``; ``device`` (where given) goes
    to its ``train`` as a keyword, the card being the default."""
    config_path = os.path.abspath(config_path)
    save_path = os.path.dirname(config_path)
    config = load_config(config_path)

    for attribute in ("make_train_loader", "make_val_loader", "make_model", "train"):
        if not hasattr(config, attribute):
            raise AssertionError(f"Config {config_path!r} is missing the callable {attribute!r}")

    train_loader = config.make_train_loader()
    val_loader = config.make_val_loader()

    metadata = {"date": datetime.datetime.now(datetime.timezone.utc).isoformat()}
    try:
        metadata["git-hash"] = subprocess.check_output(
            ["git", "rev-parse", "HEAD"], cwd=os.path.dirname(os.path.abspath(__file__)),
            stderr=subprocess.DEVNULL).decode().strip()
    except Exception:
        pass
    with open(os.path.join(save_path, "metadata.json"), "w") as f:
        json.dump(metadata, f)

    extra = {} if device is None else {"device": device}
    return config.train(config.make_model, train_loader, val_loader, save_path, **extra)


def main():
    parser = argparse.ArgumentParser(description="Train a gecco_tpu_torch model")
    parser.add_argument("config", help="path to a .py config file")
    parser.add_argument("--device", default=None,
                        help="the device to train on (default: the card); the config's "
                        "train takes it as a keyword")
    args = parser.parse_args()
    execute(args.config, args.device)


if __name__ == "__main__":
    main()
