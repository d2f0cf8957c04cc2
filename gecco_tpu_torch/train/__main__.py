"""Training CLI: ``python -m gecco_tpu_torch.train <config.py>`` (counterpart
of ``gecco_tpu/train/__main__.py``): checks the config's contract
(``make_train_loader``, ``make_val_loader``, ``make_model``, ``train``),
records the date and the git hash in ``metadata.json`` and trains with the
checkpoints and logs next to the config file, on the card unless
``--device`` names another.

``--distributed`` joins the process group of a launcher before any device
use (``parallel.init_distributed``) and trains data-parallel, rank 0
writing ``metadata.json``, the checkpoints and the logs:

    python -m torch.distributed.run --nproc_per_node K \\
        -m gecco_tpu_torch.train CONFIG --distributed [--backend gloo]

The backend is NCCL on the card and gloo on the CPU unless ``--backend``
names one; two ranks on one card need gloo (NCCL refuses a shared device).
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import subprocess
from typing import Optional

from gecco_tpu_torch.config import load_config


def execute(config_path: str, device=None, distributed: bool = False,
            backend: Optional[str] = None):
    """Train the config at ``config_path``; ``device`` (where given) goes
    to its ``train`` as a keyword, the card being the default.
    ``distributed``: join the launcher's process group first, with
    ``backend`` (None: NCCL on the card, gloo on the CPU)."""
    process_index = 0
    if distributed:
        from gecco_tpu_torch.parallel import init_distributed

        process_index = init_distributed(**({} if backend is None else {"backend": backend}))
        print(f"Distributed: process {process_index}", flush=True)
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
    if process_index == 0:
        with open(os.path.join(save_path, "metadata.json"), "w") as f:
            json.dump(metadata, f)

    extra = {} if device is None else {"device": device}
    try:
        return config.train(config.make_model, train_loader, val_loader, save_path, **extra)
    finally:
        if distributed:
            from gecco_tpu_torch.parallel import shutdown_distributed

            shutdown_distributed()


def main():
    parser = argparse.ArgumentParser(description="Train a gecco_tpu_torch model")
    parser.add_argument("config", help="path to a .py config file")
    parser.add_argument("--device", default=None,
                        help="the device to train on (default: the card); the config's "
                        "train takes it as a keyword")
    parser.add_argument("--distributed", action="store_true",
                        help="join the process group of torch.distributed.run (its RANK, "
                        "WORLD_SIZE, MASTER_ADDR, LOCAL_RANK) and train data-parallel")
    parser.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                        help="the process group's backend (default: nccl on the card, gloo "
                        "on the CPU)")
    args = parser.parse_args()
    execute(args.config, args.device, args.distributed, args.backend)


if __name__ == "__main__":
    main()
