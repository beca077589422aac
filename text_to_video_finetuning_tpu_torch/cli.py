"""Command-line entry of the PyTorch port's training (the `t2v-train-torch`
script; port of `train_main` in text_to_video_finetuning_tpu/cli.py).

    t2v-train-torch --config configs/v2/train_config.yaml [--device cpu]
    python -m text_to_video_finetuning_tpu_torch.cli --config <yaml>

The YAML's keys are `training/engine.py::main`'s kwargs, as the reference's
`train.py` splats its config into `main()`.  The run is on the card unless
`--device` names another device.  Reading the YAML needs `yaml`; where it
is not installed, call `engine.main(**config_dict)` instead.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence


def train_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Finetune a ModelScope text-to-video model with the "
                    "PyTorch port")
    parser.add_argument("--config", type=str, required=True,
                        help="a training YAML (configs/v2/*.yaml)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to train on (default: cuda)")
    return parser


def train_main(argv: Optional[Sequence[str]] = None) -> str:
    args = train_parser().parse_args(argv)
    from .config import load_train_config
    from .training.engine import main
    return main(config=load_train_config(args.config), device=args.device)


if __name__ == "__main__":
    train_main()
