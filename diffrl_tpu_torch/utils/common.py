"""Misc helpers: seeding, colored prints, timestamps (port of
diffrl_tpu/utils/common.py)."""

from __future__ import annotations

import datetime
import os
import random

import numpy as np
import torch


def seeding(seed=0):
    """Seed the host's generators (Python's, numpy's global one and
    torch's default); the trainers draw from their own seeded
    torch.Generator."""
    print(f"Setting seed: {seed}")
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    return seed


def get_time_stamp():
    now = datetime.datetime.now()
    return "{:02d}-{:02d}-{:02d}-{:02d}-{:02d}-{:02d}".format(
        now.year % 100, now.month, now.day, now.hour, now.minute, now.second)


_GREEN = "\033[92m"
_RED = "\033[91m"
_YELLOW = "\033[93m"
_END = "\033[0m"


def print_info(*message):
    print(_GREEN, *message, _END)


def print_ok(*message):
    print(_GREEN, *message, _END)


def print_warning(*message):
    print(_YELLOW, *message, _END)


def print_error(*message):
    print(_RED, *message, _END)


def parse_diff_env_kwargs(cfg_env: dict) -> dict:
    """Env constructor kwargs from a cfg['params']['diff_env'] block: every
    entry but the env's name."""
    return {k: v for k, v in cfg_env.items() if k != "name"}
