"""Dual stderr+file logger (reference: utils/logger.py:7-41).

Fixes the reference's early-return bug where a second call with the same name
returned None (reference: utils/logger.py:25-26); here setup is idempotent
and always returns the logger. In multi-host runs only process 0 attaches
handlers, so logs aren't duplicated N times.
"""

from __future__ import annotations

import logging
import os
import sys
import time
from typing import Optional


def setup_logger(name: str, save_dir: Optional[str] = None,
                 process_index: int = 0) -> logging.Logger:
    logger = logging.getLogger(f"lwsnet.{os.path.basename(name)}")
    logger.setLevel(logging.DEBUG)
    logger.propagate = False

    if logger.handlers:  # idempotent: already configured
        return logger
    if process_index != 0:  # non-zero hosts log nothing
        logger.addHandler(logging.NullHandler())
        return logger

    fmt = logging.Formatter(
        "[%(asctime)s %(filename)s:%(lineno)s] %(levelname)s: %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S")

    sh = logging.StreamHandler(stream=sys.stderr)
    sh.setLevel(logging.DEBUG)
    sh.setFormatter(fmt)
    logger.addHandler(sh)

    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        stamp = time.strftime("%Y-%m-%d-%H-%M", time.localtime())
        fh = logging.FileHandler(
            os.path.join(save_dir, f"{os.path.basename(name)}-{stamp}.log"))
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(fmt)
        logger.addHandler(fh)

    return logger
