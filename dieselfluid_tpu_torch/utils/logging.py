"""Structured logging for simulations (counterpart of
dieselfluid_tpu/utils/logging.py; replaces the reference's printf banners,
e.g. model/sph/fluid.go:84)."""

from __future__ import annotations

import logging
import sys


def get_logger(name: str = "dieselfluid") -> logging.Logger:
    """A logger writing '<time> <name> <level> <message>' to standard
    error, at INFO, set up once per name."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s %(message)s", "%H:%M:%S"))
        logger.addHandler(h)
        logger.setLevel(logging.INFO)
    return logger


def log_banner(logger: logging.Logger, sim) -> None:
    """The SPH system banner (ref: fluid.go:84-86)."""
    p = sim.params
    logger.info(
        "SPH system: N=%d h=%.4f dt=%.5f d0=%.1f mu=%.3f solver=%s "
        "neighbors=%s", sim.n(), p.h, p.dt, p.d0, p.mu, sim.config.solver,
        sim.config.neighbors)
