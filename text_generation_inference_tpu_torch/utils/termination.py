"""K8s termination-log writer (reference: server/.../utils/termination.py,
launcher/src/main.rs:99-110 write /dev/termination-log on fatal errors)."""

from __future__ import annotations

import logging

logger = logging.getLogger(__name__)

TERMINATION_LOG = "/dev/termination-log"


def write_termination_log(message: str) -> None:
    try:
        with open(TERMINATION_LOG, "w") as f:
            f.write(message[:4096])
    except OSError:
        logger.debug("no termination log available")
