"""Process-group initialization under ``torchrun``.

Counterpart of ``moviigen_tpu/parallel/distributed.py``: there
``jax.distributed.initialize()`` joins the processes of a TPU pod; here
``torch.distributed.init_process_group`` joins the ranks that ``torchrun``
starts, from the variables it sets (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``). Each rank runs on
``cuda:LOCAL_RANK`` over NCCL, or over gloo when it runs on the CPU.

Failure semantics are the JAX package's: in a launch that looks
distributed, a failed initialization would leave every process running
alone on its own card, a silently divergent fleet. That is logged as an
error naming the variables that triggered it and, with ``strict=True`` or
``MOVIIGEN_STRICT_DISTRIBUTED=1``, raised.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch

# Variables that signal a torchrun launch; any one triggers the
# initialization (order matters only for the log message).
_LAUNCH_ENV_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR")


def detect_multi_host_env() -> list:
    """The launcher variables present (empty in a plain launch)."""
    return [k for k in _LAUNCH_ENV_VARS if os.environ.get(k)]


def is_initialized() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def local_device(device=None) -> Optional[str]:
    """``device`` with this rank's card: ``cuda`` (or None) becomes
    ``cuda:LOCAL_RANK`` once the process group is up; anything else is
    returned as it is."""
    if is_initialized() and device in (None, "cuda") \
            and torch.cuda.is_available():
        return f"cuda:{local_rank()}"
    return device


def maybe_initialize_distributed(force: bool = False, strict: bool = False,
                                 device=None) -> bool:
    """Initialize ``torch.distributed`` when launched by ``torchrun`` (or
    forced); True once a process group is up. Safe to call again.

    The backend is NCCL with each rank on ``cuda:LOCAL_RANK``, or gloo
    when ``device`` names the CPU or no card is present."""
    import torch.distributed as dist

    if is_initialized():
        return True
    triggers = detect_multi_host_env()
    if not (force or triggers):
        return False
    strict = strict or os.environ.get(
        "MOVIIGEN_STRICT_DISTRIBUTED", "") not in ("", "0", "false")
    cuda = torch.cuda.is_available() and (
        device is None or torch.device(device).type == "cuda")
    try:
        if cuda:
            torch.cuda.set_device(local_rank())
        dist.init_process_group("nccl" if cuda else "gloo",
                                init_method="env://")
        logging.info("torch.distributed initialized (%s): rank %d/%d, "
                     "local rank %d", dist.get_backend(), dist.get_rank(),
                     dist.get_world_size(), local_rank())
        return True
    except Exception as e:  # noqa: BLE001 (logged or raised below)
        msg = (f"torch.distributed.init_process_group FAILED in a "
               f"distributed launch (triggered by {triggers or ['force']}): "
               f"{e}. Continuing alone would run every process on its own "
               f"card with its own request — a silently divergent fleet. "
               f"Set MOVIIGEN_STRICT_DISTRIBUTED=1 to make this fatal.")
        if strict:
            raise RuntimeError(msg) from e
        logging.error(msg)
        return False
