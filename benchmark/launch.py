"""One rank per card under ``torchrun``, for a cell whose work spans
cards: a copy of ``tools/cards.py::launch`` and its ``STRICT_ENV``
(commit 503dac0). No cell on one card uses it.

``launch`` runs ``torch.distributed.run --standalone`` over a worker
script in a session of its own, with ``STRICT_ENV`` (a failed
process-group init is fatal; every rank hashes the same words; nothing
reaches the network), every rank's output in a log file; past its time
limit the whole session is killed. It raises ``SystemExit`` with the
log's tail when the launch exits non-zero.
"""

from __future__ import annotations

import os
import pathlib
import signal
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
STRICT_ENV = {
    "MOVIIGEN_STRICT_DISTRIBUTED": "1",
    "PYTHONHASHSEED": "0",
    "OMP_NUM_THREADS": "1",
    "HF_HUB_OFFLINE": "1",
    "TRANSFORMERS_OFFLINE": "1",
}


def launch(script, worker_args, nproc: int, log_path, timeout: float,
           env=None) -> float:
    """``torchrun --standalone --nproc_per_node nproc script --worker
    worker_args``; returns its seconds."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(nproc), str(script), "--worker",
           *map(str, worker_args)]
    full_env = dict(os.environ, **STRICT_ENV, **(env or {}))
    log_path = pathlib.Path(log_path)
    log_path.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        log.write(" ".join(cmd) + "\n")
        log.flush()
        proc = subprocess.Popen(cmd, cwd=ROOT, env=full_env, stdout=log,
                                stderr=subprocess.STDOUT,
                                start_new_session=True)
        try:
            rc = proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            rc = f"killed after {timeout:.0f} s"
    seconds = time.perf_counter() - t0
    if rc != 0:
        print(log_path.read_text(errors="replace")[-12000:],
              file=sys.stderr, flush=True)
        raise SystemExit(f"launch of {nproc} ranks failed: {rc}; log "
                         f"{log_path}")
    return seconds
