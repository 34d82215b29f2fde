"""The process helpers the stripe runner shares with the serving
fleet's supervisor.

The port's counterpart of the first part of
`licensee_tpu/fleet/supervisor.py`: the restart backoff, the graceful
stop and the child environment.  The ``Supervisor`` of the serving
fleet comes with the fleet tier (ROADMAP A).
"""

from __future__ import annotations

import os
import subprocess

from licensee_tpu_torch.parallel.distributed import apply_visible_chips

__all__ = ["BackoffPolicy", "terminate_process", "worker_env"]


class BackoffPolicy:
    """Capped exponential restart backoff: restart number ``r + 1``
    waits ``base_s * 2^r`` seconds, capped at ``max_s``; a worker that
    stays healthy ``stable_after_s`` earns its restart counter back, so
    an old process's first crash restarts fast."""

    def __init__(
        self,
        base_s: float = 0.25,
        max_s: float = 10.0,
        stable_after_s: float = 10.0,
    ):
        self.base_s = float(base_s)
        self.max_s = float(max_s)
        self.stable_after_s = float(stable_after_s)

    def delay_s(self, restarts: int) -> float:
        """The delay before restart number ``restarts + 1``."""
        return min(self.base_s * (2 ** restarts), self.max_s)


def terminate_process(
    proc: subprocess.Popen | None, sigterm_timeout_s: float = 5.0
) -> None:
    """SIGTERM, escalated to SIGKILL after ``sigterm_timeout_s``: the one
    graceful stop."""
    if proc is None or proc.poll() is not None:
        return
    try:
        proc.terminate()
        proc.wait(timeout=sigterm_timeout_s)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=5.0)
    except OSError:
        pass


def worker_env(
    base_env: dict | None, chips: list[str] | None
) -> dict[str, str]:
    """The child environment of one worker.

    With ``chips``, exports ``LICENSEE_TPU_VISIBLE_CHIPS`` and derives
    ``CUDA_VISIBLE_DEVICES`` through ``apply_visible_chips`` on the
    child's dict, never this process's environment.  Pins PYTHONPATH to
    the port's root, so ``-m licensee_tpu_torch...`` resolves whatever
    the child's working directory."""
    env = dict(os.environ if base_env is None else base_env)
    pkg_root = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    existing = env.get("PYTHONPATH")
    env["PYTHONPATH"] = (
        pkg_root if not existing else pkg_root + os.pathsep + existing
    )
    if chips:
        env["LICENSEE_TPU_VISIBLE_CHIPS"] = ",".join(chips)
        apply_visible_chips(env)
    return env
