"""Structured logging with the pipeline's runtime warning thresholds.

Mirrors `spsvo_tpu.utils.logging`: a standard-library logger plus explicit,
testable guards:

  * per-step latency over budget
  * match count below 10
  * keypoint/descriptor starvation
  * chain matches beyond the `solve_slots` capacity
"""

from __future__ import annotations

import logging
import sys
from typing import Dict, Optional

_LOGGER_NAME = "spsvo_tpu_torch"


def get_logger(level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger(_LOGGER_NAME)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(
            "[%(asctime)s] [%(levelname)s] [spsvo] %(message)s",
            datefmt="%H:%M:%S"))
        logger.addHandler(handler)
        logger.setLevel(level)
        logger.propagate = False
    return logger


class RuntimeGuards:
    """The runtime self-checks; each returns whether the value is fine and
    counts its violations."""

    def __init__(self, latency_budget_ms: float = 125.0,
                 min_matches: int = 10, min_descriptors: int = 10,
                 logger: Optional[logging.Logger] = None):
        self.latency_budget_ms = latency_budget_ms
        self.min_matches = min_matches
        self.min_descriptors = min_descriptors
        self.log = logger or get_logger()
        self.violations: Dict[str, int] = {"latency": 0, "matches": 0,
                                           "descriptors": 0,
                                           "chain_capacity": 0}

    def check_latency(self, ms: float, frame: int = -1) -> bool:
        ok = ms <= self.latency_budget_ms
        if not ok:
            self.violations["latency"] += 1
            self.log.warning("frame %d took %.1f ms (> %.0f ms budget)",
                             frame, ms, self.latency_budget_ms)
        return ok

    def check_matches(self, count: int, match_type: str = "") -> bool:
        ok = count >= self.min_matches
        if not ok:
            self.violations["matches"] += 1
            self.log.warning("%d matches < %d for %s", count,
                             self.min_matches, match_type)
        return ok

    def check_descriptors(self, count: int, side: str = "") -> bool:
        ok = count >= self.min_descriptors
        if not ok:
            self.violations["descriptors"] += 1
            self.log.warning("%d descriptors < %d (%s)", count,
                             self.min_descriptors, side)
        return ok

    def check_chain_capacity(self, truncated: bool, num_chain: int = -1,
                             capacity: int = -1, frame: int = -1) -> bool:
        """Warn when `cfg.solve_slots` dropped valid chain matches: the
        compaction capacity is fixed, so a rich frame loses matches
        silently otherwise. The fix is raising `solve_slots` (0 = the full-K
        solve)."""
        if truncated:
            self.violations["chain_capacity"] += 1
            detail = []
            if num_chain >= 0:
                detail.append(f"{num_chain} kept")
            if capacity >= 0:
                detail.append(f"capacity {capacity}")
            self.log.warning(
                "frame %d: chain matches exceeded solve_slots capacity%s "
                "— excess matches dropped; raise cfg.solve_slots",
                frame, f" ({', '.join(detail)})" if detail else "")
        return not truncated

    def summary(self) -> Dict[str, int]:
        return dict(self.violations)
