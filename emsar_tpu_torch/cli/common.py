"""Shared CLI helpers."""

from __future__ import annotations

import sys


def die(msg: str) -> None:
    print(msg, file=sys.stderr)
    raise SystemExit(1)
